"""The port's versioned weight bus (``distributed/weight_bus.py``) against the
JAX package's, mirroring ``tests/test_weight_bus.py``.

* **Codec, leaf by leaf.** For each (previous, new) tree pair the port's
  ``encode_update`` chooses the JAX codec's mode on every leaf (bf16 delta,
  f32 delta or full) with the same wire bytes, the same checksum, base
  version and delta flag; each package decodes the other's payload to the
  same bytes. The pairs cover bf16-exact and f32-only deltas, inexact ones
  (full), an unchanged leaf, -0.0 and NaN, shape, dtype and structure
  drift, bf16, f16, f64 and integer leaves. ``checksum_tree`` equals JAX's
  on the same adapter (the port's tensors through ``lora_to_numpy``).
* The checksum and version errors; ``AdapterCache`` (two slots, the
  out-of-order resync, ``wait_for`` across threads and its timeout).
* **The bus over port workers** (TINY f32 checkpoints on the CPU): a full
  first push, deltas after, acks and the workers' checksums equal to the
  driver's, the two-slot cache; the corrupt drill (a flipped byte in a
  worker's cached base: the next delta is rejected, one full resync lands
  it); an unknown version re-requested by the driver's transient hook; a
  rejoined worker resynced in full before its admission.
"""

import dataclasses
import pickle
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distrl_llm_tpu.distributed import weight_bus as jwb
from distrl_llm_tpu.models import TINY, init_lora_params
from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.distributed import connect_remote_engine
from distrl_llm_tpu_torch.distributed import weight_bus as twb
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, lora_to_numpy
from distrl_llm_tpu_torch.native.build import native_available
from tests.test_torch_control_plane import (  # noqa: F401  (_reap_and_reset: the fixture)
    _reap_and_reset, kill, serve_args, spawn, tiny_checkpoint,
)

BF16 = ml_dtypes.bfloat16
P_LEN, MAX_NEW, SCALE = 8, 4, 2.0


def _rand(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pairs():
    """(name, prev, new) trees; ``prev`` None encodes full."""
    a, b = _rand(0, (3, 4)), _rand(1, (5,))
    base = {"q": {"A": a, "B": b}, "v": {"A": _rand(2, (2, 3)), "B": np.zeros(4, np.float32)}}
    step = {"q": {"A": a + 0.5, "B": b + 0.25}, "v": {"A": base["v"]["A"] + 2.0**-8,
                                                      "B": np.zeros(4, np.float32)}}
    f32_only = {"q": {"A": _rand(3, (3, 4)), "B": _rand(4, (5,))},
                "v": {"A": _rand(5, (2, 3)), "B": _rand(6, (4,))}}
    huge = {"q": {"A": a * 1e30, "B": b}, "v": base["v"]}
    signed = {"x": np.array([0.0, -0.0, np.nan, 1.0, np.inf], np.float32)}
    signed2 = {"x": np.array([-0.0, 0.0, np.nan, 1.0 + 2.0**-20, -np.inf], np.float32)}
    bf = {"w": _rand(7, (4, 6)).astype(BF16), "n": _rand(8, (6,)).astype(BF16)}
    bf2 = {"w": (bf["w"].astype(np.float32) + 0.25).astype(BF16),
           "n": (bf["n"].astype(np.float32) * 1.37).astype(BF16)}
    mixed = {"h": _rand(9, (5,), np.float16), "d": _rand(10, (3,), np.float64),
             "i": np.arange(6, dtype=np.int32), "b": _rand(11, (2, 2)).astype(BF16)}
    mixed2 = {"h": (mixed["h"] + np.float16(0.5)).astype(np.float16),
              "d": mixed["d"] + 1e-12, "i": np.arange(6, dtype=np.int32) + 1,
              "b": (mixed["b"].astype(np.float32) - 0.5).astype(BF16)}
    drift = {"q": {"A": a.reshape(4, 3), "B": b.astype(np.float16)}, "v": base["v"]}
    return [
        ("first_contact", None, base),
        ("bf16_exact", base, step),
        ("f32_only", {k: {j: np.zeros_like(x) for j, x in v.items()} for k, v in base.items()},
         f32_only),
        ("random_to_random", base, f32_only),
        ("inexact_full", huge, base),
        ("unchanged", base, base),
        ("signed_zero_nan_inf", signed, signed2),
        ("bf16_leaves", bf, bf2),
        ("mixed_dtypes", mixed, mixed2),
        ("shape_and_dtype_drift", base, drift),
        ("structure_drift", {"a": np.ones(2, np.float32)}, {"b": np.ones(2, np.float32)}),
    ]


def _port(tree):
    """The port's side of a JAX tree: bf16 leaves as CPU bf16 tensors."""
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if tree is not None and tree.dtype == BF16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _bytes(tree) -> list[tuple[str, tuple, bytes]]:
    return [(d, a.shape, a.tobytes()) for a, d in map(twb._leaf, twb.tree_leaves(tree))]


def _jbytes(tree) -> list[tuple[str, tuple, bytes]]:
    leaves = jax.tree_util.tree_leaves(tree)
    return [(np.asarray(x).dtype.name, np.asarray(x).shape, np.asarray(x).tobytes())
            for x in leaves]


@pytest.mark.parametrize("name,prev,new", _pairs(), ids=[p[0] for p in _pairs()])
def test_codec_matches_jax_leaf_by_leaf(name, prev, new):
    base = None if prev is None else 3
    jp = jwb.encode_update(new, 4, prev, base)
    tp = twb.encode_update(_port(new), 4, None if prev is None else _port(prev), base)
    assert [r["mode"] for r in tp["leaves"]] == [r["mode"] for r in jp["leaves"]]
    assert [r["data"] for r in tp["leaves"]] == [r["data"] for r in jp["leaves"]]
    assert [(r["dtype"], tuple(r["shape"])) for r in tp["leaves"]] == [
        (r["dtype"], tuple(r["shape"])) for r in jp["leaves"]]
    for k in ("version", "base_version", "checksum", "delta"):
        assert tp[k] == jp[k], k
    assert twb.checksum_tree(_port(new)) == jwb.checksum_tree(new)
    # each package decodes the other's payload to the same bytes
    want = _jbytes(new)
    _, jt = jwb.decode_update(pickle.loads(twb.serialize_update(tp)), prev)
    _, tj = twb.decode_update(pickle.loads(jwb.serialize_update(jp)),
                              None if prev is None else _port(prev))
    _, tt = twb.decode_update(tp, None if prev is None else _port(prev))
    assert _jbytes(jt) == want and _bytes(tj) == want and _bytes(tt) == want


def test_modes_of_the_interesting_pairs():
    modes = {name: {r["mode"] for r in twb.encode_update(
        _port(new), 1, None if prev is None else _port(prev), 0)["leaves"]}
        for name, prev, new in _pairs()}
    assert modes["bf16_exact"] == modes["unchanged"] == {"delta_bf16"}
    assert modes["f32_only"] == {"delta_f32"}
    assert modes["first_contact"] == modes["structure_drift"] == {"full"}
    assert "full" in modes["shape_and_dtype_drift"]


def test_checksum_of_an_adapter_equals_jax():
    """The port's adapter tensors, shipped through ``lora_to_numpy`` (the
    JAX tree's layout), checksum as the JAX tree they came from."""
    tree = jax.tree_util.tree_map(np.asarray, init_lora_params(jax.random.PRNGKey(1), TINY, 4))
    lora = lora_from_numpy(tree, ModelConfig(**dataclasses.asdict(TINY)), device="cpu")
    assert twb.checksum_tree(lora_to_numpy(lora)) == jwb.checksum_tree(tree)
    assert twb.checksum_tree(lora) == jwb.checksum_tree(tree)  # tensors hash alike


def test_errors():
    prev = _pairs()[0][2]
    new = _pairs()[1][2]
    payload = twb.encode_update(new, 2, prev, 1)
    with pytest.raises(twb.WeightChecksumError):
        twb.decode_update(payload, _pairs()[2][2])  # a wrong base
    with pytest.raises(twb.WeightVersionError, match="does not hold"):
        twb.decode_update(payload, None)
    full = twb.encode_update(new, 1)
    data = bytearray(full["leaves"][0]["data"])
    data[0] ^= 0xFF
    full["leaves"][0]["data"] = bytes(data)
    with pytest.raises(twb.WeightChecksumError):
        twb.decode_update(full)
    for cls in (twb.WeightChecksumError, twb.WeightVersionError):
        assert str(cls("x")).startswith("[transient]")


def test_adapter_cache():
    c = twb.AdapterCache()
    assert c.get(None) is None and c.current_version is None and c.previous() is None
    c.put(1, "a")
    c.put(2, "b")
    assert c.versions() == [1, 2] and c.previous() == (1, "a")
    c.put(3, "c")
    assert c.versions() == [2, 3] and c.get(1) is None
    c.put(1, "a2")  # an out-of-order resync keeps what it delivered and the newest
    assert c.versions() == [1, 3] and c.current_version == 3
    threading.Timer(0.05, lambda: c.put(9, "z")).start()
    assert c.wait_for(9, 5.0) == "z"
    t0 = time.monotonic()
    with pytest.raises(twb.WeightVersionError, match="re-push"):
        c.wait_for(42, 0.1)
    assert time.monotonic() - t0 < 2


def test_resolve_wait_s(monkeypatch):
    monkeypatch.setenv(twb.WEIGHT_WAIT_ENV, "2.5")
    assert twb.resolve_wait_s() == jwb.resolve_wait_s() == 2.5
    monkeypatch.setenv(twb.WEIGHT_WAIT_ENV, "x")
    assert twb.resolve_wait_s() == jwb.resolve_wait_s() == twb.DEFAULT_WEIGHT_WAIT_S


# ------------------------------------------------------- over port workers

needs_native = pytest.mark.skipif(not native_available(), reason="g++ not available")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory.mktemp("tiny") / "hf")


def _workers(ckpt, n=2, env=None, port=0):
    return [spawn(*serve_args(ckpt, prompt=P_LEN, new=MAX_NEW), env=env, port=port)
            for _ in range(n)]


def _connect(addrs, **kw):
    return connect_remote_engine(addrs, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                                 timeout_ms=60_000, lora_scale=SCALE, eos_token_ids=[3],
                                 weight_bus="broadcast", **kw)


def _lora(shift=0.0):
    tree = jax.tree_util.tree_map(np.asarray, init_lora_params(jax.random.PRNGKey(1), TINY, 4))
    return jax.tree_util.tree_map(lambda x: (x + shift).astype(np.float32), tree)


@needs_native
def test_push_ack_delta_and_cache_slots(ckpt):
    addrs = [("127.0.0.1", p) for _, p in _workers(ckpt)]
    eng = _connect(addrs)
    try:
        lora0, lora1, lora2 = _lora(), _lora(0.5), _lora(0.75)
        eng.push_lora(lora0, version=0)
        assert eng.bus.flush(timeout_s=60)
        eng.push_lora(lora1, version=1)
        assert eng.bus.flush(timeout_s=60)
        assert [eng.bus.acked_version(a) for a in addrs] == [1, 1]
        assert eng.bus.last_acked_version == 1
        b = eng.bus.history
        assert [x["modes"] for x in b] == [{f"{h}:{p}": m for h, p in addrs}
                                          for m in ("full", "delta")]
        assert all(n < min(b[0]["bytes"].values()) for n in b[1]["bytes"].values())
        want = {0: jwb.checksum_tree(lora0), 1: jwb.checksum_tree(lora1)}
        for dbg in eng.driver.dispatch_objects([("weights_debug", {})] * 2, 60_000):
            assert dbg["versions"] == [0, 1] and dbg["current"] == 1
            assert dbg["checksums"] == want
        eng.push_lora(lora2, version=2)
        assert eng.bus.flush(timeout_s=60)
        assert eng.driver.dispatch_objects([("weights_debug", {})], 60_000)[0][
            "versions"] == [1, 2]
        snap = telemetry.metrics_snapshot()
        assert snap["cp/weight_pushes"] == 6 and snap["cp/weight_full_syncs"] == 2
    finally:
        eng.driver.shutdown()


@needs_native
def test_corrupt_base_falls_back_to_one_full_push(ckpt):
    addrs = [("127.0.0.1", p) for _, p in _workers(ckpt, 1)]
    eng = _connect(addrs)
    try:
        eng.push_lora(_lora(), version=0)
        assert eng.bus.flush(timeout_s=60)
        telemetry.metrics_snapshot()
        eng.driver.dispatch_objects([("weights_debug", {"corrupt": 0})], 60_000)
        lora1 = _lora(0.5)
        eng.push_lora(lora1, version=1)
        assert eng.bus.flush(timeout_s=60)
        dbg = eng.driver.dispatch_objects([("weights_debug", {})], 60_000)[0]
        assert dbg["current"] == 1 and dbg["checksums"][1] == jwb.checksum_tree(lora1)
        snap = telemetry.metrics_snapshot()
        assert snap["cp/weight_full_syncs"] == 1 and snap["cp/weight_pushes"] == 2
        assert eng.bus.history[-1]["modes"] == {f"127.0.0.1:{addrs[0][1]}": "full"}
    finally:
        eng.driver.shutdown()


@needs_native
def test_unknown_version_is_re_requested(ckpt):
    """A dispatch naming a version the worker never received surfaces as a
    transient WeightVersionError; the driver's hook re-pushes that version
    in full and the bounded retry completes the round."""
    addrs = [("127.0.0.1", p) for _, p in _workers(ckpt, 1, env={twb.WEIGHT_WAIT_ENV: "0.5"})]
    eng = _connect(addrs)
    try:
        eng.push_lora(_lora(), version=0)
        assert eng.bus.flush(timeout_s=60)
        lora7 = _lora(0.5)
        eng._bus_state = (lora7, lora7, 7)  # the driver believes v7 went out
        eng._versioned_pushes = True
        telemetry.metrics_snapshot()
        ids = np.random.default_rng(0).integers(4, 200, (2, P_LEN)).astype(np.int32)
        got = eng.generate(None, lora7, ids, np.ones_like(ids),
                           SamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=1), 0)
        assert got.tokens.shape == (2, 1, MAX_NEW)
        snap = telemetry.metrics_snapshot()
        assert snap["cp/weight_rerequests"] >= 1 and snap["cp/retries"] >= 1
        assert 7 in eng.driver.dispatch_objects([("weights_debug", {})], 60_000)[0]["versions"]
    finally:
        eng.driver.shutdown()


@needs_native
def test_rejoin_resyncs_in_full_before_admission(ckpt):
    procs, ports = zip(*_workers(ckpt))
    addrs = [("127.0.0.1", p) for p in ports]
    eng = connect_remote_engine(addrs, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                                timeout_ms=60_000, lora_scale=SCALE, eos_token_ids=[3],
                                weight_bus="broadcast")
    eng.driver._rejoin_poll_s = 0.05
    try:
        lora = _lora(0.25)
        eng.push_lora(lora, version=3)
        assert eng.bus.flush(timeout_s=60)
        kill(procs[0])
        assert eng.driver.ping_all(timeout_ms=2000) == [False, True]
        _workers(ckpt, 1, port=ports[0])
        deadline = time.monotonic() + 60
        while eng.driver.num_healthy < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.driver.num_healthy == 2 and eng.driver.rejoin_epoch >= 1
        for dbg in eng.driver.dispatch_objects([("weights_debug", {})] * 2, 60_000):
            assert dbg["versions"] == [3] and dbg["checksums"][3] == jwb.checksum_tree(lora)
    finally:
        eng.driver.shutdown()
