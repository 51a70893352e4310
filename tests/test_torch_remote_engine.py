"""The port's ``RemoteEngine`` (``distributed/remote_engine.py``) over port
worker processes, mirroring ``tests/test_remote_engine.py``, and the
worker's generate path (``distributed/worker_main.py``) in process.

* Greedy rounds over two workers (TINY f32 checkpoints from the JAX
  package's ``init_params``, uneven shards) equal the live JAX
  ``GenerationEngine`` on the same params token for token, with the
  adapter over the weight bus ("broadcast") and in every shard
  ("dispatch"); captured behavior logprobs within ``LOGP_ATOL``. Sampled
  rounds (seeds from the port's generator, not ``jax.random``) are only
  held to their own reproducibility.
* The worker's generate path in process: a push landing at a chosen
  decode step through ``weights_handler`` (the bus frame, the adapter ring,
  the mailbox) swaps there, as ``push_lora`` does on a local engine at the
  same step: equal tokens, logprobs and swap log; a dispatch naming an
  older version than the ring's newest opens with it and swaps at step 0;
  every ring hold is released.
* The engine's own logic without workers: the lost-shard zero fill and its
  accounting, the swap-event merge, the rejoin epoch's reset of warm keys,
  dispatch mode's refusal of ``push_lora``; the worker's flag rules, the
  refusals naming ROADMAP item 11, and the refusal of a missing GPU.
"""

import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.models import TINY, init_lora_params, init_params
from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.distributed import (
    RemoteEngine, ShardFailedError, connect_remote_engine, weight_bus as twb, worker_main,
)
from distrl_llm_tpu_torch.engine import GenerationEngine
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy
from distrl_llm_tpu_torch.native.build import native_available
from tests.test_torch_control_plane import (  # noqa: F401  (_reap_and_reset: the fixture)
    _reap_and_reset, serve_args, spawn, tiny_checkpoint,
)

P_LEN, MAX_NEW, RANK, ALPHA = 12, 10, 4, 8.0
SCALE = ALPHA / RANK
EOS, PAD = 3, 0
LOGP_ATOL = 1e-4  # f32 behavior logprobs, two frameworks' summation orders
CFG = ModelConfig(**dataclasses.asdict(TINY))
needs_native = pytest.mark.skipif(not native_available(), reason="g++ not available")


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(7), TINY))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(tmp_path_factory.mktemp("tiny") / "hf")


def _lora(seed=1, scale=0.05):
    t = jax.tree_util.tree_map(np.asarray, init_lora_params(jax.random.PRNGKey(seed), TINY, RANK))
    rng = np.random.default_rng(seed)
    for ab in t["layers"].values():
        ab["b"] = (scale * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return t


def _prompts(b=3, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TINY.vocab_size, (b, P_LEN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, :3] = 0
    ids[mask == 0] = PAD
    return ids, mask


def _jax_round(tree, lora, ids, mask, n):
    eng = JEngine(TINY, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW, eos_token_ids=[EOS],
                  pad_token_id=PAD, lora_scale=SCALE, cache_dtype=jnp.float32, autotune=False,
                  capture_logprobs=True)
    return eng.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                        jax.tree_util.tree_map(jnp.asarray, lora), ids, mask,
                        JSamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=n),
                        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def workers(ckpt):
    out = [spawn(*serve_args(ckpt, prompt=P_LEN, new=MAX_NEW, rank=RANK, alpha=ALPHA,
                             extra=["--capture-logprobs"]), reap=False) for _ in range(2)]
    yield [("127.0.0.1", p) for _, p in out]
    for proc, _ in out:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


def _connect(addrs, mode):
    return connect_remote_engine(addrs, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                                 timeout_ms=60_000, lora_scale=SCALE, eos_token_ids=[EOS],
                                 weight_bus=mode, rejoin=False)


def _detach(eng):
    if eng.bus is not None:
        eng.bus.close()
    for w in eng.driver._workers:
        if w.conn is not None:
            w.conn.close()
            w.conn = None


@needs_native
@pytest.mark.parametrize("mode", ["broadcast", "dispatch"])
def test_greedy_rounds_match_jax(workers, tree, mode):
    lora = _lora()
    ids, mask = _prompts()
    want = _jax_round(tree, lora, ids, mask, n=2)
    eng = _connect(workers, mode)
    try:
        got = eng.generate(None, lora, ids, mask,
                           SamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=2), 5)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
        np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs), atol=LOGP_ATOL,
                                   rtol=0)
        assert [m["rows"] for m in eng.last_shard_meta] == [(0, 2), (2, 3)]
        assert {m["worker"] for m in eng.last_shard_meta} == {f"{h}:{p}" for h, p in workers}
        assert all(m["round_stats"]["sampler_calls"] > 0 for m in eng.last_shard_meta)
        assert eng.last_lost_rows == [] and eng.last_swap_steps == []
        if mode == "broadcast":
            assert eng.bus.flush(30) and eng._bus_state[2] == 0
    finally:
        _detach(eng)


@needs_native
def test_sampled_rounds_are_reproducible(workers):
    eng = _connect(workers, "broadcast")
    try:
        lora = _lora()
        ids, mask = _prompts(4, seed=3)
        sc = SamplingConfig(max_tokens=MAX_NEW, temperature=1.2, top_p=0.95, n=3)
        a = eng.generate(None, lora, ids, mask, sc, 11)
        b = eng.generate(None, lora, ids, mask, sc, 11)
        c = eng.generate(None, lora, ids, mask, sc, 12)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.logprobs, b.logprobs)
        assert not np.array_equal(a.tokens, c.tokens)
        tok, lengths = a.tokens.reshape(-1, MAX_NEW), a.lengths.reshape(-1)
        after = np.arange(MAX_NEW)[None, :] >= lengths[:, None]
        assert ((tok >= 0) & (tok < TINY.vocab_size)).all() and (tok[after] == PAD).all()
        assert np.isfinite(a.logprobs).all()
    finally:
        _detach(eng)


# ------------------------------------------------ the worker's path in process


@pytest.fixture
def in_process_worker(ckpt):
    """worker_main's engine state built in this process (CPU, f32)."""
    saved = dict(worker_main._ENGINE_STATE)
    worker_main._ENGINE_STATE.clear()
    worker_main._init_engine(str(ckpt), P_LEN, MAX_NEW, 0, device="cpu", dtype="float32",
                             lora_rank=RANK, lora_alpha=ALPHA, capture_logprobs=True)
    yield worker_main._ENGINE_STATE
    worker_main._ENGINE_STATE.clear()
    worker_main._ENGINE_STATE.update(saved)


def _frame(tree, version, prev=None, base=None):
    return twb.serialize_update(twb.encode_update(tree, version, prev, base))


def _shard(ids, mask, version, n=2):
    return {"prompt_ids": ids, "prompt_mask": mask, "lora": None, "weight_version": version,
            "sampling": dataclasses.asdict(SamplingConfig(max_tokens=MAX_NEW, temperature=0.0,
                                                          n=n)),
            "lora_scale": SCALE, "eos_token_ids": [EOS], "rng_seed": 3}


def _local(tree):
    return GenerationEngine(CFG, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                            eos_token_ids=[EOS], pad_token_id=PAD, lora_scale=SCALE,
                            cache_dtype=torch.float32, capture_logprobs=True, device="cpu")


@pytest.mark.parametrize("step", [0, 4])
def test_a_bus_push_mid_round_swaps_as_push_lora_does(in_process_worker, tree, step):
    st = in_process_worker
    eng, ring = st["engine"], st["ring"]
    lora0, lora1 = _lora(1), _lora(2, scale=0.2)
    pickle.loads(worker_main.weights_handler(_frame(lora0, 0)))
    take = eng._take_pending_lora

    def pushed_at(cell, dispatched):
        if dispatched == step:  # the bus frame lands here, on the decoding thread
            ack = pickle.loads(worker_main.weights_handler(_frame(lora1, 1, lora0, 0)))
            assert ack == {"version": 1, "checksum": twb.checksum_tree(lora1)}
        take(cell, dispatched)

    eng._take_pending_lora = pushed_at
    ids, mask = _prompts()
    got = worker_main._generate(_shard(ids, mask, 0))
    eng._take_pending_lora = take
    assert got["swap_steps"] == [step] and got["swap_versions"] == [1]
    assert got["entry_version"] == 0 and ring.holds() == [0, 0, 0]
    # the same swap on a local engine: push_lora at the same step
    local = _local(tree)
    model = params_from_numpy(tree, CFG, device="cpu")
    ltake = local._take_pending_lora

    def local_at(cell, dispatched):
        if dispatched == step:
            local.push_lora(lora_from_numpy(lora1, CFG, device="cpu"), version=1)
        ltake(cell, dispatched)

    local._take_pending_lora = local_at
    want = local.generate(model, lora_from_numpy(lora0, CFG, device="cpu"), ids, mask,
                          SamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=2), 3)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_array_equal(got["logprobs"], want.logprobs)
    assert local.last_swap_steps == [step]
    # the next round names v1: the ring's published buffer, no swap
    nxt = worker_main._generate(_shard(ids, mask, 1))
    assert nxt["swap_steps"] == [] and ring.holds() == [0, 0, 0]
    dbg = pickle.loads(worker_main.handler(pickle.dumps(("weights_debug", None))))
    assert dbg["versions"] == [0, 1] and dbg["checksums"][1] == twb.checksum_tree(lora1)


def test_a_dispatch_older_than_the_ring_opens_with_it(in_process_worker):
    """v1 landed before a dispatch naming v0 (the push outran it): the round
    opens with v0 from its ring buffer and the pending v1 swaps at step 0."""
    st = in_process_worker
    lora0, lora1 = _lora(1), _lora(2, scale=0.2)
    worker_main.weights_handler(_frame(lora0, 0))
    worker_main.weights_handler(_frame(lora1, 1, lora0, 0))
    ids, mask = _prompts()
    got = worker_main._generate(_shard(ids, mask, 0))
    assert got["swap_steps"] == [0] and got["swap_versions"] == [1]
    assert st["ring"].holds() == [0, 0, 0]
    again = worker_main._generate(_shard(ids, mask, 1))  # a pending v1 at v1's entry is dropped
    assert again["swap_steps"] == []


def test_a_dispatch_past_the_ring_is_copied_into_it_and_every_hold_returns(
        in_process_worker, tree):
    """A dispatch names v0 after v1-v3 have overwritten its ring buffer (the
    adapter cache still holds it, as in the window between a push's ring
    copy and its cache put): the round reads v0 copied into a free ring
    buffer, swaps to the pending v3 at step 0 and to v4, pushed in flight,
    at step 4, as a local engine does; every hold returns to 0 at its end,
    so the two pushes after it find free buffers, and the round's adapters
    are ring buffers, the addresses its graphs are keyed on."""
    from distrl_llm_tpu_torch.distributed.weight_bus import AdapterCache
    from distrl_llm_tpu_torch.engine.decode_graph import tensors_key

    st = in_process_worker
    st["adapter_cache"] = AdapterCache(slots=8)
    eng, ring = st["engine"], st["ring"]
    loras = [_lora(1 + v, scale=0.05 * (v + 1)) for v in range(7)]
    worker_main.weights_handler(_frame(loras[0], 0))
    for v in range(1, 4):
        worker_main.weights_handler(_frame(loras[v], v, loras[v - 1], v - 1))
    assert 0 not in ring._versions
    take, generate, read = eng._take_pending_lora, eng.generate, []

    def pushed_at(cell, dispatched):
        if dispatched == 4:
            worker_main.weights_handler(_frame(loras[4], 4, loras[3], 3))
        take(cell, dispatched)

    def reading(model, lora, *a, **kw):
        read.append(tensors_key(lora))
        return generate(model, lora, *a, **kw)

    eng._take_pending_lora, eng.generate = pushed_at, reading
    ids, mask = _prompts()
    try:
        got = worker_main._generate(_shard(ids, mask, 0))
    finally:
        eng._take_pending_lora, eng.generate = take, generate
    assert got["swap_steps"] == [0, 4] and got["swap_versions"] == [3, 4]
    assert ring.holds() == [0, 0, 0]
    assert read[0] in {tensors_key(b) for b in ring._bufs}
    local = _local(tree)
    ltake = local._take_pending_lora

    def local_at(cell, dispatched):
        if dispatched == 4:
            local.push_lora(lora_from_numpy(loras[4], CFG, device="cpu"), version=4)
        ltake(cell, dispatched)

    local._take_pending_lora = local_at
    local.push_lora(lora_from_numpy(loras[3], CFG, device="cpu"), version=3)
    want = local.generate(params_from_numpy(tree, CFG, device="cpu"),
                          lora_from_numpy(loras[0], CFG, device="cpu"), ids, mask,
                          SamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=2), 3)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_array_equal(got["logprobs"], want.logprobs)
    assert local.last_swap_steps == [0, 4]
    # two more pushes: a hold left behind would make the second wait forever
    done = threading.Thread(target=lambda: [
        worker_main.weights_handler(_frame(loras[v], v, loras[v - 1], v - 1))
        for v in (5, 6)], daemon=True)
    done.start()
    done.join(timeout=60)
    assert not done.is_alive(), f"a push waited for a free buffer: holds {ring.holds()}"
    assert ring.holds() == [0, 0, 0] and ring.push_waits == 0
    # a dispatch that ships its own adapter reads it from a ring buffer too
    eng.discard_pending_at_or_below(6)  # a dispatch-mode driver pushes nothing
    eng.generate = reading
    try:
        again = worker_main._generate({**_shard(ids, mask, None), "lora": loras[0]})
    finally:
        eng.generate = generate
    plain = _local(tree).generate(params_from_numpy(tree, CFG, device="cpu"),
                                  lora_from_numpy(loras[0], CFG, device="cpu"), ids, mask,
                                  SamplingConfig(max_tokens=MAX_NEW, temperature=0.0, n=2), 3)
    np.testing.assert_array_equal(again["tokens"], plain.tokens)
    assert again["swap_steps"] == []
    assert read[-1] in {tensors_key(b) for b in ring._bufs} and ring.holds() == [0, 0, 0]


def test_lora_scale_mismatch_is_refused(in_process_worker):
    worker_main.weights_handler(_frame(_lora(), 0))
    ids, mask = _prompts()
    shard = _shard(ids, mask, 0)
    shard["lora_scale"] = 1.0
    with pytest.raises(ValueError, match="lora_scale mismatch"):
        worker_main._generate(shard)
    assert in_process_worker["ring"].holds() == [0, 0, 0]


# ------------------------------------------------------------ without workers


class _FakeDriver:
    def __init__(self, results):
        self.results, self.num_healthy, self.rejoin_epoch = results, 2, 0
        self.last_dispatch_meta = [{"worker": "w0", "dispatch_id": 1},
                                   {"worker": "w1", "dispatch_id": 2}]
        self.calls = []

    def dispatch_objects(self, shards, timeout_ms, allow_partial):
        self.calls.append((shards, timeout_ms, allow_partial))
        return list(self.results)


def _result(rows, steps=(), versions=()):
    return {"tokens": np.full((rows, 1, 4), 7, np.int32), "lengths": np.full((rows, 1), 4),
            "logprobs": None, "swap_steps": list(steps), "swap_versions": list(versions)}


def test_lost_shards_are_zero_filled_and_accounted():
    telemetry.reset()
    drv = _FakeDriver([_result(2, [8], [1]), None])
    eng = RemoteEngine(drv, max_prompt_tokens=4, max_new_tokens=4,
                       degrade_on_shard_failure=True)
    ids = np.ones((4, 4), np.int32)
    res = eng.generate(None, None, ids, ids, SamplingConfig(max_tokens=4, n=1), 0)
    assert drv.calls[0][2] is True  # allow_partial
    assert eng.last_lost_rows == [2, 3] and res.tokens.shape == (4, 1, 4)
    assert (res.tokens[2:] == 0).all() and (res.tokens[:2] == 7).all()
    assert eng.last_swap_steps == [8] and eng.last_swap_versions == [1]
    assert telemetry.metrics_snapshot()["cp/degraded_groups"] == 2.0
    eng2 = RemoteEngine(_FakeDriver([None, None]), max_prompt_tokens=4, max_new_tokens=4,
                        degrade_on_shard_failure=True)
    with pytest.raises(ShardFailedError, match="every shard"):
        eng2.generate(None, None, ids, ids, SamplingConfig(max_tokens=4, n=1), 0)


def test_swap_merge_rejoin_reset_and_dispatch_refusal():
    drv = _FakeDriver([_result(1, [4, 12], [1, 2]), _result(1, [8], [1])])
    eng = RemoteEngine(drv, max_prompt_tokens=4, max_new_tokens=4, timeout_ms=1000,
                       cold_timeout_ms=9000)
    ids = np.ones((2, 4), np.int32)
    sc = SamplingConfig(max_tokens=4, n=1)
    eng.generate(None, None, ids, ids, sc, 0)
    # per version the latest step any shard swapped at
    assert eng.last_swap_steps == [8, 12] and eng.last_swap_versions == [1, 2]
    eng.generate(None, None, ids, ids, sc, 0)
    assert [c[1] for c in drv.calls] == [9000, 1000]  # cold, then warm
    drv.rejoin_epoch = 1
    eng.generate(None, None, ids, ids, sc, 0)
    assert drv.calls[-1][1] == 9000  # a rejoin makes every shape cold again
    seeds = [[s[1]["rng_seed"] for s in c[0]] for c in drv.calls]
    assert seeds[0] == seeds[1] and len(set(seeds[0])) == 2  # per shard, from the seed
    assert eng.supports_inflight_push is False
    with pytest.raises(RuntimeError, match="broadcast"):
        eng.push_lora({"layers": {}}, version=1)
    with pytest.raises(ValueError, match="weight_bus"):
        RemoteEngine(drv, max_prompt_tokens=4, max_new_tokens=4, weight_bus="carrier")


@pytest.mark.parametrize("flags", [
    ["--trace"], ["--metrics-port", "0"], ["--serving-obs"], ["--gateway-port", "0"],
    ["--control"], ["--control-budget", "3"], ["--slo-ttft-ms", "5"], ["--plan-db", "x"],
    ["--autotune", "on"],
])
def test_the_planes_of_item_11_are_refused(flags):
    parser = worker_main.build_parser()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
        worker_main.validate(parser, parser.parse_args(flags))


@pytest.mark.parametrize("flags", [
    ["--scheduler", "refill"], ["--scheduler", "refill", "--engine-impl", "paged"],
    ["--spec-draft", "2"], ["--quant-group-size", "16"], ["--env", "code"],
    ["--max-turns", "2"], ["--decode-chunk", "0"], ["--kv-spill"],
    ["--engine-impl", "paged", "--scheduler", "refill", "--max-concurrent-sequences", "4",
     "--spec-draft", "0", "--spec-ngram", "2"],
])
def test_dead_flags_are_refused(flags):
    parser = worker_main.build_parser()
    with pytest.raises(SystemExit):
        worker_main.validate(parser, parser.parse_args(flags))


def test_the_worker_runs_on_the_gpu_unless_told(ckpt, monkeypatch, tmp_path):
    parser = worker_main.build_parser()
    args = parser.parse_args(["--autotune", "off", "--scan-chunk", "16", "--gpu-usage", "0.2"])
    worker_main.validate(parser, args)
    assert args.device == "cuda" and args.decode_scan_chunk == 16 and args.gpu_usage == 0.2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main._init_engine(str(ckpt), P_LEN, MAX_NEW, 0)
    # EOS and pad come from the checkpoint's tokenizer, as the JAX worker's do
    bare = tmp_path / "no_tokenizer"
    bare.mkdir()
    for f in ckpt.iterdir():
        if f.name != "tokenizer.json":
            (bare / f.name).symlink_to(f)
    with pytest.raises(ValueError, match="tokenizer.json"):
        worker_main._init_engine(str(bare), P_LEN, MAX_NEW, 0, device="cpu")
