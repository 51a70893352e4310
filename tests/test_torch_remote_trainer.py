"""The port's ``Trainer`` over port rollout workers (``rollout_workers``,
``RemoteEngine`` with the weight bus) against the live JAX trainer, on the
CPU at TINY in f32.

* **Sync.** Both trainers at temperature 0 with a position-scripted reward,
  the JAX one over its local dense engine, the port's over two worker
  processes serving the same params (``tests/test_torch_trainer.py``'s
  ``test_trainer_with_real_dense_engines_matches_jax``, its tolerances and
  their reasons): the eval round and round 1 equal token for token, round 2
  on ``ROUND2_ROWS_SHARE`` of its rows (it samples with adapters one update
  apart), the update batches equal, the losses within ``STEP_ATOL``, the
  adapter after step 1 within ``ADAPTER_STEP1_ATOL``; every version went out
  on the bus, full first and deltas after, and each worker holds the last
  one with the driver's checksum.
* **Async with in-flight pushes** (GRPO, clip 0.2, ``max_staleness=2``,
  captured behavior logprobs). A schedule fixed by the test on both
  packages alike: round t >= 1 enters once update t - 1 and its pushes are
  done, so each round opens with the newest version (on the workers an
  in-flight push that lands before the round's entry is dropped there as
  covered; the JAX engine consumes the same adapter at step 0). Held as in
  sync, and the behavior logprobs within ``LOGP_ATOL``.
* ``from_pretrained`` with ``rollout_workers`` builds no local engine; a
  degraded round drops its lost groups with exact accounting (and refuses a
  round with none left); the in-flight check refuses a dispatch-mode
  ``RemoteEngine``; the CLI flags reach the seven fields; ``chip_smoke.py``'s
  phase 16 rehearsed on the CPU.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.distributed import weight_bus as jwb
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu_torch import telemetry, trainer
from distrl_llm_tpu_torch.distributed import RemoteEngine, connect_remote_engine
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.models.convert import params_from_numpy
from distrl_llm_tpu_torch.native.build import native_available
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from distrl_llm_tpu_torch.train_distributed import build_parser, config_from_args
from tests.test_torch_control_plane import (  # noqa: F401  (_reap_and_reset: the fixture)
    _reap_and_reset, serve_args, spawn, tiny_checkpoint,
)
from tests.test_torch_learner import ADAPTER_STEP1_ATOL, STEP_ATOL
from tests.test_torch_trainer import (  # noqa: F401  (base_tree: the fixture)
    CFG, ROUND2_ROWS_SHARE, _adapter_diffs, _port_config, _record_learner_batches, _trainers,
    base_tree, position_reward,
)
from tests.test_trainer import make_datasets

pytestmark = pytest.mark.skipif(not native_available(), reason="g++ not available")

P_LEN, MAX_NEW = 16, 12
LOGP_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY's tensors are too small for torch's intra-op threads to pay."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # base_tree's weights: the JAX package's init_params(PRNGKey(0))
    return tiny_checkpoint(tmp_path_factory.mktemp("tiny") / "hf", seed=0)


def _remote_pair(base_tree, ckpt, **cfg_kw):
    capture = cfg_kw.get("clip_ratio", 0.0) > 0
    addrs = [("127.0.0.1", spawn(*serve_args(ckpt, prompt=P_LEN, new=MAX_NEW, extra=(
        ["--capture-logprobs"] if capture else [])))[1]) for _ in range(2)]
    jeng = JEngine(TINY, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW, eos_token_ids=[3],
                   pad_token_id=0, lora_scale=2.0, cache_dtype=jnp.float32, autotune=False,
                   capture_logprobs=capture)
    eng = connect_remote_engine(addrs, max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                                timeout_ms=60_000, lora_scale=2.0, eos_token_ids=[3],
                                weight_bus="broadcast", rejoin=False)
    jtr, tr = _trainers(base_tree, jengine=jeng, engine=eng,
                        reward_fns=(position_reward, position_reward), max_new_tokens=MAX_NEW,
                        temperature=0.0, eval_temperature=0.0, **cfg_kw)
    tr._push_weights()  # v0 again: the JAX trainer's initial adapter was copied in
    return jtr, tr


def _record(engine):
    out, gen = [], engine.generate

    def recorded(*a):
        res = gen(*a)
        out.append((np.asarray(res.tokens), np.asarray(res.lengths),
                    None if res.logprobs is None else np.asarray(res.logprobs)))
        return res

    engine.generate = recorded
    return out


def _fix_schedule(tr):
    """Train round t >= 1 enters once update t - 1 and its pushes are done
    (the push into the engine, and the in-flight one, of version t)."""
    done = {}
    push, gen_round = tr.engine.push_lora, tr._generate_round
    calls = [0]

    def pushed(lora, version=None):
        push(lora, version=version)
        if version is not None and tr._rollout_weight_version >= version:
            done.setdefault(version, threading.Event()).set()

    def gated(batch, sampling):
        t = calls[0] - 1  # call 0 is the initial eval's round
        calls[0] += 1
        if t >= 1:
            assert done.setdefault(t, threading.Event()).wait(120), f"update {t - 1} never pushed"
        return gen_round(batch, sampling)

    tr.engine.push_lora, tr._generate_round = pushed, gated


def _check_pair(jtr, tr, jrounds, rounds, jbatches, batches, logps: bool):
    (jev, j1, j2), (ev, r1, r2) = jrounds, rounds
    for got, want in ((ev, jev), (r1, j1)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if logps:
            np.testing.assert_allclose(got[2], want[2], atol=LOGP_ATOL, rtol=0)
    rows_same = (r2[0] == j2[0]).reshape(-1, r2[0].shape[-1]).all(axis=1)
    assert rows_same.mean() >= ROUND2_ROWS_SHARE, rows_same.mean()
    for k in ("coeffs", "sample_mask", "prompt_ids", "prompt_mask", "answer_ids"):
        np.testing.assert_array_equal(batches[0][k], jbatches[0][k], err_msg=k)
    recs, jrecs = ([m for _, m in t.sink.records if "loss" in m] for t in (tr, jtr))
    assert len(recs) == len(jrecs) == 2
    np.testing.assert_allclose([m["loss"] for m in recs], [m["loss"] for m in jrecs],
                               atol=STEP_ATOL, rtol=0)
    assert all(m["loss"] != 0 for m in recs)
    assert _adapter_diffs(tr.sink.adapters[0], jtr.sink.adapters[0]).max() <= ADAPTER_STEP1_ATOL
    for m, jm in zip(recs, jrecs):  # the control plane's series beside the JAX names
        assert {k for k in m if not k.startswith("cp/")} <= set(jm)
    # the first record holds the eval's and round 1's shards and both v0
    # broadcasts (later pushes may land after the record they follow)
    assert recs[0]["cp/dispatch_bytes"] > 0 and recs[0]["cp/weight_pushes"] >= 2
    assert tr.weight_version == jtr.weight_version == 2
    eng = tr.engine
    assert eng.bus.flush(60) and [eng.bus.acked_version(a) for a in eng.driver.addresses] == [2, 2]
    # v0 went out once or twice: the constructor's push, then the copied-in
    # adapter's, which supersedes the first when it was not sent yet
    versions = [x["version"] for x in eng.bus.history]
    assert versions[-2:] == [1, 2] and set(versions[:-2]) == {0}
    assert all(set(x["modes"].values()) == {"full" if i == 0 else "delta"}
               for i, x in enumerate(eng.bus.history))
    want = jwb.checksum_tree(jax.tree_util.tree_map(np.asarray, eng._bus_state[1]))
    for d in eng.driver.dispatch_objects([("weights_debug", None)] * 2, 60_000):
        assert d["current"] == 2 and d["checksums"][2] == want
    eng.driver.shutdown()


def test_sync_trainer_over_workers_matches_jax(base_tree, ckpt):
    jtr, tr = _remote_pair(base_tree, ckpt, learner="pg", topk=2)
    jrounds, rounds = _record(jtr.engine), _record(tr.engine)
    jbatches, batches = _record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)
    jtr.train()
    tr.train()
    _check_pair(jtr, tr, jrounds, rounds, jbatches, batches, logps=False)


def test_async_trainer_over_workers_matches_jax(base_tree, ckpt):
    jtr, tr = _remote_pair(base_tree, ckpt, learner="grpo", topk=2, clip_ratio=0.2,
                           rollout_mode="async", max_staleness=2, inflight_weight_updates=True)
    assert tr.engine.supports_inflight_push and tr._ring is None
    for t in (jtr, tr):
        _fix_schedule(t)
    jrounds, rounds = _record(jtr.engine), _record(tr.engine)
    jbatches, batches = _record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)
    jtr.train()
    tr.train()
    for got, want in zip(batches, jbatches):
        np.testing.assert_allclose(got["behavior_logps"], want["behavior_logps"],
                                   atol=LOGP_ATOL, rtol=0)
        np.testing.assert_array_equal(got["version_lag"], want["version_lag"])
    assert tr._rollout_buffer.stats() == jtr._rollout_buffer.stats()
    assert tr._rollout_buffer.stats()["total_got"] == 8  # 2 batches of 4 groups
    _check_pair(jtr, tr, jrounds, rounds, jbatches, batches, logps=True)


def test_from_pretrained_over_workers_builds_no_local_engine(tmp_path, monkeypatch):
    import chip_smoke

    ckpt = tiny_checkpoint(tmp_path / "hf", vocab_size=1024)
    chip_smoke.write_bpe_tokenizer(ckpt, 1024)
    addrs = [f"127.0.0.1:{spawn(*serve_args(ckpt, prompt=P_LEN, new=MAX_NEW))[1]}"
             for _ in range(2)]

    def no_local_engine(*a, **kw):
        raise AssertionError("from_pretrained built a local engine")

    monkeypatch.setattr(trainer, "make_engine", no_local_engine)
    cfg = _port_config(rollout_workers=tuple(addrs), dtype="float32", model=str(ckpt))
    train, test = make_datasets()
    tr = trainer.Trainer.from_pretrained(train, test, position_reward, cfg, device="cpu")
    assert isinstance(tr.engine, RemoteEngine) and tr._ring is None
    assert tr.engine.driver.addresses == [("127.0.0.1", int(a.split(":")[1])) for a in addrs]
    assert tr.engine.weight_bus_mode == "broadcast" and tr.engine.bus.flush(60)
    assert tr.engine.driver.retry.max_call_retries == cfg.rpc_retries
    tr.engine.driver.shutdown()


def test_a_degraded_round_drops_its_lost_groups():
    cfg = _port_config()
    train, test = make_datasets()
    tok = CharTokenizer()
    eng = FakeEngine(tok, lambda p, j: "<answer>x</answer>", max_new_tokens=cfg.max_new_tokens)
    model = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), TINY)), CFG, device="cpu")
    tr = trainer.Trainer(train, test, position_reward, cfg, tokenizer=tok, engine=eng, model=model)
    eng.last_lost_rows = [1, 3]
    batch = {"problem": ["q a", "q b", "q c", "q d"], "solution": ["A", "B", "C", "D"]}
    [cand] = tr._generate_round(batch, cfg.train_sampling())
    assert [p[0] for p in cand["problem"]] == ["q a", "q c"]
    assert [s[0] for s in cand["solution"]] == ["A", "C"]
    assert len(cand["answers"]) == len(cand["token_lengths"]) == 2
    eng.last_lost_rows = [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="every group"):
        tr._generate_round(batch, cfg.train_sampling())


def test_inflight_updates_refuse_a_dispatch_mode_remote_engine(base_tree):
    class _Driver:
        num_healthy, rejoin_epoch = 1, 0

    eng = RemoteEngine(_Driver(), max_prompt_tokens=P_LEN, max_new_tokens=MAX_NEW,
                       weight_bus="dispatch")
    cfg = _port_config(rollout_mode="async", clip_ratio=0.2, inflight_weight_updates=True)
    model = params_from_numpy(base_tree, CFG, device="cpu")
    train, test = make_datasets()
    with pytest.raises(ValueError, match="weight_bus='broadcast'"):
        trainer.Trainer(train, test, position_reward, cfg, tokenizer=CharTokenizer(),
                        engine=eng, model=model)


def test_cli_reaches_the_remote_fields():
    from train_distributed import build_parser as jbuild_parser, config_from_args as jconfig

    argv = ["--rollout_workers", "a:1, b:2", "--weight_bus", "dispatch", "--worker_rejoin",
            "off", "--rpc_retries", "4", "--rpc_backoff_s", "0.5", "--poison_shard_k", "2",
            "--degrade_on_poison", "--workers_capture_logprobs", "--clip_ratio", "0.2"]
    cfg, jcfg = config_from_args(build_parser().parse_args(argv)), jconfig(
        jbuild_parser().parse_args(argv))
    fields = ("rollout_workers", "weight_bus", "worker_rejoin", "rpc_retries", "rpc_backoff_s",
              "poison_shard_k", "degrade_on_poison", "workers_capture_logprobs")
    assert [getattr(cfg, f) for f in fields] == [getattr(jcfg, f) for f in fields] == [
        ("a:1", "b:2"), "dispatch", False, 4, 0.5, 2, True, True]


def test_chip_smoke_remote_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's phase 16 at TINY's width on the CPU: every regime over
    its own pair of worker processes, checked as on the card (launch counts
    and the in-flight swap apart)."""
    import chip_smoke

    telemetry.reset()
    out = chip_smoke.remote_rehearsal(tmp_path)
    assert list(out["runs"]) == [r[0] for r in chip_smoke.REMOTE_REGIMES]
    for label, run in out["runs"].items():
        assert len(run["workers"]) == chip_smoke.REMOTE_WORKERS
        assert [x["version"] for x in run["broadcasts"]] == [0, 1, 2]
        assert run["config"].rollout_workers and run["config"].engine_impl == "dense"
        assert len(run["step_ms"]) == 2
    assert out["runs"]["sync"]["eval"]["positions"] > 0
    lines = chip_smoke.remote_lines(out, "cpu")
    assert any(line.startswith("remote GIL:") for line in lines)
