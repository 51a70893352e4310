"""The port's overlapped rollout modes against the live JAX trainer, on the
CPU at TINY in f32 (``rollout_mode`` "pipelined" and "async",
``inflight_weight_updates``).

* **Config.** Every value of the rollout fields the JAX ``TrainConfig``
  accepts, the port's accepts with the same derived values (the alias,
  ``allowed_weight_lag``), and what it rejects the port rejects; the
  configurations once refused under ROADMAP item 8b (full fine-tuning
  overlapped, a multi-turn environment) both take. The CLI's flags reach
  the fields.
* **A schedule fixed by the test** (``FixedSchedule``, installed on both
  packages' trainer and engine alike; neither package holds such a gate):
  the push after update u waits until round u+1 has entered ``generate``
  (so that round opens with update u-1's adapter whatever the threads'
  speeds), and in async each round r >= 1 consumes its in-flight swap at
  dispatch step ``SWAP_STEP``, once update r-1's push has landed. Greedy
  rounds (the packages' samplers draw differently; a position-scripted
  reward as in ``tests/test_torch_trainer.py``), 4 rounds of 2 prompts x 4
  candidates, topk keeping 2 of 4 so that the coefficients of a group's
  identical greedy candidates do not cancel (with all 4 kept the loss is 0
  and an update is only Adam's magnified noise), the dense engine and the
  refill scheduler. Held exactly:
  every round's tokens, lengths and version tags, its opening version and
  swap log, each update batch's coefficients, masks, ids and version lag.
  Held within tolerances: captured logprobs within ``LOGP_ATOL``; losses
  within ``STEP_ATOL`` and non-zero; each update's adapter within
  ``ADAPTER_STEP_ATOL`` of the JAX trainer's, and on at most ``FLIP_SHARE``
  of its elements by more than 1e-3·lr (measured over the four runs: at
  most 0.049·lr, and 0.025% of the elements; a missing update, or one
  applied to other tensors than the trainer's adapter, moves most elements
  by about lr). The port's trainer pushes the JAX trainer's adapter
  of each version (its own kept aside for the comparison): two adapters
  apart by a fraction of lr flip near-tied greedy tokens (seen: round 2 of
  the dense pipelined run, 64 of 96 tokens, when each package pushed its
  own), so the rounds are held token for token over the same weights and
  each update from the same starting adapter. The tolerances are the
  learner's of ``tests/test_torch_learner.py`` and
  ``test_trainer_with_real_dense_engines_matches_jax``: Adam's ``g / (|g| +
  eps)`` magnifies the two frameworks' summation-order noise (here also the
  engines' captured logprobs, within ``LOGP_ATOL``) on elements whose grad
  is near eps, up to about one lr a step.
* **Free-running threads** (the port alone): the invariants of JAX's
  ``TestAsyncMode``: finite losses, the buffer's books balanced, the
  registry's series in the records, every swap version a real learner
  version; pipelined rounds one step stale at most.
* The async checkpoint sidecar: resume restores the buffer and cursor, a
  corrupt sidecar starts fresh. Segment-wise teacher forcing across two
  in-flight swaps (``tests/test_inflight_updates.py``) on the port's
  engine. ``chip_smoke.py``'s phase 13 rehearsed at TINY.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu import telemetry as jtelemetry
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.models import TINY
from distrl_llm_tpu_torch import config, telemetry, trainer
from distrl_llm_tpu_torch.checkpoint import rollout_state_path, save_rollout_state
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
from distrl_llm_tpu_torch.learner.losses import answer_logprobs
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, lora_to_numpy, params_from_numpy
from distrl_llm_tpu_torch.rollout import Trajectory, TrajectoryBuffer, version_tags_for_round
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from distrl_llm_tpu_torch.train_distributed import build_parser, config_from_args
from tests.test_torch_engine import _lora, _params
from tests.test_torch_learner import FLIP_SHARE, LR, STEP_ATOL
from tests.test_torch_trainer import (  # noqa: F401  (base_tree: the fixture)
    CFG, _adapter_diffs, _port_config as _port, _record_learner_batches, _trainers, base_tree,
    position_reward,
)
from tests.test_trainer import make_config, make_datasets

LOGP_ATOL = 1e-5
ADAPTER_STEP_ATOL = 2 * LR  # an update from the same adapter: the learner's step-1 tolerance
SWAP_STEP = 4  # async: each round r >= 1 swaps to v_r at this dispatch step
ROUNDS = 4  # 8 problems, batch 2, one episode
TRAIN_N, EVAL_N = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY's tensors are too small for torch's intra-op threads to pay."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()


# ------------------------------------------------------------------ config

VALID = [
    dict(rollout_mode="pipelined"),
    dict(async_rollout=True),
    dict(async_rollout=True, rollout_mode="async", clip_ratio=0.2),
    dict(rollout_mode="async", clip_ratio=0.2, max_staleness=5, rollout_buffer_groups=3,
         staleness_policy="downweight", staleness_downweight=0.25, rollout_is_cap=3.0),
    dict(rollout_mode="async", clip_ratio=0.1, max_staleness=1, inflight_weight_updates=True,
         producer_restarts=0, rpc_backoff_s=0.0),
    dict(rollout_mode="pipelined", clip_ratio=0.2, inflight_weight_updates=True),
    dict(max_staleness=0, staleness_downweight=1.0, rollout_is_cap=1.0),
]

INVALID = [
    dict(rollout_mode="async"),
    dict(rollout_mode="async", clip_ratio=0.2, max_staleness=0),
    dict(max_staleness=-1),
    dict(staleness_policy="discard"),
    dict(rollout_buffer_groups=-1),
    dict(inflight_weight_updates=True, clip_ratio=0.2),
    dict(rollout_mode="pipelined", inflight_weight_updates=True),
    dict(rollout_mode="pipelined", inflight_weight_updates=True, clip_ratio=0.2,
         full_finetune=True, model="tiny"),
    dict(rpc_backoff_s=-0.1),
    dict(producer_restarts=-1),
]

FIELDS = ("rollout_mode", "async_rollout", "max_staleness", "rollout_buffer_groups",
          "staleness_policy", "staleness_downweight", "rollout_is_cap",
          "inflight_weight_updates", "producer_restarts", "rpc_backoff_s")


@pytest.mark.parametrize("kw", VALID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_rollout_fields_match_jax(kw):
    j, p = jconfig.TrainConfig(**kw), config.TrainConfig(**kw)
    for f in FIELDS + ("allowed_weight_lag",):
        assert getattr(p, f) == getattr(j, f), f
    assert trainer.engine_kwargs_from_config(p) == __import__(
        "distrl_llm_tpu.trainer", fromlist=["x"]).engine_kwargs_from_config(j)


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_rollout_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jconfig.TrainConfig(**kw)
    with pytest.raises(ValueError) as err:
        config.TrainConfig(**kw)
    # the same rule: the messages share their first words
    assert str(err.value).split()[:2] == str(jerr.value).split()[:2]


@pytest.mark.parametrize("kw", [dict(rollout_mode="pipelined", full_finetune=True, model="tiny"),
                                dict(rollout_mode="async", clip_ratio=0.2, full_finetune=True,
                                     model="tiny"),
                                dict(async_rollout=True, full_finetune=True, model="tiny"),
                                dict(env="verifier", engine_impl="paged",
                                     continuous_batching=True, continuous_admission=True,
                                     max_concurrent_sequences=8)])
def test_the_refusals_name_item_8b(kw):
    """The configurations the port once refused naming ROADMAP item 8b (full
    fine-tuning under the overlapped modes, a multi-turn environment): both
    packages take them now, with the same rollout fields and engine
    knobs."""
    j, p = jconfig.TrainConfig(**kw), config.TrainConfig(**kw)
    for f in FIELDS + ("allowed_weight_lag", "full_finetune", "env", "max_turns"):
        assert getattr(p, f) == getattr(j, f), f
    assert trainer.engine_kwargs_from_config(p) == __import__(
        "distrl_llm_tpu.trainer", fromlist=["x"]).engine_kwargs_from_config(j)


def test_alias_and_allowed_lag():
    cfg = config.TrainConfig(model="t", async_rollout=True)
    assert (cfg.rollout_mode, cfg.async_rollout, cfg.allowed_weight_lag) == ("pipelined", True, 1)
    assert not config.TrainConfig().async_rollout
    assert config.TrainConfig(rollout_mode="async", clip_ratio=0.2,
                              max_staleness=5).allowed_weight_lag == 5


def test_cli_reaches_the_rollout_fields():
    args = build_parser().parse_args([
        "--rollout_mode", "async", "--clip_ratio", "0.2", "--max_staleness", "3",
        "--staleness_policy", "downweight", "--staleness_downweight", "0.25",
        "--rollout_is_cap", "1.5", "--rollout_buffer_groups", "6",
        "--inflight_weight_updates", "--producer_restarts", "1", "--rpc_backoff_s", "0.5"])
    cfg = config_from_args(args)
    assert (cfg.rollout_mode, cfg.max_staleness, cfg.staleness_policy, cfg.staleness_downweight,
            cfg.rollout_is_cap, cfg.rollout_buffer_groups, cfg.inflight_weight_updates,
            cfg.producer_restarts, cfg.rpc_backoff_s) == (
        "async", 3, "downweight", 0.25, 1.5, 6, True, 1, 0.5)
    assert config_from_args(build_parser().parse_args(["--async_rollout"])).rollout_mode == \
        "pipelined"


def test_stale_detector_names_mode_and_bound(base_tree):
    from distrl_llm_tpu_torch.engine.fake import FakeEngine
    from tests.test_trainer import script

    tr = trainer.Trainer(*make_datasets(), position_reward, _port(), tokenizer=CharTokenizer(),
                         engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24),
                         model=params_from_numpy(base_tree, CFG, device="cpu"))
    tr.weight_version, tr._rollout_weight_version = 5, 4
    batch = {"problem": ["q a"], "solution": ["A"]}
    with pytest.raises(trainer.StaleWeightsError, match="rollout_mode='sync'.*lag <= 0"):
        tr._generate_round(batch, tr.config.train_sampling())
    with pytest.raises(ValueError, match="real push_lora"):
        trainer.Trainer(*make_datasets(), position_reward,
                        _port(rollout_mode="pipelined", clip_ratio=0.2,
                              inflight_weight_updates=True),
                        tokenizer=CharTokenizer(), engine=FakeEngine(CharTokenizer(), script),
                        model=params_from_numpy(base_tree, CFG, device="cpu"))


# --------------------------------------------------------- fixed schedule

class FixedSchedule:
    """Fixes the order of the rollout and learner threads' events from the
    test, on either package's trainer and engine alike:

    * the push after update u proceeds only once train round u+1 (when the
      run has one) has entered ``engine.generate``;
    * with ``swap_step`` S, train round r >= 1 consumes a pending swap only
      at its dispatch step S, once ``push_lora`` has been called r times.

    Train rounds are told from eval rounds by their candidate count. It
    records each train round's engine result. With ``forced`` (the JAX
    trainer's adapter after each update, as numpy), the port's trainer
    pushes that adapter instead of its own, whose values it keeps in
    ``own``: both packages then sample with the same weights, so their
    greedy rounds can be held token for token (two adapters a few ulps of
    lr apart flip near-tied greedy tokens), and each update is held from
    the same starting adapter."""

    def __init__(self, tr, engine, *, rounds: int, swap_step: int | None = None,
                 forced: list | None = None, timeout: float = 120.0):
        self.cv = threading.Condition()
        self.entered = self.updates = self.inflight = 0
        self.round_of: dict[int, int | None] = {}
        self.results: dict[int, object] = {}
        self.own: list = []
        self.timeout = timeout
        generate, push = engine.generate, tr._push_weights

        def gen(*a):
            ident = threading.get_ident()
            r = None
            if a[4].n == TRAIN_N:
                with self.cv:
                    r, self.entered = self.entered, self.entered + 1
                    self.cv.notify_all()
            self.round_of[ident] = r
            try:
                res = generate(*a)
                if r is not None:
                    self.results[r] = res
                return res
            finally:
                self.round_of.pop(ident, None)

        def push_weights():
            u, self.updates = self.updates, self.updates + 1
            if u + 1 < rounds:
                self._wait(lambda: self.entered >= u + 2)
            if forced is not None:
                self.own.append(lora_to_numpy(tr.lora))
                with torch.no_grad():
                    for t, ab in tr.lora["layers"].items():
                        for k, x in ab.items():
                            x.copy_(torch.tensor(forced[u]["layers"][t][k]))
            push()

        engine.generate, tr._push_weights = gen, push_weights
        if swap_step is None:
            return
        push_lora, take = engine.push_lora, engine._take_pending_lora

        def counted_push(*a, **kw):
            push_lora(*a, **kw)
            with self.cv:
                self.inflight += 1
                self.cv.notify_all()

        def take_at(cell, dispatched):
            r = self.round_of.get(threading.get_ident())
            if r:  # a train round after the first
                if dispatched < swap_step:
                    return
                if dispatched == swap_step:
                    self._wait(lambda: self.inflight >= r)
            take(cell, dispatched)

        engine.push_lora, engine._take_pending_lora = counted_push, take_at

    def _wait(self, pred) -> None:
        with self.cv:
            if not self.cv.wait_for(pred, self.timeout):
                raise RuntimeError("the fixed schedule stalled")


def _engines(kind: str):
    common = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
                  lora_scale=8 / 4, capture_logprobs=True)
    if kind == "dense":
        return (JEngine(TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0, **common),
                GenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **common))
    paged = dict(common, page_size=8, scheduler="refill", max_concurrent_rows=4)
    return (jpe.PagedGenerationEngine(TINY, cache_dtype=jnp.float32, autotune=False,
                                      scan_chunk=0, paged_impl="reference", **paged),
            PagedGenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **paged))


def _record_rounds(tr):
    rounds, gen = [], tr._generate_round

    def wrapped(batch, sampling):
        out = gen(batch, sampling)
        if sampling.n == TRAIN_N:
            c = out[0]
            rounds.append((c["base_version"], list(c["swap_events"]),
                           np.stack([np.asarray(x) for x in c["version_tags"]])))
        return out

    tr._generate_round = wrapped
    return rounds


def _run_pair(base_tree, kind: str, mode: str):
    inflight = mode == "async"
    jeng, teng = _engines(kind)
    cfg_kw = dict(learner="grpo", topk=2, num_candidates=TRAIN_N, batch_size=2,
                  max_new_tokens=12, temperature=0.0, eval_temperature=0.0, eval_n=EVAL_N,
                  clip_ratio=0.2, rollout_mode=mode, max_staleness=2,
                  inflight_weight_updates=inflight)
    jtr, tr = _trainers(base_tree, jengine=jeng, engine=teng,
                        reward_fns=(position_reward, position_reward), **cfg_kw)
    tr._push_weights()  # v0 again: the ring now holds the JAX trainer's initial adapter
    swap = SWAP_STEP if inflight else None
    jsched = FixedSchedule(jtr, jeng, rounds=ROUNDS, swap_step=swap)
    rounds = [_record_rounds(t) for t in (jtr, tr)]
    batches = [_record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)]
    jtr.train()
    tsched = FixedSchedule(tr, teng, rounds=ROUNDS, swap_step=swap, forced=jtr.sink.adapters)
    tr.train()
    return jtr, tr, (jsched, tsched), rounds, batches


@pytest.mark.parametrize("kind", ["dense", "refill"])
@pytest.mark.parametrize("mode", ["pipelined", "async"])
def test_overlapped_modes_match_jax_under_a_fixed_schedule(base_tree, kind, mode):
    jtr, tr, (jsched, tsched), (jrounds, trounds), (jb, tb) = _run_pair(base_tree, kind, mode)
    assert len(trounds) == len(jrounds) == ROUNDS
    for r in range(ROUNDS):
        jres, tres = jsched.results[r], tsched.results[r]
        np.testing.assert_array_equal(tres.tokens, jres.tokens, err_msg=f"round {r}")
        np.testing.assert_array_equal(tres.lengths, jres.lengths)
        np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)
        (jbase, jev, jtags), (base, ev, tags) = jrounds[r], trounds[r]
        assert (base, ev) == (jbase, jev), r
        np.testing.assert_array_equal(tags, jtags)
        # the schedule the gates fix: round r opens with update r-1's adapter,
        # and in async swaps to update r's at SWAP_STEP
        assert base == max(r - 1, 0)
        assert ev == ([(SWAP_STEP, r)] if mode == "async" and r else [])
    assert len(tb) == len(jb) == ROUNDS
    for got, want in zip(tb, jb):
        for k in ("coeffs", "sample_mask", "prompt_ids", "prompt_mask", "answer_ids",
                  "answer_mask", "version_lag"):
            if want.get(k) is None:
                assert got.get(k) is None, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["behavior_logps"], want["behavior_logps"],
                                   atol=LOGP_ATOL, rtol=0)
    if mode == "async":  # version lags 1 before the swap, 0 after it
        assert {float(x) for b in tb[1:] for x in np.unique(b["version_lag"])} <= {0.0, 1.0}
        assert any(b["version_lag"].max() == 1.0 for b in tb[1:])
    recs, jrecs = ([m for _, m in t.sink.records if "loss" in m] for t in (tr, jtr))
    np.testing.assert_allclose([m["loss"] for m in recs], [m["loss"] for m in jrecs],
                               atol=STEP_ATOL, rtol=0)
    assert all(m["loss"] != 0 for m in recs)
    for m, jm in zip(recs, jrecs):
        for k in ("rollout_mode", "max_staleness", "rollout_dropped_stale",
                  "mean_accuracy_reward", "total_samples_processed"):
            assert m[k] == jm[k], k
    assert len(tsched.own) == len(jtr.sink.adapters) == ROUNDS
    for k, (got, want) in enumerate(zip(tsched.own, jtr.sink.adapters), start=1):
        diffs = _adapter_diffs(got, want)
        assert diffs.max() <= ADAPTER_STEP_ATOL, (k, diffs.max())
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE, (k, (diffs > 1e-3 * LR).mean())
    assert tr.weight_version == jtr.weight_version == ROUNDS
    if mode == "async":
        swaps = list(zip(tr.engine.last_swap_steps, tr.engine.last_swap_versions))
        assert swaps == [(SWAP_STEP, r) for r in range(1, ROUNDS)]
        stats = tr._rollout_buffer.stats()
        assert stats == jtr._rollout_buffer.stats()
        assert stats["total_put"] == stats["total_got"] == 2 * ROUNDS
    ring = tr._ring
    assert ring is not None and ring.holds() == [0, 0]


# ----------------------------------------------------- free-running threads

def _port_run(base_tree, *, engine=None, sink=None, **kw):
    cfg = _port(**kw)
    eng = engine or GenerationEngine(CFG, max_prompt_tokens=cfg.max_prompt_tokens,
                                     max_new_tokens=cfg.max_new_tokens,
                                     eos_token_ids=[3], pad_token_id=0, lora_scale=2.0,
                                     cache_dtype=torch.float32, device="cpu", decode_chunk=4,
                                     capture_logprobs=cfg.clip_ratio > 0)
    tr = trainer.Trainer(*make_datasets(), position_reward, cfg, tokenizer=CharTokenizer(),
                         engine=eng, model=params_from_numpy(base_tree, CFG, device="cpu"),
                         sink=sink)
    return tr, eng


class _Sink:
    def __init__(self):
        self.records = []

    def log(self, m, step):
        self.records.append((step, dict(m)))

    def finish(self):
        pass


def test_free_running_async_with_inflight_swaps(base_tree):
    """JAX's ``TestAsyncMode`` acceptance run on the port: 4 episodes, the
    buffer at its floor (2 x batch) so rounds interleave with updates."""
    sink = _Sink()
    tr, eng = _port_run(base_tree, sink=sink, episodes=4, num_candidates=2, topk=2,
                        rollout_mode="async", max_staleness=3, clip_ratio=0.2,
                        inflight_weight_updates=True, rollout_buffer_groups=1, lr=1e-2)
    tr.train()
    recs = [m for _, m in sink.records if "loss" in m]
    assert recs and all(np.isfinite(m["loss"]) for m in recs)
    assert all(m["rollout_mode"] == "async" and m["max_staleness"] == 3 for m in recs)
    s = tr._rollout_buffer.stats()
    # 4 episodes x 2 rounds x 4 groups
    assert s["total_put"] == 32 == (s["total_got"] + s["dropped_stale"] + s["dropped_capacity"]
                                    + s["occupancy"])
    assert any(k.startswith("rollout/staleness") for m in recs for k in m)
    assert any("rollout/buffer_occupancy" in m for m in recs)
    assert len(eng.last_swap_versions) == len(eng.last_swap_steps) >= 1
    assert all(v is not None and 0 < v <= tr.weight_version for v in eng.last_swap_versions)
    assert tr._ring.holds() == [0, 0]


def test_free_running_pipelined_lags_at_most_one_step(base_tree):
    tr, eng = _port_run(base_tree, sink=_Sink(), episodes=2, rollout_mode="pipelined",
                        clip_ratio=0.2)
    bases = _record_rounds(tr)
    tr.train()
    assert len(bases) == 4
    for t, (base, events, _) in enumerate(bases):
        assert max(t - 1, 0) <= base <= t and events == []
    assert tr.weight_version == 4 and tr._ring.pushes == 5


@pytest.mark.parametrize("mode", ["pipelined", "async"])
def test_inflight_swaps_under_the_hang_detector_release_every_hold(base_tree, mode):
    """With ``generation_timeout_s`` a warm shape's round decodes on the
    hang detector's own thread, so its in-flight swaps reach the adapter
    ring from another thread than the one that acquired and releases the
    round: every swap lands (the schedule fixes them at ``SWAP_STEP``) and
    every hold is let go."""
    tr, eng = _port_run(base_tree, sink=_Sink(), num_candidates=TRAIN_N, topk=TRAIN_N,
                        eval_n=EVAL_N, batch_size=2, max_new_tokens=12, rollout_mode=mode, max_staleness=2, clip_ratio=0.2,
                        inflight_weight_updates=True, generation_timeout_s=120.0)
    threads = []
    generate = eng.generate

    def on_thread(*a):
        threads.append(threading.get_ident())
        return generate(*a)

    eng.generate = on_thread
    FixedSchedule(tr, eng, rounds=ROUNDS, swap_step=SWAP_STEP)
    tr.train()
    assert threading.get_ident() not in threads[1:]  # warm rounds ran on the watchdog
    swaps = list(zip(eng.last_swap_steps, eng.last_swap_versions))
    assert swaps == [(SWAP_STEP, r) for r in range(1, ROUNDS)]
    assert tr.weight_version == ROUNDS and tr._ring.holds() == [0, 0]


@pytest.mark.parametrize("policy", ["drop", "downweight"])
def test_async_same_stream_when_nothing_drops_and_downweight_never_evicts(base_tree, policy):
    sink = _Sink()
    tr, _ = _port_run(base_tree, sink=sink, episodes=2, num_candidates=2, topk=2,
                      rollout_mode="async", clip_ratio=0.2, staleness_policy=policy,
                      max_staleness=100 if policy == "drop" else 1)
    tr.train()
    recs = [m for _, m in sink.records if "loss" in m]
    assert len(recs) == 4 and all(m["rollout_dropped_stale"] == 0 for m in recs)
    s = tr._rollout_buffer.stats()
    assert s["dropped_stale"] == 0 and tr._staleness_policy.admitted == s["total_got"]


def test_producer_failure_reraises_through_train(base_tree):
    tr, eng = _port_run(base_tree, sink=_Sink(), num_candidates=2, topk=2,
                        rollout_mode="async", clip_ratio=0.2, producer_restarts=1,
                        rpc_backoff_s=0.0)
    calls = {"n": 0}
    gen = eng.generate

    def failing(*a):
        if a[4].n == 2 and calls["n"] >= 0:
            calls["n"] += 1
            raise RuntimeError("engine died")
        return gen(*a)

    eng.generate = failing
    tr.evaluate = lambda: {}
    with pytest.raises(RuntimeError, match="engine died"):
        tr.train()
    assert calls["n"] == 2  # the first try and one restart
    assert tr._rollout_service is None and tr._ring.holds() == [0, 0]


# ------------------------------------------------------------------ sidecar

def test_sidecar_resume_and_a_corrupt_sidecar(base_tree, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(num_candidates=2, topk=2, rollout_mode="async", max_staleness=100,
              clip_ratio=0.2, checkpoint_dir=ckpt)
    tr, _ = _port_run(base_tree, sink=_Sink(), save_every=2, **kw)
    tr.train()
    step = tr.total_batch_steps
    assert step == 2 and (tmp_path / "ckpt" / f"rollout_state_{step}.pkl").exists()
    buf = TrajectoryBuffer(8)
    buf.put(Trajectory(problem="carried", solution="S", answers=["a", "b"],
                       token_lengths=[2, 2], produced_version=step))
    save_rollout_state(ckpt, step, {"buffer": buf.state_dict(), "cursor": (1, 1),
                                    "policy_dropped": 3, "policy_admitted": 5})
    resumed, _ = _port_run(base_tree, sink=_Sink(), resume=True, **kw)
    assert resumed.total_batch_steps == step
    state = resumed._resume_rollout_state
    assert state["cursor"] == (1, 1) and state["policy_dropped"] == 3
    restored = TrajectoryBuffer(8)
    restored.load_state(state["buffer"])
    assert [t.problem for t in restored.get_batch(1)] == ["carried"]
    with open(rollout_state_path(ckpt, step), "wb") as f:
        f.write(b"not a pickle")
    fresh, _ = _port_run(base_tree, sink=_Sink(), resume=True, **kw)
    assert fresh.total_batch_steps == step and fresh._resume_rollout_state is None
    fresh.train()  # a finished run resumes as a no-op, from a fresh buffer
    assert fresh.total_batch_steps == step and fresh._rollout_buffer.stats()["total_put"] == 0


# ------------------------------------------------- segment-wise teacher forcing

def test_per_token_ratios_across_two_inflight_swaps():
    """A trajectory spanning two in-flight swaps (A to B at step 0, B to C at
    step 8) on the port's dense engine: the swap log and the trainer's tags
    agree; positions sampled under A reproduce A's teacher-forced logprobs;
    the B and C segments are finite, proper and no longer A's (or B's):
    they were sampled over KV the older adapters wrote."""
    cfg = CFG
    model = params_from_numpy(_params(), cfg, device="cpu")
    scale = 2.0
    a, b = _lora(seed=1, scale=0.0), _lora(seed=2, scale=0.5)
    c = {"layers": {t: {k: v + 0.25 for k, v in ab.items()} for t, ab in b["layers"].items()}}
    la, lb, lc = (lora_from_numpy(x, cfg, device="cpu") for x in (a, b, c))
    eng = GenerationEngine(cfg, max_prompt_tokens=16, max_new_tokens=24, eos_token_ids=[1],
                           pad_token_id=0, cache_dtype=torch.float32, lora_scale=scale,
                           decode_chunk=4, capture_logprobs=True, device="cpu")
    eng.push_lora(lb, version=1)  # consumed at step 0
    take = eng._take_pending_lora

    def hook(cell, dispatched):
        if dispatched == 8:
            eng.push_lora(lc, version=2)
        take(cell, dispatched)

    eng._take_pending_lora = hook
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    res = eng.generate(model, la, ids, np.ones((4, 16), np.int32),
                       SamplingConfig(max_tokens=24, temperature=1.1, top_p=1.0, n=2), 4)
    assert eng.last_swap_steps == [0, 8] and eng.last_swap_versions == [1, 2]
    bsz, n, t = res.tokens.shape
    tags = version_tags_for_round(bsz * n, t, 0, [(0, 1), (8, 2)])
    assert (tags[:, 0] == 0).all() and (tags[:, 1:9] == 1).all() and (tags[:, 9:] == 2).all()
    aid = torch.as_tensor(res.tokens.reshape(bsz * n, t))
    lengths = res.lengths.reshape(bsz * n)
    amask = torch.as_tensor((np.arange(t)[None, :] < lengths[:, None]).astype(np.int32))
    pid = torch.as_tensor(np.repeat(ids, n, axis=0))
    pmask = torch.ones_like(pid)
    got = res.logprobs.reshape(bsz * n, t)

    def under(lora):
        with torch.no_grad():
            return answer_logprobs(model, pid, pmask, aid, amask, lora=lora, lora_scale=scale,
                                   remat=False).numpy()

    under_a, under_b = under(la), under(lb)
    real = amask.numpy().astype(bool)
    seg_a, seg_b, seg_c = ((tags == v) & real for v in (0, 1, 2))
    assert seg_a.any() and seg_b.any() and seg_c.any()
    np.testing.assert_allclose(got[seg_a], under_a[seg_a], atol=2e-4, rtol=2e-4)
    for seg in (seg_b, seg_c):
        assert np.isfinite(got[seg]).all() and (got[seg] <= 0).all()
        assert np.abs(got[seg] - under_a[seg]).max() > 1e-3
    assert np.abs(got[seg_c] - under_b[seg_c]).max() > 1e-3


# --------------------------------------------------- phase 13 rehearsed

def test_chip_smoke_overlap_phase_rehearses_on_cpu(tmp_path):
    """``chip_smoke.py``'s phase 13 at TINY on the CPU (8 new tokens, 8
    slots): sync and pipelined, graphed and eager, and async with in-flight
    updates, each run checked as on the card (``check_overlap_run``; launch
    counts and captures apart: nothing is graphed or launched here), every
    regime's first train round equal to the sync one's."""
    import chip_smoke

    out = chip_smoke.overlap_rehearsal(tmp_path)
    assert sorted(out) == ["async", "pipelined_eager", "pipelined_graphed", "sync_eager",
                           "sync_graphed"]
    assert [t["base"] for t in out["pipelined_graphed"]["tagged"]] == [0, 0, 1, 2]
    assert any(t["events"] for t in out["async"]["tagged"])
    assert out["pipelined_eager"]["overlap_s"] > 0
    assert chip_smoke.overlap_lines(out, "cpu")
