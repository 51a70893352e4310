"""``Trainer.train()`` with a multi-turn environment (``env`` "verifier" and
"code") against the live JAX trainer, on the CPU at TINY in f32.

Both trainers run the paged refill engine with continuous admission (4
slots, 8-token pages) over the same base and initial adapter, greedy, with
one EOS set of every 16th id, so that random weights end turns (a single
EOS id is almost never sampled: every candidate would run to its window and
the round fall back to one turn). Each turn's observation and the turns
after it share the window of ``max_new_tokens``. GRPO with the clip
objective (0.2), so the learner trains on the engine's tokens under the
environment's loss mask.

Random weights never format an answer, so every environment reward would be
0, every advantage 0 and every update a no-op. The environments are the
packages' own with one addition, the same on both sides (``_scored``): each
turn's reward also gets the candidate's position in its group over n, so
identical greedy candidates still score apart (as
``tests/test_torch_trainer.py``'s ``position_reward``).

Held exactly: every round's tokens and lengths, its loss masks, (n, 2)
rewards and turns' provenance, each update batch's coefficients, ids and
masks, and every metric of every record but the losses, times and rates
(the ``env/*`` series included, ``env/step_ms*`` aside). Held within
tolerances: captured logprobs within ``LOGP_ATOL``; losses within the
learner's ``STEP_ATOL`` (``tests/test_torch_learner.py`` states it) and
non-zero. Synchronous, and pipelined under the schedule
``tests/test_torch_rollout_modes.py``'s ``FixedSchedule`` fixes on both
sides (the port pushing the JAX trainer's adapter of each version).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import env as jenv
from distrl_llm_tpu import telemetry as jtelemetry
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.models import TINY
from distrl_llm_tpu_torch import env as tenv
from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.engine import PagedGenerationEngine
from tests.test_torch_learner import STEP_ATOL
from tests.test_torch_refill_preemption import _SnapshotJnp
from tests.test_torch_rollout_modes import FixedSchedule
from tests import test_torch_trainer as ttrainer_tests
from tests.test_torch_trainer import (  # noqa: F401  (base_tree: the fixture)
    CFG, _record_learner_batches, _trainers, base_tree, lora_to_numpy, position_reward,
)

LOGP_ATOL = 1e-5
# eval rounds take the train rounds' shape (2 prompts x 4), so the JAX
# engine compiles its programs once
N = EVAL_N = 4
T = 160  # the shared window: a ~125-token critique and short turns around it
EOS = list(range(5, TINY.vocab_size, 8))  # turns of ~8 tokens
ROUNDS = 2  # 4 problems, batch 2
PROBLEMS = [f"q {c}" for c in "abcd"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    # 4 train problems (2 rounds) and 2 eval problems (1 round): the JAX
    # trainer's host loop over a 160-token window sets this file's time
    train = {"problem": PROBLEMS, "solution": [p[-1].upper() for p in PROBLEMS]}
    monkeypatch.setattr(ttrainer_tests, "make_datasets", lambda: (
        train, {k: v[:2] for k, v in train.items()}))
    for mod in (jenv, tenv):
        registry = mod.registry.ENV_REGISTRY
        for name in ("code", "verifier"):
            monkeypatch.setitem(registry, name, _scored(registry[name]))
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
    for eng in _JENGINE:  # the shared engine sheds the case's wrappers
        for name in ("generate", "push_lora", "_take_pending_lora"):
            vars(eng).pop(name, None)


def _scored(cls):
    """``cls`` whose turn rewards also carry the candidate's position in its
    group over n: the driver builds one environment per candidate row in
    row order, so the k-th instance of a round serves row k."""
    counter = itertools.count()

    class Scored(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._pos = next(counter) % N

        def step(self, completion):
            step = super().step(completion)
            step.reward += self._pos / N
            return step

    Scored.name = cls.name
    return Scored


_JENGINE: list = []  # one JAX engine for every case: its compiles are most of the time


def _engines():
    common = dict(max_prompt_tokens=16, max_new_tokens=T, eos_token_ids=EOS, pad_token_id=0,
                  lora_scale=8 / 4, capture_logprobs=True, page_size=8, scheduler="refill",
                  max_concurrent_rows=4, continuous_admission=True)
    if not _JENGINE:
        _JENGINE.append(jpe.PagedGenerationEngine(
            TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0,
            paged_impl="reference", **common))
    return (_JENGINE[0],
            PagedGenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **common))


def _record(tr, engine):
    """Each round's result and the environment's columns of its candidates."""
    rounds, gen = [], tr._generate_round
    results, generate = [], engine.generate

    def wrapped(batch, sampling):
        out = gen(batch, sampling)
        c = out[0]
        rounds.append({"n": sampling.n, "loss_mask": [np.asarray(m) for m in c["loss_mask"]],
                       "rewards": [np.asarray(r) for r in c["rewards"]], "turns": c["turns"],
                       "env_name": c["env_name"]})
        return out

    def recorded(*a):
        res = generate(*a)
        results.append(res)
        return res

    tr._generate_round, engine.generate = wrapped, recorded
    return rounds, results


def _forced_pushes(tr, adapters):
    """Sync: the port's trainer pushes the JAX trainer's adapter of each
    version (``FixedSchedule``'s ``forced`` without its wait, which only an
    overlapped round can end): two adapters a fraction of lr apart flip
    near-tied greedy tokens, so the rounds are held over the same weights."""
    push, own = tr._push_weights, []

    def forced():
        u = len(own)
        if u < len(adapters):
            own.append(lora_to_numpy(tr.lora))
            with torch.no_grad():
                for t, ab in tr.lora["layers"].items():
                    for k, x in ab.items():
                        x.copy_(torch.tensor(adapters[u]["layers"][t][k]))
        push()

    tr._push_weights = forced
    return own


def _run_pair(base_tree, env: str, mode: str):
    jeng, teng = _engines()
    jtr, tr = _trainers(
        base_tree, jengine=jeng, engine=teng, reward_fns=(position_reward, position_reward),
        learner="grpo", topk=2, num_candidates=N, batch_size=2, max_new_tokens=T,
        temperature=0.0, eval_temperature=0.0, eval_n=EVAL_N, clip_ratio=0.2,
        rollout_mode=mode, env=env, max_turns=3, engine_impl="paged",
        continuous_batching=True, continuous_admission=True, max_concurrent_sequences=4)
    if mode != "sync":
        tr._push_weights()  # the ring now holds the JAX trainer's initial adapter
    records = [_record(jtr, jeng), _record(tr, teng)]
    batches = [_record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)]
    if mode != "sync":
        FixedSchedule(jtr, jeng, rounds=ROUNDS)
    jtr.train()
    if mode != "sync":
        FixedSchedule(tr, teng, rounds=ROUNDS, forced=jtr.sink.adapters)
    else:
        _forced_pushes(tr, jtr.sink.adapters)
    tr.train()
    return jtr, tr, records, batches


@pytest.mark.parametrize("env,mode", [("verifier", "sync"), ("code", "sync"),
                                      ("verifier", "pipelined")])
def test_env_trainer_matches_jax(base_tree, env, mode):
    jtr, tr, ((jrounds, jres), (trounds, tres)), (jb, tb) = _run_pair(base_tree, env, mode)
    # the initial eval (one round of 2 prompts) and the train rounds
    assert len(trounds) == len(jrounds) == 1 + ROUNDS
    assert len(tres) == len(jres) == len(trounds)
    multi = 0
    for r, (got, want, g, w) in enumerate(zip(trounds, jrounds, tres, jres)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"round {r}")
        np.testing.assert_array_equal(g.lengths, w.lengths, err_msg=f"round {r}")
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LOGP_ATOL, rtol=0)
        assert got["n"] == want["n"] and got["env_name"] == want["env_name"] == env
        for k in ("loss_mask", "rewards"):
            assert len(got[k]) == len(want[k])
            for x, y in zip(got[k], want[k]):
                np.testing.assert_array_equal(x, y, err_msg=f"round {r} {k}")
        assert got["turns"] == want["turns"], r
        # the loss mask is 0 exactly on the injected observations
        for grp_mask, grp_turns in zip(got["loss_mask"], got["turns"]):
            for row_mask, turns in zip(grp_mask, grp_turns):
                want_mask = np.zeros_like(row_mask)
                for t in turns:
                    want_mask[t["policy_span"][0]:t["policy_span"][1]] = 1
                np.testing.assert_array_equal(row_mask, want_mask)
                multi += len(turns) > 1
    assert multi > 0, "no episode took a second turn"
    assert len(tb) == len(jb) == ROUNDS
    for got, want in zip(tb, jb):
        for k in ("coeffs", "sample_mask", "prompt_ids", "prompt_mask", "answer_ids",
                  "answer_mask", "loss_mask"):
            if want.get(k) is None:
                assert got.get(k) is None, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["behavior_logps"], want["behavior_logps"],
                                   atol=LOGP_ATOL, rtol=0)
    assert any((b["loss_mask"] != b["answer_mask"]).any() for b in tb), \
        "no update batch masked an observation"
    recs, jrecs = tr.sink.records, jtr.sink.records
    assert [s for s, _ in recs] == [s for s, _ in jrecs]
    skip = ("timing/", "engine/prefill_tok_s", "engine/decode_tok_s", "env/step_ms")
    if mode != "sync":
        # the registry's series: a record snapshots them while the next
        # round runs on the rollout thread, so each holds what that round
        # had finished by then (the rounds' own columns are held above)
        skip += ("env/turns", "env/episodes", "env/tool_calls", "env/resume_declined",
                 "engine/turn_")
    for (_, m), (_, jm) in zip(recs, jrecs):
        for k, v in m.items():
            if k.startswith(skip):
                continue
            assert k in jm, k
            if k == "loss":
                np.testing.assert_allclose(v, jm[k], atol=STEP_ATOL, rtol=0)
            else:
                assert v == jm[k], k
        assert {k for k in jm if k.startswith("env/") and not k.startswith(skip)} <= set(m)
    train = [m for _, m in recs if "loss" in m]
    assert all(m["loss"] != 0 for m in train)
    assert sum(m.get("engine/turn_resumes", 0) for _, m in recs) > 0
    assert tr.weight_version == jtr.weight_version == ROUNDS
