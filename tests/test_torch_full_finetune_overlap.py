"""Full fine-tuning under the overlapped rollout modes (``rollout_mode``
"pipelined" and "async"): the port against the live JAX trainer on the CPU
at TINY in f32, and the port's ring of rollout copies
(``rollout/adapter_ring.py`` over ``Decoder``s).

* **Against JAX.** Both trainers on the real dense engines (f32, greedy,
  behavior logprobs captured for the clip objective), GRPO with topk 2 of 4
  (``tests/test_torch_trainer.py``'s position reward: a group's identical
  greedy candidates still score apart), lr 1e-2, under the schedule
  ``tests/test_torch_rollout_modes.py``'s ``FixedSchedule`` fixes on both
  sides (the push after update u waits until round u+1 entered
  ``generate``, so round u+1 opens with version u-1's weights whatever the
  threads' speeds). The port pushes the JAX trainer's trained tree of each
  version (its own kept aside), so the rounds are held token for token over
  the same weights and each update from the same starting tree. Held
  exactly: every train round's tokens, lengths and opening version. Held
  within ``tests/test_torch_full_finetune.py``'s tolerances (its docstring
  states them): each step's loss within ``REL``, each update's trained
  tree leaf by leaf (``_close``).
* **The ring.** A round in flight reads exactly the copy it acquired: a
  push during the round casts the masters into the other copy, which the
  next round acquires; the held copy's weights and ``weights_version`` do
  not move; a push waits while every copy but the published one is held;
  each copy is its own graph key (``tensors_key``).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.engine.fake import FakeEngine as JFakeEngine
from distrl_llm_tpu.models import TINY
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from distrl_llm_tpu_torch.engine.decode_graph import tensors_key
from distrl_llm_tpu_torch.engine.engine import GenerationEngine
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from tests.test_torch_full_finetune import CFG, REL, _base, _close, _np_tree, _trainers
from tests.test_torch_rollout_modes import FixedSchedule
from tests.test_torch_trainer import position_reward
from tests.test_trainer import script

LR = 1e-2
ROUNDS = 2  # 8 problems, batch 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines():
    kw = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
              capture_logprobs=True)
    return (JEngine(TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0, **kw),
            GenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **kw))


def _leaves(tree: dict) -> dict:
    out = {f"layers.{k}": v for k, v in tree["layers"].items()}
    out.update({k: tree[k] for k in ("embed", "final_norm", "lm_head") if tree.get(k) is not None})
    return out


def _versions(tr):
    """The opening version of each train round (the trainer's candidates
    carry it when the engine captures behavior logprobs)."""
    out, gen = [], tr._generate_round

    def wrapped(batch, sampling):
        res = gen(batch, sampling)
        if sampling.n == tr.config.num_candidates:
            out.append(res[0]["base_version"])
        return res

    tr._generate_round = wrapped
    return out


def _forced(tr, trees):
    """The port pushes the JAX trainer's tree after update u (kept in
    ``trees``) in place of its own, whose values it keeps in ``own``."""
    push, own = tr._push_weights, []

    def forced():
        u = len(own)
        own.append(params_to_numpy(tr.lora))
        with torch.no_grad():
            for p, q in zip(tr.lora.parameters(),
                            params_from_numpy(trees[u], CFG, device="cpu").parameters(),
                            strict=True):
                p.copy_(q)
        push()

    tr._push_weights = forced
    return own


@pytest.mark.parametrize("mode", ["pipelined", "async"])
def test_full_finetune_overlapped_matches_jax(mode):
    tree = _base(TINY)
    jeng, teng = _engines()
    jtr, tr = _trainers(tree, jengine=jeng, engine=teng,
                        reward_fns=(position_reward, position_reward), lr=LR, topk=2,
                        learner="grpo", clip_ratio=0.2, max_new_tokens=12, temperature=0.0,
                        eval_temperature=0.0, rollout_mode=mode, max_staleness=2)
    assert tr._ring is not None and tr._ring.size == 2
    trees, log = [], jtr.sink.log

    def jlog(m, step):
        log(m, step)
        if "loss" in m:
            trees.append(_np_tree(jtr.lora))

    jtr.sink.log = jlog
    jversions, versions = _versions(jtr), _versions(tr)
    jsched = FixedSchedule(jtr, jeng, rounds=ROUNDS)
    jtr.train()
    tsched = FixedSchedule(tr, teng, rounds=ROUNDS)
    own = _forced(tr, trees)
    tr.train()
    assert versions == jversions == [0] * ROUNDS  # round 1 opens one version stale
    for r in range(ROUNDS):
        jres, tres = jsched.results[r], tsched.results[r]
        np.testing.assert_array_equal(tres.tokens, jres.tokens, err_msg=f"round {r}")
        np.testing.assert_array_equal(tres.lengths, jres.lengths)
    recs = [m for _, m in tr.sink.records if "loss" in m]
    jrecs = [m for _, m in jtr.sink.records if "loss" in m]
    assert len(recs) == len(jrecs) == len(own) == len(trees) == ROUNDS
    for m, jm in zip(recs, jrecs):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=REL, atol=REL)
        assert m["loss"] != 0 and m["rollout_mode"] == jm["rollout_mode"] == mode
    for u, (got, want) in enumerate(zip(own, trees)):
        got, want = _leaves(got), _leaves(want)
        assert sorted(got) == sorted(want)
        for key in got:
            _close(got[key], want[key], f"update {u} {key}", LR)
    assert tr.weight_version == jtr.weight_version == ROUNDS
    assert tr._ring.holds() == [0, 0]
    # the published copy holds the last pushed tree (JAX's, forced) cast to
    # the rollout dtype
    rollout = tr._engine_params()[0]
    for p, q in zip(rollout.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, q.detach().to(p.dtype))


def _ring_trainer(dtype=torch.bfloat16):
    tree = _base(TINY)
    return _trainers(tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                     engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24),
                     dtype=dtype, rollout_mode="pipelined")[1]


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def test_a_round_in_flight_reads_the_copy_it_acquired():
    """Full mode's ring: the base and a second bf16 ``Decoder``. A round
    holds the published copy from its entry; a push during it casts the
    masters into the other copy and publishes that; the held copy's
    weights and version stay; the next round reads the new copy; each copy
    is its own graph key."""
    tr = _ring_trainer()
    ring = tr._ring
    a = tr._engine_params()[0]
    assert ring.size == 2 and a is ring._bufs[0] and ring._bufs[1] is not a
    assert all(p.dtype == torch.bfloat16 for p in ring._bufs[1].parameters())
    held, version, hold = ring.acquire()
    assert held is a and version == 0 and ring.holds() == [1, 0]
    before, v_a = _snapshot(a), a.weights_version
    with torch.no_grad():
        for p in tr.lora.parameters():
            p.add_(0.25)
    tr.weight_version += 1
    tr._push_weights()
    b = tr._engine_params()[0]
    assert b is ring._bufs[1] and b is not a
    # the round in flight still reads its copy, untouched
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), before))
    assert a.weights_version == v_a
    for p, m in zip(b.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, m.detach().to(torch.bfloat16))
    assert tensors_key(a) != tensors_key(b)
    # a second push while the round still holds A: the only copy a push may
    # write (not the published B) is held, so the push waits for the release
    with torch.no_grad():
        for p in tr.lora.parameters():
            p.add_(0.25)
    tr.weight_version += 1
    done = threading.Event()
    pusher = threading.Thread(target=lambda: (tr._push_weights(), done.set()))
    pusher.start()
    assert not done.wait(0.3), "a push wrote the copy a round in flight holds"
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), before))
    ring.release_round(hold)
    pusher.join(10)
    assert done.is_set() and ring.push_waits == 1
    assert tr._engine_params()[0] is a and a.weights_version == v_a + 1
    for p, m in zip(a.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, m.detach().to(torch.bfloat16))
    assert ring.holds() == [0, 0]


def test_the_trainer_round_samples_the_acquired_copy():
    """Through ``_generate_round``: the engine gets the copy the round
    acquired, and a push landing inside the round (as the learner's does
    under the overlapped modes) leaves that copy as it was."""
    tr = _ring_trainer(torch.float32)
    seen, gen = [], tr.engine.generate

    def generate(model, lora, *a):
        before = _snapshot(model)
        with torch.no_grad():
            for p in tr.lora.parameters():
                p.add_(0.5)
        tr.weight_version += 1
        tr._push_weights()
        seen.append((model, lora, all(torch.equal(x, y)
                                      for x, y in zip(model.parameters(), before))))
        return gen(model, lora, *a)

    tr.engine.generate = generate
    batch = {"problem": ["q a", "q b"], "solution": ["A", "B"]}
    first = tr._engine_params()[0]
    tr._generate_round(batch, tr.config.train_sampling())
    second = tr._engine_params()[0]
    tr._generate_round(batch, tr.config.train_sampling())
    (m1, l1, same1), (m2, l2, same2) = seen
    assert m1 is first and m2 is second and m1 is not m2
    assert l1 is None and l2 is None and same1 and same2
    assert tr._ring.holds() == [0, 0]


def test_chip_smoke_env_phase_rehearses_on_cpu(tmp_path):
    """``chip_smoke.py``'s phase 15 at small shapes on the CPU, each part
    checked as on the card (launch counts and captures apart: nothing is
    graphed or launched here): (a) the verifier environment through
    ``Trainer.train()`` graphed and eager (TINY's width, a 1024-token BPE,
    a 192-token window), more than one turn an episode and the eager step
    equal to the graphed one; (b) the resume against a dense decode of the
    whole conversation; (c) full fine-tuning pipelined and async on a
    2-layer Gemma-shaped config, the ring's books, round 0 equal to sync's."""
    import chip_smoke

    out = chip_smoke.env_rehearsal(tmp_path)
    for kind in ("graphed", "eager"):
        env = out["a"][kind]["env"]
        assert env["train"]["turns_mean"] > 1 and env["train"]["resumes"] > 0
        assert env["eval"]["turns_mean"] > 1 and env["eval"]["resumes"] > 0
    assert out["b"]["continuation"] > 0 and out["b"]["logit_err"] <= chip_smoke.LOGIT_F32_ATOL
    c = out["c"]
    assert [t["base"] for t in c["pipelined"]["tagged"]] == [0, 0, 1]
    for mode in ("pipelined", "async"):
        books = c[mode]["books"]
        assert [b[1] for b in books] == [0, 1, 2, 3]
        assert all(holds[j] == 0 for j, _, holds, _ in books)
