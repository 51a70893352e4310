"""The port's learner against the JAX package's, on the CPU at TINY size.

One numpy param tree, one numpy adapter tree (non-zero B) and one batch of
text through ``CharTokenizer`` feed both packages in f32. The port runs
``attn_impl="splash"`` (K4's plain version on the CPU); the JAX package's
splash falls back to ``attention_reference`` on its CPU backend. The two
differ only on rows with no valid key, which no loss term reads.

Tolerances:

* shaping and ``prepare_update_batch``: equal arrays;
* each loss and its grad against JAX on the same inputs: ``LOSS_RTOL``;
* ``answer_logprobs`` (dense and chunked, with entropy): ``LOGP_ATOL``
  (f32 forwards over widths <= 128 summed in another order);
* the train step: ``loss_sum`` and the dynamics within ``STEP_ATOL``; the
  adapter after step 1 within ``ADAPTER_STEP1_ATOL`` = 2·lr: Adam's first
  normalized update is ``g / |g|`` = ±1 whatever the quantized state, so
  the two packages move an element by the same ``lr`` unless its grad
  cancels to f32 noise, where the sign may differ; after step 2 within
  ``ADAPTER_STEP2_ATOL`` = 10·lr:
  an int8 moment code can flip at a decision boundary when the grads differ
  in the last place, which moves one element's moment by one code (about
  1% in the top decade, up to 10x in the lowest) and so its second
  normalized step anywhere inside Adam8bit's clip of ±5·lr, a difference of
  at most 10·lr; and on at most ``FLIP_SHARE`` of the elements by more
  than 1e-3·lr.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import shaping as jshaping
from distrl_llm_tpu.learner import losses as jlosses
from distrl_llm_tpu.learner import optim as joptim
from distrl_llm_tpu.learner import train_step as jts
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch import shaping
from distrl_llm_tpu_torch.learner import losses, optim, train_step as ts
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import (
    lora_from_numpy, lora_to_numpy, params_from_numpy,
)
from distrl_llm_tpu_torch.ops.linear import dropout_stream, lora_delta
from distrl_llm_tpu_torch.parallel.mesh import RoleMesh
from distrl_llm_tpu_torch.tokenizer import CharTokenizer

LOSS_RTOL = 1e-6
LOGP_ATOL = 1e-5
STEP_ATOL = 1e-5
LR = 1e-3
ADAPTER_STEP1_ATOL = 2 * LR
ADAPTER_STEP2_ATOL = 10 * LR
FLIP_SHARE = 0.01
SCALE = 0.5
MICRO = 4
P, T = 14, 12
CFG = ModelConfig(**dataclasses.asdict(TINY))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(0), TINY))
    rng = np.random.default_rng(0)
    for name, arr in list(tree["layers"].items()):
        if name.endswith("norm") or name.startswith("b"):
            tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    lora = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(1), TINY, 4))
    for ab in lora["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree, lora


@pytest.fixture(scope="module")
def model(trees):
    return params_from_numpy(trees[0], CFG, device="cpu")


def _trainable(lora_tree):
    lora = lora_from_numpy(lora_tree, CFG, device="cpu")
    for ab in lora["layers"].values():
        for x in ab.values():
            x.requires_grad_(True)
    return lora


def _leaves(lora):
    return [x for t in sorted(lora["layers"]) for x in (lora["layers"][t]["a"],
                                                        lora["layers"][t]["b"])]


def _text(rng, n, lo, hi):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789 +-*/=?"))
    return ["".join(rng.choice(letters, rng.integers(lo, hi + 1))) for _ in range(n)]


# ---------------------------------------------------------------- shaping


def _candidates(rng, n=4, groups=2, t=6):
    cands = []
    for _ in range(2):
        cands.append({
            "rewards": [rng.integers(0, 2, (n, 2)).astype(np.float32) for _ in range(groups)],
            "token_lengths": [rng.integers(1, t, n) for _ in range(groups)],
            "answers": [_text(rng, n, 0, 9) for _ in range(groups)],
            "problem": [[p] * n for p in _text(rng, groups, 3, 9)],
            "answer_tokens": [rng.integers(0, 256, (n, t)).astype(np.int32) for _ in range(groups)],
            "behavior_logps": [-rng.random((n, t)).astype(np.float32) for _ in range(groups)],
            "gen_lengths": [rng.integers(0, t + 1, n).astype(np.int32) for _ in range(groups)],
        })
    return cands


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("learner", ["pg", "grpo"])
def test_shaping_matches_jax(learner):
    cands = _candidates(np.random.default_rng(2))
    mine, theirs = copy.deepcopy(cands), copy.deepcopy(cands)
    s1 = shaping.shape_rewards(mine, learner)
    s2 = jshaping.shape_rewards(theirs, learner)
    assert dataclasses.asdict(s1) == dataclasses.asdict(s2)
    shaping.topk_filter(mine, 3)
    jshaping.topk_filter(theirs, 3)
    _assert_tree_equal(mine, theirs)
    _assert_tree_equal(shaping.flatten_for_update(mine, learner),
                       jshaping.flatten_for_update(theirs, learner))


# ------------------------------------------------------ prepare_update_batch


def _raw(rng, n, width=T + 3):
    return {"answer_tokens": rng.integers(1, 256, (n, width)).astype(np.int32),
            "behavior_logps": -rng.random((n, width)).astype(np.float32),
            "lengths": rng.integers(0, width + 2, n).astype(np.int32)}


@pytest.mark.parametrize("variant", ["text", "raw", "buckets"])
def test_prepare_update_batch_matches_jax(variant):
    rng = np.random.default_rng(3)
    n = 7
    problems, answers = _text(rng, n, 1, P + 4), _text(rng, n, 0, T + 3)
    coeffs = rng.standard_normal(n).astype(np.float32)
    kw = dict(max_prompt_tokens=P, max_new_tokens=T, micro_size=MICRO)
    if variant == "raw":
        kw["raw_rollout"] = _raw(rng, n)
    if variant == "buckets":
        kw.update(answer_buckets=[4, 8], prompt_buckets=[6, 10])
    tok = CharTokenizer()
    got = ts.prepare_update_batch(tok, problems, answers, coeffs, device="cpu", **kw)
    want = jts.prepare_update_batch(tok, problems, answers, coeffs, **kw)
    for name, g, w in zip(ts.UpdateBatch._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tp_mesh = RoleMesh(np.arange(2).reshape(1, 1, 1, 2))  # tensor parallelism: item 10b
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.prepare_update_batch(tok, problems, answers, coeffs, device="cpu", mesh=tp_mesh, **kw)


# ----------------------------------------------------------------- losses


def _loss_inputs(rng, b=5, t=7):
    logp = -rng.random((b, t)).astype(np.float32) * 3
    mask = (rng.random((b, t)) < 0.7).astype(np.float32)
    mask[0] = 0  # an empty answer
    return {"logp": logp, "mask": mask,
            "coeffs": rng.standard_normal(b).astype(np.float32),
            "sample": np.array([1, 1, 1, 0, 1], np.float32)[:b],
            "behavior": (logp + 0.3 * rng.standard_normal((b, t))).astype(np.float32),
            "lag": rng.integers(0, 4, (b, t)).astype(np.float32)}


LOSSES = {
    "pg": lambda m, x: m.pg_loss(x["logp"], x["mask"], x["coeffs"], x["sample"]),
    "pg_no_sample_mask": lambda m, x: m.pg_loss(x["logp"], x["mask"], x["coeffs"]),
    "grpo": lambda m, x: m.grpo_loss(x["logp"], x["mask"], x["coeffs"], x["sample"]),
    "grpo_clip": lambda m, x: m.grpo_clip_loss(x["logp"], x["behavior"], x["mask"],
                                               x["coeffs"], x["sample"], clip_ratio=0.2),
    "grpo_aipo": lambda m, x: m.grpo_aipo_loss(x["logp"], x["behavior"], x["mask"],
                                               x["coeffs"], x["sample"], is_cap=1.5,
                                               version_lag=x["lag"], max_staleness=2),
    "kl_to_ref": lambda m, x: m.kl_to_ref(x["logp"], x["behavior"], x["mask"], x["sample"]),
    "entropy_bonus": lambda m, x: m.entropy_bonus(x["logp"], 0.3),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_grad_match_jax(name):
    x = _loss_inputs(np.random.default_rng(4))
    fn = LOSSES[name]
    if name == "entropy_bonus":  # a normalized log-distribution over the last axis
        x = dict(x, logp=(x["logp"] - np.log(np.exp(x["logp"]).sum(-1, keepdims=True))
                          ).astype(np.float32))

    def jf(logp):
        return fn(jlosses, {**{k: jnp.asarray(v) for k, v in x.items()}, "logp": logp})

    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(x["logp"]))
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    tx["logp"].requires_grad_(True)
    got = fn(losses, tx)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(tx["logp"].grad.numpy(), np.asarray(jgrad),
                               rtol=LOSS_RTOL, atol=1e-7)


# --------------------------------------------------------- answer_logprobs


def _batch_arrays(seed, n=8):
    rng = np.random.default_rng(seed)
    tok = CharTokenizer()
    problems, answers = _text(rng, n, 1, P), _text(rng, n, 0, T)
    answers[1] = ""  # an empty answer
    b = ts.prepare_update_batch(tok, problems, answers, rng.standard_normal(n),
                                max_prompt_tokens=P, max_new_tokens=T, micro_size=MICRO,
                                device="cpu")
    return b


@pytest.mark.parametrize("chunk", [0, 4, 5])
def test_answer_logprobs_and_entropy_match_jax(trees, model, chunk):
    tree, lora_tree = trees
    b = _batch_arrays(5)
    args = (b.prompt_ids, b.prompt_mask, b.answer_ids, b.answer_mask)
    want_lp, want_ent = jlosses.answer_logprobs(
        _jnp_tree(tree), TINY, *(jnp.asarray(a.numpy()) for a in args),
        lora=_jnp_tree(lora_tree), lora_scale=SCALE, attn_impl="splash",
        logit_chunk=chunk, return_entropy=True)
    lora = _trainable(lora_tree)
    lp, ent = losses.answer_logprobs(model, *args, lora=lora, lora_scale=SCALE,
                                     attn_impl="splash", logit_chunk=chunk,
                                     return_entropy=True)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp), atol=LOGP_ATOL, rtol=0)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(want_ent), atol=LOGP_ATOL,
                               rtol=0)
    only = losses.answer_logprobs(model, *args, lora=lora, lora_scale=SCALE,
                                  attn_impl="splash", logit_chunk=chunk)
    assert torch.equal(only, lp)
    (only * b.answer_mask).sum().backward()  # the chunks' checkpoints backprop
    assert all(torch.isfinite(x.grad).all() for x in _leaves(lora))


# ---------------------------------------------------------- the train step


def _step_batch(case):
    """The case's batch as numpy arrays: prepare_update_batch of random
    text (or the engine path for ``raw``), with coefficients that make
    microbatch 1 all-zero (skipped under both semantics) and microbatch 2
    hold one zero (skipped under "any_zero"), plus, for ``pad_micro``, a
    trailing padding-only microbatch."""
    rng = np.random.default_rng(6)
    n = 3 * MICRO
    problems, answers = _text(rng, n, 1, P), _text(rng, n, 1, T)
    coeffs = rng.standard_normal(n).astype(np.float32)
    coeffs[:MICRO] = 0.0
    coeffs[MICRO + 1] = 0.0
    raw = _raw(rng, n) if case.get("raw") else None
    b = ts.prepare_update_batch(CharTokenizer(), problems, answers, coeffs,
                                max_prompt_tokens=P, max_new_tokens=T, micro_size=MICRO,
                                raw_rollout=raw, device="cpu")
    arrays = [None if x is None else x.numpy() for x in b]
    if case.get("pad_micro"):
        arrays = [None if x is None else np.concatenate([x, np.zeros((MICRO,) + x.shape[1:],
                                                                     x.dtype)])
                  for x in arrays]
    return arrays


STEP_CASES = {
    "pg_all_zero_pad_micro_dynamics_chunked": dict(
        learner_type="pg", skip_semantics="all_zero", emit_dynamics=True, logit_chunk=4,
        pad_micro=True),
    "grpo_any_zero_kl": dict(learner_type="grpo", skip_semantics="any_zero", kl_coeff=0.1),
    "clip_behavior_dynamics": dict(learner_type="grpo", skip_semantics="all_zero",
                                   clip_ratio=0.2, emit_dynamics=True, raw=True),
}


def _port_step_kwargs(case):
    return {k: v for k, v in case.items() if k not in ("raw", "pad_micro")}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_matches_jax(trees, model, name):
    case = STEP_CASES[name]
    tree, lora_tree = trees
    arrays = _step_batch(case)
    kw = _port_step_kwargs(case)
    jopt = joptim.make_optimizer(LR)
    jlo = _jnp_tree(lora_tree)
    jstate = jopt.init(jlo)
    jstep = jts.make_train_step(TINY, optimizer=jopt, lora_scale=SCALE, micro_size=MICRO,
                                attn_impl="splash", donate=False, **kw)
    jbatch = jts.UpdateBatch(*(None if x is None else jnp.asarray(x) for x in arrays))
    lora = _trainable(lora_tree)
    opt = optim.make_optimizer(_leaves(lora), LR)
    step = ts.make_train_step(CFG, optimizer=opt, lora_scale=SCALE, micro_size=MICRO,
                              attn_impl="splash", **kw)
    batch = ts.UpdateBatch(*(None if x is None else torch.from_numpy(x) for x in arrays))
    jparams = _jnp_tree(tree)
    for i, atol in enumerate((ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL)):
        jout = jstep(jlo, jstate, jparams, jbatch)
        jlo, jstate, jloss = jout[:3]
        out = step(lora, model, batch)
        loss = out[0] if kw.get("emit_dynamics") else out
        np.testing.assert_allclose(float(loss), float(jloss), atol=STEP_ATOL, rtol=0)
        if kw.get("emit_dynamics"):
            dyn, jdyn = out[1], jout[3]
            assert sorted(dyn) == sorted(jdyn)
            for k in dyn:
                np.testing.assert_allclose(dyn[k].numpy(), np.asarray(jdyn[k]), atol=STEP_ATOL,
                                           rtol=STEP_ATOL, err_msg=k)
        got, want = lora_to_numpy(lora), _np_tree(jlo)
        diffs = np.concatenate([np.abs(got["layers"][t][f] - want["layers"][t][f]).ravel()
                                for t in got["layers"] for f in ("a", "b")])
        assert diffs.max() <= atol, (i, diffs.max())
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE, (i, (diffs > 1e-3 * LR).mean())
    moved = np.abs(lora_to_numpy(lora)["layers"]["wq"]["a"] - lora_tree["layers"]["wq"]["a"])
    assert moved.max() > 0.5 * LR  # the adapter trained


def test_train_step_without_remat_gives_the_same_step(trees, model):
    tree, lora_tree = trees
    arrays = _step_batch({})
    batch = ts.UpdateBatch(*(None if x is None else torch.from_numpy(x) for x in arrays))
    after = []
    for remat in (True, False):
        lora = _trainable(lora_tree)
        opt = optim.make_optimizer(_leaves(lora), LR)
        step = ts.make_train_step(CFG, optimizer=opt, lora_scale=SCALE, micro_size=MICRO,
                                  attn_impl="splash", remat=remat, lora_dropout=0.3)
        loss = step(lora, model, batch, dropout_seed=11)
        after.append((float(loss), lora_to_numpy(lora)))
    assert after[0][0] == pytest.approx(after[1][0], abs=1e-6)
    _assert_close_trees(after[0][1], after[1][1], 1e-7)


def _assert_close_trees(a, b, atol):
    for t in a["layers"]:
        for f in ("a", "b"):
            np.testing.assert_allclose(a["layers"][t][f], b["layers"][t][f], atol=atol, rtol=0)


def test_train_step_refuses_unported_modes(model):
    """Ring and ulysses attention meshes are item 10b. Full fine-tuning is ported
    (``tests/test_torch_full_finetune.py``): only its KL term, which needs
    a frozen base, and an unknown mode raise."""
    opt = optim.make_optimizer([torch.zeros(1, requires_grad=True)], LR)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.make_train_step(CFG, optimizer=opt, lora_scale=1.0, micro_size=2, attn_mesh=object())
    ts.make_train_step(CFG, optimizer=opt, lora_scale=1.0, micro_size=2, train_mode="full")
    with pytest.raises(ValueError, match="kl_coeff"):
        ts.make_train_step(CFG, optimizer=opt, lora_scale=1.0, micro_size=2, train_mode="full",
                           kl_coeff=0.1)
    with pytest.raises(ValueError, match="train_mode"):
        ts.make_train_step(CFG, optimizer=opt, lora_scale=1.0, micro_size=2, train_mode="qlora")


# ------------------------------------------------------------ LoRA dropout


def _dropped(rate, seed, shape=(400, 64)):
    """The adapter input lora_delta sees: identity factors expose it."""
    eye = torch.eye(shape[1])
    return lora_delta(torch.ones(shape), eye, eye, 1.0, dropout_rate=rate, dropout_seed=seed)


def test_lora_dropout_rate_zero_changes_nothing():
    x = torch.randn(5, 64)
    a, b = torch.randn(64, 4), torch.randn(4, 8)
    assert torch.equal(lora_delta(x, a, b, 0.5, dropout_rate=0.0, dropout_seed=3),
                       lora_delta(x, a, b, 0.5))
    assert torch.equal(lora_delta(x, a, b, 0.5, dropout_rate=0.3, dropout_seed=None),
                       lora_delta(x, a, b, 0.5))


def test_lora_dropout_keep_fraction_and_inverted_scaling():
    rate = 0.25
    y = _dropped(rate, 7)
    kept = y != 0
    assert bool(torch.all(y[kept] == 1.0 / (1.0 - rate)))
    n = y.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - rate)) < 4 * sigma
    assert torch.equal(_dropped(rate, 7), y)  # the same seed, the same mask
    assert not torch.equal(_dropped(rate, 8), y)


def test_lora_dropout_masks_differ_across_targets_and_layers():
    seeds = {(layer, t): dropout_stream(dropout_stream(5, 0), layer, t)
             for layer in range(3) for t in range(7)}
    assert len(set(seeds.values())) == len(seeds)
    masks = [_dropped(0.5, s) != 0 for s in list(seeds.values())[:4]]
    assert all(not torch.equal(masks[0], m) for m in masks[1:])


def test_lora_dropout_masks_repeat_in_the_remat_recompute(trees, model):
    """With dropout on, remat's recompute must draw the forward's masks:
    grads with remat equal grads without it, and another seed differs."""
    _, lora_tree = trees
    b = _batch_arrays(8)
    args = (b.prompt_ids, b.prompt_mask, b.answer_ids, b.answer_mask)
    grads = {}
    for remat, seed in ((True, 3), (False, 3), (True, 4)):
        lora = _trainable(lora_tree)
        lp = losses.answer_logprobs(model, *args, lora=lora, lora_scale=SCALE, remat=remat,
                                    attn_impl="splash", lora_dropout=0.5, dropout_seed=seed)
        (lp * b.answer_mask).sum().backward()
        grads[(remat, seed)] = torch.cat([x.grad.reshape(-1) for x in _leaves(lora)])
    torch.testing.assert_close(grads[(True, 3)], grads[(False, 3)], atol=1e-7, rtol=0)
    assert not torch.allclose(grads[(True, 3)], grads[(True, 4)])


def test_chip_smoke_learner_phases_rehearse_on_cpu():
    """chip_smoke.py's learner phases at TINY size on the CPU (the plain
    versions in the kernels' place): the sampled round through shaping
    into microbatches, two optimizer steps within Adam8bit's clip, the push
    into the dense engine's mailbox, the K4-vs-plain and learner-vs-engine
    comparisons, and the paged engine's splash prefill."""
    import chip_smoke

    w = chip_smoke.make_weights(CFG, "cpu", seed=0, rank=4)
    out = chip_smoke.rollout(CFG, "cpu", seed=0, max_prompt_tokens=96, max_new_tokens=12,
                             n=2, rank=4, weights=w)
    sp = chip_smoke.splash_prefill(CFG, "cpu", w, chip_smoke.widen(w), seed=0,
                                   max_prompt_tokens=96, max_new_tokens=12, n=2,
                                   page_size=8, rank=4)
    assert sp["logit_err"] <= chip_smoke.LOGIT_F32_ATOL and sp["steps"] > 0
    batch, source = chip_smoke.learner_batch(out, n=2, seed=0, device="cpu",
                                             max_prompt_tokens=96, max_new_tokens=20, micro=4)
    assert "seed" in source  # random weights score 0: the coefficients are drawn
    assert batch.prompt_ids.shape == (8, 96) and bool((batch.coeffs != 0).all())
    lrn = chip_smoke.learner_run(w, batch, lr=LR, scale=1.0, micro=4, logit_chunk=8)
    assert all(np.isfinite(s["loss"]) and s["within_clip"] and s["moved_share"] > 0
               for s in lrn["steps"])
    # on the CPU the plain version runs: 2 steps x 2 microbatches x layers x
    # (forward + remat recompute)
    assert lrn["plain_calls"] == 2 * 2 * CFG.num_layers * 2
    pushed = chip_smoke.push_and_round(CFG, "cpu", w, lrn["lora"], seed=0, version=1, n=2,
                                       max_prompt_tokens=96, max_new_tokens=12, rank=4)
    assert pushed["versions"] == [1] and pushed["swap_steps"] == [0]
    lp = chip_smoke.learner_parity(CFG, "cpu", seed=0, n=2, max_prompt_tokens=96,
                                   max_new_tokens=30, gen_tokens=12, rank=4, logit_chunk=8)
    assert lp["logp_err"] <= chip_smoke.LEARNER_LOGP_ATOL
    assert lp["loss_rel"] <= chip_smoke.LEARNER_REL and lp["grad_rel"] <= chip_smoke.LEARNER_REL
