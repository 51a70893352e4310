"""Parity of the PyTorch port's dense rollout engine with the JAX package's.

One numpy param tree and one numpy adapter tree (non-zero B) feed the JAX
``GenerationEngine`` (host loop, no autotune, f32 cache) and the port's
``GenerationEngine(device="cpu")`` on ``TINY``. Greedy tokens and lengths
must be identical; captured behavior logprobs agree within ``LOGP_ATOL``
(f32 forwards over widths <= 128 in another summation order). The sampled
path draws other random numbers than the JAX engine by construction, so it
is held to its invariants and to its own reproducibility.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import (
    GenerationEngine, accumulate_round_stats, run_decode_loop,
)
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy

LOGP_ATOL = 1e-4
PAD = 0
NO_EOS = 999  # outside TINY's vocabulary: never sampled
LORA_SCALE = 0.5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(seed=0):
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(seed), TINY))
    rng = np.random.default_rng(seed)
    for name, arr in list(tree["layers"].items()):
        if name.endswith("norm") or name.startswith("b"):
            tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    return tree


def _lora(seed=1, scale=0.05):
    tree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), TINY, 4))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():
        ab["b"] = (scale * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def weights():
    tree, lora = _params(), _lora()
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    return {
        "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
        "jlora": jax.tree_util.tree_map(jnp.asarray, lora),
        "model": params_from_numpy(tree, cfg, device="cpu"),
        "lora": lora_from_numpy(lora, cfg, device="cpu"),
        "cfg": cfg,
    }


def _prompts(lengths, p, seed=7):
    """Left-padded prompt ids/mask [B, p]; a length of 0 is a batch-padding
    row (empty prompt)."""
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), p), PAD, np.int32)
    mask = np.zeros((len(lengths), p), np.int32)
    for i, n in enumerate(lengths):
        if n:
            ids[i, p - n:] = rng.integers(4, TINY.vocab_size, n)
            mask[i, p - n:] = 1
    return ids, mask


def _engines(weights, *, p, t, eos=NO_EOS, **kw):
    common = dict(max_prompt_tokens=p, max_new_tokens=t, eos_token_ids=[eos],
                  pad_token_id=PAD, lora_scale=LORA_SCALE, capture_logprobs=True, **kw)
    jeng = JEngine(TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0, **common)
    teng = GenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu", **common)
    return jeng, teng


def _greedy(t, n):
    return (JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
            SamplingConfig(max_tokens=t, temperature=0.0, n=n))


def _run_both(weights, jeng, teng, ids, mask, t, n, seed=0):
    js, ts = _greedy(t, n)
    jres = jeng.generate(weights["jparams"], weights["jlora"], ids, mask, js,
                         jax.random.PRNGKey(seed))
    tres = teng.generate(weights["model"], weights["lora"], ids, mask, ts, seed)
    return jres, tres


def _assert_same(jres, tres):
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)


def _assert_invariants(res, *, t, eos, vocab):
    tok = res.tokens.reshape(-1, t)
    lengths = res.lengths.reshape(-1)
    assert ((tok >= 0) & (tok < vocab)).all()
    col = np.arange(t)[None, :]
    after = col >= lengths[:, None]
    assert (tok[after] == PAD).all()
    assert (res.logprobs.reshape(-1, t)[after] == 0.0).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 1e-6).all()
    first_eos = np.where((tok == eos) & ~after, col, t).min(axis=1)
    ended = lengths < t
    assert (first_eos[ended] == lengths[ended] - 1).all()


@pytest.mark.parametrize("lengths,bucket", [([5, 8, 3], 8), ([12, 4, 9], 16)],
                         ids=["short_bucket", "full_bucket"])
def test_greedy_matches_jax_across_prompt_buckets(weights, lengths, bucket):
    p, t, n = 16, 10, 2
    ids, mask = _prompts(lengths, p)
    jeng, teng = _engines(weights, p=p, t=t, prompt_buckets=(8, 16))
    assert teng.prompt_buckets == jeng.prompt_buckets == [8, 16]
    assert teng.bucket_for(mask) == jeng.bucket_for(mask) == bucket
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert tres.tokens.shape == (3, n, t)
    # round stats: the same token counts as the JAX engine's
    for key in ("prefill_tokens", "prompt_rows", "gen_tokens", "gen_rows"):
        assert teng.last_round_stats[key] == jeng.last_round_stats[key], key
    assert teng.last_round_stats["prefill_tokens"] == int(mask.sum())


def test_greedy_matches_jax_in_waves_with_dead_tail_and_empty_prompt(weights):
    """5 prompts x 2 candidates at max 4 concurrent rows: 3 waves of 2
    prompts, the tail wave padded with a dead row; prompt 1 is empty (batch
    padding), so its candidates are born done."""
    p, t, n = 12, 8, 2
    ids, mask = _prompts([7, 0, 12, 3, 9], p, seed=8)
    jeng, teng = _engines(weights, p=p, t=t, max_concurrent_rows=4)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n, seed=3)
    _assert_same(jres, tres)
    assert tres.tokens.shape == (5, n, t)
    assert (tres.lengths[1] == 0).all() and (tres.tokens[1] == PAD).all()
    assert (tres.lengths[[0, 2, 3, 4]] == t).all()
    assert tres.steps_dispatched == 3 * t  # one sampler launch per step per wave
    assert teng.last_round_stats["prompt_rows"] == 6  # 3 waves of 2
    assert teng.last_round_stats["prefill_tokens"] == int(mask.sum())


def test_greedy_matches_jax_when_eos_is_hit(weights):
    p, t, n = 12, 12, 2
    ids, mask = _prompts([10, 6, 12], p, seed=9)
    _, probe = _engines(weights, p=p, t=t)
    base = probe.generate(weights["model"], weights["lora"], ids, mask, _greedy(t, n)[1], 0)
    eos = int(base.tokens[0, 0, 2])  # row 0 meets it at step 2 at the latest
    jeng, teng = _engines(weights, p=p, t=t, eos=eos)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert tres.lengths[0, 0] <= 3 and (tres.lengths < t).any()
    _assert_invariants(tres, t=t, eos=eos, vocab=TINY.vocab_size)


def test_sampled_path_invariants_and_reproducibility(weights):
    p, t, n = 12, 16, 4
    ids, mask = _prompts([10, 4, 12], p, seed=10)
    _, teng = _engines(weights, p=p, t=t, eos=5)
    sc = SamplingConfig(max_tokens=t, temperature=1.2, top_p=0.95, n=n)
    a = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    b = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    c = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 12)
    _assert_invariants(a, t=t, eos=5, vocab=TINY.vocab_size)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    # candidates of one prompt draw different tokens
    assert not np.array_equal(a.tokens[0, 0], a.tokens[0, 1])
    # the exact (sort) filter runs the plain multi-pass path
    e = teng.generate(weights["model"], weights["lora"], ids, mask,
                      sc.replace(top_p_exact=True), 11)
    _assert_invariants(e, t=t, eos=5, vocab=TINY.vocab_size)


def _swap_at(engine, step, lora, version):
    """Push ``lora`` into the engine's mailbox just before the decode step
    ``step`` is dispatched (the learner thread's push, made deterministic)."""
    take = engine._take_pending_lora

    def patched(cell, dispatched):
        if dispatched == step:
            engine.push_lora(lora, version=version)
        take(cell, dispatched)

    engine._take_pending_lora = patched


def test_push_lora_mid_round_matches_jax(weights):
    p, t, n = 12, 10, 2
    ids, mask = _prompts([9, 12], p, seed=12)
    new = _lora(seed=5, scale=0.5)
    cfg = weights["cfg"]
    jeng, teng = _engines(weights, p=p, t=t)
    _swap_at(jeng, 3, jax.tree_util.tree_map(jnp.asarray, new), 7)
    _swap_at(teng, 3, lora_from_numpy(new, cfg, device="cpu"), 7)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert teng.last_swap_steps == jeng.last_swap_steps == [3]
    assert teng.last_swap_versions == [7]
    # the swap changed what was decoded after it, not before
    _, plain = _engines(weights, p=p, t=t)
    ref = plain.generate(weights["model"], weights["lora"], ids, mask, _greedy(t, n)[1], 0)
    np.testing.assert_array_equal(tres.tokens[..., :4], ref.tokens[..., :4])
    assert not np.array_equal(tres.tokens, ref.tokens)
    assert plain.last_swap_steps == []


def test_engine_checks_its_inputs(weights):
    _, teng = _engines(weights, p=8, t=4)
    ids, mask = _prompts([3], 6)
    with pytest.raises(ValueError, match="padded to 8"):
        teng.generate(weights["model"], None, ids, mask, _greedy(4, 1)[1], 0)
    other = types.SimpleNamespace(cfg=dataclasses.replace(weights["cfg"], rope_theta=1.0))
    ids, mask = _prompts([3], 8)
    with pytest.raises(ValueError, match="config"):
        teng.generate(other, None, ids, mask, _greedy(4, 1)[1], 0)
    with pytest.raises(ValueError, match="buckets"):
        _engines(weights, p=8, t=4, prompt_buckets=(16,))


def test_chip_smoke_phases_rehearse_on_cpu():
    """chip_smoke.py's rollout and kernel-comparison phases at TINY size on
    the CPU (plain versions, so no launch is counted): the same code the
    card runs at full width."""
    import chip_smoke

    cfg = ModelConfig(**dataclasses.asdict(TINY))
    out = chip_smoke.rollout(cfg, "cpu", seed=0, max_prompt_tokens=96,
                             max_new_tokens=12, n=2, rank=4)
    # 12 steps < the 16-step done poll: no early exit, 3 rounds of 12
    assert out["steps"] == 3 * 12
    assert out["counts"] == {k["name"]: 0 for k in chip_smoke.KERNELS}  # CPU: no launch
    assert chip_smoke.compare_fused_sample("cpu", 1, shapes=((5, 300),)) == 0.0
    assert chip_smoke.fused_sample_bound_ms(64, 152064, sampling=True)[1] == "bytes"


def test_run_decode_loop_polls_done_every_check_steps():
    class S:
        def __init__(self):
            self.done = torch.zeros(3, dtype=torch.bool)
            self.calls = []

    def step(s, last):
        s.calls.append(last)
        if len(s.calls) == 5:
            s.done[:] = True

    s = run_decode_loop(step, S(), max_steps=100, decode_chunk=4)
    assert len(s.calls) == 8  # all done at 5; seen at the next poll (step 8)
    s = run_decode_loop(step, S(), max_steps=3, decode_chunk=128)
    assert s.calls == [False, False, True]  # the last step is flagged


def test_accumulate_round_stats_folds_waves():
    st = accumulate_round_stats(None, prefill_s=0.5, prefill_tokens=10, prompt_rows=2,
                                decode_s=1.0, gen_tokens=30, gen_rows=4)
    st = accumulate_round_stats(st, prefill_s=0.25, prefill_tokens=5, prompt_rows=2,
                                decode_s=2.0, gen_tokens=12, gen_rows=4)
    assert st == {"prefill_s": 0.75, "prefill_tokens": 15, "prompt_rows": 4,
                  "decode_s": 3.0, "gen_tokens": 42, "gen_rows": 8}
