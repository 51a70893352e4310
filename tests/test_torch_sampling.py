"""Parity of the PyTorch port's sampler with the JAX package's.

The port's ``fused_sample_reference`` (the plain version of the Hopper
kernel) is fed the per-row seeds the JAX wrapper derives from its key and
held against the JAX Pallas kernel run in interpret mode on the CPU. The
filters and ``token_logprob`` are held against their JAX counterparts. All
inputs are made from a seed with numpy; everything is f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.ops import sampling as jsampling
from distrl_llm_tpu_torch.ops import sampling as tsampling

# |Δlogp| bound: the same f32 log-sum-exp over V <= 1000 terms, summed in a
# different order by XLA and PyTorch
LOGP_ATOL = 1e-5
# a row whose two best perturbed scores lie within this relative gap is a
# near-tie that exp/sum rounding may flip; none is expected at these seeds
NEAR_TIE_REL = 1e-5


def _logits(b, v, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, v)) * scale).astype(np.float32)


def _jax_seeds(key, b):
    # the per-row seeds jax fused_sample derives (ops/sampling.py:280)
    return np.array(jax.random.bits(key, (b, 1), jnp.uint32).astype(jnp.int32))[:, 0]


def _near_tie_rows(scores: torch.Tensor) -> np.ndarray:
    top2 = scores.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).abs()
    return (gap <= NEAR_TIE_REL * top2[:, 0].abs().clamp_min(1e-30)).numpy()


CASES = [
    # (B, V, temperature, top_p)
    (8, 256, 0.0, 0.95),  # greedy
    (8, 256, 1.2, 0.95),  # train sampling
    (8, 256, 0.6, 0.95),  # eval sampling
    (8, 256, 1.0, 1.0),  # no nucleus cut
    (6, 300, 1.2, 0.95),  # V not a multiple of 128
    (5, 1000, 1.2, 0.9),
]


@pytest.mark.parametrize("b,v,t,p", CASES)
def test_fused_reference_matches_jax_kernel(b, v, t, p):
    lg = _logits(b, v, seed=v + b)
    key = jax.random.PRNGKey(v * 7 + b)
    jtok, jlogp = jsampling.fused_sample(key, jnp.asarray(lg), t, p, interpret=True)
    seeds = torch.from_numpy(_jax_seeds(key, b))
    ttok, tlogp = tsampling.fused_sample_reference(torch.from_numpy(lg), t, p, seeds)
    scores = tsampling.fused_sample_scores(torch.from_numpy(lg), t, p, seeds)
    ties = _near_tie_rows(scores)
    assert not ties.any(), "a near-tie at these seeds: pick other seeds"
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=LOGP_ATOL, rtol=0)


def test_fused_sample_on_cpu_runs_plain_version_without_launching():
    lg = torch.from_numpy(_logits(4, 512, seed=3))
    seeds = torch.tensor([1, -2, 3, 2**31 - 1], dtype=torch.int32)
    before = tsampling.fused_sample_launches
    tok, logp = tsampling.fused_sample(lg, 1.2, 0.95, seeds)
    rtok, rlogp = tsampling.fused_sample_reference(lg, 1.2, 0.95, seeds)
    assert tsampling.fused_sample_launches == before == 0
    assert tok.dtype == torch.int32 and logp.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), rtok.numpy())
    np.testing.assert_array_equal(logp.numpy(), rlogp.numpy())


@pytest.mark.parametrize("bad", ["dtype", "rank", "seeds_dtype", "seeds_shape",
                                 "noncontig"])
def test_fused_sample_rejects_bad_inputs(bad):
    lg = torch.zeros((3, 16), dtype=torch.float32)
    seeds = torch.zeros((3,), dtype=torch.int32)
    if bad == "dtype":
        lg = lg.to(torch.bfloat16)
    elif bad == "rank":
        lg = lg[None]
    elif bad == "seeds_dtype":
        seeds = seeds.long()
    elif bad == "seeds_shape":
        seeds = seeds[:2]
    else:
        lg = torch.zeros((16, 3)).T
    with pytest.raises((TypeError, ValueError)):
        tsampling.fused_sample(lg, 1.0, 0.9, seeds)


def test_nan_row_returns_in_range_index():
    lg = torch.from_numpy(_logits(3, 200, seed=4))
    lg[1] = float("nan")
    seeds = torch.tensor([5, 6, 7], dtype=torch.int32)
    for t in (0.0, 1.2):
        tok, _ = tsampling.fused_sample(lg, t, 0.95, seeds)
        assert ((tok >= 0) & (tok < 200)).all()


def test_gumbel_hash_matches_uint32_arithmetic():
    seeds = np.array([0, 1, -1, 2**31 - 1, -(2**31)], np.int32)
    v = 300
    got = tsampling.gumbel_noise(torch.from_numpy(seeds), v).numpy()
    col = np.arange(v, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = col[None, :] * np.uint32(0x9E3779B9) + seeds.astype(np.uint32)[:, None]
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    u = (h >> np.uint32(9)).astype(np.float32) * np.float32(2.0**-23) + np.float32(2.0**-24)
    want = -np.log(-np.log(u))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# top_p = 1.0 is left out here: whether the tail survives then rests on the
# last ulp of a cumulative sum, which XLA and PyTorch round differently
@pytest.mark.parametrize("top_p", [0.5, 0.8, 0.9, 0.95])
def test_top_p_filters_match_jax(top_p):
    lg = _logits(6, 400, seed=11)
    for jfn, tfn in ((jsampling.top_p_filter, tsampling.top_p_filter),
                     (jsampling.top_p_filter_bisect, tsampling.top_p_filter_bisect)):
        want = np.array(jfn(jnp.asarray(lg), top_p))
        got = tfn(torch.from_numpy(lg), top_p).numpy()
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_token_logprob_matches_jax():
    lg = _logits(2, 5, seed=12)[None].repeat(3, axis=0)  # [3, 2, 5]
    toks = np.random.default_rng(13).integers(0, 5, (3, 2)).astype(np.int32)
    want = np.asarray(jsampling.token_logprob(jnp.asarray(lg), jnp.asarray(toks)))
    got = tsampling.token_logprob(torch.from_numpy(lg), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)


def test_sample_bisect_equals_fused_reference():
    lg = torch.from_numpy(_logits(6, 700, seed=14))
    seeds = torch.arange(6, dtype=torch.int32) * 977
    for t in (0.0, 0.6, 1.2):
        tok = tsampling.sample(lg, t, 0.95, seeds, top_p_impl="bisect")
        ref, _ = tsampling.fused_sample_reference(lg, t, 0.95, seeds)
        np.testing.assert_array_equal(tok.numpy(), ref.numpy())


def test_sample_with_logprob_dispatch():
    lg = torch.from_numpy(_logits(4, 300, seed=15))
    seeds = torch.arange(4, dtype=torch.int32)
    tok_e, lp_e = tsampling.sample_with_logprob(
        lg, 0.0, 0.95, seeds, top_p_impl="exact", capture_logprob=True)
    tok_b, lp_b = tsampling.sample_with_logprob(
        lg, 0.0, 0.95, seeds, top_p_impl="bisect", capture_logprob=True)
    np.testing.assert_array_equal(tok_e.numpy(), lg.argmax(-1).numpy())
    np.testing.assert_array_equal(tok_b.numpy(), tok_e.numpy())
    np.testing.assert_allclose(lp_b.numpy(), lp_e.numpy(), atol=LOGP_ATOL)
    _, none = tsampling.sample_with_logprob(lg, 1.2, 0.95, seeds)
    assert none is None
    # bisect_mw on a CPU tensor: the multi-pass sample with the multiway
    # filter (on a CUDA tensor it launches K1, tests/test_torch_dense_int8.py)
    tok_m, lp_m = tsampling.sample_with_logprob(lg, 1.2, 0.95, seeds, top_p_impl="bisect_mw",
                                                capture_logprob=True)
    want = tsampling.sample(lg, 1.2, 0.95, seeds, top_p_impl="bisect_mw")
    np.testing.assert_array_equal(tok_m.numpy(), want.numpy())
    np.testing.assert_allclose(lp_m.numpy(), tsampling.token_logprob(lg, want).numpy(), atol=0)
