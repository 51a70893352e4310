"""Parity of the dense slice's leftovers with the JAX package: the int8
dense KV cache (``ops/attention.py::quantize_kv_position`` and
``attention_cached_quant``, ``models/transformer.py::init_kv_cache_int8``,
``GenerationEngine(kv_quant="int8")``) and the multiway bisection nucleus
filter (``ops/sampling.py::top_p_filter_bisect_multiway``).

Tolerances: the quantization is bit-equal (both packages divide tensor by
tensor, round half to even and clamp before the cast); the attention
reads within ``ATTN_ATOL`` (f32, the same products in another summation
order); the engine's greedy tokens and lengths exactly, its captured
logprobs within ``LOGP_ATOL``; the filter's kept set exactly, except on a
row where one of the tested thresholds kept a mass within ``MASS_ATOL`` of
top_p: the two packages sum 152,064 probabilities in other orders, and a
mass that close to top_p can fall on either side (the criterion
``test_torch_sample_plan.py`` holds K1's masses to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.ops import sampling as jsampling
from distrl_llm_tpu.ops.attention import (
    attention_cached_quant as j_attention_cached_quant,
    causal_padding_mask as j_causal_padding_mask,
    quantize_kv_position as j_quantize_kv_position,
)
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.ops import attention as tattn
from distrl_llm_tpu_torch.ops import sampling as tsampling
from tests.test_torch_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, _assert_same, _engines, _prompts, _run_both, weights,
)
from tests.test_torch_prefix_cache import _one_torch_thread  # noqa: F401  (autouse)

ATTN_ATOL = 1e-5
MASS_ATOL = 1e-5


def _closest_decision(lg: np.ndarray, top_p: float, passes: int = 4, k: int = 15):
    """Per row, the least |kept mass - top_p| over the thresholds the
    port's multiway filter tested on its way (its decisions there are the
    only ones a summation order can flip)."""
    probs = torch.softmax(torch.from_numpy(lg), dim=-1)
    frac = torch.arange(1, k + 1, dtype=torch.float32) / torch.full((k,), k + 1.0)
    lo, hi = torch.zeros(probs.shape[0]), probs.max(dim=-1).values
    best = torch.full((probs.shape[0],), float("inf"))
    for _ in range(passes):
        ts = lo[:, None] + (hi - lo)[:, None] * frac
        mass = torch.stack([torch.where(probs >= ts[:, j:j + 1], probs, 0.0).sum(-1)
                            for j in range(k)], dim=-1)
        best = torch.minimum(best, (mass - top_p).abs().amin(dim=-1))
        ok = mass >= top_p
        lo, hi = (torch.where(ok, ts, lo[:, None]).amax(-1),
                  torch.where(ok, hi[:, None], ts).amin(-1))
    return best.numpy()


def _kv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 4.0, shape[:-1] + (1,))).astype(dtype)
    x[0, 0, 0] = 0.0  # an all-zero head vector: the scale floor
    x[0, 0, 1, :3] = [127.0, -63.5, 0.5]  # exact halves after the division
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_position_is_bit_equal_to_jax(dtype):
    """[B, K, S, hd] in the port's layout against JAX's [B, K, hd, S]: int8
    values and f32 scales identical, bf16 inputs included."""
    x = torch.from_numpy(_kv((3, 2, 40, 16), seed=1)).to(dtype)
    q8, s = tattn.quantize_kv_position(x)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                              else jnp.float32)
    jq8, js = j_quantize_kv_position(jnp.swapaxes(jx, 2, 3))
    np.testing.assert_array_equal(q8.numpy(), np.swapaxes(np.asarray(jq8), 2, 3))
    np.testing.assert_array_equal(s.numpy(), np.swapaxes(np.asarray(js), 2, 3))
    assert q8.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q8.abs().max()) == 127 and float(s.min()) == float(np.float32(1e-8))


@pytest.mark.parametrize("sq", [1, 5])
def test_attention_cached_quant_matches_jax(sq):
    """GQA (8 query heads over 2 kv heads), a causal-and-padding mask over
    a 24-position window, Sq 1 (decode) and 5 (a prefill block)."""
    rng = np.random.default_rng(2)
    b, h, kh, d, sk = 2, 8, 2, 16, 24
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, kh, sk, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, kh, sk, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (b, kh, sk, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (b, kh, sk, 1)).astype(np.float32)
    valid = np.ones((b, sk), np.int32)
    valid[1, :4] = 0
    off = sk - sq - 3
    mask = np.asarray(j_causal_padding_mask(jnp.asarray(valid), sq, off))
    want = np.asarray(j_attention_cached_quant(
        jnp.asarray(q), jnp.swapaxes(jnp.asarray(k8), 2, 3), jnp.swapaxes(jnp.asarray(ks), 2, 3),
        jnp.swapaxes(jnp.asarray(v8), 2, 3), jnp.swapaxes(jnp.asarray(vs), 2, 3),
        jnp.asarray(mask)))
    got = tattn.attention_cached_quant(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(ks),
        torch.from_numpy(v8), torch.from_numpy(vs), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("lengths,n", [([5, 8, 3], 2), ([12, 0, 9, 16], 3)])
def test_dense_engine_with_int8_cache_matches_jax(weights, lengths, n):
    """The dense engine with ``kv_quant="int8"`` (an empty prompt included):
    greedy tokens and lengths exactly, logprobs within LOGP_ATOL."""
    p, t = 16, 10
    ids, mask = _prompts(lengths, p)
    jeng, teng = _engines(weights, p=p, t=t, kv_quant="int8")
    assert teng.kv_quant == "int8"
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    plain = _engines(weights, p=p, t=t)[1]
    bf = plain.generate(weights["model"], weights["lora"], ids, mask,
                        SamplingConfig(max_tokens=t, temperature=0.0, n=n), 0)
    assert np.abs(tres.logprobs - bf.logprobs).max() > 0  # the int8 cache did run
    with pytest.raises(ValueError, match="kv_quant"):
        _engines(weights, p=p, t=t, kv_quant="fp8")


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.95, 1.0])
def test_bisect_multiway_keeps_the_set_jax_keeps(top_p):
    """The multiway filter's kept columns equal JAX's
    ``top_p_filter_bisect_multiway`` on peaked and flat rows (152 columns
    and a Qwen-sized vocabulary), and its kept mass reaches top_p."""
    rng = np.random.default_rng(4)
    for v, scale in ((152, 3.0), (152064, 1.0)):
        lg = (scale * rng.standard_normal((4, v))).astype(np.float32)
        want = np.asarray(jsampling.top_p_filter_bisect_multiway(jnp.asarray(lg), top_p))
        got = tsampling.top_p_filter_bisect_multiway(torch.from_numpy(lg), top_p).numpy()
        differs = ((got > -1e29) != (want > -1e29)).any(axis=-1)
        near = _closest_decision(lg, top_p) < MASS_ATOL
        assert not (differs & ~near).any(), (v, top_p, differs, near)
        if v == 152:
            assert not differs.any()
        np.testing.assert_array_equal(got[got > -1e29], lg[got > -1e29])
        probs = jax.nn.softmax(jnp.asarray(lg), axis=-1)
        assert (np.asarray(jnp.where(want > -1e29, probs, 0).sum(-1)) >= top_p - 1e-6).all()


def test_bisect_multiway_sampling_routes_as_jax_does(weights):
    """On a CPU tensor "bisect_mw" runs the multi-pass sample with the
    multiway filter (the JAX package's dispatch off its accelerator); its
    greedy engine round equals the default filter's (greedy ignores the
    filter)."""
    p, t, n = 16, 8, 2
    ids, mask = _prompts([5, 8, 3], p)
    _, teng = _engines(weights, p=p, t=t)
    greedy = teng.generate(weights["model"], weights["lora"], ids, mask,
                           SamplingConfig(max_tokens=t, temperature=0.0, n=n), 0)
    mw = teng.generate(weights["model"], weights["lora"], ids, mask,
                       SamplingConfig(max_tokens=t, temperature=0.0, n=n,
                                      top_p_impl="bisect_mw"), 0)
    np.testing.assert_array_equal(mw.tokens, greedy.tokens)
    lg = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 300)).astype(np.float32))
    seeds = torch.arange(3, dtype=torch.int32)
    tok, _ = tsampling.sample_with_logprob(lg, 0.8, 0.9, seeds, top_p_impl="bisect_mw")
    np.testing.assert_array_equal(
        tok.numpy(), tsampling.sample(lg, 0.8, 0.9, seeds, top_p_impl="bisect_mw").numpy())
