"""K4's plain version (``ops/flash_attention.py::flash_attention_reference``)
against the JAX package's attention oracle, on the CPU.

The oracle is ``ops/attention.py::attention_reference`` with
``causal_padding_mask``: what ``attention(..., impl="flash"|"splash")``
computes on a JAX CPU backend (the splash interpreter parity fails on this
jaxlib and flash needs the TPU backend). The inputs are made with numpy from
a seed and fed to both packages in f32.

* Outputs on rows with a valid key within ``OUT_ATOL`` (f32 sums over at
  most 70 keys x hd 256 in another order); bf16 cases (head_dim 256) add
  one bf16 rounding, ``BF16_REL``. A row with no valid key is 0 in
  the port and a uniform average in the oracle; it is compared only for
  being 0 and finite.
* dq, dk, dv from ``torch.autograd`` against ``jax.grad`` of a random
  projection of the output that is 0 on rows with no valid key (the loss
  never reads them): ``GRAD_RTOL`` relative, with ``GRAD_ATOL`` absolute
  for elements that cancel to near 0 (dk sums S·G·hd f32 terms of order
  1, ~3e4 at the Qwen heads, so its rounding reaches ~1e-6 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.ops.attention import attention_reference as j_attention
from distrl_llm_tpu.ops.attention import causal_padding_mask as j_mask
from distrl_llm_tpu_torch.ops import flash_attention as fa
from distrl_llm_tpu_torch.ops.attention import attention

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-5

# (name, B, S, H, K, hd, key-validity pattern[, dtype]): f32 unless named;
# the Gemma cases at head_dim 256, Gemma-2B's 8 / 1 heads and 2 / 1
CASES = (
    ("tiny_left_pad", 3, 9, 4, 2, 16, "left"),
    ("qwen_heads_prompt_answer", 2, 37, 28, 4, 128, "prompt_answer"),
    ("qwen_heads_s1", 3, 1, 28, 4, 128, "left"),
    ("tiny_all_valid", 2, 70, 4, 2, 16, "all"),
    ("tiny_right_pad_non_tile", 2, 67, 4, 1, 32, "right"),
    ("gemma_heads_prompt_answer", 2, 37, 8, 1, 256, "prompt_answer"),
    ("gemma_2_1_left_pad", 3, 20, 2, 1, 256, "left"),
    ("gemma_heads_prompt_answer_bf16", 2, 37, 8, 1, 256, "prompt_answer", "bfloat16"),
    ("gemma_2_1_left_pad_bf16", 3, 20, 2, 1, 256, "left", "bfloat16"),
)
# bf16 cases: the inputs rounded to bf16 go to the JAX oracle in f32; the
# plain version computes in f32 and rounds its result once to bf16, so the
# two differ by the tolerances above plus one bf16 rounding (2^-8 of a value)
BF16_REL = 2.0**-8


def _valid(b, s, pattern):
    v = np.ones((b, s), np.int32)
    if pattern == "left":  # row r has r·s/(b+1) leading pads; row 0 none
        for r in range(b):
            v[r, : (r * s) // (b + 1)] = 0
        if s == 1:
            v[-1] = 0  # an empty row
    elif pattern == "right":
        for r in range(b):
            v[r, s - (r + 1) * s // (b + 2):] = 0
    elif pattern == "prompt_answer":  # left-padded prompt, right-padded answer
        p = s // 2
        for r in range(b):
            plen = [p, 3][r % 2]
            alen = [s - p, 0][r % 2]
            v[r, : p - plen] = 0
            v[r, p + alen:] = 0
    return v


def _dtype(case):
    return getattr(torch, case[7]) if len(case) > 7 else torch.float32


def _inputs(case, seed=0):
    _, b, s, h, kh, d, pattern = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    valid = _valid(b, s, pattern)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    if _dtype(case) == torch.bfloat16:  # the values bf16 holds
        q, k, v, w = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v, w))
    return q, k, v, valid, w


def _has_key(valid):
    """[B, S] bool: query i has some valid key j <= i."""
    return np.cumsum(valid, axis=1) > 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_matches_jax_reference(case):
    q, k, v, valid, _ = _inputs(case)
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  j_mask(jnp.asarray(valid), q_len=q.shape[1])))
    dtype = _dtype(case)
    got = fa.flash_attention_reference(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                       torch.from_numpy(valid))
    assert got.dtype == dtype
    got = got.float().numpy()
    rows = _has_key(valid)
    np.testing.assert_allclose(got[rows], want[rows], atol=OUT_ATOL,
                               rtol=BF16_REL if dtype == torch.bfloat16 else 0)
    assert np.isfinite(got).all()
    assert (got[~rows] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_grads_match_jax(case):
    q, k, v, valid, w = _inputs(case, seed=1)
    w = w * _has_key(valid)[:, :, None, None]  # the loss never reads keyless rows
    mask = j_mask(jnp.asarray(valid), q_len=q.shape[1])

    def jloss(q_, k_, v_):
        return (j_attention(q_, k_, v_, mask) * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dtype = _dtype(case)
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention_reference(tq, tk, tv, torch.from_numpy(valid))
    out.backward(torch.from_numpy(w).to(dtype))  # d(sum(out * w)) / d out = w
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                                   rtol=BF16_REL if dtype == torch.bfloat16 else GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_rows_without_a_valid_key_are_zero_with_finite_grads():
    """All-pad rows and left-pad positions: out exactly 0, every grad
    finite, and a loss that reads only those rows gives exactly 0 grads."""
    b, s, h, kh, d = 2, 6, 4, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .requires_grad_(True) for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    valid = torch.tensor([[0] * s, [0, 0, 0, 1, 1, 1]], dtype=torch.int32)
    out = fa.flash_attention(q, k, v, valid)
    assert (out[0] == 0).all() and (out[1, :3] == 0).all()
    assert bool((out[1, 3:] != 0).any())
    keyless = torch.zeros((b, s, 1, 1))
    keyless[0] = 1
    keyless[1, :3] = 1
    (out * keyless).sum().backward()
    for g in (q.grad, k.grad, v.grad):
        assert torch.isfinite(g).all() and (g == 0).all()


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    case = CASES[1]
    q, k, v, valid, _ = _inputs(case, seed=2)
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    before = (fa.flash_attention_fwd_launches, fa.flash_attention_bwd_launches)
    want = fa.flash_attention_reference(*args, scale=0.3)
    assert torch.equal(fa.flash_attention(*args, scale=0.3), want)
    for impl in ("flash", "splash"):
        assert torch.equal(attention(args[0], args[1], args[2], None, scale=0.3, impl=impl,
                                     key_valid=args[3]), want)
    assert (fa.flash_attention_fwd_launches, fa.flash_attention_bwd_launches) == before
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention(*args[:3], None, impl="ring", key_valid=args[3])


def test_bf16_inputs_keep_their_dtype_and_track_f32():
    q, k, v, valid, _ = _inputs(CASES[0], seed=4)
    args16 = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out16 = fa.flash_attention(*args16, torch.from_numpy(valid))
    out32 = fa.flash_attention(*(x.float() for x in args16), torch.from_numpy(valid))
    assert out16.dtype == torch.bfloat16
    # one rounding of the f32 result: within one bf16 ulp of it
    err = (out16.float() - out32).abs()
    assert bool((err <= out32.abs() * 2.0**-8 + 1e-30).all())


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "heads", "dtype", "valid_shape",
                                 "head_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The argument checks (every device), and the head dims the kernel is
    built for, which a CUDA tensor meets before a launch (96 is not one)."""
    q = torch.zeros((1, 4, 4, 16))
    k = v = torch.zeros((1, 4, 2, 16))
    valid = torch.ones((1, 4), dtype=torch.int32)
    if bad == "head_dim":
        for d in fa.KERNEL_HEAD_DIMS:
            fa.check_kernel_domain(torch.zeros((1, 4, 4, d)))
        with pytest.raises(ValueError, match="head_dim in"):
            fa.check_kernel_domain(torch.zeros((1, 4, 4, 96)))
        return
    args = {"rank": (q[0], k, v, valid), "kv_shape": (q, k[:, :3], v[:, :3], valid),
            "heads": (q[:, :, :3], k, v, valid),
            "dtype": (q, k.double(), v.double(), valid),
            "valid_shape": (q, k, v, valid[:, :3])}[bad]
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(*args)
