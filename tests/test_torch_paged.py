"""Parity of the port's paged-KV ops (``ops/paged.py``) and of the plain
version of kernel K2 (``ops/paged_native.py``) with the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
Pallas launches run in interpret mode on the CPU, as the JAX package's own
tests run them. Page writes and int8 quantization must agree exactly;
attention within ``ATOL`` (f32 sums over head_dim <= 128 and a few hundred
positions, taken in another order).
"""

import ctypes
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.paged_attention import paged_attention as jaxlib_paged_attention
from jax.experimental.pallas.ops.tpu.paged_attention import quantization_utils as qu

from distrl_llm_tpu.ops import paged as jpaged
from distrl_llm_tpu.ops import paged_native as jnative
from distrl_llm_tpu.ops.paged_int8 import paged_attention_gqa, paged_attention_int8
from distrl_llm_tpu_torch.ops import paged as tpaged
from distrl_llm_tpu_torch.ops import paged_native as tnative
from pallas_env import pallas_env_marks

ATOL = 1e-5
# the jaxlib kernel's own matmuls in TPU interpret mode carry ~1e-3 error on
# unit-scale f32 inputs (the JAX package holds this launch to 2e-3 on
# 0.3-scaled pages: tests/test_paged_int8_kernel.py); its int8 path agrees
# with the exact reference to ~1e-6
JAXLIB_F32_ATOL = 2e-3
PS = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _pages(rng, kh, total, ps, hd, scale=1.0):
    return (scale * rng.standard_normal((kh, total, ps, hd))).astype(np.float32)


def _jq(w, s):
    return qu.QuantizedTensor(weight=jnp.asarray(w), scales=jnp.asarray(s))


def _tq(w, s):
    return tpaged.QuantizedPages(weight=_t(w), scales=_t(s))


def _as_np(pages):
    if isinstance(pages, (tpaged.QuantizedPages, qu.QuantizedTensor)):
        return np.asarray(pages.weight), np.asarray(pages.scales)
    return (np.asarray(pages),)


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("rows,max_len,ps", [(3, 20, 8), (2, 16, 8), (1, 1, 128),
                                             (4, 350, 128)])
def test_page_table_matches_jax(rows, max_len, ps):
    assert tpaged.pages_per_seq(max_len, ps) == jpaged.pages_per_seq(max_len, ps)
    np.testing.assert_array_equal(tpaged.make_page_table(rows, max_len, ps),
                                  jpaged.make_page_table(rows, max_len, ps))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_init_paged_kv_cache_matches_jax_layout(quant):
    from distrl_llm_tpu.models.configs import TINY

    from distrl_llm_tpu_torch.models.configs import TINY as TTINY

    tc = tpaged.init_paged_kv_cache(TTINY, 3, 20, PS, dtype=torch.float32,
                                    device="cpu", kv_quant=quant)
    jc = jpaged.init_paged_kv_cache(TINY, 3, 20, PS, dtype=jnp.float32)
    assert len(tc["k"]) == len(jc["k"]) == TINY.num_layers
    if quant == "int8":
        want = jpaged.init_quantized_pages(jc["k"][0].shape)
        assert tc["k"][0].weight.shape == want.weight.shape
        assert tc["k"][0].scales.shape == want.scales.shape
        assert tc["v"][1].weight.dtype == torch.int8
        assert tc["v"][1].scales.dtype == torch.float32
    else:
        assert tuple(tc["v"][1].shape) == jc["v"][1].shape


# ---------------------------------------------------------------- int8


def _quant_vectors(rng):
    """Rows whose absmax element lands at exactly +127.5 or -127.5 (h = 1 or
    0.5, so 127.5 / h is exact), an all-zero row (zero scale: 0 · inf = NaN),
    and random rows."""
    fixed = np.array([
        [1.0, 0.3, -0.2, 0.7, 0.1, -0.9, 0.0, 0.5],
        [-1.0, 0.5, 0.25, -0.5, 0.75, 0.125, -0.375, 0.0],
        [0.5, -0.25, 0.125, 0.3, -0.4, 0.2, 0.1, -0.1],
        [-0.5, 0.25, 0.5, -0.25, 0.0, 0.1, 0.2, 0.3],
        np.zeros(8),
    ], np.float32)
    return np.concatenate([fixed, rng.standard_normal((11, 8)).astype(np.float32)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_int8_saturates_like_jax_at_absmax_and_zero_scale(dtype):
    """+127.5 rounds to 128 and saturates to 127 (a plain cast would wrap it
    to -128); -127.5 rounds to -128; a zero scale gives 0, not garbage. In
    bf16 too, where the product is rounded to bf16 before the rint."""
    x = _quant_vectors(np.random.default_rng(0))
    jx = jnp.asarray(x, dtype)
    jw = np.asarray(qu.to_int8(jx, qu.get_quantization_scales(jx)))
    tx = _t(x).to(getattr(torch, dtype))
    tw = tpaged.to_int8(tx, tpaged.get_quantization_scales(tx)).numpy()
    np.testing.assert_array_equal(tw, jw)
    assert tw.dtype == np.int8
    assert tw[0, 0] == 127 and tw[2, 0] == 127  # +127.5 → 128 → 127
    assert tw[1, 0] == -128 and tw[3, 0] == -128  # -127.5 → -128 fits
    assert (tw[4] == 0).all()
    np.testing.assert_array_equal(
        tpaged.get_quantization_scales(tx).float().numpy(),
        np.asarray(qu.get_quantization_scales(jx), np.float32))


def test_quantize_pages_matches_jax():
    rng = np.random.default_rng(1)
    pages = _pages(rng, 2, 5, PS, 16)
    pages[0, 1, 3] = 0.0  # a zero token: scale 0
    pages[1, 2, 0, 4] = -np.abs(pages[1, 2, 0]).max() - 1.0  # a negative absmax
    jq = jpaged.quantize_pages(jnp.asarray(pages))
    tq = tpaged.quantize_pages(_t(pages))
    np.testing.assert_array_equal(tq.weight.numpy(), np.asarray(jq.weight))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_allclose(tpaged.dequantize_pages(tq).numpy(),
                               np.asarray(jpaged.dequantize_pages(jq)), atol=0, rtol=0)


# ---------------------------------------------------------------- writes


def _pool(rng, quant, kh=2, total=12, hd=8):
    pages = _pages(rng, kh, total, PS, hd)
    if quant == "int8":
        q = jpaged.quantize_pages(jnp.asarray(pages))
        w, s = np.asarray(q.weight), np.asarray(q.scales)
        return _jq(w, s), _tq(w, s)
    return jnp.asarray(pages), _t(pages)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_prompt_write_matches_jax(quant):
    rng = np.random.default_rng(2)
    b, p, kh, hd = 3, 16, 2, 8
    jpool, tpool = _pool(rng, quant)
    table = rng.permutation(12)[:b * 2].reshape(b, 2).astype(np.int32)  # not identity
    kv = rng.standard_normal((b, p, kh, hd)).astype(np.float32)
    want = jpaged.write_prompt_to_pages(jpool, jnp.asarray(kv), jnp.asarray(table), PS)
    got = tpaged.write_prompt_to_pages(tpool, _t(kv), _t(table), PS)
    assert got is tpool  # written in place
    for g, w in zip(_as_np(got), _as_np(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_token_write_matches_jax(quant, with_valid):
    rng = np.random.default_rng(3)
    b, kh, hd = 4, 2, 8
    jpool, tpool = _pool(rng, quant)
    table = jpaged.make_page_table(b, 24, PS)  # 3 pages per row, 12 in all
    lengths = np.array([0, 9, 17, 23], np.int32)
    new = rng.standard_normal((b, kh, hd)).astype(np.float32)
    valid = np.array([True, False, True, True]) if with_valid else None
    want = jpaged.write_token_to_pages(
        jpool, jnp.asarray(new), jnp.asarray(lengths), jnp.asarray(table), PS,
        valid=jnp.asarray(valid) if with_valid else None)
    before = [a.copy() for a in _as_np(tpool)]
    got = tpaged.write_token_to_pages(tpool, _t(new), _t(lengths), _t(table), PS,
                                      valid=_t(valid) if with_valid else None)
    for g, w in zip(_as_np(got), _as_np(want)):
        np.testing.assert_array_equal(g, w)
    if with_valid:  # row 1's slot (page 4, slot 1) kept its old content
        for g, old in zip(_as_np(got), before):
            np.testing.assert_array_equal(g[:, 4, 1], old[:, 4, 1])


def test_gather_pages_dense_matches_jax():
    rng = np.random.default_rng(4)
    jpool, tpool = _pool(rng, "int8")
    table = rng.integers(0, 12, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tpaged.gather_pages_dense(tpool, _t(table)).numpy(),
        np.asarray(jpaged.gather_pages_dense(jpool, jnp.asarray(table))))


# ---------------------------------------------------------------- attention


def _attn_case(rng, *, b, h, kh, hd, pps, lengths, quant, scale=1.0):
    """Pages, q and a scrambled page table; entries past each row's needed
    pages are garbage (huge or negative), which every launch must clip and
    never let into the output."""
    total = b * pps + 3
    kp, vp = _pages(rng, kh, total, PS, hd, scale), _pages(rng, kh, total, PS, hd, scale)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    table = rng.permutation(total)[:b * pps].reshape(b, pps).astype(np.int32)
    for r, n in enumerate(lengths):
        table[r, -(-n // PS):] = [10**6, -7][r % 2]
    lengths = np.asarray(lengths, np.int32)
    if quant == "int8":
        kq = jpaged.quantize_pages(jnp.asarray(kp))
        vq = jpaged.quantize_pages(jnp.asarray(vp))
        kp = (np.asarray(kq.weight), np.asarray(kq.scales))
        vp = (np.asarray(vq.weight), np.asarray(vq.scales))
    return q, kp, vp, lengths, table


def _j(pages):
    return _jq(*pages) if isinstance(pages, tuple) else jnp.asarray(pages)


def _tt(pages):
    return _tq(*pages) if isinstance(pages, tuple) else _t(pages)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_attention_reference_matches_jax(quant):
    rng = np.random.default_rng(5)
    q, kp, vp, lengths, table = _attn_case(rng, b=4, h=14, kh=2, hd=64, pps=3,
                                           lengths=[5, 24, 13, 1], quant=quant)
    table = np.clip(table, 0, 4 * 3 + 2)  # the gather reference takes in-range tables
    want = jpaged.paged_attention_reference(
        jnp.asarray(q), _j(kp), _j(vp), jnp.asarray(lengths), jnp.asarray(table))
    got = tpaged.paged_attention_reference(_t(q), _tt(kp), _tt(vp), _t(lengths), _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


JAX_LAUNCHES = {
    "native": jnative.paged_attention_native,
    "folded": jnative.paged_attention_native_folded,
    "blocked1": functools.partial(jnative.paged_attention_native_blocked, pages_per_block=1),
    "blocked3": functools.partial(jnative.paged_attention_native_blocked, pages_per_block=3),
    "blocked8": functools.partial(jnative.paged_attention_native_blocked, pages_per_block=8),
}
GEOMETRIES = {"hd64": (14, 2, 64), "hd128": (28, 4, 128)}


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("launch", sorted(JAX_LAUNCHES))
def test_plain_k2_matches_each_native_tpu_launch(launch, geom, quant):
    """Ragged lengths (a length-0 row, one token, a partial last page, a
    full table), garbage table entries past the length, 5 pages per row
    (blocked3 leaves a non-divisor tail; blocked8 clamps to 5)."""
    h, kh, hd = GEOMETRIES[geom]
    rng = np.random.default_rng(6)
    q, kp, vp, lengths, table = _attn_case(rng, b=4, h=h, kh=kh, hd=hd, pps=5,
                                           lengths=[0, 1, 17, 40], quant=quant)
    qs = (q * hd**-0.5).astype(np.float32)  # the op's pre-scale
    scales = {}
    if quant == "int8":
        (kw, ks), (vw, vs) = kp, vp
        kp, vp, scales = kw, vw, {"k_scales": ks, "v_scales": vs}
    want = JAX_LAUNCHES[launch](
        jnp.asarray(qs), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(table), **{k: jnp.asarray(v) for k, v in scales.items()},
        interpret=True)
    ppb = int(launch[len("blocked"):]) if launch.startswith("blocked") else 8
    got = tnative.paged_attention_native(
        _t(qs), _t(kp), _t(vp), _t(lengths), _t(table),
        **{k: _t(v) for k, v in scales.items()}, pages_per_block=ppb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[0] == 0).all()  # length 0: exactly zero, never NaN
    assert tnative.paged_attention_launches == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_plain_k2_matches_the_jaxlib_kernel_k6_at_hd128(quant):
    """K6: the jaxlib paged flash-attention kernel that
    ``ops/paged_int8.py`` launches, here through jaxlib's own wrapper in
    TPU interpret mode, at Qwen2.5-7B's head geometry (28 / 4, hd 128).
    Lengths >= 1 (the jaxlib kernel leaves a length-0 row unwritten)."""
    rng = np.random.default_rng(7)
    b, pps = 3, 4
    q, kp, vp, lengths, table = _attn_case(rng, b=b, h=28, kh=4, hd=128, pps=pps,
                                           lengths=[1, 19, 32], quant=quant, scale=0.3)
    table = np.clip(table, 0, b * pps + 2)  # jaxlib's DMA takes in-range ids
    qs = (q * 128**-0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jaxlib_paged_attention(jnp.asarray(qs), _j(kp), _j(vp), jnp.asarray(lengths),
                                      jnp.asarray(table), pages_per_compute_block=2)
    got = tpaged.paged_attention_op(_t(q), _tt(kp), _tt(vp), _t(lengths), _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL if quant == "int8" else JAXLIB_F32_ATOL, rtol=0)


def _probe_paged_int8_launch():
    q, kp, vp, lengths, table = _attn_case(np.random.default_rng(0), b=1, h=2, kh=1,
                                           hd=128, pps=2, lengths=[3], quant="none")
    jax.eval_shape(lambda: paged_attention_gqa(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(np.clip(table, 0, 4)), pages_per_compute_block=2, interpret=True))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_plain_k2_matches_paged_int8_launches(quant):
    """K6 against the JAX package's own corrected launches, where this
    jaxlib can trace them (``pallas_env`` names the drift when it cannot)."""
    for mark in pallas_env_marks(_probe_paged_int8_launch, "ops/paged_int8.py launch"):
        if mark.name == "skip":
            pytest.skip(mark.kwargs["reason"])
    rng = np.random.default_rng(8)
    q, kp, vp, lengths, table = _attn_case(rng, b=3, h=28, kh=4, hd=128, pps=4,
                                           lengths=[1, 19, 32], quant=quant, scale=0.3)
    table = np.clip(table, 0, 3 * 4 + 2)
    qs = jnp.asarray((q * 128**-0.5).astype(np.float32))
    launch = paged_attention_int8 if quant == "int8" else paged_attention_gqa
    want = launch(qs, _j(kp), _j(vp), jnp.asarray(lengths), jnp.asarray(table),
                  pages_per_compute_block=2, interpret=True)
    got = tpaged.paged_attention_op(_t(q), _tt(kp), _tt(vp), _t(lengths), _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAXLIB_F32_ATOL, rtol=0)


# ---------------------------------------------------------------- the op


def test_paged_attention_op_dispatch():
    """The op pre-scales q in its own dtype and runs K2 (its plain version
    on the CPU, no launch counted); it agrees with the gather reference and
    its output keeps q's dtype."""
    rng = np.random.default_rng(9)
    q, kp, vp, lengths, table = _attn_case(rng, b=3, h=4, kh=2, hd=16, pps=3,
                                           lengths=[3, 24, 9], quant="none")
    table = np.clip(table, 0, 11)
    args = (_t(kp), _t(vp), _t(lengths), _t(table))
    ref = tpaged.paged_attention_reference(_t(q), *args)
    plain = tnative.paged_attention_native(_t(q) * 16**-0.5, *args)
    got = tpaged.paged_attention_op(_t(q), *args)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    bf = tpaged.paged_attention_op(_t(q).bfloat16(), *args)
    assert bf.dtype == torch.bfloat16
    assert tnative.paged_attention_launches == 0


def test_unported_paged_ops_raise_naming_roadmap():
    """The multi-token writes, the chunked context attention and the verify
    ops are ported (their parity cases are in test_torch_verify.py), and so
    is the warm (radix-hit) suffix prefill (tests/test_torch_prefix_cache.py):
    its forward takes a table with one trailing scratch column, whose gather
    drops that column; a table without it is no packed window and cannot
    be attended as one."""
    from distrl_llm_tpu_torch.models.configs import TINY as TTINY
    from distrl_llm_tpu_torch.models.transformer import Decoder

    for fn in (tpaged.write_tokens_to_pages, tpaged.chunked_context_attention,
               tpaged.paged_verify_reference, tpaged.paged_verify_op):
        with pytest.raises(TypeError):  # real signatures now, no catch-all stub
            fn()
    cache = tpaged.init_paged_kv_cache(TTINY, 1, 8, 4, dtype=torch.float32)
    cache.update(lengths=torch.zeros((1,), dtype=torch.int32),
                 page_indices=torch.as_tensor(tpaged.make_page_table(1, 8, 4)))
    model = Decoder(TTINY)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    ext = torch.cat([cache["page_indices"], cache["page_indices"][:, -1:]], dim=1)
    logits, _ = model(torch.ones((1, 8), dtype=torch.int32), page_size=4, paged_prefix=True,
                      kv_cache={**cache, "page_indices": ext})
    assert logits.shape == (1, 8, TTINY.vocab_size) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="exclude"):
        model(torch.ones((1, 2), dtype=torch.int32), kv_cache=cache, page_size=4,
              paged_prefix=True, paged_chunked=True)


def test_kernel_wrapper_checks_its_inputs():
    rng = np.random.default_rng(10)
    q, kp, vp, lengths, table = _attn_case(rng, b=2, h=4, kh=2, hd=16, pps=2,
                                           lengths=[3, 9], quant="none")
    table = np.clip(table, 0, 6)
    good = dict(q=_t(q), k_pages=_t(kp), v_pages=_t(vp), lengths=_t(lengths),
                page_indices=_t(table))
    bad = {
        "q dtype": dict(good, q=_t(q).half()),
        "lengths dtype": dict(good, lengths=_t(lengths).long()),
        "heads": dict(good, q=_t(q)[:, :3].contiguous()),
        "int8 without scales": dict(good, k_pages=_t(kp).to(torch.int8),
                                    v_pages=_t(vp).to(torch.int8)),
        "scales on float pages": dict(good, k_scales=torch.ones(2, 7, PS, 1),
                                      v_scales=torch.ones(2, 7, PS, 1)),
        "not contiguous": dict(good, page_indices=_t(table).t().contiguous().t()),
    }
    for what, kw in bad.items():
        with pytest.raises((ValueError, TypeError)):
            tnative.paged_attention_native(**kw)
            pytest.fail(what)
    with pytest.raises(ValueError, match="pages_per_block"):
        tnative.paged_attention_native(**good, pages_per_block=0)


def test_kernel_geometry_limits():
    """What the kernels take (csrc/paged_common.cuh): any number of query
    rows (up to 64 a block, more in row tiles, each block's shared memory
    within the card), a head_dim >= 8 whose page rows are a multiple of 16
    bytes, any page size. bf16 q over bf16 or int8
    pages at head_dim 64 or 128 takes the tensor cores, the rest the CUDA
    cores; the main path's geometry fits at every pages_per_block (which
    the kernel ignores) and the exact shared memory of each ring."""
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    assert tnative._check_kernel_geometry(7, 128, bf, bf) == "mma"  # K2, Qwen2.5-7B
    assert tnative._check_kernel_geometry(7, 128, bf, i8) == "mma"
    assert tnative._check_kernel_geometry(35, 128, bf, bf) == "mma"  # K5 at d = 4
    assert tnative._check_kernel_geometry(7, 64, bf, i8) == "mma"  # Qwen2.5-0.5B
    assert tnative._check_kernel_geometry(7, 128, f32, f32) == "cuda_cores"
    assert tnative._check_kernel_geometry(7, 128, bf, f32) == "cuda_cores"
    assert tnative._check_kernel_geometry(10, 16, f32, f32) == "cuda_cores"  # TINY, S 5
    assert tnative._check_kernel_geometry(2, 16, bf, i8) == "cuda_cores"
    assert tnative._check_kernel_geometry(8, 256, bf, bf) == "cuda_cores"  # gemma
    # past 64 rows, or past the shared memory of one block, row tiles
    assert tnative._check_kernel_geometry(65, 128, bf, bf) == "mma"
    assert tnative.plan_row_tiles(65, 128, bf, bf) == tnative.RowTiles(2, 33)
    assert tnative._check_kernel_geometry(64, 256, f32, f32) == "cuda_cores"
    assert tnative.plan_row_tiles(64, 256, f32, f32) == tnative.RowTiles(2, 32)
    with pytest.raises(ValueError, match="query row"):
        tnative._check_kernel_geometry(0, 128, bf, bf)
    with pytest.raises(ValueError, match="head_dim"):
        tnative._check_kernel_geometry(7, 4, f32, f32)
    with pytest.raises(ValueError, match="head_dim"):
        tnative._check_kernel_geometry(7, 24, bf, i8)  # 24-byte rows
    with pytest.raises(ValueError, match="shared memory"):  # one f32 row of 8 KB pages
        tnative._check_kernel_geometry(1, 2048, f32, f32)
    # tensor cores: bf16 q [16, 128], 2 stages of bf16 K and V [64, 128], the
    # m and l of 4 warps and of the block (three blocks an SM)
    assert tnative.smem_bytes(7, 128, bf, bf) == 4096 + 2 * 32768 + 512 + 128
    # int8: 2 stages of int8 K and V and their scales, the bf16 work tiles
    assert tnative.smem_bytes(7, 128, bf, i8) == 4096 + 2 * (16384 + 512) + 32768 + 512 + 128
    # 9-16 rows: 3 stages
    assert tnative.smem_bytes(14, 128, bf, bf) == 4096 + 3 * 32768 + 512 + 128
    # K5: 3 m-tiles of q, 2 stages of 128 positions, 12 warps
    assert tnative.smem_bytes(35, 128, bf, bf) == 12288 + 2 * 65536 + 1536 + 384
    # CUDA cores: 2 stages of 32 padded f32 rows of K and V, then f32 q, acc,
    # p and m / l / alpha / limit of 7 rows
    assert tnative.smem_bytes(7, 128, f32, f32) == 2 * 2 * 32 * 528 + 4 * 7 * (256 + 32 + 4)
    rng = np.random.default_rng(11)
    q, kp, vp, lengths, table = _attn_case(rng, b=2, h=4, kh=2, hd=16, pps=2,
                                           lengths=[3, 9], quant="none")
    want = tnative.paged_attention_native(_t(q), _t(kp), _t(vp), _t(lengths), _t(table))
    for ppb in (1, 3, 8):
        got = tnative.paged_attention_native(_t(q), _t(kp), _t(vp), _t(lengths), _t(table),
                                             pages_per_block=ppb)
        assert torch.equal(got, want)


def test_paged_kernel_wrapper_signature_matches_the_c_launcher(monkeypatch):
    """Every pointer crosses ctypes as c_void_p and the argument count
    matches the C declaration."""
    from distrl_llm_tpu_torch.ops import _build

    src = (Path(tnative.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    decl = re.search(r"int paged_attention_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in decl.split(",")]

    class Fn:
        argtypes = None
        restype = None

    lib = type("Lib", (), {"paged_attention_launch": Fn(),
                           "paged_attention_error_string": Fn()})()
    monkeypatch.setattr(_build, "load", lambda name: type("B", (), {"lib": lib}))
    got = tnative._kernel_lib.__wrapped__().paged_attention_launch.argtypes
    assert len(got) == len(params) == 23  # 9 pointers, 13 ints (row_tiles among them), the stream
    for c_param, ct in zip(params, got):
        assert ct is (ctypes.c_void_p if "*" in c_param else ctypes.c_int), c_param


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_forward_matches_jax(quant):
    """``Decoder.forward`` over a paged cache against the JAX ``forward``: a
    packed prefill (prompt pages written, self-attention over the input,
    per-row ``logits_positions``), then three decode steps at per-row
    positions that write at ``lengths`` and attend over ``lengths + 1``."""
    import dataclasses

    from distrl_llm_tpu.models import transformer as jtf
    from distrl_llm_tpu.models.configs import TINY

    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import params_from_numpy

    tree = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.PRNGKey(3), TINY))
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    model = params_from_numpy(tree, cfg, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    b, p, pps = 3, 16, 4
    real = np.array([16, 5, 9], np.int32)
    ids = rng.integers(4, TINY.vocab_size, (b, p)).astype(np.int32)
    mask = (np.arange(p)[None, :] < real[:, None]).astype(np.int32)
    ids = ids * mask
    table = jpaged.make_page_table(b, pps * PS, PS)
    shape = (TINY.num_kv_heads, b * pps, PS, TINY.head_dim)

    def pool(j):
        if quant == "int8":
            return (jpaged.init_quantized_pages(shape) if j
                    else tpaged.init_quantized_pages(shape))
        return jnp.zeros(shape, jnp.float32) if j else torch.zeros(shape)

    jc = {"k": tuple(pool(1) for _ in range(2)), "v": tuple(pool(1) for _ in range(2)),
          "lengths": jnp.asarray(real), "page_indices": jnp.asarray(table)}
    tc = {"k": [pool(0) for _ in range(2)], "v": [pool(0) for _ in range(2)],
          "lengths": _t(real), "page_indices": _t(table)}
    pos = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p))
    last = np.maximum(real - 1, 0)
    jlog, jc = jtf.forward(jp, TINY, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           positions=jnp.asarray(pos), kv_cache=jc, page_size=PS,
                           logits_positions=jnp.asarray(last))
    with torch.inference_mode():
        tlog, tc = model(_t(ids), attention_mask=_t(mask), positions=_t(pos), kv_cache=tc,
                         page_size=PS, logits_positions=_t(last))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
    # decode reads the pages: with int8 pages a token's absmax element sits
    # at ±127.5 up to f32 rounding and may land one step apart in the two
    # packages (-127 or -128), which moves TINY's logits by ~5e-4
    atol = 1e-3 if quant == "int8" else 1e-4
    lengths = real.copy()
    for _ in range(3):
        tok = np.asarray(jlog[:, 0]).argmax(-1).astype(np.int32)[:, None]
        jc = {**jc, "lengths": jnp.asarray(lengths)}
        tc["lengths"] = _t(lengths)
        jlog, jc = jtf.forward(jp, TINY, jnp.asarray(tok), positions=jnp.asarray(lengths[:, None]),
                               kv_cache=jc, page_size=PS, paged_impl="reference")
        with torch.inference_mode():
            tlog, tc = model(_t(tok), positions=_t(lengths[:, None]), kv_cache=tc,
                             page_size=PS)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=atol, rtol=0)
        lengths = lengths + 1
    for g, w in zip(_as_np(tc["k"][1]), _as_np(jc["k"][1])):
        if g.dtype == np.int8:  # an absmax element may round either way
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0)
