"""Parity of the port's draft-block verify (the plain version of kernel K5,
``ops/paged_native.py``; ``paged_verify_op`` and ``paged_verify_reference``,
``ops/paged.py``), its multi-token page writes and chunked context
attention, and the model's verify forward, with the JAX package.

Inputs are made with numpy from a seed. The JAX verify kernel
(``paged_attention_native_verify``) runs in interpret mode on the CPU, as
the JAX package's own tests run it. f32 attention must agree within
``ATOL`` (2e-5: sums over head_dim <= 128 and a few hundred positions in
another order); bf16 q within one bf16 ulp of the value plus ``ATOL``
(each side rounds its f32 result once); page writes bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu.ops import paged as jpaged
from distrl_llm_tpu.ops import paged_native as jnative
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import params_from_numpy
from distrl_llm_tpu_torch.ops import paged as tpaged
from distrl_llm_tpu_torch.ops import paged_native as tnative

ATOL = 2e-5
LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _setup(*, b, s, h, kh, hd, ps, pps, seed=0, lengths=None):
    """Pages of b rows of pps pages each (identity table), q [b, s, h, hd],
    and resident lengths that leave room for the s-token block."""
    rng = np.random.default_rng(seed)
    cap = pps * ps
    kp = rng.standard_normal((kh, b * pps, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((kh, b * pps, ps, hd)).astype(np.float32)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    table = tpaged.make_page_table(b, cap, ps)
    if lengths is None:
        lengths = rng.integers(1, cap - s, size=(b,))
    return q, kp, vp, np.asarray(lengths, np.int32), table


def _jax_verify(q, kp, vp, lengths, table, hd, ppb=2, scales=None):
    kw = {} if scales is None else {"k_scales": jnp.asarray(scales[0]),
                                    "v_scales": jnp.asarray(scales[1])}
    return np.asarray(jnative.paged_attention_native_verify(
        jnp.asarray(q) * hd**-0.5, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(table), pages_per_block=ppb,
        interpret=True, **kw))


def _torch_verify(q, kp, vp, lengths, table, hd, ppb=2, scales=None):
    kw = {} if scales is None else {"k_scales": _t(scales[0]), "v_scales": _t(scales[1])}
    return tnative.paged_attention_native_verify(
        (_t(q) * hd**-0.5).contiguous(), _t(kp), _t(vp), _t(lengths), _t(table),
        pages_per_block=ppb, **kw)


# the JAX package's verify geometries (GQA 14/2 hd 64 at S 4; page crossing
# at hd 32; S = 1) and Qwen2.5-7B's heads at d = 4
GEOMETRIES = [
    dict(b=3, s=4, h=14, kh=2, hd=64, ps=8, pps=5),
    dict(b=4, s=2, h=8, kh=2, hd=32, ps=4, pps=6, lengths=[3, 4, 7, 15]),
    dict(b=4, s=5, h=8, kh=2, hd=32, ps=4, pps=6, lengths=[3, 4, 7, 15]),
    dict(b=4, s=1, h=14, kh=2, hd=64, ps=8, pps=3),
    dict(b=3, s=5, h=28, kh=4, hd=128, ps=16, pps=4, lengths=[1, 17, 59]),
]


@pytest.mark.parametrize("ppb", [1, 2, 4])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"s{g['s']}h{g['h']}k{g['kh']}d{g['hd']}")
def test_plain_version_matches_the_jax_verify_kernel(geo, ppb):
    q, kp, vp, lengths, table = _setup(**geo)
    hd = geo["hd"]
    want = _jax_verify(q, kp, vp, lengths, table, hd, ppb)
    got = _torch_verify(q, kp, vp, lengths, table, hd, ppb)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = np.asarray(jpaged.paged_verify_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(table)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    tref = tpaged.paged_verify_reference(_t(q), _t(kp), _t(vp), _t(lengths), _t(table))
    np.testing.assert_allclose(tref.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("lengths", [[1, 1, 1], [27, 27, 27], [0, 13, 27]],
                         ids=["length1", "at_capacity", "mixed"])
def test_lengths_one_and_at_capacity(lengths):
    """Length 1 (one resident token), and the block ending exactly at the
    table's last position (capacity 32 = 27 resident + 5)."""
    geo = dict(b=3, s=5, h=28, kh=4, hd=128, ps=8, pps=4, lengths=lengths, seed=4)
    q, kp, vp, lens, table = _setup(**geo)
    want = _jax_verify(q, kp, vp, lens, table, 128)
    got = _torch_verify(q, kp, vp, lens, table, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.isfinite(got.numpy()).all()


def test_int8_pages_match_jax():
    geo = dict(b=3, s=5, h=28, kh=4, hd=128, ps=16, pps=3, seed=3)
    q, kp, vp, lengths, table = _setup(**geo)
    kq, vq = jpaged.quantize_pages(jnp.asarray(kp)), jpaged.quantize_pages(jnp.asarray(vp))
    w = (np.asarray(kq.weight), np.asarray(vq.weight))
    sc = (np.asarray(kq.scales), np.asarray(vq.scales))
    want = _jax_verify(q, w[0], w[1], lengths, table, 128, scales=sc)
    got = _torch_verify(q, w[0], w[1], lengths, table, 128, scales=sc)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = np.asarray(jpaged.paged_verify_reference(
        jnp.asarray(q), kq, vq, jnp.asarray(lengths), jnp.asarray(table)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_bf16_q_and_pages_match_jax_within_one_ulp():
    geo = dict(b=3, s=5, h=28, kh=4, hd=128, ps=16, pps=3, seed=5)
    q, kp, vp, lengths, table = _setup(**geo)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))  # noqa: E731
    qs = jnp.asarray(q, jnp.bfloat16) * jnp.asarray(128**-0.5, jnp.bfloat16)
    want = np.asarray(jnative.paged_attention_native_verify(
        qs, jnp.asarray(bf(kp)), jnp.asarray(bf(vp)), jnp.asarray(lengths),
        jnp.asarray(table), pages_per_block=2, interpret=True)).astype(np.float32)
    tq = _t(np.asarray(qs).astype(np.float32)).to(torch.bfloat16)
    got = tnative.paged_attention_native_verify(
        tq, _t(bf(kp).astype(np.float32)).to(torch.bfloat16),
        _t(bf(vp).astype(np.float32)).to(torch.bfloat16), _t(lengths), _t(table))
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    mag = np.maximum(np.abs(g), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert (np.abs(g - want) <= ulp + ATOL).all()


def test_verify_op_fused_equals_unrolled_and_the_reference():
    """paged_verify_op: the fused sweep (K5's plain version on the CPU) and
    the unrolled S calls of K2's plain version agree, for f32 and int8
    pools, and neither counts a launch on the CPU."""
    geo = dict(b=3, s=5, h=28, kh=4, hd=128, ps=8, pps=4, seed=6)
    q, kp, vp, lengths, table = _setup(**geo)
    before = (tnative.paged_verify_launches, tnative.paged_attention_launches)
    pools = [(_t(kp), _t(vp)), (tpaged.quantize_pages(_t(kp)), tpaged.quantize_pages(_t(vp)))]
    for k_pages, v_pages in pools:
        args = (_t(q), k_pages, v_pages, _t(lengths), _t(table))
        fused = tpaged.paged_verify_op(*args, verify_impl="fused")
        unrolled = tpaged.paged_verify_op(*args, verify_impl="unrolled")
        ref = tpaged.paged_verify_reference(*args)
        np.testing.assert_allclose(fused.numpy(), unrolled.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(fused.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    assert (tnative.paged_verify_launches, tnative.paged_attention_launches) == before
    with pytest.raises(ValueError, match="verify_impl"):
        tpaged.paged_verify_op(*args, verify_impl="blocked")


def test_wrapper_checks_its_inputs():
    q, kp, vp, lengths, table = _setup(b=2, s=3, h=4, kh=2, hd=16, ps=4, pps=3)
    args = [_t(q), _t(kp), _t(vp), _t(lengths), _t(table)]
    with pytest.raises(ValueError, match="S, H, hd"):
        tnative.paged_attention_native_verify(args[0][:, 0], *args[1:])
    with pytest.raises(ValueError, match="lengths"):
        tnative.paged_attention_native_verify(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError, match="int8 pages need"):
        tnative.paged_attention_native_verify(*args, k_scales=_t(kp[..., :1]))
    with pytest.raises(ValueError, match="contiguous"):
        strided = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        tnative.paged_attention_native_verify(strided, *args[1:])


def test_row_tiles_cover_every_query_row():
    """K5 serves all S · G query rows of a (row, kv head, split) in one
    block up to 64, so each page is read once: on the tensor cores the rows
    pad to m16 tiles (Qwen2.5-7B at d = 4: 35 rows, 3 tiles, 4 warps each),
    none empty; more take balanced row tiles of at most 64 (Qwen2.5-7B at
    d = 12: 91 rows, two blocks of 46)."""
    assert tnative.mma_layout(35) == (3, 12)
    assert tnative.mma_layout(7) == (1, 4)  # K2's G = 7
    assert tnative.mma_layout(16) == (1, 4)
    assert tnative.mma_layout(17) == (2, 4)
    assert tnative.mma_layout(64) == (4, 4)
    for rows in range(1, tnative.MAX_ROWS + 1):
        tiles, warps = tnative.mma_layout(rows)
        assert 16 * (tiles - 1) < rows <= 16 * tiles  # every row, no empty tile
        assert warps % tiles == 0 and warps // tiles in (1, 2, 4)
    for rows in (0, 65):  # one block's rows; more take row tiles
        with pytest.raises(ValueError, match="query rows"):
            tnative.mma_layout(rows)
    bf = torch.bfloat16
    assert tnative._check_kernel_geometry(70, 128, bf, bf) == "mma"  # S 10 x G 7
    assert tnative.plan_row_tiles(70, 128, bf, bf) == tnative.RowTiles(2, 35)
    assert tnative.plan_row_tiles(91, 128, bf, bf) == tnative.RowTiles(2, 46)
    assert tnative.mma_layout(46) == (3, 12)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("valid", [False, True], ids=["all", "masked"])
def test_write_tokens_to_pages_bit_for_bit(quant, valid):
    """S tokens per row at per-row offsets that cross page boundaries, with
    and without per-token validity, f32 and int8 pools."""
    rng = np.random.default_rng(8)
    kh, ps, hd, b, d, pps = 2, 4, 16, 3, 5, 4
    pages = rng.standard_normal((kh, b * pps, ps, hd)).astype(np.float32)
    kv = rng.standard_normal((b, d, kh, hd)).astype(np.float32)
    lengths = np.array([0, 3, 9], np.int32)
    table = tpaged.make_page_table(b, pps * ps, ps)
    table = table[:, ::-1].copy()  # pages out of order
    mask = rng.random((b, d)) < 0.6 if valid else None
    if quant == "int8":
        jp = jpaged.quantize_pages(jnp.asarray(pages))
        tp = tpaged.QuantizedPages(_t(jp.weight), _t(jp.scales))
    else:
        jp, tp = jnp.asarray(pages), _t(pages)
    want = jpaged.write_tokens_to_pages(
        jp, jnp.asarray(kv), jnp.asarray(lengths), jnp.asarray(table), ps,
        valid=None if mask is None else jnp.asarray(mask))
    got = tpaged.write_tokens_to_pages(tp, _t(kv), _t(lengths), _t(table), ps,
                                       valid=None if mask is None else _t(mask))
    if quant == "int8":
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_context_attention_matches_jax():
    rng = np.random.default_rng(9)
    b, s, h, kh, hd, sk = 2, 6, 4, 2, 16, 24
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    ck = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    cv = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    lengths = np.array([3, 11], np.int32)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jpaged.chunked_context_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths),
        jnp.asarray(valid)))
    got = tpaged.chunked_context_attention(_t(q), _t(ck), _t(cv), _t(lengths), _t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (got.numpy()[valid == 0] == 0).all()


def _tiny_weights(seed=0):
    jparams = jtf.init_params(jax.random.PRNGKey(seed), TINY)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    return jparams, params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("mode", ["verify", "chunked"])
def test_model_forward_matches_jax(mode):
    """The model's verify forward (and the chunked resume forward) over a
    paged cache at TINY: logits within LOGIT_ATOL, the written pages
    equal."""
    jparams, model = _tiny_weights()
    rng = np.random.default_rng(10)
    b, s, ps, pps = 3, 4, 8, 4
    kh, hd, layers = TINY.num_kv_heads, TINY.head_dim, TINY.num_layers
    pages = [rng.standard_normal((kh, b * pps, ps, hd)).astype(np.float32)
             for _ in range(2 * layers)]
    ids = rng.integers(0, TINY.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([2, 7, 13], np.int32)
    table = tpaged.make_page_table(b, pps * ps, ps)
    positions = (lengths[:, None] + np.arange(s)[None, :]).astype(np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.int32)
    flag = {"paged_verify": True} if mode == "verify" else {"paged_chunked": True}
    mask_kw = {} if mode == "verify" else {"attention_mask": valid}
    jcache = {"k": tuple(jnp.asarray(x) for x in pages[:layers]),
              "v": tuple(jnp.asarray(x) for x in pages[layers:]),
              "lengths": jnp.asarray(lengths), "page_indices": jnp.asarray(table)}
    jlog, jc = jtf.forward(jparams, TINY, jnp.asarray(ids), positions=jnp.asarray(positions),
                           kv_cache=jcache, page_size=ps,
                           **{k: jnp.asarray(v) for k, v in mask_kw.items()}, **flag)
    tcache = {"k": [_t(x) for x in pages[:layers]], "v": [_t(x) for x in pages[layers:]],
              "lengths": _t(lengths), "page_indices": _t(table)}
    with torch.inference_mode():
        tlog, tc = model(_t(ids), positions=_t(positions), kv_cache=tcache, page_size=ps,
                         **{k: _t(v) for k, v in mask_kw.items()}, **flag)
    assert tlog.shape == (b, s, TINY.vocab_size)
    got, want = tlog.numpy(), np.asarray(jlog)
    if mode == "chunked":  # padding queries are zeroed, their logits unread
        got, want = got[valid > 0], want[valid > 0]
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    for i in range(layers):
        np.testing.assert_allclose(tc["k"][i].numpy(), np.asarray(jc["k"][i]),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(tc["v"][i].numpy(), np.asarray(jc["v"][i]),
                                   atol=LOGIT_ATOL, rtol=0)


def test_verify_forward_equals_per_token_decode_forwards():
    """One verify forward over S positions gives the logits of S single-token
    decode forwards fed the same tokens (the check chip_smoke.py makes at
    full width), and leaves the same pages (the K/V projections batch over
    other row counts, so equal up to f32 rounding)."""
    _, model = _tiny_weights(seed=1)
    rng = np.random.default_rng(12)
    b, s, ps, pps, layers = 3, 5, 8, 4, TINY.num_layers
    shape = (TINY.num_kv_heads, b * pps, ps, TINY.head_dim)
    base = [rng.standard_normal(shape).astype(np.float32) for _ in range(2 * layers)]
    ids = _t(rng.integers(0, TINY.vocab_size, (b, s)).astype(np.int32))
    lengths = _t(np.array([0, 6, 19], np.int32))
    table = _t(tpaged.make_page_table(b, pps * ps, ps))

    def cache(lens):
        return {"k": [_t(x) for x in base[:layers]], "v": [_t(x) for x in base[layers:]],
                "lengths": lens, "page_indices": table}

    with torch.inference_mode():
        c1 = cache(lengths)
        positions = lengths[:, None] + torch.arange(s, dtype=torch.int32)[None, :]
        verify, _ = model(ids, positions=positions, kv_cache=c1, page_size=ps,
                          paged_verify=True)
        c2 = cache(lengths)
        steps = []
        for i in range(s):
            c2["lengths"] = lengths + i
            lg, _ = model(ids[:, i:i + 1], positions=(lengths + i)[:, None], kv_cache=c2,
                          page_size=ps)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(verify.numpy(), torch.stack(steps, 1).numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    for a, b_ in zip(c1["k"] + c1["v"], c2["k"] + c2["v"]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-6, rtol=0)
