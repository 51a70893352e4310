"""The host side of K2's and K5's split over pages (``ops/paged_native.py``):
the planner ``plan_paged_split``, the workspace and plan the wrapper hands
the kernel, and the split-and-merge algorithm itself on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them to their
plain versions); here a stand-in for the built library records what the
wrapper passes it, and the algorithm runs as the plain version over each
split's page range, merged with the merge kernel's formula in split order,
against the plain version over the whole table and the JAX package's
kernels in interpret mode.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distrl_llm_tpu.ops import paged_native as jnative
from distrl_llm_tpu_torch.ops import paged as tpaged
from distrl_llm_tpu_torch.ops import paged_native as tnative
from distrl_llm_tpu_torch.ops.attention import NEG_INF

# the main path: Qwen2.5-7B's 4 kv heads, 128-token pages, a table of 3
# prompt + 11 private pages; 64 rows (4 prompts x 16) and a wave's tail of 16
KV_HEADS, PAGE, PPS = 4, 128, 14
CSRC = Path(tnative.__file__).resolve().parents[1] / "csrc"
ATOL = 1e-5  # f32: the same sums, split and merged in another order
JAX_ATOL = 2e-5  # tests/test_torch_verify.py's tolerance against the JAX kernels


def _ranges(plan, pps):
    return [(z * plan.pages_per_split, min(pps, (z + 1) * plan.pages_per_split))
            for z in range(plan.splits)]


def _check_cover(plan, pps):
    ranges = _ranges(plan, pps)
    assert ranges[0][0] == 0 and ranges[-1][1] == pps
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start  # every page once, in order
    assert all(end > start for start, end in ranges)  # none empty


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("batch", [64, 16])
def test_main_path_plans_cover_every_page_once(batch, s):
    plan = tnative.plan_paged_split(batch, KV_HEADS, PPS, PAGE, s)
    _check_cover(plan, PPS)
    assert plan.blocks == plan.splits * batch * KV_HEADS
    least = math.ceil(tnative.MIN_SPLIT_POSITIONS * s / PAGE)
    # the grid reaches the fill target unless the splits are at their shortest
    assert (plan.blocks >= tnative.TARGET_BLOCKS_PER_SM * tnative.SMS
            or plan.pages_per_split == least or plan.splits == PPS)


def test_main_path_plans():
    """64 rows: 4 splits of 4 pages (1550 tokens reach 13 of the 14 pages,
    so all 4 are live); a wave's tail of 16 rows: 7 splits of 2, the
    shortest; K5's draft block of 5 keeps at least 1280 positions a split,
    so its rows of ~600 resident tokens fit the first split."""
    plan = tnative.plan_paged_split
    assert (plan(64, 4, 14, 128).splits, plan(64, 4, 14, 128).pages_per_split) == (4, 4)
    assert (plan(16, 4, 14, 128).splits, plan(16, 4, 14, 128).pages_per_split) == (7, 2)
    assert (plan(64, 4, 14, 128, 5).pages_per_split, plan(16, 4, 14, 128, 5).splits) == (10, 2)
    assert plan(512, 4, 14, 128).splits == 1  # a full card: no split, no merge


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 512), kv_heads=st.integers(1, 16), pps=st.integers(1, 400),
       page_size=st.sampled_from([1, 4, 8, 16, 64, 128, 256]), s=st.integers(1, 9),
       sms=st.integers(1, 264))
def test_any_plan_covers_every_page_once(batch, kv_heads, pps, page_size, s, sms):
    plan = tnative.plan_paged_split(batch, kv_heads, pps, page_size, s, sms=sms)
    _check_cover(plan, pps)
    least = math.ceil(tnative.MIN_SPLIT_POSITIONS * s / page_size)
    assert plan.splits == 1 or plan.pages_per_split >= least
    # the grid reaches the target unless the splits are at their shortest
    target = tnative.TARGET_BLOCKS_PER_SM * sms
    assert plan.blocks >= target or plan.pages_per_split <= max(least, 1)
    assert plan.workspace_numel(batch, s, 8, 64) == (
        0 if plan.splits == 1 else plan.splits * batch * s * 8 * 66)


def test_planner_refuses_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        tnative.plan_paged_split(0, 4, 14, 128)
    with pytest.raises(ValueError, match="positive"):
        tnative.plan_paged_split(4, 4, 0, 128)


# ---------------------------------------------------------------- the wrapper


class _FakeLib:
    """Records the arguments of each ``*_launch`` and returns 0."""

    def __init__(self):
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return 0

        self.paged_attention_launch = launch
        self.paged_verify_launch = launch


def _inputs(b, s, h, kh, hd, ps, pps, kv_dtype=torch.bfloat16, q_dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    total = 16  # a small pool: the rows' tables share its pages
    pages = [torch.randn(kh, total, ps, hd, generator=g) for _ in range(2)]
    kw = {}
    if kv_dtype == torch.int8:
        qk, qv = (tpaged.quantize_pages(x) for x in pages)
        pages, kw = [qk.weight, qv.weight], {"k_scales": qk.scales, "v_scales": qv.scales}
    else:
        pages = [x.to(kv_dtype) for x in pages]
    shape = (b, h, hd) if s is None else (b, s, h, hd)
    q = torch.randn(shape, generator=g).to(q_dtype)
    lengths = torch.full((b,), ps * pps // 2, dtype=torch.int32)
    table = (torch.arange(b * pps, dtype=torch.int32) % total).reshape(b, pps)
    return (q, pages[0], pages[1], lengths, table), kw


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,s", [(64, None), (16, None), (64, 5), (16, 5), (512, None), (64, 13)])
def test_wrapper_hands_the_kernel_the_plan_and_its_workspace(monkeypatch, b, s, kv):
    """K2 (s None) and K5 through a stand-in library: the plan's splits and
    pages per split, a workspace of the planned size (none for one split),
    and one count per call."""
    fake = _FakeLib()
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(tnative, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(tnative, "_verify_lib", lambda: fake)
    monkeypatch.setattr(tnative, "_stream", lambda device: 0)
    monkeypatch.setattr(tnative.torch, "empty", recording_empty)
    monkeypatch.setattr(tnative, "paged_attention_launches", 0)
    monkeypatch.setattr(tnative, "paged_verify_launches", 0)
    h, hd = 28, 128
    (q, kp, vp, lens, table), kw = _inputs(b, s, h, KV_HEADS, hd, PAGE, PPS, kv_dtype=kv)
    out = tnative.paged_launch(q, kp, vp, lens, table, kw.get("k_scales"), kw.get("v_scales"))
    assert out.shape == q.shape and out.dtype == q.dtype
    (args,) = fake.calls
    # the call lines up with the C declaration: a pointer (or null) for
    # each pointer parameter, an int for each int
    source = "paged_attention" if s is None else "paged_verify"
    decl = re.search(rf"int {source}_launch\(([^)]*)\)",
                     (CSRC / f"{source}.cu").read_text()).group(1)
    params = [p.strip() for p in decl.split(",")]
    assert len(args) == len(params)
    for c_param, arg in zip(params, args):
        assert (arg is None or isinstance(arg, int)) and (arg is not None or "*" in c_param)
    plan = tnative.plan_paged_split(b, KV_HEADS, PPS, PAGE, s or 1)
    tiles = tnative.plan_row_tiles((s or 1) * h // KV_HEADS, hd, q.dtype, kp.dtype)
    ws_ptr = args[8]
    ints = args[9:-1]
    if s is None:
        assert ints == (b, h, KV_HEADS, hd, kp.shape[1], PAGE, PPS, plan.splits,
                        plan.pages_per_split, tiles.tiles, 1,
                        1 if kv == torch.bfloat16 else 2, 0)
        assert (tnative.paged_attention_launches, tnative.paged_verify_launches) == (1, 0)
    else:
        assert ints == (b, s, h, KV_HEADS, hd, kp.shape[1], PAGE, PPS, plan.splits,
                        plan.pages_per_split, tiles.tiles, 1,
                        1 if kv == torch.bfloat16 else 2, 0)
        assert (tnative.paged_attention_launches, tnative.paged_verify_launches) == (0, 1)
    want = plan.workspace_numel(b, s or 1, h, hd)
    if want:
        ws = [t for t in allocated if t.data_ptr() == ws_ptr]
        assert len(ws) == 1 and ws[0].numel() == want and ws[0].dtype == torch.float32
    else:
        assert ws_ptr is None and plan.splits == 1
    assert (args[3] is None) == (kv != torch.int8)  # scales only for int8 pages


# ---------------------------------------------------------------- the algorithm


def _partial_stats(q, kp, vp, lens, table, ks, vs, s):
    """m and l of the masked f32 scores of a (cut) table: q [B, S, H, hd],
    query i of row b attending positions < lens[b] + i + 1 of the table;
    m = NEG_INF and l = 0 where none is valid. [B, S, H] each."""
    b, _, h, hd = q.shape
    kh, _, ps, _ = kp.shape
    g = h // kh
    tab = table.long().clamp(0, kp.shape[1] - 1)
    k = kp[:, tab].float()  # [K, B, pps, ps, hd]
    if ks is not None:
        k = k * (ks[:, tab] * (1.0 / tpaged.MAX_INT8))
    k = k.reshape(kh, b, -1, hd).permute(1, 0, 2, 3)  # [B, K, T, hd]
    qf = q.float().reshape(b, s, kh, g, hd)
    sc = torch.einsum("bskgd,bktd->bskgt", qf, k)
    pos = torch.arange(k.shape[2])
    lim = lens.long()[:, None] + torch.arange(s)[None, :] + 1  # [B, S]
    valid = pos[None, None, :] < lim[:, :, None]  # [B, S, T]
    sc = torch.where(valid[:, :, None, None, :], sc, -torch.inf)
    m = sc.amax(-1).clamp_min(NEG_INF)
    l = torch.exp(sc - m[..., None]).sum(-1)  # noqa: E741
    return m.reshape(b, s, h), l.reshape(b, s, h)


def _split_and_merge(q, kp, vp, lens, table, ks, vs, pages_per_split, verify):
    """The kernel's algorithm with the plain version: each split's range of
    the table run alone (the table cut to it, the lengths shifted and
    clipped to it), then acc_z = l_z · out_z merged in split order as the
    merge kernel does: sum_z acc_z e^(m_z - M) / max(sum_z l_z e^(m_z - M),
    1e-30)."""
    ps, pps = kp.shape[2], table.shape[1]
    s = q.shape[1] if verify else 1
    q4 = q if verify else q[:, None]
    # K5's function over a cut table with K2's taken one lower (lag -1)
    base = lens.long() - (0 if verify else 1)
    parts = []
    for p0 in range(0, pps, pages_per_split):
        p1 = min(pps, p0 + pages_per_split)
        cut = table[:, p0:p1].contiguous()
        lz = (base - p0 * ps).clamp(-s - 1, (p1 - p0) * ps).to(torch.int32)
        out = tnative.paged_attention_native_verify_reference(
            q4, kp, vp, lz, cut, ks, vs).float()
        m, l = _partial_stats(q4, kp, vp, lz, cut, ks, vs, s)  # noqa: E741
        parts.append((m, l, out * l[..., None]))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - big) for m, _, _ in parts]
    lsum = sum(l * wz for (_, l, _), wz in zip(parts, w))
    acc = sum(a * wz[..., None] for (_, _, a), wz in zip(parts, w))
    out = (acc / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out if verify else out[:, 0]


def _case(rng, *, b, s, h, kh, hd, ps, pps, lengths, quant=False):
    kp = rng.standard_normal((kh, b * pps + 3, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((kh, b * pps + 3, ps, hd)).astype(np.float32)
    shape = (b, h, hd) if s is None else (b, s, h, hd)
    q = (rng.standard_normal(shape) * hd**-0.5).astype(np.float32)
    table = rng.permutation(b * pps + 3)[: b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    reach = lens + (0 if s is None else s)
    table[np.arange(pps)[None, :] * ps >= reach[:, None]] = 10**6  # never read
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    ks = vs = None
    if quant:
        qk, qv = tpaged.quantize_pages(t[1]), tpaged.quantize_pages(t[2])
        t[1], t[2], ks, vs = qk.weight, qv.weight, qk.scales, qv.scales
    return t, ks, vs


# splits wholly past a row's length, a row of length 0, lengths on split
# boundaries (a split's last position, one past it) and a full table
K2_LENGTHS = [0, 1, 8, 9, 16, 17, 31, 48]
VF_LENGTHS = [0, 3, 4, 11, 12, 27, 43]  # resident; the block of 5 ends at 48 at most


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 6])
def test_k2_split_and_merge_equals_the_plain_version(pages_per_split, quant):
    rng = np.random.default_rng(1)
    (q, kp, vp, lens, table), ks, vs = _case(
        rng, b=len(K2_LENGTHS), s=None, h=14, kh=2, hd=64, ps=8, pps=6, lengths=K2_LENGTHS,
        quant=quant)
    want = tnative.paged_attention_native_reference(q, kp, vp, lens, table, ks, vs)
    got = _split_and_merge(q, kp, vp, lens, table, ks, vs, pages_per_split, verify=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert (got[0] == 0).all()  # length 0: exactly zero
    # and the JAX package's blocked kernel, in interpret mode
    kw = {} if ks is None else {"k_scales": jnp.asarray(ks.numpy()),
                                "v_scales": jnp.asarray(vs.numpy())}
    jax_out = np.asarray(jnative.paged_attention_native_blocked(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(lens.numpy()), jnp.asarray(table.numpy()), pages_per_block=3,
        interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pages_per_split", [1, 2, 4])
def test_k5_split_and_merge_equals_the_plain_version(pages_per_split, quant):
    """Each query masked at its own limit: a split may hold positions valid
    for the last draft query and none for the first."""
    rng = np.random.default_rng(2)
    (q, kp, vp, lens, table), ks, vs = _case(
        rng, b=len(VF_LENGTHS), s=5, h=14, kh=2, hd=64, ps=8, pps=6, lengths=VF_LENGTHS,
        quant=quant)
    want = tnative.paged_attention_native_verify_reference(q, kp, vp, lens, table, ks, vs)
    got = _split_and_merge(q, kp, vp, lens, table, ks, vs, pages_per_split, verify=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    kw = {} if ks is None else {"k_scales": jnp.asarray(ks.numpy()),
                                "v_scales": jnp.asarray(vs.numpy())}
    jax_out = np.asarray(jnative.paged_attention_native_verify(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(lens.numpy()), jnp.asarray(table.numpy()), pages_per_block=2,
        interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("s", [None, 5])
def test_the_main_path_plan_split_and_merged(s):
    """The planner's own split of the main path's table (16 rows: 7 splits
    of 2 pages) at Qwen2.5-7B's heads, rows reaching 0 to 14 pages."""
    rng = np.random.default_rng(3)
    b = 16
    lengths = [0, 1, 127, 128, 255, 256, 257, 511, 512, 1023, 1024, 1550, 1660, 1700, 600, 40]
    if s is not None:
        lengths = [min(x, PPS * PAGE - s) for x in lengths]
    (q, kp, vp, lens, table), ks, vs = _case(
        rng, b=b, s=s, h=28, kh=KV_HEADS, hd=128, ps=PAGE, pps=PPS, lengths=lengths)
    plan = tnative.plan_paged_split(b, KV_HEADS, PPS, PAGE, s or 1)
    assert plan.splits > 1
    ref = (tnative.paged_attention_native_verify_reference if s
           else tnative.paged_attention_native_reference)
    want = ref(q, kp, vp, lens, table)
    got = _split_and_merge(q, kp, vp, lens, table, None, None, plan.pages_per_split,
                           verify=s is not None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
