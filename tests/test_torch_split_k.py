"""The host side of K3's split over K (``ops/quant_matmul.py``): the planner
``plan_split_k`` and the workspace the wrapper hands the kernel.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to its
plain version at M 64, 320 and 12,400); here a stand-in for the built
library records what the wrapper passes it.
"""

import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distrl_llm_tpu_torch.ops import quant, quant_matmul as qmm

# Qwen2.5-7B's projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
ROWS = (64, 320, 12400)  # decode, the speculative verify step, the learner


def _ranges(plan, k):
    """The K rows each split covers: [z * k_per_split, min(k, ...))."""
    return [(z * plan.k_per_split, min(k, (z + 1) * plan.k_per_split))
            for z in range(plan.splits)]


def _check_cover(plan, k, group):
    ranges = _ranges(plan, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start  # every K step exactly once, in order
    for start, end in ranges:
        assert end > start  # no empty split
        assert start % qmm.STAGE_K == 0 and start % 32 == 0
        assert (end - start) % 32 == 0
        if group < k:
            assert start % group == 0 and (end - start) % group == 0


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("group", [64, None], ids=["g64", "per_column"])
def test_main_path_plans_cover_k_once_in_group_multiples(m, k, n, group):
    g = group or k
    plan = qmm.plan_split_k(m, k, n, g)
    _check_cover(plan, k, g)
    assert plan.blocks == (math.ceil(m / plan.block_m) * math.ceil(n / plan.block_n)
                           * plan.splits)
    if m > qmm.DECODE_MAX_M:  # the learner: large tiles, never split
        assert (plan.block_m, plan.block_n, plan.splits) == (256, 128, 1)
    else:  # split in two at least, x·A in the first column block's K loop
        assert (plan.block_m, plan.block_n) == (64, 128) and plan.splits >= 2


@pytest.mark.parametrize("k,n", SHAPES)
def test_decode_fills_the_card(k, n):
    """At M = 64 the grid reaches the target number of blocks, unless the
    splits are already at their shortest."""
    plan = qmm.plan_split_k(64, k, n, 64)
    shortest = math.ceil(qmm.MIN_SPLIT_K / qmm.STAGE_K) * qmm.STAGE_K
    assert plan.blocks >= qmm.TARGET_WAVES * qmm.SMS or plan.k_per_split == shortest
    assert plan.splits > 1


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 2048), k32=st.integers(1, 700), n=st.integers(1, 40000),
       group=st.sampled_from([16, 32, 64, 128, None]), sms=st.integers(1, 264))
def test_any_plan_covers_k_once(m, k32, n, group, sms):
    k = 32 * k32
    g = k if group is None else group
    if k % g:
        return  # no such container: the group divides K
    plan = qmm.plan_split_k(m, k, n, g, sms=sms)
    _check_cover(plan, k, g)
    assert plan.splits == 1 or plan.k_per_split >= qmm.MIN_SPLIT_K
    if m > qmm.DECODE_MAX_M:
        assert plan.splits == 1
    else:  # beyond two splits only while the grid is short of its target
        fewer = math.ceil(m / 64) * math.ceil(n / 128) * (plan.splits - 1)
        assert plan.splits <= 2 or fewer < qmm.TARGET_WAVES * sms
        if k >= 2 * math.ceil(qmm.MIN_SPLIT_K / qmm.STAGE_K) * qmm.STAGE_K * (
                1 if g >= k else math.lcm(qmm.STAGE_K, g) // qmm.STAGE_K):
            assert plan.splits >= 2


def test_workspace_sizes():
    plan = qmm.plan_split_k(64, 3584, 18944, 64)
    assert plan.splits > 1
    assert plan.workspace_numel(64, 18944, 32) == plan.splits * 64 * (18944 + 32)
    one = qmm.plan_split_k(12400, 3584, 18944, 64)
    assert one.workspace_numel(12400, 18944, 32) == 12400 * 32 // 2  # xa, bf16
    assert one.workspace_numel(12400, 18944, 8) == 12400 * 32 // 2  # rank padded to 32
    assert one.workspace_numel(12400, 18944, 40) == 12400 * 64 // 2
    assert one.workspace_numel(12400, 18944, 0) == 0
    # past rank 64 the rank runs in chunks of 64: padded to whole chunks
    assert one.workspace_numel(12400, 18944, 128) == 12400 * 128 // 2
    assert one.workspace_numel(12400, 18944, 200) == 12400 * 256 // 2
    assert one.workspace_numel(12400, 18944, 200, itemsize=4) == 12400 * 256  # f32 xa
    assert plan.workspace_numel(64, 18944, 200) == plan.splits * 64 * (18944 + 200)


class _FakeLib:
    """Records the arguments of ``quant_matmul_launch`` and returns 0."""

    def __init__(self):
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return 0

        self.quant_matmul_launch = launch


@pytest.mark.parametrize("m,k,n,rank", [(64, 256, 512, 8), (64, 512, 256, 0),
                                         (600, 256, 512, 8), (600, 256, 512, 0)])
def test_wrapper_allocates_the_workspace_the_plan_asks_for(monkeypatch, m, k, n, rank):
    fake = _FakeLib()
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(qmm, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(qmm, "_stream", lambda device: 0)
    monkeypatch.setattr(qmm.torch, "empty", recording_empty)
    g = torch.Generator().manual_seed(0)
    w = quant.quantize(torch.randn(k, n, generator=g) * 0.02, bits=4, group_size=64)
    x = torch.randn(m, k, generator=g).bfloat16()
    a = torch.randn(k, rank, generator=g) if rank else None
    b = torch.randn(rank, n, generator=g) if rank else None
    qmm.quant_matmul_launch(x, w, None, a, b, 0.5)
    (args,) = fake.calls
    plan = qmm.plan_split_k(m, k, n, 64)
    want = plan.workspace_numel(m, n, rank)
    ws_ptr, block_m, splits, k_per_split = args[7], args[17], args[18], args[19]
    assert (block_m, splits, k_per_split) == (plan.block_m, plan.splits, plan.k_per_split)
    if want:
        ws = [t for t in allocated if t.data_ptr() == ws_ptr]
        assert len(ws) == 1 and ws[0].numel() == want and ws[0].dtype == torch.float32
    else:
        assert ws_ptr is None
    # f32 activations take the CUDA-core kernel: one split; scratch only for
    # xa = x A in f32 (the rank padded to 32)
    fake.calls.clear()
    allocated.clear()
    qmm.quant_matmul_launch(x.float(), w, None, a, b, 0.5)
    (args,) = fake.calls
    assert (args[17], args[18], args[19]) == (64, 1, k)
    if rank:
        ws = [t for t in allocated if t.data_ptr() == args[7]]
        assert len(ws) == 1 and ws[0].numel() == m * 32 and ws[0].dtype == torch.float32
    else:
        assert args[7] is None


def test_wrapper_rejects_an_odd_group():
    w = {"q": torch.zeros((32, 3, 8), dtype=torch.int8),
         "scale": torch.ones((32, 1, 8), dtype=torch.float32)}
    with pytest.raises(ValueError, match="even group"):
        qmm.quant_matmul_launch(torch.zeros((4, 96), dtype=torch.bfloat16), w, None, None,
                                None, 1.0)
