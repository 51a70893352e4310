"""K1's cluster design on the CPU: the planner, the launch through a
stand-in library, and a plain model of the kernel's algorithm.

The kernel (``csrc/fused_sample.cu``) runs only on the card. What these tests
hold is the algorithm it rests on: the bands that decide the bisection's
steps while lo is 0 (exact comparisons with hi0 · 2^-b from the floats'
bits), the candidate tree that decides the later steps a cluster round at a
time, and the draw over the kept columns plus the lowest unkept one. The
model checks which columns each of the kernel's sums covers and which mids
it tests: taking its decisions from ``_bisect_threshold``'s own whole-row
masses, its lo must equal that function's bit for bit, and its token the
full scan's (``fused_sample_scores``). The kernel adds in another order (a
scan of per-band sums, then that sum plus the in-play columns' partials);
the model forms those masses too, and they must agree with the whole-row
masses within ``MASS_ATOL`` and decide alike except where the mass lies
within ``MASS_ATOL`` of top_p. On the card, ``chip_smoke.py`` compares the
kernel's tokens and logprobs with the plain version's. All inputs are made
with numpy from a seed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distrl_llm_tpu_torch.models.configs import PRESETS
from distrl_llm_tpu_torch.ops import sampling as smp

CSRC = Path(smp.__file__).resolve().parent.parent / "csrc"
VOCABS = sorted({cfg.vocab_size for cfg in PRESETS.values()} | {1000})
BANDS = smp.SAMPLE_BANDS
MASS_ATOL = 1e-5  # the kernel's order of sums against the whole-row sum


# ---------------------------------------------------------------- the planner


@pytest.mark.parametrize("vocab", VOCABS)
def test_every_preset_vocab_has_a_plan_that_covers_each_column_once(vocab):
    """Rows 0-256: C a power of two up to 16, whole quads, at most MAX_QUADS
    quads a thread, shared memory within a block's 227 KB and equal to the
    layout's, and the C slices [r·cols, min((r+1)·cols, V)) partition the
    row with no empty block."""
    for rows in range(257):
        plan = smp.plan_sample_cluster(rows, vocab)
        assert plan.cluster in smp.CLUSTER_SIZES
        assert plan.threads % 32 == 0 and 64 <= plan.threads <= 1024
        assert plan.cols % 4 == 0 and plan.cols // 4 <= smp.MAX_QUADS * plan.threads
        assert plan.smem_bytes == (smp.SAMPLE_RED_BYTES + 4 * plan.cols
                                   + 4 * BANDS * plan.threads) <= smp.SAMPLE_SMEM_LIMIT
        assert plan.blocks == rows * plan.cluster
        starts = [r * plan.cols for r in range(plan.cluster)]
        ends = [min(s + plan.cols, vocab) for s in starts]
        assert all(s < e for s, e in zip(starts, ends))
        assert starts[0] == 0 and ends[-1] == vocab
        assert all(e == s for e, s in zip(ends, starts[1:]))
    if vocab <= 1000:
        assert smp.plan_sample_cluster(64, vocab).cluster == 1


def test_main_path_plan():
    """Qwen2.5's vocabulary at the rollout's 64 rows: 8 blocks of 480
    threads, two to an SM; one row takes 16 blocks."""
    plan = smp.plan_sample_cluster(64, 152064)
    assert (plan.cluster, plan.threads, plan.cols) == (8, 480, 19008)
    assert 2 * (plan.smem_bytes + 1024) <= smp.SM_SMEM
    assert smp.plan_sample_cluster(1, 152064).cluster == 16


def test_a_vocabulary_beyond_sixteen_blocks_raises():
    assert smp.plan_sample_cluster(64, smp.MAX_SAMPLE_VOCAB).cluster == 16
    with pytest.raises(ValueError, match="does not fit"):
        smp.plan_sample_cluster(64, smp.MAX_SAMPLE_VOCAB + 1)


@pytest.mark.parametrize("args", [(64, 152064, 0), (-1, 1000, 132), (64, 0, 132),
                                  (64, smp.MAX_SAMPLE_VOCAB + 4, 132), (64, 10**7, 132)])
def test_planner_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        smp.plan_sample_cluster(*args)


def test_the_c_layout_constants_match_the_planner():
    src = (CSRC / "fused_sample.cu").read_text()
    assert int(re.search(r"constexpr int kRedBytes = (\d+);", src).group(1)) == smp.SAMPLE_RED_BYTES
    assert int(re.search(r"constexpr int kBands = (\d+);", src).group(1)) == BANDS
    assert int(re.search(r"constexpr int kMaxQuads = (\d+);", src).group(1)) == smp.MAX_QUADS
    assert int(re.search(r"constexpr int kSmemLimit = (\d+);", src).group(1)) == (
        smp.SAMPLE_SMEM_LIMIT)
    assert int(re.search(r"#define FUSED_SAMPLE_LOOKAHEAD (\d+)", src).group(1)) == smp.LOOKAHEAD


# ---------------------------------------------------------------- the wrapper


class _FakeLib:
    """Records the arguments of each ``fused_sample_launch`` and returns 0."""

    def __init__(self):
        self.calls = []

    def fused_sample_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b,v", [(64, 152064), (7, 999), (0, 1000)])
def test_launch_hands_the_kernel_its_plan_and_no_scratch(monkeypatch, b, v):
    """Through a stand-in library: the outputs are the only allocations, the
    C declaration's parameters line up with the call, the plan's shape is
    passed, one count per launch, and no launch for zero rows."""
    fake = _FakeLib()
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(tuple(t.shape))
        return t

    monkeypatch.setattr(smp, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(smp, "_stream", lambda device: 0)
    monkeypatch.setattr(smp.torch, "empty", recording_empty)
    monkeypatch.setattr(smp, "fused_sample_launches", 0)
    logits = torch.zeros((b, v))
    seeds = torch.zeros((b,), dtype=torch.int32)
    tok, logp = smp._launch(logits, 1.2, 0.95, seeds, 16)
    assert tok.shape == logp.shape == (b,)
    assert allocated == [(b,), (b,)]
    if b == 0:
        assert fake.calls == [] and smp.fused_sample_launches == 0
        return
    (args,) = fake.calls
    decl = re.search(r"int fused_sample_launch\(([^)]*)\)",
                     (CSRC / "fused_sample.cu").read_text()).group(1)
    assert len(args) == len(decl.split(","))
    plan = smp.plan_sample_cluster(b, v)
    assert args[6:12] == (b, v, 16, plan.cluster, plan.threads, plan.cols)
    assert smp.fused_sample_launches == 1


def test_launch_refuses_a_plan_that_does_not_cover_the_row(monkeypatch):
    """A row no cluster holds raises before anything is allocated or
    launched: there is no other route for it."""
    fake = _FakeLib()
    monkeypatch.setattr(smp, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(smp, "fused_sample_launches", 0)
    with pytest.raises(ValueError, match="does not fit"):
        smp._launch(torch.zeros((1, smp.MAX_SAMPLE_VOCAB + 4)), 1.0, 0.9,
                    torch.zeros((1,), dtype=torch.int32), 16)
    assert fake.calls == [] and smp.fused_sample_launches == 0


# ---------------------------------------------------------------- the model


def band_of(p: np.ndarray, hi0: np.float32) -> np.ndarray:
    """The kernel's band_of: from the floats' bits, the least b in [0, 16]
    with p >= hi0 · 2^-b, else 17 (and 17 for NaN)."""
    d = int(np.float32(hi0).view(np.uint32)) - p.astype(np.float32).view(np.uint32).astype(np.int64)
    b = np.where(d <= 0, 0, (d + (1 << 23) - 1) >> 23)
    b = np.minimum(b, BANDS)
    b[~(p >= 0)] = BANDS
    return b


def band_by_comparison(p: np.ndarray, hi0: np.float32) -> np.ndarray:
    out = np.full(p.shape, BANDS)
    for b in range(BANDS - 1, -1, -1):
        out[p >= np.float32(hi0) * np.float32(2.0**-b)] = b
    return out


def test_bands_from_bits_equal_the_threshold_comparisons():
    rng = np.random.default_rng(0)
    for hi0 in (np.float32(1.0), np.float32(0.3), np.float32(1 / 152064), np.float32(0.999)):
        thr = np.array([hi0 * np.float32(2.0**-b) for b in range(BANDS)], np.float32)
        edges = np.concatenate([thr, np.nextafter(thr, np.float32(0)),
                                np.nextafter(thr, np.float32(1))])
        p = np.concatenate([
            (hi0 * rng.random(4000) ** 8).astype(np.float32), edges,
            np.array([0.0, np.nan, 1e-45, hi0, np.float32(1e-30)], np.float32)]).astype(np.float32)
        np.testing.assert_array_equal(band_of(p, hi0), band_by_comparison(p, hi0))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _masses(probs: torch.Tensor, row: int, mids) -> list:
    """Each mid's kept mass for ``row``, by _bisect_threshold's expression on
    the whole batch (so the bits are its bits)."""
    out = []
    for mid in mids:
        m = torch.full((probs.shape[0],), float(mid), dtype=torch.float32)
        out.append(torch.where(probs >= m[..., None], probs, 0.0).sum(dim=-1)[row])
    return out


def _decide(plain, kernel, top_p: float, flips: list) -> bool:
    """The decision at one mid, from the whole-row mass ``plain``; the
    kernel's order of sums must give ``kernel`` within MASS_ATOL of it, and
    the same decision unless the mass is within MASS_ATOL of top_p (then the
    flip is counted)."""
    both_nan = bool(plain.isnan()) and bool(kernel.isnan())
    assert both_nan or abs(float(kernel) - float(plain)) <= MASS_ATOL, (kernel, plain)
    keep = bool(plain >= top_p)
    if bool(kernel >= top_p) != keep:
        assert abs(float(plain) - top_p) <= MASS_ATOL, (kernel, plain, top_p)
        flips.append(float(plain))
    return keep


def model_threshold(probs: torch.Tensor, row: int, top_p: float, iters: int,
                    lookahead: int, flips: list) -> torch.Tensor:
    """The kernel's bisection for one row: the bands decide the steps while
    lo is 0; the first step whose mass reaches top_p puts one band in play,
    and the later steps go ``lookahead`` at a time over the candidate tree.
    Every set the kernel sums is checked against the plain comparison, and
    every mass it forms (``cum`` of the band sums while lo is 0, then the
    mass of the bands above the one in play plus the in-play partial) is
    held to the whole-row mass by ``_decide``."""
    p = probs[row]
    hi0 = p.max()
    band = torch.from_numpy(band_of(p.numpy(), hi0.numpy()))
    band_sums = torch.stack([torch.where(band == b, p, 0.0).sum() for b in range(BANDS)])
    cum = torch.cumsum(band_sums, dim=0)
    lo, hi = _f32(0.0), hi0.clone()
    play, step = BANDS, min(iters, BANDS - 1)
    for s in range(min(iters, BANDS - 1)):
        mid = 0.5 * (lo + hi)
        assert torch.equal(p >= mid, band <= s + 1)
        (mass,) = _masses(probs, row, [mid])
        if _decide(mass, cum[s + 1], top_p, flips):
            lo, play, step = mid, s + 1, s + 1
            break
        hi = mid
    in_play = band == play
    above = cum[play - 1]
    while step < iters:
        depth = min(lookahead, iters - step)
        nc = 2**lookahead - 1
        nlo, nhi, mids = [lo] + [None] * (nc - 1), [hi] + [None] * (nc - 1), []
        for j in range(nc):
            mids.append(0.5 * (nlo[j] + nhi[j]))
            if 2 * j + 2 < nc:
                nlo[2 * j + 1], nhi[2 * j + 1] = nlo[j], mids[j]
                nlo[2 * j + 2], nhi[2 * j + 2] = mids[j], nhi[j]
        for mid in mids:  # only the band in play can change sides
            assert torch.equal(p >= mid, (band < play) | (in_play & (p >= mid)))
        masses = _masses(probs, row, mids)
        node = 0
        for _ in range(depth):
            partial = torch.where(in_play & (p >= mids[node]), p, 0.0).sum()
            if _decide(masses[node], above + partial, top_p, flips):
                lo, node = mids[node], 2 * node + 2
            else:
                hi, node = mids[node], 2 * node + 1
        step += lookahead
    return lo


def _beats(v: float, i: int, bv: float, bi: int) -> bool:
    if np.isnan(v):
        return not np.isnan(bv) or i < bi
    if np.isnan(bv):
        return False
    return v > bv or (v == bv and i < bi)


def model_draw(scaled: torch.Tensor, probs: torch.Tensor, lo: torch.Tensor,
               noise: torch.Tensor) -> int:
    """The kernel's draw for one row: the hash and logs only on the kept
    columns, and the lowest unkept column at -1e30 (its exact score)."""
    kept = (probs >= lo).nonzero().flatten().tolist()
    best, arg = -np.inf, 2**31 - 1
    for c in kept:
        score = float(scaled[c] + noise[c])
        if _beats(score, c, best, arg):
            best, arg = score, c
    unkept = (~(probs >= lo)).nonzero().flatten()
    if unkept.numel() and _beats(float(np.float32(-1e30)), int(unkept[0]), best, arg):
        arg = int(unkept[0])
    return arg


def _rows(v: int, seed: int) -> np.ndarray:
    """Random rows, a one-hot row, tied maxima, a row with -inf columns,
    a row of NaN, a row with +inf, a row of -inf."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((9, v)) * 3.0).astype(np.float32)
    lg[3] = -20.0
    lg[3, v // 2] = 20.0
    lg[4, [1, v - 2]] = lg[4].max() + 1.0
    lg[5, ::3] = -np.inf
    lg[6] = np.nan
    lg[7, 5] = np.inf
    lg[8] = -np.inf
    return lg


@pytest.mark.parametrize("lookahead", [1, 2, 4])
@pytest.mark.parametrize("t,top_p,iters", [(1.2, 0.95, 16), (0.6, 0.9, 16), (1.0, 1.0, 16),
                                           (1.2, 0.5, 16), (1.2, 0.95, 7), (1.2, 0.95, 20),
                                           (0.3, 0.95, 16), (1.2, 0.95, 0)])
def test_model_threshold_and_token_equal_the_plain_version(lookahead, t, top_p, iters):
    """With the whole-row masses' decisions, lo is bit-identical to
    _bisect_threshold for every lookahead (the kernel's sets and mids); the
    kernel's order of sums decides alike but within MASS_ATOL of top_p; the
    draw over the kept columns plus the lowest unkept one gives the full
    scan's token, on rows where nothing is kept too (NaN, +inf, all -inf)."""
    v = 700
    lg = torch.from_numpy(_rows(v, seed=int(t * 10) + iters))
    seeds = torch.arange(lg.shape[0], dtype=torch.int32) * 7919 - 12345
    scaled = lg / max(t, 1e-6)
    e = torch.exp(scaled - scaled.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    want_lo = smp._bisect_threshold(probs, top_p, iters)
    noise = smp.gumbel_noise(seeds, v)
    want_tok = smp.fused_sample_scores(lg, t, top_p, seeds, iters).argmax(dim=-1)
    nothing_kept, flips = 0, []
    for row in range(lg.shape[0]):
        lo = model_threshold(probs, row, top_p, iters, lookahead, flips)
        assert torch.equal(lo, want_lo[row]) or (lo.isnan() and want_lo[row].isnan()), row
        nothing_kept += int(not bool((probs[row] >= lo).any()))
        assert model_draw(scaled[row], probs[row], lo, noise[row]) == int(want_tok[row]), row
    assert nothing_kept >= 3  # the NaN, +inf and -inf rows
    assert all(abs(m - top_p) <= MASS_ATOL for m in flips)
