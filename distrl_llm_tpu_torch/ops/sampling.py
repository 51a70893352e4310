"""Batched token sampling: temperature, top-p (nucleus), greedy.

Counterpart of the JAX package's ``ops/sampling.py``. The engines' one entry
point is ``sample_with_logprob``:

* ``top_p_impl="bisect"`` (the default) goes through ``fused_sample``, the
  hand-written Hopper kernel (``csrc/fused_sample.cu``) that replaces the TPU
  kernel ``_fused_sample_kernel``: temperature, bisect top-p, Gumbel-max
  draw and the chosen token's raw-basis logprob in one launch of one
  thread-block cluster per row, shaped by ``plan_sample_cluster``. A CUDA
  tensor launches the kernel or raises; a CPU tensor runs its plain PyTorch
  version ``fused_sample_reference``.
* ``top_p_impl="exact"`` runs the plain multi-pass ``sample`` with the
  rank-based sort filter, as the JAX package sends it to XLA.
* ``top_p_impl="bisect_mw"`` (the multiway bisection filter) follows the
  JAX package's own dispatch (``sample_dispatch``): there every top-p
  filter but "exact" runs the fused kernel on the TPU and the multi-pass
  ``sample`` with the named filter elsewhere. So a CUDA tensor launches K1
  (whose bisection keeps the same nucleus up to the threshold's last
  bits), a CPU tensor runs ``sample`` with
  ``top_p_filter_bisect_multiway``. The speculative acceptance
  (``engine/speculative.py::sampling_probs``) uses the plain multiway
  filter on both, as the JAX package does.

Randomness is a per-row int32 seed: the draw's uniforms hash
``(seed, column)`` (murmur3 fmix32), so the kernel, its plain version and the
JAX kernel in interpret mode draw the same token from the same seeds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from distrl_llm_tpu_torch.ops import launch_count
from distrl_llm_tpu_torch.ops.attention import NEG_INF

#: launches of the CUDA kernel (one per ``fused_sample`` call on the GPU with
#: at least one row); CPU calls, which run the plain version, do not count
fused_sample_launches = 0

_U32 = 0xFFFFFFFF

# the cluster plan (``plan_sample_cluster``; layouts in csrc/fused_sample.cu)
SMS = 132  # the H100 SXM's streaming multiprocessors
SAMPLE_SMEM_LIMIT = 232448  # shared memory a block may use (227 KB)
SM_SMEM = 233472  # shared memory of an SM (228 KB), 1 KB of it reserved per block
SAMPLE_RED_BYTES = 2688  # the kernel's reduction area (kRedBytes)
SAMPLE_BANDS = 17  # the kernel's bisection bands (kBands): a float each a thread
MAX_QUADS = 10  # 4-column quads a thread holds (kMaxQuads)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is Hopper's largest (non-portable) cluster
MIN_BLOCK_COLS = 2048  # no split that leaves a block fewer columns than this
LOOKAHEAD = 2  # the kernel's kLookahead: bisection steps a cluster barrier once lo > 0


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Exact nucleus: sort descending, keep tokens until the cumulative
    probability first reaches ``top_p`` (the crossing token is kept).
    Membership maps back by RANK (stable sort), so ties at the cutoff don't
    widen the nucleus. [B, V] → [B, V]."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p
    ranks = torch.argsort(order, dim=-1)
    keep = torch.gather(keep_sorted, -1, ranks)
    return logits.masked_fill(~keep, NEG_INF)


def _bisect_threshold(probs: torch.Tensor, top_p: float, iters: int) -> torch.Tensor:
    """Low end of the bisected keep threshold τ: Σ p·[p ≥ τ] ≥ top_p."""
    lo = torch.zeros(probs.shape[:-1], dtype=torch.float32, device=probs.device)
    hi = probs.max(dim=-1).values
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid[..., None], probs, 0.0).sum(dim=-1)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def top_p_filter_bisect(logits: torch.Tensor, top_p: float,
                        iters: int = 16) -> torch.Tensor:
    """Sort-free nucleus: bisect a probability threshold τ so the kept mass
    just reaches ``top_p``, keep p ≥ τ (interval LOW end: kept mass ≥ top_p)."""
    probs = torch.softmax(logits.float(), dim=-1)
    lo = _bisect_threshold(probs, top_p, iters)
    return torch.where(probs >= lo[..., None], logits, NEG_INF)


def top_p_filter_bisect_multiway(logits: torch.Tensor, top_p: float,
                                 passes: int = 4, k: int = 15) -> torch.Tensor:
    """Nucleus by multiway bisection: each pass tests ``k`` evenly spaced
    thresholds of the interval at once and narrows it (k+1)-fold, 4 x 15
    reaching the 2^16 resolution of 16 binary steps. lo only moves onto a
    tested threshold whose kept mass still reaches top_p (the largest
    passing, hi the smallest failing), so the kept mass is >= top_p."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = (torch.arange(1, k + 1, dtype=torch.float32, device=probs.device)
            / torch.full((k,), k + 1.0, device=probs.device))
    lo = torch.zeros(probs.shape[:-1], dtype=torch.float32, device=probs.device)
    hi = probs.max(dim=-1).values
    for _ in range(passes):
        ts = lo[..., None] + (hi - lo)[..., None] * frac  # [..., k], increasing
        mass = torch.stack([torch.where(probs >= ts[..., j:j + 1], probs, 0.0).sum(dim=-1)
                            for j in range(k)], dim=-1)
        ok = mass >= top_p
        lo, hi = (torch.where(ok, ts, lo[..., None]).amax(dim=-1),
                  torch.where(ok, hi[..., None], ts).amin(dim=-1))
    return torch.where(probs >= lo[..., None], logits, NEG_INF)


TOP_P_IMPLS = {"exact": top_p_filter, "bisect": top_p_filter_bisect,
               "bisect_mw": top_p_filter_bisect_multiway}


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 ``h`` in [0, 2³²), split in 16-bit halves
    so no intermediate leaves int64 (CPU uint32 arithmetic is not reliable)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def gumbel_noise(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, V] f32 from the counter hash of (seed, column)
    — bit-for-bit the kernel's: h = col·0x9E3779B9 + seed, murmur3 fmix32,
    u = (h >> 9)·2⁻²³ + 2⁻²⁴, g = −log(−log u)."""
    col = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    seed = seeds.to(torch.int64)[:, None] & _U32
    h = (_mul_u32(col, 0x9E3779B9)[None, :] + seed) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    u = (h >> 9).float() * (2.0**-23) + (2.0**-24)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temperature: float, top_p: float,
           seeds: torch.Tensor, top_p_impl: str = "bisect") -> torch.Tensor:
    """Token ids [B] int32: greedy argmax at ``temperature == 0``, else a
    Gumbel-max draw from the tempered, top-p-filtered distribution."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    scaled = logits.float() / max(temperature, 1e-6)
    filtered = TOP_P_IMPLS[top_p_impl](scaled, top_p)
    noisy = filtered + gumbel_noise(seeds, logits.shape[-1])
    return noisy.argmax(dim=-1).to(torch.int32)


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """RAW-model log-probability of ``tokens`` under ``logits`` ([..., V] ×
    [...] → [...] f32) — the rollout-time behavior logprob (unscaled
    log_softmax, the RLHF/vLLM convention)."""
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tokens[..., None].long())[..., 0]
    return picked - logz


def fused_sample_scores(logits: torch.Tensor, temperature: float, top_p: float,
                        seeds: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """The [B, V] scores whose first argmax is the fused sampler's token: the
    raw logits at ``temperature == 0``, else the bisect-filtered tempered
    logits plus the (seed, column) Gumbel noise — the kernel's arithmetic in
    its order (division by t, exp(scaled − max)/Σ, low-end threshold)."""
    raw = logits.float()
    if temperature == 0.0:
        return raw
    scaled = raw / max(temperature, 1e-6)
    m = scaled.max(dim=-1, keepdim=True).values
    e = torch.exp(scaled - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    lo = _bisect_threshold(probs, top_p, iters)
    filtered = torch.where(probs >= lo[:, None], scaled, NEG_INF)
    return filtered + gumbel_noise(seeds, raw.shape[-1])


def fused_sample_reference(logits: torch.Tensor, temperature: float,
                           top_p: float, seeds: torch.Tensor,
                           iters: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: (tokens [B] int32,
    raw-basis logprobs [B] f32), on whatever device the inputs are."""
    scores = fused_sample_scores(logits, temperature, top_p, seeds, iters)
    tok = scores.argmax(dim=-1)
    return tok.to(torch.int32), token_logprob(logits, tok)


def _check_fused_args(logits: torch.Tensor, seeds: torch.Tensor) -> None:
    if logits.dim() != 2 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be [B, V] with V >= 1, got {tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (logits.shape[0],):
        raise ValueError(
            f"seeds must be int32 [{logits.shape[0]}], got {seeds.dtype} "
            f"{tuple(seeds.shape)}")
    if seeds.device != logits.device:
        raise ValueError(f"seeds on {seeds.device}, logits on {logits.device}")
    if not logits.is_contiguous() or not seeds.is_contiguous():
        raise ValueError("logits and seeds must be contiguous")


@dataclass(frozen=True)
class SamplePlan:
    """One cluster of ``cluster`` blocks per row, each of ``threads`` threads
    holding ``cols`` columns of the row and each thread's band sums in
    ``smem_bytes`` of dynamic shared memory; ``blocks`` in all."""

    cluster: int
    threads: int
    cols: int
    smem_bytes: int
    blocks: int


def _block(vocab: int, cluster: int) -> tuple[int, int, int]:
    """(columns, threads, shared-memory bytes) of one block of a cluster of
    ``cluster`` over ``vocab`` columns: whole quads, the fewest threads (a
    multiple of 32, at least 64) that hold them at ``MAX_QUADS`` quads a
    thread (fewer threads, fewer band sums)."""
    cols = 4 * math.ceil(vocab / (4 * cluster))
    threads = max(64, 32 * math.ceil(cols / (4 * MAX_QUADS * 32)))
    return cols, threads, SAMPLE_RED_BYTES + 4 * cols + 4 * SAMPLE_BANDS * threads


def _fits(vocab: int, cluster: int) -> bool:
    _, threads, smem = _block(vocab, cluster)
    return threads <= 1024 and smem <= SAMPLE_SMEM_LIMIT


#: the largest vocabulary one cluster of 16 blocks holds: the most columns a
#: block of t threads holds (MAX_QUADS quads a thread, within the shared
#: memory beside its band sums), at the best t
MAX_SAMPLE_VOCAB = CLUSTER_SIZES[-1] * max(
    min(4 * MAX_QUADS * t, (SAMPLE_SMEM_LIMIT - SAMPLE_RED_BYTES - 4 * SAMPLE_BANDS * t) // 16 * 4)
    for t in range(64, 1025, 32))


@functools.lru_cache(maxsize=256)
def plan_sample_cluster(rows: int, vocab: int, sms: int = SMS) -> SamplePlan:
    """The launch of K1 for ``rows`` rows of ``vocab`` logits, from the
    shapes alone. The cluster is the smallest size whose blocks hold their
    slice of the row on chip, doubled while the grid has fewer blocks than
    ``sms`` or a block's shared memory keeps a second one off its SM (one
    block's arithmetic then fills the other's cluster barriers), as long as
    each block keeps ``MIN_BLOCK_COLS`` columns: C = 1 for a small
    vocabulary, 8 at Qwen2.5's 152,064 and 64 rows. The blocks take
    ``cols`` columns each (``_block``; the last block the rest). Raises
    ``ValueError`` for a vocabulary beyond ``MAX_SAMPLE_VOCAB``."""
    if rows < 0 or vocab < 1 or sms < 1:
        raise ValueError(f"plan_sample_cluster takes rows >= 0, vocab >= 1 and sms >= 1, got "
                         f"rows={rows}, vocab={vocab}, sms={sms}")
    fits = [c for c in CLUSTER_SIZES if _fits(vocab, c)]
    if not fits:
        raise ValueError(f"a vocabulary of {vocab} does not fit one cluster of "
                         f"{CLUSTER_SIZES[-1]} blocks of {SAMPLE_SMEM_LIMIT} bytes of shared "
                         f"memory (at most {MAX_SAMPLE_VOCAB})")
    cluster = fits[0]
    while cluster < CLUSTER_SIZES[-1] and vocab / (2 * cluster) >= MIN_BLOCK_COLS and (
            rows * cluster < sms or 2 * (_block(vocab, cluster)[2] + 1024) > SM_SMEM):
        cluster *= 2
    cols, threads, smem = _block(vocab, cluster)
    return SamplePlan(cluster, threads, cols, smem, rows * cluster)


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (builds at
    first use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    return _declare(_build.load("fused_sample").lib)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C signatures, declared once (a build of csrc/fused_sample.cu)."""
    if lib.fused_sample_launch.argtypes is None:
        lib.fused_sample_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fused_sample_launch.restype = ctypes.c_int
        lib.fused_sample_max_active_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fused_sample_max_active_clusters.restype = ctypes.c_int
        lib.fused_sample_error_string.argtypes = [ctypes.c_int]
        lib.fused_sample_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fused_sample_error_string(err).decode()
        raise RuntimeError(f"fused_sample {what} failed: {msg} ({err})")


def max_active_clusters(plan: SamplePlan, device: int = 0) -> int:
    """How many clusters of ``plan``'s shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _kernel_lib()
    out = ctypes.c_int(0)
    _raise_on(lib, lib.fused_sample_max_active_clusters(
        plan.cluster, plan.threads, plan.cols, device, ctypes.addressof(out)),
        "occupancy query")
    return out.value


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_sample(logits: torch.Tensor, temperature: float, top_p: float,
                 seeds: torch.Tensor, *, iters: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B] int32, raw-basis logprobs [B] f32) for f32 logits [B, V]
    and int32 seeds [B]. On a CUDA tensor: one launch of the Hopper kernel
    on the current stream, shaped by ``plan_sample_cluster(B, V)`` (which
    raises for a vocabulary it cannot hold), or an exception — never a
    fallback. On a CPU tensor: the plain version."""
    _check_fused_args(logits, seeds)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if logits.device.type == "cpu":
        return fused_sample_reference(logits, temperature, top_p, seeds, iters)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample runs on cuda or cpu, got {logits.device}")
    return _launch(logits, temperature, top_p, seeds, iters)


def _launch(logits: torch.Tensor, temperature: float, top_p: float, seeds: torch.Tensor,
            iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1 (none for B == 0); outputs from ``torch.empty``, no
    scratch."""
    b, v = logits.shape
    plan = plan_sample_cluster(b, v)
    tok = torch.empty((b,), dtype=torch.int32, device=logits.device)
    logp = torch.empty((b,), dtype=torch.float32, device=logits.device)
    if b == 0:
        return tok, logp
    lib = _kernel_lib()
    _raise_on(lib, lib.fused_sample_launch(
        logits.data_ptr(), float(temperature), float(top_p), seeds.data_ptr(),
        tok.data_ptr(), logp.data_ptr(), b, v, iters, plan.cluster, plan.threads,
        plan.cols, logits.device.index or 0, _stream(logits.device)),
        "kernel launch")
    launch_count.add(__name__, "fused_sample_launches")
    return tok, logp


def sample_with_logprob(
    logits: torch.Tensor, temperature: float, top_p: float,
    seeds: torch.Tensor, *, top_p_impl: str = "bisect",
    capture_logprob: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The engines' one sampling entry point: (tokens [B] int32, behavior
    logprobs [B] or None). "bisect" runs ``fused_sample`` (K1 on a CUDA
    tensor, its plain version on a CPU one); "bisect_mw" runs K1 on a CUDA
    tensor and the multi-pass ``sample`` with the multiway filter on a CPU
    one (the JAX package's dispatch on and off its accelerator); "exact"
    runs ``sample`` with the sort filter everywhere."""
    if top_p_impl not in TOP_P_IMPLS:
        raise ValueError(f"unknown top_p_impl {top_p_impl!r}")
    if top_p_impl == "bisect" or (top_p_impl == "bisect_mw"
                                  and logits.device.type == "cuda"):
        tok, logp = fused_sample(logits.float().contiguous(), temperature,
                                 top_p, seeds)
        return tok, (logp if capture_logprob else None)
    tok = sample(logits, temperature, top_p, seeds, top_p_impl=top_p_impl)
    return tok, (token_logprob(logits, tok) if capture_logprob else None)
