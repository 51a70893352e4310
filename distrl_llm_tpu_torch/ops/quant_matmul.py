"""Dequant-matmul over a quantized base weight with the LoRA delta fused into
its epilogue: the hand-written Hopper kernel K3 and its plain PyTorch version.

K3 (``csrc/quant_matmul.cu``) replaces the JAX package's
``ops/quant_matmul.py::quant_matmul`` (the Pallas kernel ``_kernel_body``).
With T the dtype of x (bf16 or f32) and "T(...)" one rounding:

    w = T(q · scale in f32)                 # dequantize(w, T), exactly
    y = T(x @ w, summed in f32) [+ bias]    # bias added in T
    y = y + T(T(T(x @ A) @ B) · T(lora_scale))   # with an adapter

the TPU kernel's rounding order; A and B (f32 or bf16) are cast to T.

``quant_matmul`` launches K3 on CUDA tensors or raises, never falling back;
on CPU tensors it runs ``quant_matmul_reference``. Both go through one
``torch.autograd.Function`` whose backward is the gradient of the plain math
written in PyTorch (as the JAX package's ``jax.custom_vjp`` runs ``jax.vjp``
over its reference): dx, dA and dB, and dbias for a bias that asks for one;
q and scale get none. Each launch adds one to ``quant_matmul_launches``
(and one with a rank above 64, which the kernel walks in chunks, to
``quant_matmul_rank_chunks_launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from distrl_llm_tpu_torch.ops import launch_count
from distrl_llm_tpu_torch.ops.quant import dequantize, group_size_of, quant_bits

#: launches of the CUDA kernel; CPU calls, which run the plain version, do
#: not count
quant_matmul_launches = 0
#: the launches among them whose adapter takes more than one rank chunk
#: (rank above ``RANK_CHUNK``)
quant_matmul_rank_chunks_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K_STEP = 32  # the input dim must be a multiple of it
RANK_CHUNK = 64  # adapter columns a chunk of the kernel's rank loop (32 up to rank 32)

# split-K planning for the bf16 kernel (``plan_split_k``)
SMS = 132  # the H100 SXM's streaming multiprocessors
STAGE_K = 64  # K rows per pipeline stage of the bf16 kernel
DECODE_MAX_M = 512  # at or below: 64-token tiles, split over K; above: 256, no split
TARGET_WAVES = 4  # split until the grid holds this many blocks per SM
MIN_SPLIT_K = 384  # no split shorter than this many K rows (six stages)


@dataclass(frozen=True)
class SplitPlan:
    """How one bf16 call of K3 is cut: tiles of ``block_m`` x ``block_n``
    outputs, K in ``splits`` ranges of ``k_per_split`` rows (the last one
    ends at K), ``blocks`` blocks in all."""

    block_m: int
    block_n: int
    splits: int
    k_per_split: int
    blocks: int

    def workspace_numel(self, m: int, n: int, rank: int, itemsize: int = 2) -> int:
        """f32 elements of a call's scratch: with a split, each split's
        partial y [M, N] and partial x·A [M, rank]; without, xa = T(x·A)
        [M, r] in x's dtype (``itemsize`` bytes: bf16 2, f32 4; r the rank
        padded to whole chunks, ``plan_rank``), which a first kernel of the
        call writes for the main kernel's epilogue."""
        if self.splits > 1:
            return self.splits * m * (n + rank)
        tile, chunks = plan_rank(rank)
        return m * tile * chunks * itemsize // 4


def plan_rank(rank: int) -> tuple[int, int]:
    """How K3 walks an adapter of ``rank`` columns: (R, chunks), chunks of R
    columns, R = 32 up to rank 32, else ``RANK_CHUNK``; the last chunk
    zero-padded. Every route loops over the chunks, so K3 takes any rank, as
    the TPU kernel does; (0, 0) without an adapter."""
    if rank < 0:
        raise ValueError(f"an adapter rank is >= 0, got {rank}")
    if rank == 0:
        return 0, 0
    tile = 32 if rank <= 32 else RANK_CHUNK
    return tile, -(-rank // tile)


def plan_split_k(m: int, k: int, n: int, group: int, sms: int = SMS) -> SplitPlan:
    """The bf16 kernel's tiling of an [m, k] x [k, n] call whose scales come
    in groups of ``group`` rows (``k`` for per-column scales). Up to
    ``DECODE_MAX_M`` rows (decode at 64, the verify step at 320) the tiles
    are 64 tokens x 128 columns, and K is split in two or more, until the
    grid holds ``TARGET_WAVES`` x ``sms`` blocks: each split a multiple of
    the stage (64 rows) and of the group, at least ``MIN_SPLIT_K`` rows (the
    last one takes what is left). Above it
    (prefill, the learner's 12,400 rows) the tiles are 256 x 128 and K is
    never split."""
    if m > DECODE_MAX_M:
        bm, bn = 256, 128
        return SplitPlan(bm, bn, 1, k, math.ceil(m / bm) * math.ceil(n / bn))
    bm, bn = 64, 128
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    unit = math.lcm(STAGE_K, group) if group < k else STAGE_K
    units = math.ceil(k / unit)
    # splits that would fill the card; at least two, so that x·A runs in the
    # first column block's K loop and not in a kernel of its own (at 320
    # rows the latter cost more than the split's reduce)
    want = max(2, math.ceil(TARGET_WAVES * sms / tiles))
    per = max(math.ceil(MIN_SPLIT_K / unit), math.ceil(units / want))  # units a split
    splits = math.ceil(units / per)
    if splits == 1:
        return SplitPlan(bm, bn, 1, k, tiles)
    return SplitPlan(bm, bn, splits, per * unit, tiles * splits)


def _payload(w: dict) -> torch.Tensor:
    return w["q4"] if "q4" in w else w["q"]


def _lora_scale_t(lora_scale: float, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The LoRA scale as a 0-dim tensor of the activation dtype: the delta is
    multiplied by its rounded value, as the JAX package does."""
    return torch.tensor(lora_scale, dtype=dtype, device=device)


def quant_matmul_reference(x: torch.Tensor, w: dict, bias: torch.Tensor | None = None,
                           lora_a: torch.Tensor | None = None,
                           lora_b: torch.Tensor | None = None,
                           lora_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K3, differentiable by autograd, on whatever
    device the inputs are: the weight dequantized to x's dtype, every
    product summed in f32 and rounded once to x's dtype, in K3's order."""
    k, n = x.shape[-1], w["scale"].shape[-1]
    x2 = x.reshape(-1, k)
    dt = x.dtype
    y = (x2.float() @ dequantize(w, dt).float()).to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    if lora_a is not None:
        xa = (x2.float() @ lora_a.to(dt).float()).to(dt)
        xab = (xa.float() @ lora_b.to(dt).float()).to(dt)
        y = y + xab * _lora_scale_t(lora_scale, dt, x.device)
    return y.reshape(*x.shape[:-1], n)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (builds at
    first use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    lib = _build.load("quant_matmul").lib
    if lib.quant_matmul_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.quant_matmul_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, i32,
            i32, i32, i32, i32, i32, ptr]
        lib.quant_matmul_launch.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _rounded_scale(lora_scale: float, dtype: torch.dtype) -> float:
    return float(_lora_scale_t(lora_scale, dtype))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def quant_matmul_launch(x2: torch.Tensor, w: dict, bias, lora_a, lora_b,
                        lora_scale: float) -> torch.Tensor:
    """One call of K3 on CUDA tensors: x2 [M, K] contiguous f32 or bf16 →
    [M, N] in x2's dtype. bf16 follows ``plan_split_k``: with a split, the
    partial sums go to an f32 workspace allocated here, and a second kernel
    of the same call sums them in a fixed order and applies the epilogue."""
    m, k = x2.shape
    q, scale = _payload(w), w["scale"]
    n = scale.shape[-1]
    group = group_size_of(w)
    dt = x2.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"K3 takes f32 or bf16 activations, got {dt}")
    if k % K_STEP:
        raise ValueError(f"K3 needs an input dim divisible by {K_STEP}, got {k}")
    if group % 2 and group != k:
        raise ValueError(f"K3 needs an even group size (or one group of the whole input "
                         f"dim), got {group}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"K3 takes an int8 payload and f32 scales, got {q.dtype}, {scale.dtype}")
    tensors = [x2, q, scale]
    if bias is not None:
        bias = bias.to(dt).contiguous()
        tensors.append(bias)
    rank, lora_code = 0, 0
    if lora_a is not None:
        rank = lora_a.shape[-1]
        if lora_a.dtype not in _DTYPE_CODES:
            lora_a = lora_a.float()
        lora_b = lora_b.to(lora_a.dtype)
        lora_a, lora_b = lora_a.contiguous(), lora_b.contiguous()
        lora_code = _DTYPE_CODES[lora_a.dtype]
        tensors += [lora_a, lora_b]
    if any(t.device != x2.device for t in tensors):
        raise ValueError("all of K3's inputs must be on one device")
    if not all(t.is_contiguous() for t in (x2, q, scale)):
        raise ValueError("K3 takes contiguous x, payload and scales")
    if any(t.data_ptr() % 16 for t in (x2, q, scale)):
        raise ValueError("K3 takes 16-byte aligned x, payload and scales")
    lib = _kernel_lib()
    out = torch.empty((m, n), dtype=dt, device=x2.device)
    if dt == torch.bfloat16:
        plan = plan_split_k(m, k, n, group)
    else:  # f32: the CUDA cores, 64-row tiles, one split
        plan = SplitPlan(64, 128, 1, k, math.ceil(m / 64) * math.ceil(n / 128))
    numel = plan.workspace_numel(m, n, rank, x2.element_size())
    ws = torch.empty(numel, dtype=torch.float32, device=x2.device) if numel else None
    err = lib.quant_matmul_launch(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if lora_a is None else lora_a.data_ptr(),
        None if lora_b is None else lora_b.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), m, k, n, group,
        quant_bits(w), rank, _rounded_scale(float(lora_scale), dt), _DTYPE_CODES[dt],
        lora_code, plan.block_m, plan.splits, plan.k_per_split, x2.device.index or 0,
        _stream(x2.device))
    if err != 0:
        msg = lib.quant_matmul_error_string(err).decode()
        raise RuntimeError(f"quant_matmul kernel launch failed: {msg} ({err})")
    launch_count.add(__name__, "quant_matmul_launches")
    if rank > RANK_CHUNK:
        launch_count.add(__name__, "quant_matmul_rank_chunks_launches")
    return out


class _QuantMatmul(torch.autograd.Function):
    """K3 (or, on the CPU, its plain version) forward; the gradient of the
    plain math backward, in x's dtype."""

    @staticmethod
    def forward(ctx, x2, w, bias, lora_a, lora_b, lora_scale):
        if x2.is_cuda:
            y = quant_matmul_launch(x2, w, bias, lora_a, lora_b, lora_scale)
        else:
            y = quant_matmul_reference(x2, w, bias, lora_a, lora_b, lora_scale)
        ctx.int4 = "q4" in w
        ctx.lora_scale = lora_scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x2, _payload(w), w["scale"], lora_a, lora_b)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, payload, scale, a, b = ctx.saved_tensors
        dt = x2.dtype
        w = {("q4" if ctx.int4 else "q"): payload, "scale": scale}
        g = g.contiguous()
        gx = g @ dequantize(w, dt).T if ctx.needs_input_grad[0] else None
        ga = gb = None
        if a is not None:
            ac, bc = a.to(dt), b.to(dt)
            g_xab = g * _lora_scale_t(ctx.lora_scale, dt, g.device)
            g_xa = g_xab @ bc.T
            if gx is not None:
                gx = gx + g_xa @ ac.T
            if ctx.needs_input_grad[3]:
                ga = (x2.T @ g_xa).to(a.dtype)
            if ctx.needs_input_grad[4]:
                gb = ((x2 @ ac).T @ g_xab).to(b.dtype)
        gbias = (g.sum(0).to(ctx.bias_dtype)
                 if ctx.bias_dtype is not None and ctx.needs_input_grad[2] else None)
        return gx, None, gbias, ga, gb, None


def quant_matmul(x: torch.Tensor, w: dict, bias: torch.Tensor | None = None,
                 lora_a: torch.Tensor | None = None, lora_b: torch.Tensor | None = None,
                 lora_scale: float = 1.0) -> torch.Tensor:
    """``[..., K]`` through a per-layer quantized container (``{"q": int8
    [G, g, N]}`` or ``{"q4": int8 [G, g/2, N]}`` with ``"scale"`` f32 [G, 1,
    N]), plus an optional bias [N] and an optional adapter ``lora_a`` [K, r],
    ``lora_b`` [r, N] → ``[..., N]`` in x's dtype, differentiable in x, the
    bias and the adapter. On CUDA tensors: K3, or an exception, never a
    fallback. On CPU tensors: the plain version."""
    q = _payload(w)
    if q.dim() != 3:
        raise ValueError(
            f"quant_matmul takes per-layer containers [G, g, N], got q.shape="
            f"{tuple(q.shape)} (a model holds one container per layer)")
    k = x.shape[-1]
    if q.shape[0] * group_size_of(w) != k:
        raise ValueError(f"container input dim {q.shape[0]}x{group_size_of(w)} != x's {k}")
    if (lora_a is None) != (lora_b is None):
        raise ValueError("pass both LoRA factors or neither")
    n = w["scale"].shape[-1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    if lora_a is not None:
        r = lora_a.shape[-1]
        if lora_a.dim() != 2 or tuple(lora_a.shape) != (k, r):
            raise ValueError(f"lora_a must be [{k}, r], got {tuple(lora_a.shape)}")
        if tuple(lora_b.shape) != (r, n):
            raise ValueError(f"lora_b must be [{r}, {n}], got {tuple(lora_b.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_matmul runs on cuda or cpu, got {x.device}")
    x2 = x.reshape(-1, k).contiguous()
    y = _QuantMatmul.apply(x2, w, bias, lora_a, lora_b, float(lora_scale))
    return y.reshape(*x.shape[:-1], n)
