"""Paged decode attention: the hand-written Hopper kernel K2 and its plain
PyTorch version.

K2 (``csrc/paged_attention.cu``) replaces the JAX package's three native
TPU launches, ``paged_attention_native`` / ``_folded`` / ``_blocked``
(``ops/paged_native.py``), and the jaxlib launches ``paged_attention_gqa`` /
``paged_attention_int8`` (``ops/paged_int8.py``): all five compute one
function, single-token GQA decode attention over a page table.

For each row b and kv head k, with G = H / K query heads per kv head:

* q ``[G, hd]`` is already scaled by ``hd**-0.5`` (the op's contract);
* the pages ``tables[b, j]``, clipped to ``[0, total_pages - 1]``, are
  walked for ``j · ps < length[b]`` (pages past the length are not read);
* scores ``q · kᵀ`` in f32 are masked to ``NEG_INF`` at positions ``>=
  length``; an online softmax (m, l, acc) runs in f32;
* int8 pages dequantize as ``w · (scale · (1 / 127.5))``;
* the output ``acc / max(l, 1e-30)`` has q's dtype, so a row of length 0
  gives 0, never NaN. Head ``h = k · G + g``.

``paged_attention_native`` launches the kernel on a CUDA tensor or raises;
on a CPU tensor it runs ``paged_attention_native_reference``. Each launch
adds one to ``paged_attention_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distrl_llm_tpu_torch.ops.attention import NEG_INF
from distrl_llm_tpu_torch.ops.paged import MAX_INT8

#: launches of the CUDA kernel; CPU calls, which run the plain version, do
#: not count
paged_attention_launches = 0

# dtype codes of the C launcher
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_THREADS = 256  # the kernel's block size (kThreads in the source)
_MAX_ACC = 8  # accumulators per thread (kMaxAcc)
_SMEM_LIMIT = 232448  # dynamic shared memory a block can use on Hopper


def paged_attention_native_reference(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_indices: torch.Tensor,
    k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
    *, pages_per_block: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of K2, on whatever device the inputs are: the
    per-page online softmax in f32 (pages past a row's length leave the
    running state untouched), int8 dequantized as ``w · (s · (1/127.5))``.
    The result does not depend on ``pages_per_block``: a fully masked page
    inside a block adds ``exp(NEG_INF - m) = 0`` and rescales by 1."""
    if pages_per_block < 1:
        raise ValueError(f"pages_per_block must be >= 1, got {pages_per_block}")
    b, h, hd = q.shape
    kh, total_pages, ps, _ = k_pages.shape
    g = h // kh
    pps = page_indices.shape[1]
    tables = page_indices.long().clamp(0, total_pages - 1)
    lens = lengths.long()
    qf = q.float().reshape(b, kh, g, hd)
    m = torch.full((b, kh, g, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, 1), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((b, kh, g, hd), dtype=torch.float32, device=q.device)
    pos0 = torch.arange(ps, device=q.device)
    for j in range(pps):
        live = j * ps < lens  # [B]
        if not bool(live.any()):
            break
        tab = tables[:, j]
        k = k_pages[:, tab].float().transpose(0, 1)  # [B, K, ps, hd]
        v = v_pages[:, tab].float().transpose(0, 1)
        if k_scales is not None:
            k = k * (k_scales[:, tab].transpose(0, 1) * (1.0 / MAX_INT8))
            v = v * (v_scales[:, tab].transpose(0, 1) * (1.0 / MAX_INT8))
        s = qf @ k.transpose(-1, -2)  # [B, K, G, ps]
        valid = (j * ps + pos0)[None, :] < lens[:, None]  # [B, ps]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        upd = live[:, None, None, None]
        l = torch.where(upd, alpha * l + p.sum(dim=-1, keepdim=True), l)  # noqa: E741
        acc = torch.where(upd, acc * alpha + p @ v, acc)
        m = torch.where(upd, m_new, m)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, hd).to(q.dtype)


def _check_args(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                pages_per_block) -> None:
    if q.dim() not in (3, 4) or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] ([B, S, H, hd] for the verify) and "
                         f"pages [K, P, ps, hd], got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    kh, total_pages, ps, hd_k = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must have one shape and dtype")
    if hd_k != hd:
        raise ValueError(f"head_dim mismatch: {hd_k} vs {hd}")
    if kh < 1 or h % kh:
        raise ValueError(f"H={h} not divisible by K={kh}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_pages.dtype == torch.int8
    if k_pages.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"pages must be float32, bfloat16 or int8, got {k_pages.dtype}")
    if quantized != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need k_scales and v_scales; float pages take none")
    if quantized:
        want = (kh, total_pages, ps, 1)
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(sc.shape) != want or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {want}, got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 [{b}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if (page_indices.dtype != torch.int32 or page_indices.dim() != 2
            or page_indices.shape[0] != b or page_indices.shape[1] < 1):
        raise ValueError(f"page_indices must be int32 [{b}, pps >= 1], got "
                         f"{page_indices.dtype} {tuple(page_indices.shape)}")
    if pages_per_block < 1:
        raise ValueError(f"pages_per_block must be >= 1, got {pages_per_block}")
    tensors = [q, k_pages, v_pages, lengths, page_indices] + (
        [k_scales, v_scales] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def smem_bytes(groups: int, head_dim: int, page_size: int, pages_per_block: int,
               kv_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (the layout in the source): the
    scores of ``pages_per_block`` pages, q and the running m/l/alpha in f32,
    one staged K or V page in its stored type, and its int8 scales."""
    floats = groups * head_dim + 3 * groups + groups * pages_per_block * page_size
    page = -(-page_size * head_dim * kv_dtype.itemsize // 16) * 16
    return -(-4 * floats // 16) * 16 + page + 4 * page_size


@functools.lru_cache(maxsize=None)
def _check_kernel_geometry(groups: int, hd: int, ps: int, ppb: int,
                           kv_dtype: torch.dtype) -> None:
    """What the kernel's thread layout and staging take (raises otherwise);
    checked once per geometry."""
    if hd < 8 or hd > _THREADS or _THREADS % hd:
        raise ValueError(f"head_dim must divide {_THREADS} and be >= 8, got {hd}")
    if -(-groups // (_THREADS // hd)) > _MAX_ACC:
        raise ValueError(f"{groups} query heads per kv head at head_dim {hd} exceed "
                         f"the kernel's {_MAX_ACC} accumulators per thread")
    if ps % 4:
        raise ValueError(f"page_size must be a multiple of 4, got {ps}")
    if (ps * hd * kv_dtype.itemsize) % 16:
        raise ValueError(f"a page of {ps} x {hd} {kv_dtype} is not a multiple of "
                         "16 bytes")
    need = smem_bytes(groups, hd, ps, ppb, kv_dtype)
    if need > _SMEM_LIMIT:
        raise ValueError(f"pages_per_block={ppb} needs {need} bytes of shared "
                         f"memory, above the card's {_SMEM_LIMIT}")


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (builds at
    first use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    lib = _build.load("paged_attention").lib
    if lib.paged_attention_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_native(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_indices: torch.Tensor,
    k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
    *, pages_per_block: int = 8,
) -> torch.Tensor:
    """Decode attention over pages: q [B, H, hd] pre-scaled, bf16 or f32;
    pages [K, P, ps, hd] bf16/f32, or int8 with f32 ``k_scales``/``v_scales``
    [K, P, ps, 1]; lengths int32 [B]; page_indices int32 [B, pps] →
    [B, H, hd] in q's dtype. On a CUDA tensor: one launch of K2 on the
    current stream, or an exception, never a fallback. On a CPU tensor: the
    plain version. ``pages_per_block`` (clamped to pps) is the number of
    pages the kernel scores per softmax update."""
    global paged_attention_launches
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, hd], got {tuple(q.shape)}")
    _check_args(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                pages_per_block)
    if q.device.type == "cpu":
        return paged_attention_native_reference(
            q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
            pages_per_block=pages_per_block)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_native runs on cuda or cpu, got {q.device}")
    b, h, hd = q.shape
    kh, total_pages, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    ppb = min(pages_per_block, pps)
    _check_kernel_geometry(h // kh, hd, ps, ppb, k_pages.dtype)
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and the pages must be 16-byte aligned")
    lib = _kernel_lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        b, h, kh, hd, total_pages, ps, pps, ppb,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
        q.device.index or 0, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} ({err})")
    paged_attention_launches += 1
    return out


# --------------------------------------------------------------------------
# K5: the speculative draft-block verify
#
# K5 (``csrc/paged_verify.cu``) replaces the JAX package's
# ``paged_attention_native_verify`` (``ops/paged_native.py``, body
# ``_make_verify_kernel``): K2's function with an S-query draft block per
# row. For row b, kv head k and query row r = i · G + g (draft position i,
# query head h = k · G + g):
#
# * q [B, S, H, hd] is already scaled by hd**-0.5;
# * the pages ``tables[b, j]``, clipped to [0, total_pages - 1], are walked
#   for j · ps < lengths[b] + S (the block's own KV is resident: the verify
#   forward writes it first), never past the table;
# * scores in f32 are NEG_INF at positions >= lengths[b] + i + 1, each
#   query's own causal limit; int8 pages dequantize as w · (s · (1/127.5));
# * an online softmax over the pages; the output acc / max(l, 1e-30) has
#   q's dtype. Every query attends at least position 0, so no row is empty.
#
# ``paged_attention_native_verify`` launches K5 on a CUDA tensor or raises;
# on a CPU tensor it runs ``paged_attention_native_verify_reference``. Each
# launch adds one to ``paged_verify_launches``.

#: launches of K5; CPU calls, which run the plain version, do not count
paged_verify_launches = 0

_VERIFY_ACC = 8  # row accumulators per thread in K5 (kAcc; see csrc/paged_verify.cu)
_VERIFY_PPB = 2  # pages scored per softmax update by default


def paged_attention_native_verify_reference(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_indices: torch.Tensor,
    k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
    *, pages_per_block: int = _VERIFY_PPB,
) -> torch.Tensor:
    """Plain PyTorch version of K5, on whatever device the inputs are: the
    per-page online softmax in f32 over [B, K, S·G] query rows, each row
    masked at its own limit ``lengths + i + 1``; pages past ``lengths + S``
    leave the running state untouched. The result does not depend on
    ``pages_per_block`` (a page fully masked for a row adds exp(NEG_INF -
    m) = 0 and rescales by 1)."""
    if pages_per_block < 1:
        raise ValueError(f"pages_per_block must be >= 1, got {pages_per_block}")
    b, s, h, hd = q.shape
    kh, total_pages, ps, _ = k_pages.shape
    g = h // kh
    pps = page_indices.shape[1]
    tables = page_indices.long().clamp(0, total_pages - 1)
    lens = lengths.long()
    dev = q.device
    # [B, S, H, hd] -> [B, K, S·G, hd]: head h = k·G + g, row r = i·G + g
    qf = (q.float().reshape(b, s, kh, g, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, kh, s * g, hd))
    limit = lens[:, None] + (torch.arange(s * g, device=dev) // g)[None, :] + 1  # [B, S·G]
    m = torch.full((b, kh, s * g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, s * g, 1), dtype=torch.float32, device=dev)  # noqa: E741
    acc = torch.zeros((b, kh, s * g, hd), dtype=torch.float32, device=dev)
    pos0 = torch.arange(ps, device=dev)
    for j in range(pps):
        live = j * ps < lens + s  # [B]
        if not bool(live.any()):
            break
        tab = tables[:, j]
        k = k_pages[:, tab].float().transpose(0, 1)  # [B, K, ps, hd]
        v = v_pages[:, tab].float().transpose(0, 1)
        if k_scales is not None:
            k = k * (k_scales[:, tab].transpose(0, 1) * (1.0 / MAX_INT8))
            v = v * (v_scales[:, tab].transpose(0, 1) * (1.0 / MAX_INT8))
        sc = qf @ k.transpose(-1, -2)  # [B, K, S·G, ps]
        valid = (j * ps + pos0)[None, None, :] < limit[:, :, None]  # [B, S·G, ps]
        sc = torch.where(valid[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        upd = live[:, None, None, None]
        l = torch.where(upd, alpha * l + p.sum(dim=-1, keepdim=True), l)  # noqa: E741
        acc = torch.where(upd, acc * alpha + p @ v, acc)
        m = torch.where(upd, m_new, m)
    out = acc / torch.clamp(l, min=1e-30)
    return (out.reshape(b, kh, s, g, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, s, h, hd).to(q.dtype))


def verify_row_tiles(rows: int, head_dim: int) -> tuple[int, int]:
    """(row tiles, rows per tile) of K5's grid: one block serves up to
    ``8 · (256 / hd)`` query rows of one (row, kv head); more rows split
    into balanced tiles along the grid's fastest axis."""
    cap = _VERIFY_ACC * (_THREADS // head_dim)
    tiles = -(-rows // cap)
    return tiles, -(-rows // tiles)


@functools.lru_cache(maxsize=None)
def _check_verify_geometry(rows: int, hd: int, ps: int, ppb: int,
                           kv_dtype: torch.dtype) -> None:
    if hd < 8 or hd > _THREADS or _THREADS % hd:
        raise ValueError(f"head_dim must divide {_THREADS} and be >= 8, got {hd}")
    if ps % 4:
        raise ValueError(f"page_size must be a multiple of 4, got {ps}")
    if (ps * hd * kv_dtype.itemsize) % 16:
        raise ValueError(f"a page of {ps} x {hd} {kv_dtype} is not a multiple of "
                         "16 bytes")
    _, tile_rows = verify_row_tiles(rows, hd)
    # K5's shared memory is K2's layout with the tile's rows for the heads
    need = smem_bytes(tile_rows, hd, ps, ppb, kv_dtype)
    if need > _SMEM_LIMIT:
        raise ValueError(f"pages_per_block={ppb} with {tile_rows} query rows needs "
                         f"{need} bytes of shared memory, above the card's {_SMEM_LIMIT}")


@functools.cache
def _verify_lib() -> ctypes.CDLL:
    """The built K5 library with its C signatures declared (builds at first
    use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    lib = _build.load("paged_verify").lib
    if lib.paged_verify_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_verify_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.paged_verify_launch.restype = ctypes.c_int
        lib.paged_verify_error_string.argtypes = [ctypes.c_int]
        lib.paged_verify_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_native_verify(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_indices: torch.Tensor,
    k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
    *, pages_per_block: int = _VERIFY_PPB,
) -> torch.Tensor:
    """Draft-block verify attention over pages: q [B, S, H, hd] pre-scaled,
    bf16 or f32; pages [K, P, ps, hd] bf16/f32, or int8 with f32
    ``k_scales``/``v_scales`` [K, P, ps, 1]; lengths int32 [B], the tokens
    resident before the block; page_indices int32 [B, pps] → [B, S, H, hd]
    in q's dtype, query i attending ``[0, lengths + i + 1)``. On a CUDA
    tensor: one launch of K5 on the current stream, or an exception, never a
    fallback. On a CPU tensor: the plain version."""
    global paged_verify_launches
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, hd], got {tuple(q.shape)}")
    b, s, h, hd = q.shape
    if s < 1:
        raise ValueError("the draft block needs S >= 1 queries")
    _check_args(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                pages_per_block)
    if q.device.type == "cpu":
        return paged_attention_native_verify_reference(
            q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
            pages_per_block=pages_per_block)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_native_verify runs on cuda or cpu, got {q.device}")
    kh, total_pages, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    ppb = min(pages_per_block, pps)
    rows = s * (h // kh)
    _check_verify_geometry(rows, hd, ps, ppb, k_pages.dtype)
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and the pages must be 16-byte aligned")
    tiles, tile_rows = verify_row_tiles(rows, hd)
    lib = _verify_lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_verify_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        b, s, h, kh, hd, total_pages, ps, pps, ppb, tiles, tile_rows,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
        q.device.index or 0, stream)
    if err != 0:
        msg = lib.paged_verify_error_string(err).decode()
        raise RuntimeError(f"paged_verify kernel launch failed: {msg} ({err})")
    paged_verify_launches += 1
    return out
