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
on a CPU tensor it runs ``paged_attention_native_reference``. Each call on
the card adds one to ``paged_attention_launches``, also when it runs the
merge kernel of a split.

K2 and K5 share one body (``csrc/paged_common.cuh``): the S·G query rows
of a (row, kv head) in one block up to ``MAX_ROWS`` (more take the row
tiles ``plan_row_tiles`` gives, a block each), the table split over pages
into the ranges ``plan_paged_split`` gives (flash-decoding; the partials
merged by a second kernel in split order), a cp.async ring of 64- or
128-position stages, and mma.sync for bf16 q over bf16 or int8 pages at
head_dim 64 or 128 (``MMA_SHAPES``); every
other case (f32 q or f32 pages, other head sizes) runs the same split on
the CUDA cores in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from distrl_llm_tpu_torch.ops import launch_count
from distrl_llm_tpu_torch.ops.attention import NEG_INF
from distrl_llm_tpu_torch.ops.paged import MAX_INT8

#: launches of the CUDA kernel; CPU calls, which run the plain version, do
#: not count
paged_attention_launches = 0
#: every geometry K2 or K5 launched on the card since the caller last
#: cleared it: (kernel, query rows, row tiles, rows a tile, head_dim)
launch_geometries: set[tuple[str, int, int, int, int]] = set()

# dtype codes of the C launcher
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232448  # dynamic shared memory a block can use on Hopper

# the kernels' geometry (csrc/paged_common.cuh)
MAX_ROWS = 64  # query rows (of S · G) a block serves (kMaxRows); more take row tiles
MMA_HEAD_DIMS = (64, 128)  # head sizes of the tensor-core body
# its block by (m16 tiles, 8-row halves holding query rows): positions a
# ring stage, stages, warps per m-tile (MmaCfg in the source)
MMA_SHAPES = {(1, 1): (64, 2, 4), (1, 2): (64, 3, 4), (2, 2): (64, 3, 2),
              (3, 2): (128, 2, 4), (4, 2): (64, 3, 1)}
CC_TILE, CC_STAGES = 32, 2  # the CUDA-core body's ring

# the split over pages (``plan_paged_split``)
SMS = 132  # the H100 SXM's streaming multiprocessors
TARGET_BLOCKS_PER_SM = 4  # split until the grid holds this many blocks per SM
# no split shorter than this many positions per query of a row: a split's
# partials (m, l, acc of each of its S · G query rows) then stay a small,
# fixed share of the K/V bytes it reads (~3% at G = 7, hd 128, bf16 pages),
# and it runs four 64-position stages at least
MIN_SPLIT_POSITIONS = 256


@dataclass(frozen=True)
class PagedSplitPlan:
    """How one call of K2 or K5 cuts its page table: ``splits`` ranges of
    ``pages_per_split`` whole pages (the last one ends at the table's
    width), one block per (split, row, kv head), ``blocks`` in all. A block
    whose range starts past its row's reach exits at once."""

    splits: int
    pages_per_split: int
    blocks: int

    def workspace_numel(self, batch: int, s: int, heads: int, head_dim: int) -> int:
        """f32 elements of the partials a split call writes for the merge:
        acc [splits, B, S·H, hd], then m and l [splits, B, S·H]; none for
        one split, which writes the output directly."""
        if self.splits == 1:
            return 0
        return self.splits * batch * s * heads * (head_dim + 2)


def plan_paged_split(batch: int, kv_heads: int, pps: int, page_size: int, s: int = 1,
                     sms: int = SMS) -> PagedSplitPlan:
    """The split of a table of ``pps`` pages of ``page_size`` positions for
    ``batch`` rows of ``kv_heads`` kv heads and ``s`` queries a row (K2: 1;
    K5: the draft block). From the shapes alone: the rows' lengths live on
    the card, and reading them would stop the host every step. The splits
    multiply until the grid holds ``TARGET_BLOCKS_PER_SM`` x ``sms``
    blocks: each split takes the table's pages over the splits that
    target asks for, rounded down, but at least ``MIN_SPLIT_POSITIONS`` x
    ``s`` positions (whole pages) and at most the table; the last split
    takes what is left."""
    if min(batch, kv_heads, pps, page_size, s, sms) < 1:
        raise ValueError(f"plan_paged_split takes positive sizes, got batch={batch}, "
                         f"kv_heads={kv_heads}, pps={pps}, page_size={page_size}, s={s}, "
                         f"sms={sms}")
    pairs = batch * kv_heads
    want = math.ceil(TARGET_BLOCKS_PER_SM * sms / pairs)
    least = math.ceil(MIN_SPLIT_POSITIONS * s / page_size)
    per = min(pps, max(least, pps // want, 1))
    splits = math.ceil(pps / per)
    return PagedSplitPlan(splits, per, splits * pairs)


@dataclass(frozen=True)
class RowTiles:
    """How the S·G query rows of a (row, kv head) spread over blocks:
    ``tiles`` blocks of ``rows`` query rows each, the last one the rest
    (never empty)."""

    tiles: int
    rows: int


@functools.lru_cache(maxsize=None)
def plan_row_tiles(rows: int, head_dim: int, q_dtype: torch.dtype,
                   kv_dtype: torch.dtype) -> RowTiles:
    """The row tiles of a (row, kv head)'s ``rows`` query rows: the fewest
    balanced tiles of at most ``MAX_ROWS`` rows whose block fits the card's
    shared memory (``smem_bytes``: the CUDA-core body at head_dim 256 needs
    ~2.2 KB a row, so Gemma-2B's 136 rows at d = 16 could not sit in one
    block). Up to 64 rows that fit, one tile: every shape of the earlier
    kernels keeps its block. Raises ValueError only when one row does not
    fit."""
    if rows < 1:
        raise ValueError(f"a block serves at least 1 query row, got {rows}")
    cap = MAX_ROWS
    while cap >= 1 and smem_bytes(cap, head_dim, q_dtype, kv_dtype) > _SMEM_LIMIT:
        cap -= 1
    if cap < 1:
        raise ValueError(f"one query row at head_dim {head_dim} needs "
                         f"{smem_bytes(1, head_dim, q_dtype, kv_dtype)} bytes of shared "
                         f"memory, above the card's {_SMEM_LIMIT}")
    per = -(-rows // -(-rows // cap))
    return RowTiles(-(-rows // per), per)


def kernel_route(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int) -> str:
    """Which body a call takes: ``"mma"`` (the tensor cores) for bf16 q over
    bf16 or int8 pages at head_dim 64 or 128, else ``"cuda_cores"``."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim in MMA_HEAD_DIMS):
        return "mma"
    return "cuda_cores"


def _mma_shape(rows: int) -> tuple[int, int, int, int, int]:
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"a block serves 1 to {MAX_ROWS} query rows (more take row "
                         f"tiles), got {rows}")
    mt, nh = -(-rows // 16), 1 if rows <= 8 else 2
    return (mt, nh) + MMA_SHAPES[(mt, nh)]


def mma_layout(rows: int) -> tuple[int, int]:
    """(m16 tiles, warps) of a tensor-core block serving ``rows`` query
    rows (at most ``MAX_ROWS``): the rows padded to 16-row tiles, each tile
    shared by the warps that take its share of a stage's positions
    (``MMA_SHAPES``): 4 warps for K2's 7 rows, 12 for K5's 35 and for each
    46-row tile of 91."""
    mt, _, _, _, pw = _mma_shape(rows)
    return mt, mt * pw


def smem_bytes(rows: int, head_dim: int, q_dtype: torch.dtype,
               kv_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of ``rows`` query rows (at most
    ``MAX_ROWS``) in the body ``kernel_route``
    picks (the layouts in csrc/paged_common.cuh). Tensor cores: bf16 q
    [16·MT, hd], the ring's stages (K and V tiles in their stored type, and
    int8's scales; ``MMA_SHAPES``), int8's bf16 work tiles, and the m, l of
    each warp and of the block. CUDA cores: the ring's two stages of 32
    positions (rows padded by 16 bytes), then f32 q and acc [R, hd], p
    [R, 32], m, l, alpha and the limits [R]."""
    es = kv_dtype.itemsize
    if kernel_route(q_dtype, kv_dtype, head_dim) == "mma":
        mt, _, tile, stages, pw = _mma_shape(rows)
        quant = kv_dtype == torch.int8
        stage = 2 * tile * head_dim * es + (2 * tile * 4 if quant else 0)
        work = 2 * tile * head_dim * 2 if quant else 0
        return (mt * 16 * head_dim * 2 + stages * stage + work
                + 2 * mt * pw * 16 * 4 + 2 * mt * 16 * 4)
    stage = 2 * CC_TILE * (head_dim * es + 16) + (2 * CC_TILE * 4 if es == 1 else 0)
    return CC_STAGES * stage + 4 * rows * (2 * head_dim + CC_TILE + 4)


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


@functools.lru_cache(maxsize=None)
def _check_kernel_geometry(rows: int, hd: int, q_dtype: torch.dtype,
                           kv_dtype: torch.dtype) -> str:
    """What the kernels take (raises ValueError otherwise): any number of
    query rows (S · G; ``plan_row_tiles`` spreads them over blocks whose
    shared memory fits the card), a head_dim of at least 8 whose page rows
    are a multiple of 16 bytes (the ring copies 16-byte chunks). Any page
    size. Returns the route; checked once per geometry."""
    if rows < 1:
        raise ValueError(f"{rows} query rows (S x query heads per kv head): need >= 1")
    if hd < 8 or (hd * kv_dtype.itemsize) % 16:
        raise ValueError(f"head_dim must be >= 8 with rows of a multiple of 16 bytes, got "
                         f"{hd} in {kv_dtype}")
    plan_row_tiles(rows, hd, q_dtype, kv_dtype)
    return kernel_route(q_dtype, kv_dtype, hd)


def _declare(lib: ctypes.CDLL, name: str, ints: int) -> ctypes.CDLL:
    """Declare ``<name>_launch`` (9 pointers, ``ints`` ints, the stream)
    and ``<name>_error_string`` on a built library, once."""
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [i32] * ints + [ptr]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built K2 library with its C signatures declared (builds at first
    use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    return _declare(_build.load("paged_attention").lib, "paged_attention", 13)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def paged_launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 lengths: torch.Tensor, page_indices: torch.Tensor,
                 k_scales: torch.Tensor | None, v_scales: torch.Tensor | None) -> torch.Tensor:
    """One call of K2 (q [B, H, hd]) or K5 (q [B, S, H, hd]) on checked
    CUDA tensors: the split from ``plan_paged_split``, its f32 workspace
    allocated here when it has more than one split (the kernel of the call
    writes the partials, a second one merges them), the row tiles from
    ``plan_row_tiles``, and the body ``kernel_route`` picks. Records the
    geometry it launched in ``launch_geometries`` and adds one to the
    wrapper's launch count."""
    verify = q.dim() == 4
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    s = q.shape[1] if verify else 1
    kh, total_pages, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    rows = s * (h // kh)
    _check_kernel_geometry(rows, hd, q.dtype, k_pages.dtype)
    tiles = plan_row_tiles(rows, hd, q.dtype, k_pages.dtype)
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and the pages must be 16-byte aligned")
    plan = plan_paged_split(b, kh, pps, ps, s)
    lib = _verify_lib() if verify else _kernel_lib()
    out = torch.empty_like(q)
    numel = plan.workspace_numel(b, s, h, hd)
    ws = torch.empty(numel, dtype=torch.float32, device=q.device) if numel else None
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if k_scales is not None else None,
            v_scales.data_ptr() if v_scales is not None else None,
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None)
    dims = (h, kh, hd, total_pages, ps, pps, plan.splits, plan.pages_per_split, tiles.tiles,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], q.device.index or 0,
            _stream(q.device))
    name = "paged_verify" if verify else "paged_attention"
    launch = getattr(lib, f"{name}_launch")
    err = launch(*ptrs, b, s, *dims) if verify else launch(*ptrs, b, *dims)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    launch_geometries.add((name, rows, tiles.tiles, tiles.rows, hd))
    launch_count.add(__name__, f"{name}_launches")
    if verify and tiles.tiles > 1:
        launch_count.add(__name__, "paged_verify_row_tiles_launches")
    return out


def paged_attention_native(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_indices: torch.Tensor,
    k_scales: torch.Tensor | None = None, v_scales: torch.Tensor | None = None,
    *, pages_per_block: int = 8,
) -> torch.Tensor:
    """Decode attention over pages: q [B, H, hd] pre-scaled, bf16 or f32;
    pages [K, P, ps, hd] bf16/f32, or int8 with f32 ``k_scales``/``v_scales``
    [K, P, ps, 1]; lengths int32 [B]; page_indices int32 [B, pps] →
    [B, H, hd] in q's dtype. On a CUDA tensor: one call of K2 on the current
    stream (its kernel and, for a split table, the merge), or an exception,
    never a fallback. On a CPU tensor: the plain version.
    ``pages_per_block`` is the JAX package's interface: it must be >= 1,
    and the kernel ignores it (its tiles are 64 or 32 positions, its split
    is ``plan_paged_split``'s); the result never depended on it."""
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
    return paged_launch(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales)


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
#: the launches of K5 among them whose query rows take more than one block
#: (``plan_row_tiles``)
paged_verify_row_tiles_launches = 0

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


@functools.cache
def _verify_lib() -> ctypes.CDLL:
    """The built K5 library with its C signatures declared (builds at first
    use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    return _declare(_build.load("paged_verify").lib, "paged_verify", 14)


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
    tensor: one call of K5 on the current stream (the S · G query rows of a
    (row, kv head) in one block, or in ``plan_row_tiles``'s blocks past 64;
    for a split table, the merge too), or an
    exception, never a fallback. On a CPU tensor: the plain version.
    ``pages_per_block`` must be >= 1 and is ignored by the kernel, as
    K2's."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, hd], got {tuple(q.shape)}")
    if q.shape[1] < 1:
        raise ValueError("the draft block needs S >= 1 queries")
    _check_args(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
                pages_per_block)
    if q.device.type == "cpu":
        return paged_attention_native_verify_reference(
            q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales,
            pages_per_block=pages_per_block)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_native_verify runs on cuda or cpu, got {q.device}")
    return paged_launch(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales)
