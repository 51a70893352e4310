"""Paged KV cache ops: page tables, page writes, and paged decode attention.

Counterpart of the JAX package's ``ops/paged.py``.

* **Pages** are ``[num_kv_heads, total_pages, page_size, head_dim]`` tensors
  per layer; a row's sequence lives at the pages listed in its
  ``page_indices`` row, valid up to ``lengths[row]`` tokens. Prompts are
  PACKED (position 0 is the first real token), so decode attention reads
  each row's true ``[0, length)`` prefix only.
* **int8 pages** are a ``QuantizedPages(weight int8 [K,P,ps,hd], scales f32
  [K,P,ps,1])`` pair: one absmax scale per token and head, dequantized as
  ``w * s / 127.5`` (the jaxlib ``quantization_utils`` contract, copied here).
  ``to_int8`` rounds half to even, SATURATES to ``[-128, 127]`` and maps NaN
  (a zero scale gives ``0 * inf``) to 0, as the JAX package's conversion
  does on its backends: the element that is its vector's absmax lands at
  exactly ±127.5 and rounds to ±128, which a plain ``.to(torch.int8)``
  would wrap to -128 for the positive side.
* **Writes are in place** (``index_put_``): the port has no functional-update
  constraint, so a page write touches only the written slots and returns the
  same pages object.
* ``paged_attention_op`` is the decode-attention front door: a CUDA tensor
  launches the hand-written Hopper kernel K2 (``ops/paged_native.py``), a CPU
  tensor runs its plain version. The TPU package's choice among its paged
  launches (``impl``, ``pages_per_block``) has no counterpart: K2 is the one
  kernel. ``paged_attention_reference`` is the independent gather reference.
* ``paged_verify_op`` is the speculative draft-block verify: S queries per
  row, query i attending ``[0, lengths + i + 1)``. ``verify_impl="fused"``
  runs kernel K5 (one launch per call on a CUDA tensor, its plain version on
  a CPU one), ``"unrolled"`` S calls of ``paged_attention_op`` (K2), as the
  JAX package dispatches them. ``paged_verify_reference`` is the gather
  reference.
* ``write_tokens_to_pages`` writes S tokens per row in one scatter (the
  verify forward's block, the preemption resume's prefix), and
  ``chunked_context_attention`` is the resume's attention over the row's
  dense-gathered context (plain PyTorch, as the JAX package leaves it to
  XLA). The warm (radix-hit) prefill reads its context through
  ``gather_pages_dense`` in the compute dtype and attends with the plain
  ``ops/attention.py::attention_reference`` (``models/transformer.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distrl_llm_tpu_torch.ops.attention import NEG_INF

DEFAULT_PAGE_SIZE = 128
#: int8 quantization range: w = rint(x · 127.5 / absmax) (jaxlib's MAX_INT8)
MAX_INT8 = 127.5


class QuantizedPages(NamedTuple):
    """int8 page pool: ``weight`` int8 [K, P, ps, hd] and compact per-token
    ``scales`` f32 [K, P, ps, 1] (the absmax of each token's head vector)."""

    weight: torch.Tensor
    scales: torch.Tensor


def is_quantized_pages(pages) -> bool:
    return isinstance(pages, QuantizedPages)


def get_quantization_scales(x: torch.Tensor) -> torch.Tensor:
    """Absmax over the trailing dimension, kept as a size-1 axis."""
    return x.abs().amax(dim=-1, keepdim=True)


def to_int8(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``rint(x · (127.5 / h))`` in ``x``'s dtype, rounded half to even,
    saturated to [-128, 127], NaN to 0 (the JAX package's int8 conversion).
    ``127.5 / h`` is a true division of two tensors: PyTorch computes
    ``scalar / tensor`` as a reciprocal times the scalar, which rounds
    differently."""
    y = torch.round(x * (torch.full_like(h, MAX_INT8) / h))
    return torch.nan_to_num(y, nan=0.0).clamp(-128.0, 127.0).to(torch.int8)


def from_int8(x: torch.Tensor, h: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return x.to(dtype) * h / MAX_INT8


def quantize_pages(pages: torch.Tensor) -> QuantizedPages:
    """Float pages [K, P, ps, hd] → int8 weight + f32 scales [K, P, ps, 1]."""
    scales = get_quantization_scales(pages)
    return QuantizedPages(weight=to_int8(pages, scales),
                          scales=scales.to(torch.float32))


def init_quantized_pages(shape: tuple[int, int, int, int],
                         device: torch.device | str | None = None) -> QuantizedPages:
    """Zeroed int8 pages for ``shape`` [K, total_pages, ps, hd]."""
    return QuantizedPages(
        weight=torch.zeros(shape, dtype=torch.int8, device=device),
        scales=torch.zeros(tuple(shape[:3]) + (1,), dtype=torch.float32,
                           device=device),
    )


def dequantize_pages(pages, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if not is_quantized_pages(pages):
        return pages.to(dtype)
    return from_int8(pages.weight, pages.scales, dtype=dtype)


def pages_per_seq(max_len: int, page_size: int = DEFAULT_PAGE_SIZE) -> int:
    return -(-max_len // page_size)


def make_page_table(n_rows: int, max_len: int,
                    page_size: int = DEFAULT_PAGE_SIZE) -> np.ndarray:
    """Row-major identity page table: row r owns pages [r·pps, (r+1)·pps).
    int32 [n_rows, pages_per_seq]."""
    pps = pages_per_seq(max_len, page_size)
    return (np.arange(n_rows, dtype=np.int32)[:, None] * pps
            + np.arange(pps, dtype=np.int32)[None, :])


def init_paged_kv_cache(cfg, n_rows: int, max_len: int,
                        page_size: int = DEFAULT_PAGE_SIZE,
                        dtype: torch.dtype = torch.bfloat16,
                        device: torch.device | str | None = None,
                        kv_quant: str = "none") -> dict:
    """Per-layer page lists for ``n_rows`` sequences of capacity ``max_len``:
    ``{"k": [L × pages], "v": [L × pages]}``, pages zeroed [K, n_rows·pps,
    ps, hd] in ``dtype``, or ``QuantizedPages`` with ``kv_quant="int8"``."""
    shape = (cfg.num_kv_heads, n_rows * pages_per_seq(max_len, page_size),
             page_size, cfg.head_dim)
    return {kv: [init_pages(shape, dtype, device, kv_quant)
                 for _ in range(cfg.num_layers)] for kv in ("k", "v")}


def init_pages(shape, dtype: torch.dtype, device, kv_quant: str = "none"):
    """One zeroed page pool of ``shape`` [K, P, ps, hd]."""
    if kv_quant == "int8":
        return init_quantized_pages(shape, device)
    if kv_quant != "none":
        raise ValueError(f"kv_quant must be none/int8, got {kv_quant!r}")
    return torch.zeros(shape, dtype=dtype, device=device)


def write_prompt_to_pages(pages, prompt_kv: torch.Tensor,
                          page_indices: torch.Tensor, page_size: int):
    """Write every row's packed prompt KV [B, P, K, hd] into its leading
    ``P / page_size`` pages, in place. P must be a multiple of the page
    size (positions past a row's real length hold garbage that ``lengths``
    masking never reads)."""
    b, p, kh, hd = prompt_kv.shape
    if p % page_size:
        raise ValueError(f"prompt length {p} is not a multiple of page size {page_size}")
    n_prompt_pages = p // page_size
    # [B, P, K, hd] → [K, B·n_prompt_pages, ps, hd]
    tiles = (prompt_kv.reshape(b, n_prompt_pages, page_size, kh, hd)
             .permute(3, 0, 1, 2, 4)
             .reshape(kh, b * n_prompt_pages, page_size, hd))
    dest = page_indices[:, :n_prompt_pages].reshape(-1).long()
    if is_quantized_pages(pages):
        scales = get_quantization_scales(tiles)
        pages.weight[:, dest] = to_int8(tiles, scales)
        pages.scales[:, dest] = scales.to(pages.scales.dtype)
    else:
        pages[:, dest] = tiles.to(pages.dtype)
    return pages


def token_slots(lengths: torch.Tensor, page_indices: torch.Tensor,
                page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (page, slot) at which each row's next token goes: position
    ``lengths[row]`` of its table. The page column is clamped to the
    table's width (the JAX gather's clamping), so a write never leaves its
    own row's table. A decode forward computes this once for all layers."""
    lens = lengths.long()
    col = (lens // page_size).clamp(max=page_indices.shape[1] - 1)
    page = page_indices.gather(1, col[:, None])[:, 0].long()
    return page, lens % page_size


def write_token_at(pages, new_kv: torch.Tensor, page: torch.Tensor,
                   slot: torch.Tensor):
    """Write one token's KV [B, K, hd] per row at ``(page[row],
    slot[row])``, in place (int8 pools quantize it with its own scale)."""
    tok = new_kv.transpose(0, 1)  # [K, B, hd]
    if is_quantized_pages(pages):
        scales = get_quantization_scales(tok)  # [K, B, 1]
        pages.weight[:, page, slot] = to_int8(tok, scales)
        pages.scales[:, page, slot] = scales.to(pages.scales.dtype)
    else:
        pages[:, page, slot] = tok.to(pages.dtype)
    return pages


def write_token_to_pages(pages, new_kv: torch.Tensor, lengths: torch.Tensor,
                         page_indices: torch.Tensor, page_size: int,
                         valid: torch.Tensor | None = None):
    """Write one token's KV [B, K, hd] per row at position ``lengths[row]``,
    in place. Rows where ``valid`` is False write nothing."""
    page, slot = token_slots(lengths, page_indices, page_size)
    if valid is not None:
        keep = valid.bool()
        page, slot, new_kv = page[keep], slot[keep], new_kv[keep]
    return write_token_at(pages, new_kv, page, slot)


def tokens_slots(lengths: torch.Tensor, page_indices: torch.Tensor, page_size: int,
                 d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (page, slot) of positions ``lengths[row] + i``, i < d, flattened
    row-major to [B · d]; page columns clamp to the table's width as in
    ``token_slots``. A multi-token forward computes this once for all
    layers."""
    pos = lengths.long()[:, None] + torch.arange(d, device=lengths.device)[None, :]
    col = (pos // page_size).clamp(max=page_indices.shape[1] - 1)
    page = page_indices.long().gather(1, col).reshape(-1)
    return page, (pos % page_size).reshape(-1)


def write_tokens_to_pages(pages, new_kv: torch.Tensor, lengths: torch.Tensor,
                          page_indices: torch.Tensor, page_size: int,
                          valid: torch.Tensor | None = None):
    """Write D consecutive tokens' KV [B, D, K, hd] per row at positions
    ``lengths[row] + i``, in place, in one scatter (int8 pools quantize each
    token with its own scale). Tokens where ``valid`` [B, D] is False write
    nothing (the JAX package drops them with an out-of-range page). The
    positions of one row are distinct and rows own disjoint pages, so no two
    live writes meet; the one exception is a position past the table,
    clamped onto the row's last column, which no read window reaches."""
    b, d = new_kv.shape[:2]
    page, slot = tokens_slots(lengths, page_indices, page_size, d)
    flat = new_kv.reshape(b * d, *new_kv.shape[2:])
    if valid is not None:
        keep = valid.reshape(-1).bool()
        page, slot, flat = page[keep], slot[keep], flat[keep]
    return write_token_at(pages, flat, page, slot)


def gather_pages_dense(pages, page_indices: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each row's pages gathered into a dense position-ordered context
    [B, width·ps, K, hd]; quantized pools dequantize after the gather."""
    idx = page_indices.long()
    if is_quantized_pages(pages):
        dense = from_int8(pages.weight[:, idx], pages.scales[:, idx], dtype=dtype)
    else:
        dense = pages[:, idx].to(dtype)
    kh, b, width, ps, hd = dense.shape
    return dense.permute(1, 2, 3, 0, 4).reshape(b, width * ps, kh, hd)


def chunked_context_attention(q: torch.Tensor, ctx_k: torch.Tensor,
                              ctx_v: torch.Tensor, lengths: torch.Tensor,
                              q_valid: torch.Tensor) -> torch.Tensor:
    """Attention for a continuation (chunked) prefill over a paged cache:
    query i of row b (q [B, S, H, hd]) sits at position ``lengths[b] + i``
    and attends the context [B, Sk, K, hd] (f32, dense-gathered, already
    holding the block's own KV) at positions ``j <= lengths[b] + i``. Rows
    of invalid (padding) queries are zeroed. Returns [B, S, H, hd] in q's
    dtype."""
    b, s, h, hd = q.shape
    kh = ctx_k.shape[2]
    g = h // kh
    sk = ctx_k.shape[1]
    qg = q.reshape(b, s, kh, g, hd).float()
    logits = torch.einsum("bskgd,bjkd->bkgsj", qg, ctx_k) * (hd**-0.5)
    jpos = torch.arange(sk, device=q.device)[None, None, :]
    qpos = lengths.long()[:, None, None] + torch.arange(s, device=q.device)[None, :, None]
    causal = jpos <= qpos  # [B, S, Sk]
    logits = logits.masked_fill(~causal[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgsj,bjkd->bskgd", probs, ctx_v)
    out = torch.where(q_valid[:, :, None, None, None] > 0, out, 0.0)
    return out.reshape(b, s, h, hd).to(q.dtype)


def paged_attention_reference(q: torch.Tensor, k_pages, v_pages,
                              lengths: torch.Tensor, page_indices: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """Gather-softmax reference: each row's pages gathered, masked GQA
    attention over its valid prefix in f32 (quantized pools dequantize after
    the gather). q [B, H, hd] → [B, H, hd] in q's dtype."""
    b, h, hd = q.shape
    k = gather_pages_dense(k_pages, page_indices)  # [B, S, K, hd]
    v = gather_pages_dense(v_pages, page_indices)
    kh = k.shape[2]
    g = h // kh
    s = k.shape[1]
    if scale is None:
        scale = hd**-0.5
    qg = q.reshape(b, kh, g, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(b, h, hd).to(q.dtype)


def paged_attention_op(q: torch.Tensor, k_pages, v_pages, lengths: torch.Tensor,
                       page_indices: torch.Tensor) -> torch.Tensor:
    """Decode attention over the paged cache: q [B, H, hd] (unscaled) →
    [B, H, hd] in q's dtype. q is scaled by ``hd**-0.5`` in its own dtype
    (as the JAX op does), then ``paged_attention_native`` runs: a CUDA
    tensor launches the Hopper kernel K2, a CPU tensor its plain version."""
    from distrl_llm_tpu_torch.ops.paged_native import paged_attention_native

    scaled_q = q * (q.shape[-1] ** -0.5)
    quantized = is_quantized_pages(k_pages)
    out = paged_attention_native(
        scaled_q.contiguous(),
        k_pages.weight if quantized else k_pages,
        v_pages.weight if quantized else v_pages,
        lengths.to(torch.int32).contiguous(),
        page_indices.to(torch.int32).contiguous(),
        k_scales=k_pages.scales if quantized else None,
        v_scales=v_pages.scales if quantized else None,
    )
    return out.to(q.dtype)


def paged_verify_reference(q: torch.Tensor, k_pages, v_pages, lengths: torch.Tensor,
                           page_indices: torch.Tensor) -> torch.Tensor:
    """Gather reference for the draft-block verify: query i of q [B, S, H,
    hd] (unscaled) attends each row's ``[0, lengths + i + 1)``, ``lengths``
    counting the tokens resident before the block. [B, S, H, hd]."""
    return torch.stack([
        paged_attention_reference(q[:, i], k_pages, v_pages, lengths + i + 1,
                                  page_indices)
        for i in range(q.shape[1])], dim=1)


VERIFY_IMPLS = ("fused", "unrolled")


def paged_verify_op(q: torch.Tensor, k_pages, v_pages, lengths: torch.Tensor,
                    page_indices: torch.Tensor, *,
                    verify_impl: str = "fused") -> torch.Tensor:
    """The verify forward's attention: q [B, S, H, hd] (unscaled) over each
    row's pages, which already hold the block's own KV; query i attends
    ``[0, lengths + i + 1)``. ``"fused"``: q scaled by ``hd**-0.5`` in its
    dtype, then ``paged_attention_native_verify`` (one launch of K5 on a
    CUDA tensor, its plain version on a CPU one). ``"unrolled"``: S calls of
    ``paged_attention_op`` (S launches of K2). [B, S, H, hd] in q's dtype."""
    if verify_impl not in VERIFY_IMPLS:
        raise ValueError(f"verify_impl must be fused/unrolled, got {verify_impl!r}")
    lens = lengths.to(torch.int32)
    if verify_impl == "unrolled":
        return torch.stack([
            paged_attention_op(q[:, i], k_pages, v_pages, lens + (i + 1), page_indices)
            for i in range(q.shape[1])], dim=1)
    from distrl_llm_tpu_torch.ops.paged_native import paged_attention_native_verify

    scaled_q = q * (q.shape[-1] ** -0.5)
    quantized = is_quantized_pages(k_pages)
    out = paged_attention_native_verify(
        scaled_q.contiguous(),
        k_pages.weight if quantized else k_pages,
        v_pages.weight if quantized else v_pages,
        lens.contiguous(), page_indices.to(torch.int32).contiguous(),
        k_scales=k_pages.scales if quantized else None,
        v_scales=v_pages.scales if quantized else None,
    )
    return out.to(q.dtype)
