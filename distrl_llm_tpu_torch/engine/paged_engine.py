"""Paged-KV rollout engine: packed prompts, ragged decode; the wave and the
refill schedulers, and speculative decoding on the refill one.

Counterpart of the JAX package's ``engine/paged_engine.py``
(``PagedGenerationEngine``, the trainer's ``engine_impl="paged"`` engine).

* **Packed prefill.** Prompts lose their left padding; one forward runs
  over ``prompt_pages · page_size`` columns at positions ``0, 1, ...`` and
  writes every row's prompt K/V into its leading pages. Each row's sampling
  logits come from its last real position.
* **One pool, allocated once.** Every layer's page pool holds ``B ·
  prompt_pages`` shared prompt pages and the decode pages. Candidates share
  their prompt's FULL pages through the page table; the partial last
  prompt page is copied, in place, into each candidate's first private
  page, which decode then extends.
* **Waves** (``scheduler="waves"``): B·n candidate rows at once (in waves
  of whole prompt groups under ``max_concurrent_rows``), each with a
  static private region. Each step samples from the carried logits (one
  launch of the fused sampler K1 on the GPU) and runs one forward that
  writes the token at ``seq_lengths`` and attends over ``seq_lengths + 1``
  (one launch of K2 per layer). The round's last step skips the forward
  nothing reads. With ``scan_chunk`` = k > 1 the steps run k at a time,
  each chunk a CUDA graph replay on the GPU (``engine/decode_graph.py``;
  the dense engine's scaffold: ``engine.run_decode``), over page pools and
  a decode state the engine keeps at fixed addresses across waves and
  rounds; a chunk's steps all forward their token.
* **Refill** (``scheduler="refill"``, continuous batching): R =
  ``max_concurrent_rows`` decode slots; a slot whose occupant finished
  takes the next pending candidate. Decode pages come from a host-side
  ``PagePool`` (``engine/page_pool.py``) of ``max_kv_pages`` pages (0 =
  the worst case), granted as slots advance; when the pool runs dry the
  least-advanced occupant is preempted and later resumed by recompute (one
  chunked forward over its generated prefix). The host reads ``done`` and
  ``seq_lengths`` through asynchronous snapshots every ``check = min(
  decode_chunk, 16, max_steps)`` steps, one boundary late, so no step waits
  on the device. With ``scan_chunk`` = k > 1 the steps between host
  decisions run k at a time (k the largest divisor of ``check`` that is <=
  ``scan_chunk``, so every admission, grant, preemption and snapshot still
  falls on its step), each chunk a CUDA graph replay on the GPU over a
  refill state and page pools kept at fixed addresses across rounds of one
  shape; the speculative and self-drafted steps' random draws come from a
  generator registered with the graphs, so a replay draws what the eager
  steps would.
* **Speculative decoding** (refill with ``spec_draft = d > 0``): each step
  proposes d n-gram drafts per slot (``engine/speculative.py``), runs one
  verify forward over ``[last_tok, draft]`` that writes d+1 tokens' K/V per
  row and attends through ``paged_verify_op`` (kernel K5, one launch per
  layer; S = d+1 launches of K2 with ``spec_verify="unrolled"``), accepts
  by rejection sampling and emits 1..d+1 tokens. Each admission draws the
  slot's first token with K1. ``spec_drafter="self"`` drafts with the
  policy's PREVIOUS adapter (the mailbox keeps the one a push superseded):
  d single-token decode forwards (K2 per layer) whose writes the verify
  overwrites; ``spec_adapt`` halves the draft length (floor 1) when the
  accept rate's EMA between host boundaries falls below 0.35 and doubles
  it back above 0.75.
* **Riders of the refill scheduler.** ``prefix_sharing``: a group's
  candidates alias one refcounted prompt page chain and split its partial
  tail page copy-on-write at admission (the copy planned on the host,
  enqueued before the step that writes the page). ``continuous_admission``
  (implies sharing): groups wait in a request queue and are prefilled one
  at a time into pool-allocated chains as slots and pages allow.
  ``prefix_cache``: finished chains' full pages enter an engine-owned
  radix tree; a later group with the same leading pages aliases them and
  prefills only its suffix (the model's ``paged_prefix`` forward, the
  plain attention the JAX package runs there); round end parks the cached
  pages in host memory; a new adapter object drops the cache.
  ``kv_spill``: a preempted candidate's written pages and logits row are
  parked in host memory (``engine/page_pool.py::HostPageStore``, copies
  ordered on the stream) and copied back at its resume instead of a
  recompute. ``last_pool_stats`` carries the JAX package's keys.
* **The turn hook** (multi-turn episodes, ``env/driver.py``): with
  ``turn_hook`` set, the refill scheduler's idle pass offers each finished
  candidate's tokens to the hook before it releases the slot. Observation
  tokens returned are appended in place: the slot keeps its occupant, its
  pages and the conversation's KV, and one chunked forward over the
  observation (the model's ``paged_chunked`` forward, as the preemption
  resume) writes its KV and the next logits; decoding then continues in
  the same window of ``max_new_tokens``. A hook forces the refill scheduler
  and refuses the wave scheduler and speculative decoding.

Not ported (ROADMAP item 11): the gateway hooks.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.decode_graph import tensors_key
from distrl_llm_tpu_torch.engine.engine import (
    GenerationResult, LoraMailbox, ScanChunks, _host, _Snapshot, accumulate_round_stats,
    add_decode_counts, generate_in_waves, is_eos, run_decode,
)
from distrl_llm_tpu_torch.engine.page_pool import HostPageStore, PagePool, RadixCache
from distrl_llm_tpu_torch.engine.speculative import (
    SpecRefillState, draw_gumbel, draw_uniforms, propose_ngram_drafts,
    sampling_probs, spec_accept,
)
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.ops.paged import (
    init_pages, is_quantized_pages, make_page_table, pages_per_seq,
)
from distrl_llm_tpu_torch.ops.sampling import sample_with_logprob, token_logprob
from distrl_llm_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# the turn hook's telemetry series (this module is their one owner)
ENGINE_TURN_RESUMES = "engine/turn_resumes"  # counter
ENGINE_TURN_PREFILL_SAVED = "engine/turn_prefill_saved_tokens"  # counter

@dataclass
class _PagedDecodeState:
    """Decode state; every tensor is updated in place by the decode step and
    keeps its address (what a captured chunk reads it by)."""

    out: torch.Tensor  # [Bn, T] int32, pad-filled
    logps: torch.Tensor  # [Bn, T] f32 raw-model logprob of each sampled token
    gen_lengths: torch.Tensor  # [Bn] generated token counts (incl. EOS)
    done: torch.Tensor  # [Bn] bool
    logits: torch.Tensor  # [Bn, V] f32 logits for the next token
    seq_lengths: torch.Tensor  # [Bn] tokens resident in the cache per row
    k_pages: list  # L × [K, total_pages, ps, hd] (or QuantizedPages)
    v_pages: list
    step: torch.Tensor  # [1] int64: the next step's index, on the device
    page_indices: torch.Tensor | None = None  # [Bn, width] int32 (chunked: static)
    seeds: torch.Tensor | None = None  # [scan_chunk, Bn] int32: a chunk's seeds


def _pack_rows(ids: torch.Tensor, mask: torch.Tensor):
    """Left-padded [B, P] → packed [B, P] (first real token at column 0),
    its mask, and the real lengths [B]."""
    b, p = ids.shape
    real_len = mask.sum(dim=-1).to(torch.int32)
    shift = p - real_len
    cols = (torch.arange(p, device=ids.device)[None, :] + shift[:, None]) % p
    packed = torch.gather(ids, 1, cols.long())
    packed_mask = (torch.arange(p, device=ids.device)[None, :]
                   < real_len[:, None]).to(mask.dtype)
    return packed * packed_mask, packed_mask, real_len


def _empty_pools(cfg: ModelConfig, total_pages: int, *, page_size: int, cache_dtype,
                 kv_quant: str, device) -> tuple[list, list]:
    """Per-layer zeroed k and v page pools of ``total_pages`` pages."""
    shape = (cfg.num_kv_heads, total_pages, page_size, cfg.head_dim)
    return tuple([init_pages(shape, cache_dtype, device, kv_quant)
                  for _ in range(cfg.num_layers)] for _ in range(2))


def _paged_prefill(model: Decoder, lora, prompt_ids, prompt_mask, *,
                   prompt_pages: int, page_size: int, lora_scale: float,
                   cache_dtype, attn_impl: str, kv_quant: str = "none",
                   total_pages: int | None = None, pools=None, table=None):
    """Pack prompts and run one forward over B rows into fresh page pools
    of ``total_pages`` pages (default ``B · prompt_pages``): row r's prompt
    lands in pages ``[r · prompt_pages, (r + 1) · prompt_pages)``. With
    ``pools`` (k, v) and ``table`` [B, prompt_pages] the prompts are written
    into those pools at the table's pages instead (a continuous admission's
    chain, padded with the scratch page). Returns (k_pages, v_pages,
    last-position logits [B, V], real lengths [B])."""
    cfg = model.cfg
    b, p = prompt_ids.shape
    packed_ids, packed_mask, real_len = _pack_rows(prompt_ids, prompt_mask)
    pad_to = prompt_pages * page_size
    packed_ids = torch.nn.functional.pad(packed_ids, (0, pad_to - p))
    packed_mask = torch.nn.functional.pad(packed_mask, (0, pad_to - p))
    dev = prompt_ids.device
    if pools is None:
        total = b * prompt_pages if total_pages is None else total_pages
        if total < b * prompt_pages:
            raise ValueError(f"a pool of {total} pages cannot hold {b} prompts of "
                             f"{prompt_pages} pages")
        pools = _empty_pools(cfg, total, page_size=page_size, cache_dtype=cache_dtype,
                             kv_quant=kv_quant, device=dev)
        table = torch.as_tensor(make_page_table(b, pad_to, page_size), device=dev)
    cache = {"k": pools[0], "v": pools[1], "lengths": real_len, "page_indices": table}
    positions = torch.arange(pad_to, dtype=torch.int32, device=dev)[None, :].expand(b, pad_to)
    logits, cache = model(
        packed_ids, attention_mask=packed_mask, positions=positions, lora=lora,
        lora_scale=lora_scale, kv_cache=cache, attn_impl=attn_impl,
        page_size=page_size, logits_positions=(real_len - 1).clamp(min=0),
    )
    return cache["k"], cache["v"], logits[:, 0], real_len


def _copy_pages(pages, src_idx: torch.Tensor, dst_idx: torch.Tensor) -> None:
    """``pages[:, dst] = pages[:, src]`` in place (int8 pools copy weight and
    scales alike, keeping each int8 value with its scale)."""
    arrays = (pages.weight, pages.scales) if is_quantized_pages(pages) else (pages,)
    for arr in arrays:
        arr[:, dst_idx] = arr[:, src_idx]


def _page_table_rows(prompt_of: torch.Tensor, full: torch.Tensor,
                     priv0: torch.Tensor, *, prompt_pages: int,
                     private_pages: int) -> torch.Tensor:
    """Page-table rows [R, width] with shared prompt prefixes: column t of
    row r holds position block t — the prompt's shared full pages below
    ``full[r]``, the row's private pages after; trailing columns clamp to
    the row's last private page."""
    width = prompt_pages + private_pages
    col = torch.arange(width, device=full.device)[None, :]
    shared = prompt_of[:, None] * prompt_pages + col
    private = torch.minimum(priv0[:, None] + (col - full[:, None]),
                            priv0[:, None] + private_pages - 1)
    return torch.where(col < full[:, None], shared, private).to(torch.int32)


def _paged_fanout(k_pages, v_pages, last_logits, real_len, row_alive, *,
                  n: int, b: int, prompt_pages: int, private_pages: int,
                  page_size: int, max_steps: int, pad_id: int,
                  into: _PagedDecodeState | None = None):
    """Expand B prompts to B·n candidate rows that share their prompt's full
    pages. The pools already hold ``B · prompt_pages + B · n ·
    private_pages`` pages; each candidate's copy of its prompt's partial
    page goes, in place, to the first page of its private region (for a
    page-aligned prompt the copied page is never read). Returns (state,
    page_indices [B·n, prompt_pages + private_pages]). With ``into`` (a
    state over these pools, its buffers at least ``max_steps`` wide and its
    ``page_indices`` allocated) the state and the table are written into
    its tensors in place."""
    bn = b * n
    dev = real_len.device
    total_shared = b * prompt_pages
    need = total_shared + bn * private_pages
    pool = k_pages[0].weight if is_quantized_pages(k_pages[0]) else k_pages[0]
    if pool.shape[1] < need:
        raise ValueError(f"the page pool holds {pool.shape[1]} pages, the fan-out "
                         f"needs {need}")
    full = real_len.long() // page_size
    full_r = full.repeat_interleave(n)
    prompt_of_row = torch.arange(b, device=dev).repeat_interleave(n)
    priv0 = total_shared + torch.arange(bn, device=dev) * private_pages
    page_indices = _page_table_rows(prompt_of_row, full_r, priv0,
                                    prompt_pages=prompt_pages,
                                    private_pages=private_pages)
    src_partial = prompt_of_row * prompt_pages + full.clamp(
        max=prompt_pages - 1).repeat_interleave(n)
    for pages in list(k_pages) + list(v_pages):
        _copy_pages(pages, src_partial, priv0)
    # rows with an empty prompt are batch padding, born done
    done = (~row_alive).repeat_interleave(n)
    logits = last_logits.repeat_interleave(n, dim=0)
    seq_lengths = real_len.to(torch.int32).repeat_interleave(n)
    if into is not None:
        into.out.fill_(pad_id)
        into.logps.zero_()
        into.gen_lengths.zero_()
        into.step.zero_()
        for dst, src in ((into.done, done), (into.logits, logits),
                         (into.seq_lengths, seq_lengths), (into.page_indices, page_indices)):
            dst.copy_(src)
        return into, into.page_indices
    state = _PagedDecodeState(
        out=torch.full((bn, max_steps), pad_id, dtype=torch.int32, device=dev),
        logps=torch.zeros((bn, max_steps), dtype=torch.float32, device=dev),
        gen_lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
        done=done, logits=logits, seq_lengths=seq_lengths,
        k_pages=list(k_pages), v_pages=list(v_pages),
        step=torch.zeros((1,), dtype=torch.int64, device=dev),
    )
    return state, page_indices


def _paged_forward(model: Decoder, lora, s: _PagedDecodeState, tok: torch.Tensor,
                   page_indices: torch.Tensor, *, page_size: int,
                   lora_scale: float) -> None:
    """The decode forward: write ``tok``'s K/V [Bn] at ``seq_lengths``,
    attend over ``seq_lengths + 1`` and copy the next logits into
    ``s.logits``. Advancing ``seq_lengths`` is the caller's."""
    cache = {"k": s.k_pages, "v": s.v_pages, "lengths": s.seq_lengths,
             "page_indices": page_indices}
    logits, _ = model(
        tok[:, None], positions=s.seq_lengths[:, None], lora=lora,
        lora_scale=lora_scale, kv_cache=cache, page_size=page_size,
    )
    s.logits.copy_(logits[:, 0])


def _paged_decode_step(model: Decoder, lora, s: _PagedDecodeState,
                       seeds: torch.Tensor, page_indices: torch.Tensor, *,
                       page_size: int, eos_ids: torch.Tensor, pad_id: int,
                       temperature: float, top_p: float, lora_scale: float,
                       top_p_impl: str, capture_logprobs: bool, last: bool) -> None:
    """One decode step over the paged cache, in place: sample, record, then
    (unless ``last``) forward the token, which writes its K/V at
    ``seq_lengths`` and attends over ``seq_lengths + 1``. Nothing is read
    back to the host (the step index ``s.step`` lives on the device), so the
    step runs inside a captured graph too."""
    tok, logp = sample_with_logprob(
        s.logits, temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs,
    )
    alive = ~s.done
    tok = torch.where(s.done, pad_id, tok)
    s.out.index_copy_(1, s.step, tok[:, None])
    if capture_logprobs:
        s.logps.index_copy_(1, s.step, torch.where(s.done, 0.0, logp)[:, None])
    s.gen_lengths += alive.to(torch.int32)
    s.done |= is_eos(tok, eos_ids)
    if not last:
        _paged_forward(model, lora, s, tok, page_indices, page_size=page_size,
                       lora_scale=lora_scale)
    # rows alive before this step hold one more resident token
    s.seq_lengths += alive.to(torch.int32)
    s.step += 1


# ---------------------------------------------------------------- refill


@dataclass
class _RefillState:
    """Decode state of the refill scheduler, updated in place (every tensor
    keeps its address: what a captured chunk reads it by). R slots each
    hold one candidate, or the dead sentinel ``total``. Finished output
    lives in the candidate-indexed ``out``/``logps_buf``/``lengths_buf``, so
    a slot can be re-assigned without disturbing it; their extra row
    ``total`` takes the writes of dead slots (the JAX package's
    ``mode="drop"``) and is never read. The host counts ``step`` and
    ``forwards``; no step body reads them."""

    out: torch.Tensor  # [total + 1, T] int32, pad-filled
    logps_buf: torch.Tensor  # [total + 1, T] f32 behavior logprobs
    lengths_buf: torch.Tensor  # [total + 1] int32 per-candidate generated counts
    cand: torch.Tensor  # [R] int64 candidate per slot (== total: dead slot)
    done: torch.Tensor  # [R] bool
    logits: torch.Tensor  # [R, V] f32 logits for each slot's next token
    seq_lengths: torch.Tensor  # [R] int32 tokens resident per slot
    gen_lengths: torch.Tensor  # [R] int32 tokens generated by the occupant
    page_indices: torch.Tensor  # [R, width] int32, authored by the PagePool
    k_pages: list
    v_pages: list
    alive_steps: torch.Tensor  # [] int64 sum over steps of alive slots
    step: int = 0
    forwards: int = 0  # decode forwards run (each launches K2 once per layer)
    seeds: torch.Tensor | None = None  # [scan_chunk, R] int32: a chunk's seeds
    gen: torch.Generator | None = None  # chunked: the round's generator, reseeded


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array as a new device tensor. To the GPU it goes through
    pinned memory without blocking, ordered on the stream like a kernel."""
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _refill_buffers(*, r_slots: int, total: int, max_steps: int, width: int,
                    scratch: int, pad_id: int, device) -> dict:
    """The tensors both refill states share: every slot born dead, its table
    row pointed at the scratch page (dead slots' writes must land where no
    live row reads; an all-zero row would alias shared prompt page 0)."""
    return dict(
        out=torch.full((total + 1, max_steps), pad_id, dtype=torch.int32, device=device),
        logps_buf=torch.zeros((total + 1, max_steps), dtype=torch.float32, device=device),
        lengths_buf=torch.zeros((total + 1,), dtype=torch.int32, device=device),
        cand=torch.full((r_slots,), total, dtype=torch.int64, device=device),
        done=torch.ones((r_slots,), dtype=torch.bool, device=device),
        seq_lengths=torch.zeros((r_slots,), dtype=torch.int32, device=device),
        gen_lengths=torch.zeros((r_slots,), dtype=torch.int32, device=device),
        page_indices=torch.full((r_slots, width), scratch, dtype=torch.int32, device=device),
        alive_steps=torch.zeros((), dtype=torch.int64, device=device),
    )


def _pool_device(pages) -> torch.device:
    return pages.weight.device if is_quantized_pages(pages) else pages.device


def _refill_init(k_pages, v_pages, *, r_slots: int, total: int, max_steps: int,
                 vocab: int, width: int, scratch: int, pad_id: int) -> _RefillState:
    """Empty R-slot decode state over the pools the prefill allocated
    (shared prompt pages first, then the decode pool from ``scratch``)."""
    dev = _pool_device(k_pages[0])
    bufs = _refill_buffers(r_slots=r_slots, total=total, max_steps=max_steps, width=width,
                           scratch=scratch, pad_id=pad_id, device=dev)
    return _RefillState(
        logits=torch.zeros((r_slots, vocab), dtype=torch.float32, device=dev),
        k_pages=list(k_pages), v_pages=list(v_pages), **bufs)


def _spec_init(k_pages, v_pages, *, r_slots: int, total: int, max_steps: int,
               buf_width: int, hist_width: int, width: int, scratch: int,
               pad_id: int) -> SpecRefillState:
    """Empty R-slot speculative decode state (``engine/speculative.py``)."""
    dev = _pool_device(k_pages[0])
    bufs = _refill_buffers(r_slots=r_slots, total=total, max_steps=max_steps, width=width,
                           scratch=scratch, pad_id=pad_id, device=dev)
    return SpecRefillState(
        last_tok=torch.zeros((r_slots,), dtype=torch.int32, device=dev),
        seq_buf=torch.zeros((r_slots + 1, buf_width), dtype=torch.int32, device=dev),
        emit_hist=torch.zeros((hist_width,), dtype=torch.int64, device=dev),
        draft_total=torch.zeros((), dtype=torch.int64, device=dev),
        accept_total=torch.zeros((), dtype=torch.int64, device=dev),
        k_pages=list(k_pages), v_pages=list(v_pages), **bufs)


def _refill_reset(s, *, total: int, scratch: int, pad_id: int) -> None:
    """A kept refill state back to ``_refill_init`` / ``_spec_init``'s
    contents, in place: every slot dead and pointed at the scratch page, the
    buffers and totals zeroed (the page pools keep their bytes: no read
    reaches a position its round did not write)."""
    s.out.fill_(pad_id)
    s.logps_buf.zero_()
    s.lengths_buf.zero_()
    s.cand.fill_(total)
    s.done.fill_(True)
    s.seq_lengths.zero_()
    s.gen_lengths.zero_()
    s.page_indices.fill_(scratch)
    s.alive_steps.zero_()
    s.step = s.forwards = 0
    if isinstance(s, SpecRefillState):
        for t in (s.last_tok, s.seq_buf, s.emit_hist, s.draft_total, s.accept_total):
            t.zero_()
        s.draft_forwards = 0
    else:
        s.logits.zero_()


def _admit_tables(s, new_cand: np.ndarray, admit_mask: np.ndarray,
                  copies: tuple[np.ndarray, np.ndarray], *, n: int, b: int):
    """The admit work both refill schedulers share, planned on the host:
    which slots take which candidates, and the page copies ``copies`` =
    (src, dst) that give each admitted live slot its prompt's partial page
    in its first owned page (decode extends that page in place; under
    prefix sharing these are the pool's copy-on-write splits). The copies
    are enqueued here, before any later step writes the split pages, on the
    same stream. Merges the assignments into ``s.cand``. Returns (slots,
    live, prompt_of) as host arrays and the device index tensors (slots_t,
    prompt_t)."""
    total = b * n
    slots = np.nonzero(admit_mask)[0]
    cand = new_cand[slots].astype(np.int64)
    live = cand < total
    prompt_of = np.clip(cand // n, 0, b - 1)
    dev = s.cand.device
    slots_t = _to_device(slots, dev, torch.int64)
    prompt_t = _to_device(prompt_of, dev, torch.int64)
    src, dst = copies
    if len(src):
        src_t = _to_device(src, dev, torch.int64)
        dst_t = _to_device(dst, dev, torch.int64)
        for pages in list(s.k_pages) + list(s.v_pages):
            _copy_pages(pages, src_t, dst_t)
    s.cand[slots_t] = _to_device(cand, dev, torch.int64)
    return slots, live, prompt_of, slots_t, prompt_t


_NO_COPIES = (np.zeros(0, np.int64), np.zeros(0, np.int64))


def _refill_admit(s: _RefillState, new_cand, admit_mask, last_logits, real_len,
                  copies, *, n: int, b: int) -> None:
    """Assign candidates to slots, in place (the plain scheduler): each
    admitted slot takes its prompt's prefill logits and resident length and
    restarts its count; a dead admission (``new_cand == total``) kills the
    slot."""
    _, live, _, slots_t, prompt_t = _admit_tables(s, new_cand, admit_mask, copies, n=n, b=b)
    s.done[slots_t] = _to_device(~live, s.done.device)
    s.logits[slots_t] = last_logits[prompt_t]
    s.seq_lengths[slots_t] = real_len[prompt_t]
    s.gen_lengths[slots_t] = 0


def _spec_admit(s: SpecRefillState, new_cand, admit_mask, last_logits, real_len,
                real_len_h, packed_ids, seeds, copies, *, n: int, b: int, eos_ids,
                temperature: float, top_p: float, top_p_impl: str,
                capture_logprobs: bool) -> None:
    """Assign candidates to slots, in place (speculative flavor): beyond the
    shared table work, draw each admitted slot's FIRST token from its
    prompt's prefill logits (one launch of K1; the step carries a pending
    token, not logits), seed the n-gram buffer with the packed prompt and
    that token, and record the token as generated output."""
    slots, live, prompt_of, slots_t, prompt_t = _admit_tables(
        s, new_cand, admit_mask, copies, n=n, b=b)
    dev = s.done.device
    tok0, logp0 = sample_with_logprob(
        last_logits[prompt_t], temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs)
    s.done[slots_t] = _to_device(~live, dev) | is_eos(tok0, eos_ids)
    # the n-gram buffer: packed prompt, then tok0 at position real_len
    k, p = len(slots), packed_ids.shape[1]
    rows = torch.zeros((k, s.seq_buf.shape[1]), dtype=torch.int32, device=dev)
    rows[:, :p] = packed_ids[prompt_t]
    rl_t = _to_device(real_len_h[prompt_of], dev, torch.int64)
    rows[torch.arange(k, device=dev), rl_t] = tok0
    s.seq_buf[slots_t] = rows
    # tok0 is generated output: out[cand, 0] and a per-candidate length of 1
    lv = np.nonzero(live)[0]
    if lv.size:
        lv_t = _to_device(lv, dev, torch.int64)
        rows_c = _to_device(new_cand[slots[lv]], dev, torch.int64)
        s.out[rows_c, 0] = tok0[lv_t]
        if capture_logprobs:
            s.logps_buf[rows_c, 0] = logp0[lv_t]
        s.lengths_buf[rows_c] = 1
    s.last_tok[slots_t] = tok0
    s.seq_lengths[slots_t] = real_len[prompt_t]
    s.gen_lengths[slots_t] = 1


def _refill_decode_step(model: Decoder, lora, s: _RefillState, seeds: torch.Tensor, *,
                        page_size: int, eos_ids, pad_id: int, temperature: float,
                        top_p: float, lora_scale: float, top_p_impl: str,
                        capture_logprobs: bool, max_steps: int) -> None:
    """One decode step over R slots, in place: sample (K1), record by
    candidate id (dead slots write the sentinel row), then one forward over
    every slot (K2 per layer). A slot stops once its occupant has generated
    ``max_steps`` tokens."""
    total = s.out.shape[0] - 1
    alive = ~s.done
    tok, logp = sample_with_logprob(
        s.logits, temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs)
    tok = torch.where(s.done, pad_id, tok)
    row = torch.where(alive, s.cand, total)
    col = s.gen_lengths.long().clamp(max=max_steps - 1)
    s.out[row, col] = tok
    if capture_logprobs:
        s.logps_buf[row, col] = logp
    s.gen_lengths += alive.to(torch.int32)
    s.lengths_buf[row] = s.gen_lengths
    s.done |= (is_eos(tok, eos_ids) & alive) | (s.gen_lengths >= max_steps)
    cache = {"k": s.k_pages, "v": s.v_pages, "lengths": s.seq_lengths,
             "page_indices": s.page_indices}
    logits, _ = model(tok[:, None], positions=s.seq_lengths[:, None], lora=lora,
                      lora_scale=lora_scale, kv_cache=cache, page_size=page_size)
    s.logits.copy_(logits[:, 0])
    s.seq_lengths += alive.to(torch.int32)
    s.alive_steps += alive.sum()


def _self_draft(model: Decoder, drafter_lora, s: SpecRefillState, gen: torch.Generator, *,
                page_size: int, lora_scale: float, d: int, temperature: float,
                top_p: float, top_p_impl: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The self-drafter: the policy under its PREVIOUS adapter proposes d
    tokens by d single-token decode forwards over the same pages (K2 per
    layer each). Its writes at ``seq_lengths + i`` are transient: the verify
    forward rewrites every one of them under the current adapter. Each
    draft is drawn from q_i, the drafter's own sampling distribution
    (greedy: its argmax), by a Gumbel draw from the engine's generator (the
    JAX package draws with ``jax.random.categorical``: the same
    distribution, not the same bits). Returns (draft [R, d] int32,
    q [R, d, V] f32)."""
    tok = s.last_tok
    drafts, qs = [], []
    for i in range(d):
        lens = s.seq_lengths + i
        cache = {"k": s.k_pages, "v": s.v_pages, "lengths": lens,
                 "page_indices": s.page_indices}
        logits, _ = model(tok[:, None], positions=lens[:, None], lora=drafter_lora,
                          lora_scale=lora_scale, kv_cache=cache, page_size=page_size)
        q_i = sampling_probs(logits[:, 0], temperature, top_p, top_p_impl=top_p_impl)
        if temperature == 0.0:
            tok = q_i.argmax(dim=-1).to(torch.int32)
        else:
            g = draw_gumbel(q_i.shape, gen, q_i.device)
            tok = (torch.log(torch.clamp(q_i, min=1e-30)) + g).argmax(dim=-1).to(torch.int32)
        drafts.append(tok)
        qs.append(q_i)
    return torch.stack(drafts, dim=1), torch.stack(qs, dim=1)


def _spec_step(model: Decoder, lora, s: SpecRefillState, gen: torch.Generator, *,
               page_size: int, eos_ids, temperature: float, top_p: float,
               lora_scale: float, top_p_impl: str, capture_logprobs: bool,
               max_steps: int, draft_len: int, ngram_k: int,
               spec_verify: str, drafter_lora=None, self_draft: bool = False) -> None:
    """One speculative step, in place: propose d drafts per slot (n-gram
    lookup, or the previous adapter with ``self_draft``), verify
    ``[last_tok, draft]`` in one (d+1)-position forward (K5 per layer),
    accept by rejection sampling and emit 1..d+1 tokens, cut at the first
    EOS and at the occupant's budget."""
    total = s.out.shape[0] - 1
    r = s.done.shape[0]
    d = draft_len
    dev = s.done.device
    alive = ~s.done
    buf_len = s.seq_lengths + 1  # resident + the pending last_tok
    if self_draft:
        # no previous adapter: the current one drafts for itself
        drafter = drafter_lora if drafter_lora is not None else lora
        draft, draft_probs = _self_draft(
            model, drafter, s, gen, page_size=page_size, lora_scale=lora_scale,
            d=d, temperature=temperature, top_p=top_p, top_p_impl=top_p_impl)
    else:
        draft = propose_ngram_drafts(s.seq_buf[:r], buf_len, k=ngram_k, d=d)
        draft_probs = None
    inputs = torch.cat([s.last_tok[:, None], draft], dim=1)  # [R, d+1]
    steps = torch.arange(d + 1, device=dev)
    positions = s.seq_lengths[:, None] + steps[None, :].to(torch.int32)
    cache = {"k": s.k_pages, "v": s.v_pages, "lengths": s.seq_lengths,
             "page_indices": s.page_indices}
    logits, _ = model(inputs, positions=positions, lora=lora, lora_scale=lora_scale,
                      kv_cache=cache, page_size=page_size, paged_verify=True,
                      paged_verify_impl=spec_verify)  # [R, d+1, V]
    probs = sampling_probs(logits, temperature, top_p, top_p_impl=top_p_impl)
    u = draw_uniforms((r, d), gen, dev)
    g = draw_gumbel((r, logits.shape[-1]), gen, dev)
    emit, n_emit, n_accept = spec_accept(u, g, probs, draft, draft_probs)

    # emission stops AT the first EOS among the emitted tokens, and at the
    # occupant's token budget
    pos = steps[None, :]
    eos_at = is_eos(emit, eos_ids) & (pos < n_emit[:, None])
    any_eos = eos_at.any(dim=1)
    first_eos = eos_at.to(torch.int8).argmax(dim=1).to(torch.int32)
    n_emit = torch.where(any_eos, first_eos + 1, n_emit)
    room = torch.clamp(max_steps - s.gen_lengths, min=0)
    n_emit = torch.where(alive, torch.minimum(n_emit, room), 0)
    gen_lengths = s.gen_lengths + n_emit
    s.done |= alive & (any_eos | (gen_lengths >= max_steps))

    # emitted tokens into out / seq_buf; the rest go to the sentinel rows
    live = pos < n_emit[:, None]  # [R, d+1]
    row = torch.where(alive, s.cand, total)
    row_i = torch.where(live, row[:, None], total)
    col_i = (s.gen_lengths[:, None].long() + pos).clamp(max=max_steps - 1)
    s.out[row_i, col_i] = emit
    if capture_logprobs:
        # behavior logprob on the raw basis: slot i's logits judged emit[:, i]
        s.logps_buf[row_i, col_i] = token_logprob(logits, emit)
    slot_i = torch.where(live, torch.arange(r, device=dev)[:, None], r)
    seq_col = (buf_len[:, None].long() + pos).clamp(max=s.seq_buf.shape[1] - 1)
    s.seq_buf[slot_i, seq_col] = emit
    s.lengths_buf[row] = gen_lengths
    last = torch.gather(emit, 1, (n_emit - 1).clamp(0, d).long()[:, None])[:, 0]
    s.last_tok.copy_(torch.where(alive, last, s.last_tok))
    s.seq_lengths += n_emit
    s.gen_lengths.copy_(gen_lengths)
    hw = s.emit_hist.shape[0]
    s.emit_hist += ((n_emit[:, None] == torch.arange(hw, device=dev)[None, :])
                    & alive[:, None]).sum(dim=0)
    n_alive = alive.sum()
    s.draft_total += d * n_alive
    s.accept_total += torch.where(alive, n_accept, 0).sum()
    s.alive_steps += n_alive


def _resume_forward(model: Decoder, lora, s, slot: int, prefix: np.ndarray,
                    resident: int, start: int, *, page_size: int,
                    lora_scale: float, logits_position: int,
                    max_position: int | None = None) -> torch.Tensor:
    """One chunked forward over ``prefix`` (the first ``resident`` tokens
    real) at positions ``start + i`` into the slot's pages, after the
    ``start`` tokens resident there: a preempted candidate's generated
    prefix after its prompt (its KV rebuilt by recompute), or a turn's
    observation after the whole conversation. ``max_position`` clamps the
    padding lanes' positions (they write no KV). Returns the logits [V] at
    ``logits_position``."""
    dev = s.done.device
    t = prefix.shape[0]
    valid = (np.arange(t) < resident).astype(np.int32)[None, :]
    cache = {"k": s.k_pages, "v": s.v_pages,
             "lengths": torch.full((1,), start, dtype=torch.int32, device=dev),
             "page_indices": s.page_indices[slot:slot + 1]}
    positions = (start + torch.arange(t, dtype=torch.int32, device=dev))[None, :]
    if max_position is not None:
        positions = positions.clamp(max=max_position)
    logits, _ = model(
        _to_device(prefix[None], dev, torch.int32), attention_mask=_to_device(valid, dev),
        positions=positions, lora=lora, lora_scale=lora_scale, kv_cache=cache,
        page_size=page_size, paged_chunked=True,
        logits_positions=torch.full((1,), logits_position, dtype=torch.int64, device=dev))
    return logits[0, 0]


def _resume_fixup(model: Decoder, lora, s: _RefillState, slot: int, prefix: np.ndarray,
                  plen: int, real_len: int, *, page_size: int, lora_scale: float) -> None:
    """Resume a preempted candidate in ``slot`` (vLLM's preempt-by-recompute),
    in place. The slot was just admitted normally (prompt logits, count 0);
    its generated prefix goes through one chunked forward, and the slot's
    logits and cursors fast-forward to the prefix's end. The prefix's
    tokens and logprobs are still in ``out``/``logps_buf``."""
    s.logits[slot] = _resume_forward(model, lora, s, slot, prefix, plen, real_len,
                                     page_size=page_size, lora_scale=lora_scale,
                                     logits_position=max(plen - 1, 0))
    s.done[slot] = False
    s.gen_lengths[slot] = plen
    s.seq_lengths[slot] = real_len + plen


def _turn_resume_fixup(model: Decoder, lora, s: _RefillState, slot: int, cand: int,
                       obs: np.ndarray, obs_len: int, gen_len: int, seq_len: int,
                       real_len: int, *, page_size: int, lora_scale: float, max_steps: int,
                       capture_logprobs: bool) -> None:
    """Continue a FINISHED candidate in place with an environment's
    observation (the JAX package's ``_turn_resume_fixup``), in place. Unlike
    ``_resume_fixup`` the slot was never released: the conversation's KV
    (prompt and every turn so far) is resident in its pages, so only the
    observation's ``obs_len`` tokens (``obs`` padded to the window) go
    through one chunked forward, at positions ``seq_len + i``. The padding
    lanes' positions are clamped to the slot's coverage, ``real_len +
    max_steps - 1`` (the host resumes only when ``gen_len + obs_len <
    max_steps``, so no real token reaches the clamp). The observation is
    recorded in the candidate's ``out`` row (the driver decodes it with the
    answer) with behavior logprobs of 0: the loss mask keeps it out of the
    update. The slot's logits, cursors and ``done`` flag take the
    continuation."""
    logits = _resume_forward(model, lora, s, slot, obs, obs_len, seq_len,
                             page_size=page_size, lora_scale=lora_scale,
                             logits_position=max(obs_len - 1, 0),
                             max_position=real_len + max_steps - 1)
    dev = s.out.device
    cols = slice(gen_len, gen_len + obs_len)
    s.out[cand, cols] = _to_device(obs[:obs_len], dev, torch.int32)
    if capture_logprobs:
        s.logps_buf[cand, cols] = 0.0
    new_gen = gen_len + obs_len
    s.lengths_buf[cand] = new_gen
    s.done[slot] = False
    s.logits[slot] = logits
    s.gen_lengths[slot] = new_gen
    s.seq_lengths[slot] = seq_len + obs_len


def _spec_resume_fixup(model: Decoder, lora, s: SpecRefillState, slot: int, cand: int,
                       prefix: np.ndarray, plen: int, real_len: int, seq_row: np.ndarray,
                       first_logp: float, *, page_size: int, lora_scale: float) -> None:
    """The speculative resume, in place: the prefix minus its pending last
    token is made resident again by one chunked forward; the n-gram buffer
    takes the host-built row; the cursors fast-forward. The re-admission
    drew a fresh first token into out[c, 0] / logps_buf[c, 0] /
    lengths_buf[c]; they are restored to the prefix the KV encodes."""
    resident = max(plen - 1, 0)
    if resident:
        _resume_forward(model, lora, s, slot, prefix, resident, real_len,
                        page_size=page_size, lora_scale=lora_scale, logits_position=0)
    s.done[slot] = False
    s.out[cand, 0] = int(prefix[0])
    s.logps_buf[cand, 0] = float(first_logp)
    s.lengths_buf[cand] = plen
    s.last_tok[slot] = int(prefix[max(plen - 1, 0)])
    s.seq_buf[slot] = _to_device(seq_row, s.seq_buf.device, torch.int32)
    s.gen_lengths[slot] = plen
    s.seq_lengths[slot] = real_len + resident


def _warm_prefill(model: Decoder, lora, k_pages, v_pages, row_ext: np.ndarray,
                  suffix: np.ndarray, start: int, *, page_size: int, lora_scale: float,
                  pad_id: int) -> torch.Tensor:
    """A group's prefill through a radix-cache hit: the prompt's first
    ``start`` tokens are resident in cached chain pages, so only the suffix
    ``suffix`` runs (the model's ``paged_prefix`` forward). Its KV lands in
    the chain's fresh pages (the hit stops below the last token, so no
    write touches a cached page) and the group's sampling logits [V] come
    off the suffix's last token. ``row_ext`` is the chain's table row padded
    with the scratch page plus one trailing scratch column; the suffix block
    is padded to the packed width, its padding lanes positioned at that
    extra column and writing nothing."""
    dev = _pool_device(k_pages[0])
    prompt_pages = row_ext.shape[0] - 1
    t = prompt_pages * page_size
    steps = np.arange(t)
    valid = steps < suffix.size
    tok = np.full(t, pad_id, np.int32)
    tok[:suffix.size] = suffix
    positions = np.where(valid, start + steps, prompt_pages * page_size).astype(np.int32)
    cache = {"k": k_pages, "v": v_pages,
             "lengths": torch.full((1,), start, dtype=torch.int32, device=dev),
             "page_indices": _to_device(row_ext[None], dev, torch.int32)}
    logits, _ = model(
        _to_device(tok[None], dev, torch.int32),
        attention_mask=_to_device(valid[None].astype(np.int32), dev),
        positions=_to_device(positions[None], dev), lora=lora, lora_scale=lora_scale,
        kv_cache=cache, page_size=page_size, paged_prefix=True,
        logits_positions=torch.full((1,), max(suffix.size - 1, 0), dtype=torch.int64,
                                    device=dev))
    return logits[0, 0]


def _page_tiles(k_pages, v_pages, page: int) -> dict:
    """One page's KV tiles across all layers, ``{"k": [L x tile], "v": ...}``
    with a tile ``[K, ps, hd]`` (int8 pools: its (weight, scales) pair):
    what the host store parks."""
    def take(pages):
        if is_quantized_pages(pages):
            return (pages.weight[:, page], pages.scales[:, page])
        return pages[:, page]

    return {"k": [take(p) for p in k_pages], "v": [take(p) for p in v_pages]}


def _restore_page_tiles(k_pages, v_pages, tiles: dict, page: int) -> None:
    """Copy one parked page's tiles back into the pools at ``page`` (from
    pinned memory, ordered on the stream)."""
    for pools, layer_tiles in ((k_pages, tiles["k"]), (v_pages, tiles["v"])):
        for pages, tile in zip(pools, layer_tiles):
            if is_quantized_pages(pages):
                pages.weight[:, page].copy_(tile[0], non_blocking=True)
                pages.scales[:, page].copy_(tile[1], non_blocking=True)
            else:
                pages[:, page].copy_(tile, non_blocking=True)


class PagedGenerationEngine(LoraMailbox, ScanChunks):
    """Drop-in for ``GenerationEngine`` with a packed paged KV cache (the
    wave or the refill scheduler, speculative decoding on the refill one).
    ``generate`` takes left-padded prompts and returns per-candidate
    tokens, lengths and behavior logprobs."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        max_prompt_tokens: int,
        max_new_tokens: int,
        eos_token_ids: Sequence[int],
        pad_token_id: int,
        lora_scale: float = 1.0,
        cache_dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "reference",
        paged_impl: str = "auto",  # interface parity: K2 is the one kernel
        page_size: int = 128,
        decode_chunk: int = 128,
        kv_quant: str | None = None,  # None/"none" | "int8"
        prompt_buckets: Sequence[int] | None = None,  # interface parity only
        max_concurrent_rows: int = 0,  # 0 = unlimited (vLLM max_num_seqs)
        max_kv_pages: int = 0,  # refill decode-page pool size; 0 = worst case
        scheduler: str = "waves",  # "waves" | "refill" (continuous batching)
        prefix_sharing: bool = False,
        continuous_admission: bool | None = None,
        prefix_cache: bool | None = None,
        kv_spill: bool = False,
        kv_spill_host_mb: int = 0,  # host page store byte cap; 0 = unbounded
        spec_draft: int | None = None,
        spec_ngram: int | None = None,
        spec_drafter: str | None = None,
        spec_verify: str | None = None,
        spec_adapt: bool = False,
        scan_chunk: int | None = None,
        pages_per_block: int | None = None,  # interface parity, as paged_impl
        capture_logprobs: bool = False,
        device: str | torch.device | None = None,  # None = the GPU
    ):
        super().__init__()
        if scheduler not in ("waves", "refill"):
            raise ValueError(f"scheduler must be waves/refill, got {scheduler!r}")
        if scheduler == "refill" and not max_concurrent_rows:
            raise ValueError("scheduler='refill' requires max_concurrent_rows (the "
                             "decode slot count)")
        refill = scheduler == "refill"
        if continuous_admission and not refill:
            raise ValueError("continuous_admission runs on the refill scheduler: set "
                             "scheduler='refill' and max_concurrent_rows")
        # continuous admission allocates prompt chains from the refcounted
        # pool: it is prefix sharing plus lazy prefill
        prefix_sharing = bool(prefix_sharing or continuous_admission)
        if prefix_sharing and not refill:
            raise ValueError("prefix_sharing shares prompt pages across the refill "
                             "scheduler's slots: set scheduler='refill' and "
                             "max_concurrent_rows")
        if prefix_cache and kv_quant == "int8":
            raise ValueError("prefix_cache requires a lossless KV pool (kv_quant='none'): "
                             "int8 pages cannot reproduce the cold prefill's attention "
                             "inputs bit-exactly")
        if prefix_cache and not continuous_admission:
            raise ValueError("prefix_cache aliases cached prompt chains out of the "
                             "continuous-admission pool: set continuous_admission=True")
        if kv_spill and not prefix_cache:
            raise ValueError("kv_spill parks KV pages through the tiered cache's host "
                             "store: it requires prefix_cache=True")
        if kv_spill and spec_draft:
            raise ValueError("kv_spill restores raw decode cursors the speculative "
                             "scheduler does not expose; speculative chains resume by "
                             "recompute: drop kv_spill or spec_draft")
        if kv_spill_host_mb < 0:
            raise ValueError(f"kv_spill_host_mb must be >= 0, got {kv_spill_host_mb}")
        if spec_adapt and not spec_draft:
            if spec_draft is not None:
                raise ValueError("spec_adapt adapts the speculative draft length: it "
                                 "requires spec_draft > 0")
            # an unset spec_draft resolves to 0 (the JAX package's plan
            # database may resolve it otherwise): the controller is inert
            warnings.warn("spec_adapt requested but spec_draft resolved to 0: the "
                          "draft-length controller is inert this run", RuntimeWarning,
                          stacklevel=2)
            spec_adapt = False
        spec_draft = spec_draft or 0
        if spec_draft < 0 or spec_draft > 16:
            raise ValueError(f"spec_draft must be in [0, 16], got {spec_draft}")
        if spec_draft and scheduler != "refill":
            raise ValueError("spec_draft (speculative decoding) runs on the refill "
                             "scheduler: set scheduler='refill' and max_concurrent_rows")
        spec_ngram = 2 if spec_ngram is None else spec_ngram
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if spec_drafter not in (None, "ngram", "self"):
            raise ValueError(f"spec_drafter must be ngram/self, got {spec_drafter!r}")
        spec_verify = spec_verify or "fused"
        if spec_verify not in ("fused", "unrolled"):
            raise ValueError(f"spec_verify must be fused/unrolled, got {spec_verify!r}")
        self._init_scan_chunks(scan_chunk)
        kv_quant = "none" if kv_quant is None else kv_quant
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be none/int8, got {kv_quant!r}")
        if paged_impl != "auto" or pages_per_block:
            raise NotImplementedError(
                "paged_impl and pages_per_block choose among the TPU paged "
                "launches; the port has one paged decode kernel, K2, and no "
                "workload needs another")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_prompt_tokens = max_prompt_tokens
        self.max_new_tokens = max_new_tokens
        cfg.check_within_window(max_prompt_tokens + max_new_tokens)
        self.eos_ids = torch.tensor(list(eos_token_ids), dtype=torch.int32,
                                    device=self.device)
        self.pad_id = int(pad_token_id)
        self.lora_scale = lora_scale
        self.cache_dtype = cache_dtype
        self.attn_impl = attn_impl
        self.page_size = page_size
        self.decode_chunk = decode_chunk
        self.kv_quant = kv_quant
        self.max_concurrent_rows = max_concurrent_rows
        self.capture_logprobs = capture_logprobs
        self.scheduler = scheduler
        self.spec_draft = spec_draft
        self.spec_ngram = spec_ngram
        self.spec_drafter = spec_drafter or "ngram"
        self.spec_verify = spec_verify
        self.spec_adapt = bool(spec_adapt)
        # only the self-drafter reads the mailbox's previous-adapter slot
        self._track_prev_lora = bool(spec_draft) and self.spec_drafter == "self"
        self.prefix_sharing = prefix_sharing
        self.continuous_admission = bool(continuous_admission)
        self.prefix_cache = bool(prefix_cache)
        self.kv_spill = bool(kv_spill)
        self.cb_mode = ("waves" if not refill else "continuous" if continuous_admission
                        else "refill_shared" if prefix_sharing else "refill")
        self.prompt_buckets = [max_prompt_tokens]
        self.prompt_pages = pages_per_seq(max_prompt_tokens, page_size)
        # per-candidate private region: the partial prompt page (extended in
        # place by decode) and the decode pages; full prompt pages are
        # shared. A verify writes up to spec_draft tokens PAST a row's last
        # position (the rejected tail of its last block): they land in the
        # region, never clamped onto resident KV
        self.private_pages = 1 + pages_per_seq(max_new_tokens + spec_draft, page_size)
        # continuous admission allocates a prompt chain from the pool, and
        # the radix cache keeps one more resident there
        pool_floor = (1 + self.private_pages
                      + (self.prompt_pages if self.continuous_admission else 0)
                      + (self.prompt_pages if self.prefix_cache else 0))
        if max_kv_pages and max_kv_pages < pool_floor:
            raise ValueError(f"max_kv_pages={max_kv_pages} cannot fit one sequence "
                             f"(need >= {pool_floor}: scratch + {self.private_pages} "
                             "private pages, plus a prompt chain each for continuous "
                             "admission and the prefix cache)")
        if (max_kv_pages and self.continuous_admission
                and max_kv_pages < pool_floor + self.private_pages):
            warnings.warn(
                f"max_kv_pages={max_kv_pages} is wedge-prone under continuous "
                f"admission: the pool fits one sequence (floor {pool_floor}) but "
                f"cannot overlap the next admission's private region; the least "
                f"comfortable budget is {pool_floor + self.private_pages} pages",
                RuntimeWarning, stacklevel=2)
        self.max_kv_pages = max_kv_pages
        # the radix index and the host page store outlive each round's pool,
        # so warm prefixes survive into the next round; the cache is dropped
        # whenever the weights that write it change (cached KV is exact only
        # under them): another adapter object, another model object, or a
        # model whose ``weights_version`` moved (full fine-tuning's push
        # rewrites the rollout copy in place)
        self._radix = RadixCache(page_size) if self.prefix_cache else None
        self._kv_store = (HostPageStore(max_bytes=kv_spill_host_mb * 2**20)
                          if self.prefix_cache else None)
        self._cache_lora_ref = None
        self._cache_weights: tuple | None = None  # (model, its weights_version)
        self.last_round_stats: dict | None = None
        self.last_pool_stats: dict | None = None
        self.last_spec_stats: dict | None = None
        # multi-turn episodes: an owner (the trainer's env driver) sets a
        # turn hook here, and the refill scheduler's idle pass consults it
        # before it retires a finished candidate: ``hook(cand_id,
        # gen_tokens) -> np.ndarray | None`` returns observation tokens to
        # append in place, or None to finish; ``hook.declined(cand_id)``
        # takes back an observation the engine could not seat
        self.turn_hook: Any = None

    def _static_state(self, b: int, n: int, max_total_pages: int) -> _PagedDecodeState:
        """The wave state and page pools captured chunks read, for ``b``
        prompts x ``n``: kept across waves and rounds of that shape; another
        shape frees it, and the graphs over it, first."""
        key = (b, n)
        if self._chunk_state is None or self._chunk_state[0] != key:
            self.release_decode_graphs()
            bn, dev, t = b * n, self.device, self.max_new_tokens
            k_pages, v_pages = _empty_pools(self.cfg, max_total_pages, page_size=self.page_size,
                                            cache_dtype=self.cache_dtype,
                                            kv_quant=self.kv_quant, device=dev)
            self._chunk_state = (key, _PagedDecodeState(
                out=torch.zeros((bn, t), dtype=torch.int32, device=dev),
                logps=torch.zeros((bn, t), dtype=torch.float32, device=dev),
                gen_lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
                done=torch.zeros((bn,), dtype=torch.bool, device=dev),
                logits=torch.zeros((bn, self.cfg.vocab_size), dtype=torch.float32,
                                   device=dev),
                seq_lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
                k_pages=k_pages, v_pages=v_pages,
                step=torch.zeros((1,), dtype=torch.int64, device=dev),
                page_indices=torch.zeros((bn, self.prompt_pages + self.private_pages),
                                         dtype=torch.int32, device=dev),
                seeds=torch.zeros((self.scan_chunk, bn), dtype=torch.int32, device=dev)))
        return self._chunk_state[1]

    def _refill_static(self, *, spec: bool, r_slots: int, total: int, max_steps: int,
                       width: int, total_pages: int, scratch: int, buf_width: int = 0,
                       hist_width: int = 0):
        """The refill state, its page pools of ``total_pages`` pages and its
        generator, which captured chunks read: kept across rounds of one
        shape and reset in place at a round's start; another shape frees
        it, and the graphs over it, first."""
        key = ("spec" if spec else "refill", r_slots, total, max_steps, width, total_pages,
               self.kv_quant, buf_width, hist_width)
        if self._chunk_state is None or self._chunk_state[0] != key:
            self.release_decode_graphs()
            pools = _empty_pools(self.cfg, total_pages, page_size=self.page_size,
                                 cache_dtype=self.cache_dtype, kv_quant=self.kv_quant,
                                 device=self.device)
            common = dict(r_slots=r_slots, total=total, max_steps=max_steps, width=width,
                          scratch=scratch, pad_id=self.pad_id)
            if spec:
                state = _spec_init(*pools, buf_width=buf_width, hist_width=hist_width,
                                   **common)
            else:
                state = _refill_init(*pools, vocab=self.cfg.vocab_size, **common)
                state.seeds = torch.zeros((self.scan_chunk, r_slots), dtype=torch.int32,
                                          device=self.device)
            state.gen = torch.Generator(device=self.device)
            self._chunk_state = (key, state)
        state = self._chunk_state[1]
        _refill_reset(state, total=total, scratch=scratch, pad_id=self.pad_id)
        return state

    def bucket_for(self, prompt_mask) -> int:
        """Single-bucket engine (interface parity with GenerationEngine)."""
        return self.max_prompt_tokens

    def generate(self, model: Decoder, lora: Params | None,
                 prompt_ids: np.ndarray,  # [B, P] left-padded to max_prompt_tokens
                 prompt_mask: np.ndarray, sampling: SamplingConfig,
                 seed: int) -> GenerationResult:
        if model.cfg != self.cfg:
            raise ValueError("model config does not match the engine's")
        self._reset_lora_mailbox_round()
        self.last_round_stats = None
        self.last_pool_stats = None
        self.last_spec_stats = None
        total = prompt_ids.shape[0] * max(sampling.n, 1)
        if self.turn_hook is not None and (
                self.scheduler != "refill" or not self.max_concurrent_rows or self.spec_draft):
            raise ValueError(
                "turn_hook (multi-turn episodes) requires the refill scheduler with "
                "max_concurrent_rows set and no spec_draft — turn continuation lives in "
                "the refill idle pass")
        with torch.inference_mode():
            # a speculative, prefix-sharing or turn-hooked engine never
            # falls back to waves on a small batch
            if self.scheduler == "refill" and (
                    total > self.max_concurrent_rows or self.spec_draft
                    or self.prefix_sharing or self.turn_hook is not None):
                return self._generate_refill(model, lora, prompt_ids, prompt_mask,
                                             sampling, seed)
            return generate_in_waves(
                self._generate_wave, self.max_concurrent_rows, model, lora,
                prompt_ids, prompt_mask, sampling, seed, self.pad_id,
            )

    def _sync(self) -> None:
        """Wait for the round's own stream (``GenerationEngine._sync``)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _generate_wave(self, model, lora, prompt_ids, prompt_mask,
                       sampling: SamplingConfig, seed: int) -> GenerationResult:
        b, p = prompt_ids.shape
        if p != self.max_prompt_tokens:
            raise ValueError(
                f"prompts must be padded to {self.max_prompt_tokens}, got {p}")
        max_steps = min(sampling.max_tokens, self.max_new_tokens)
        n = max(sampling.n, 1)
        # an in-flight swap from an earlier wave of this round also covers
        # this wave's prefill (its rows have not sampled yet)
        lora = self._round_entry_lora(lora)
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32).to(self.device)
        mask = torch.as_tensor(np.asarray(prompt_mask), dtype=torch.int32).to(self.device)
        prefill_tokens = int(np.asarray(prompt_mask).sum())

        total_pages = b * self.prompt_pages + b * n * self.private_pages
        chunked = self.scan_chunk > 1 and max_steps > 1
        static = self._static_state(b, n, total_pages) if chunked else None
        t0 = time.perf_counter()
        k_pages, v_pages, last_logits, real_len = _paged_prefill(
            model, lora, ids, mask, prompt_pages=self.prompt_pages,
            page_size=self.page_size, lora_scale=self.lora_scale,
            cache_dtype=self.cache_dtype, attn_impl=self.attn_impl,
            kv_quant=self.kv_quant, total_pages=total_pages,
            pools=None if static is None else (static.k_pages, static.v_pages),
            table=None if static is None else torch.as_tensor(
                make_page_table(b, self.prompt_pages * self.page_size, self.page_size),
                device=self.device),
        )
        self._sync()  # an honest prefill/decode timing split
        t_prefill = time.perf_counter() - t0

        t1 = time.perf_counter()
        state, page_indices = _paged_fanout(
            k_pages, v_pages, last_logits, real_len, mask.sum(dim=-1) > 0,
            n=n, b=b, prompt_pages=self.prompt_pages,
            private_pages=self.private_pages, page_size=self.page_size,
            max_steps=max_steps, pad_id=self.pad_id, into=static,
        )
        del k_pages, v_pages
        top_p_impl = sampling.resolved_top_p_impl()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bn = b * n
        step_kw = dict(page_size=self.page_size, eos_ids=self.eos_ids, pad_id=self.pad_id,
                       temperature=sampling.temperature, top_p=sampling.top_p,
                       lora_scale=self.lora_scale, top_p_impl=top_p_impl,
                       capture_logprobs=self.capture_logprobs)

        def step_fn(lo, seeds, last):
            _paged_decode_step(model, lo, state, seeds, page_indices, last=last, **step_kw)

        key = (("waves", b, n, top_p_impl, sampling.temperature, sampling.top_p,
                tensors_key(model)) if chunked else None)
        steps, forwards, graph_steps = run_decode(
            self, state, step_fn, lora_cell=[lora], gen=gen, max_steps=max_steps,
            chunked=chunked, key=key)
        out = _host(state.out[:, :max_steps]).reshape(b, n, max_steps)
        lengths = _host(state.gen_lengths).reshape(b, n)
        logps = (_host(state.logps[:, :max_steps]).reshape(b, n, max_steps)
                 if self.capture_logprobs else None)
        stats = accumulate_round_stats(
            self.last_round_stats, prefill_s=t_prefill,
            prefill_tokens=prefill_tokens, prompt_rows=b,
            decode_s=time.perf_counter() - t1, gen_tokens=int(lengths.sum()),
            gen_rows=bn,
        )
        self.last_round_stats = add_decode_counts(stats, forwards=forwards,
                                                  graph_steps=graph_steps)
        return GenerationResult(tokens=out, lengths=lengths,
                                steps_dispatched=steps, logprobs=logps)

    def _generate_refill(self, model, lora, prompt_ids, prompt_mask,
                         sampling: SamplingConfig, seed: int) -> GenerationResult:
        """Continuous batching: R decode slots, refilled per candidate (the
        JAX package's ``_generate_refill`` without the gateway hooks). The host mirrors slot occupancy; per-slot epochs make it
        ignore snapshots taken before a slot was refilled.

        With prefix sharing a group's candidates alias one refcounted prompt
        chain and split its partial tail page copy-on-write at admission;
        with continuous admission the groups wait in a request queue and
        each is prefilled lazily into pool-allocated chain pages when slots
        and pages allow; with the prefix cache a group whose prompt shares
        full pages with a finished chain aliases them and prefills only its
        suffix; with host spill a preempted candidate's pages and logits row
        are parked in host memory and copied back at its resume."""
        b, p = prompt_ids.shape
        if p != self.max_prompt_tokens:
            raise ValueError(
                f"prompts must be padded to {self.max_prompt_tokens}, got {p}")
        max_steps = min(sampling.max_tokens, self.max_new_tokens)
        n = max(sampling.n, 1)
        total = b * n
        r_slots = min(self.max_concurrent_rows, total)
        dev = self.device
        ps = self.page_size
        spec = self.spec_draft > 0
        # the turn hook, read once a round; None costs one check an idle pass
        th = self.turn_hook
        sharing = self.prefix_sharing
        continuous = self.continuous_admission
        prompt_ids_h, prompt_mask_h = np.asarray(prompt_ids), np.asarray(prompt_mask)
        real_len_h = prompt_mask_h.sum(axis=-1).astype(np.int64)
        row_alive = real_len_h > 0
        prefill_tokens = int(real_len_h.sum())
        top_p_impl = sampling.resolved_top_p_impl()
        temperature, top_p = sampling.temperature, sampling.top_p

        # the decode page pool (vLLM's budgeted block pool), host-authored
        width = self.prompt_pages + self.private_pages
        if continuous:
            # prompt chains live in the pool: a chain for each group the
            # slots can span, plus one admitted ahead
            worst_pool = (1 + r_slots * self.private_pages
                          + min(b, r_slots + 1) * self.prompt_pages)
            shared_static = 0
        else:
            worst_pool = 1 + r_slots * self.private_pages
            shared_static = b * self.prompt_pages
        pool_pages = min(self.max_kv_pages, worst_pool) if self.max_kv_pages else worst_pool
        budgeted = pool_pages < worst_pool
        cache_on = self.prefix_cache
        pool = PagePool(first_page=shared_static, n_pages=pool_pages, r_slots=r_slots,
                        width=width, page_size=ps, prompt_pages=self.prompt_pages,
                        prefix_sharing=sharing, radix=self._radix if cache_on else None,
                        store=self._kv_store if cache_on else None)
        group_hit_tok: dict[int, int] = {}
        restore_ms: list[float] = []
        spilled_keys: set = set()  # preempt payloads not consumed by a resume
        real_toks = [prompt_ids_h[g][prompt_mask_h[g] > 0].astype(np.int32) for g in range(b)]
        if cache_on:
            weights = (model, model.weights_version)
            if (self._cache_lora_ref is not lora or self._cache_weights is None
                    or self._cache_weights[0] is not model
                    or self._cache_weights[1] != weights[1]):
                pool.invalidate_cache()
                self._cache_lora_ref = lora
                self._cache_weights = weights
            radix_snap0 = self._radix.snapshot()
        # cache writes stay legal until a mid-round adapter swap is consumed
        cache_write = [cache_on]

        ids = torch.as_tensor(prompt_ids_h, dtype=torch.int32).to(dev)
        mask = torch.as_tensor(prompt_mask_h, dtype=torch.int32).to(dev)
        lora_cell = [lora]
        # snapshot cadence, never longer than a short decode's whole run
        check = max(1, min(self.decode_chunk, 16, max_steps))
        # scan chunks of k_conf steps: the largest divisor of `check` that is
        # <= scan_chunk, so every host decision (snapshot reads, admissions,
        # grants, preemption, spill and restore, the wedge detector, the
        # draft-length controller) still falls every `check` steps; a
        # non-divisor would stretch the cadence past the grant horizon
        k_conf = min(self.scan_chunk, check) if self.scan_chunk > 1 else 0
        while k_conf > 1 and check % k_conf:
            k_conf -= 1
        chunked = k_conf > 1
        buf_width = self.max_prompt_tokens + max_steps + self.spec_draft + 2
        static = (self._refill_static(
            spec=spec, r_slots=r_slots, total=total, max_steps=max_steps, width=width,
            total_pages=shared_static + pool_pages, scratch=pool.scratch,
            buf_width=buf_width if spec else 0, hist_width=self.spec_draft + 2 if spec else 0)
            if chunked else None)
        gen = (torch.Generator(device=dev) if static is None else static.gen).manual_seed(seed)
        t_prefill = 0.0
        if continuous:
            # lazy per-group prefill: the pools hold only the pool pages, and
            # each group's logits row is written when the group is admitted
            k_pages, v_pages = ((static.k_pages, static.v_pages) if static is not None else
                                _empty_pools(self.cfg, pool_pages, page_size=ps,
                                             cache_dtype=self.cache_dtype,
                                             kv_quant=self.kv_quant, device=dev))
            last_logits = torch.zeros((b, self.cfg.vocab_size), dtype=torch.float32,
                                      device=dev)
            real_len = _to_device(real_len_h.astype(np.int32), dev)
        else:
            t0 = time.perf_counter()
            k_pages, v_pages, last_logits, real_len = _paged_prefill(
                model, lora, ids, mask, prompt_pages=self.prompt_pages, page_size=ps,
                lora_scale=self.lora_scale, cache_dtype=self.cache_dtype,
                attn_impl=self.attn_impl, kv_quant=self.kv_quant,
                total_pages=shared_static + pool_pages,
                pools=None if static is None else (static.k_pages, static.v_pages),
                table=None if static is None else torch.as_tensor(
                    make_page_table(b, self.prompt_pages * ps, ps), device=dev))
            self._sync()
            t_prefill = time.perf_counter() - t0
        t_decode0 = time.perf_counter()
        if sharing and not continuous:
            # the prefill's static region becomes refcounted prefix chains:
            # ceil(rl / ps) live pages a prompt, held until its group
            # finishes; the slack and dead rows' regions feed the free list
            for g in range(b):
                base = g * self.prompt_pages
                region = list(range(base, base + self.prompt_pages))
                if not row_alive[g]:
                    pool.reclaim(region)
                    continue
                n_chain = max(-(-int(real_len_h[g]) // ps), 1)
                pool.register_prefix(g, region[:n_chain], int(real_len_h[g]) // ps)
                pool.reclaim(region[n_chain:])

        # grant horizon: a slot's write frontier advances for up to 2·check
        # steps of snapshot lag plus check steps to the next grant pass
        lag_tokens = 3 * check
        write_ceiling_extra = 0
        sampler_calls = [0]

        def seeds(rows: int, out=None) -> torch.Tensor:
            return torch.randint(-2**31, 2**31, (rows,), generator=gen,
                                 dtype=torch.int32, device=dev, out=out)

        # k steps a dispatch: one at a time, or a chunk of k_conf through the
        # chunk runner (a CUDA graph replay on the GPU) keyed by the static
        # state's shape, the sampling settings and the weights' and
        # adapters' tensors; the host counts the steps and forwards
        graphs = self.decode_graphs
        replays0 = graphs.replays
        chunk_key = ((self._chunk_state[0], k_conf, top_p_impl, temperature, top_p,
                      tensors_key(model)) if chunked else None)

        def run_steps(s, k: int, body, key_fn, generators=()) -> None:
            if chunked:
                graphs.run(chunk_key + key_fn(), body, dev, generators=generators)
            else:
                body()
            s.step += k
            s.forwards += k

        d_cell = [self.spec_draft]  # the draft length spec_adapt resizes
        drafter_cell = [None]
        drafter_version = None
        if spec:
            d = self.spec_draft
            # emission is up to d+1 tokens a step and the verify writes d
            # past the frontier: the grant horizon scales by (d+1) and
            # covers the overhang
            lag_tokens = 3 * check * (d + 1) + d
            write_ceiling_extra = d
            packed_ids, _, _ = _pack_rows(ids, mask)
            state = static if static is not None else _spec_init(
                k_pages, v_pages, r_slots=r_slots, total=total, max_steps=max_steps,
                buf_width=buf_width, hist_width=d + 2, width=width, scratch=pool.scratch,
                pad_id=self.pad_id)
            self_draft = self.spec_drafter == "self"
            if self_draft:
                # the policy's previous adapter drafts; before any swap the
                # current one drafts for itself
                drafter_cell[0] = self._prev_lora if self._prev_lora is not None else lora
                drafter_version = (self._prev_lora_version if self._prev_lora is not None
                                   else None)

            def step(s, k: int) -> None:
                # the draws of the speculative and self-drafted steps come
                # from `gen` inside the chunk: registered with its graph, a
                # replay advances the generator as the eager steps would
                lo, dl, d_now = lora_cell[0], drafter_cell[0], d_cell[0]

                def body():
                    for _ in range(k):
                        _spec_step(model, lo, s, gen, page_size=ps, eos_ids=self.eos_ids,
                                   temperature=temperature, top_p=top_p,
                                   lora_scale=self.lora_scale, top_p_impl=top_p_impl,
                                   capture_logprobs=self.capture_logprobs,
                                   max_steps=max_steps, draft_len=d_now,
                                   ngram_k=self.spec_ngram, spec_verify=self.spec_verify,
                                   drafter_lora=dl, self_draft=self_draft)

                # each draft length is its own graph (the JAX package's
                # spec:d{d}), and so is each drafter adapter
                run_steps(s, k, body, lambda: (d_now, tensors_key(lo), tensors_key(dl)),
                          generators=(gen,))
                if self_draft:
                    s.draft_forwards += k * d_now

            def admit(s, new_cand, admit_mask, copies):
                sampler_calls[0] += 1
                _spec_admit(s, new_cand, admit_mask, last_logits, real_len, real_len_h,
                            packed_ids, seeds(int(admit_mask.sum())), copies, n=n, b=b,
                            eos_ids=self.eos_ids, temperature=temperature, top_p=top_p,
                            top_p_impl=top_p_impl, capture_logprobs=self.capture_logprobs)

            def admit_last_pos(rl: int, plen: int) -> int:
                if not budgeted:
                    return rl + max_steps + d  # worst case: no grant passes
                return min(rl + max(plen, 1) + lag_tokens, rl + max_steps + d)
        else:
            state = static if static is not None else _refill_init(
                k_pages, v_pages, r_slots=r_slots, total=total, max_steps=max_steps,
                vocab=self.cfg.vocab_size, width=width, scratch=pool.scratch,
                pad_id=self.pad_id)

            def step(s, k: int) -> None:
                # a chunk's k seed vectors are drawn before it, into the
                # static buffer, by the per-step loop's k calls
                lo = lora_cell[0]
                rows = ([seeds(r_slots, out=s.seeds[i]) for i in range(k)] if chunked
                        else [seeds(r_slots)])
                sampler_calls[0] += k

                def body():
                    for i in range(k):
                        _refill_decode_step(model, lo, s, rows[i], page_size=ps,
                                            eos_ids=self.eos_ids, pad_id=self.pad_id,
                                            temperature=temperature, top_p=top_p,
                                            lora_scale=self.lora_scale, top_p_impl=top_p_impl,
                                            capture_logprobs=self.capture_logprobs,
                                            max_steps=max_steps)

                run_steps(s, k, body, lambda: (tensors_key(lo),))

            def admit(s, new_cand, admit_mask, copies):
                _refill_admit(s, new_cand, admit_mask, last_logits, real_len, copies,
                              n=n, b=b)

            def admit_last_pos(rl: int, plen: int) -> int:
                if not budgeted:
                    return rl + max_steps  # the full region: no grant passes run
                return min(rl + plen + lag_tokens, rl + max_steps)
        del k_pages, v_pages

        if cache_on:
            # spill transport: the page's tiles as they stand, copied to the
            # host on the stream by the store
            pool.spill_fn = lambda page: _page_tiles(state.k_pages, state.v_pages, page)

        # dead prompts (batch padding) are never queued. Entries are
        # candidate ids, or (cand, prefix, prefix_len, first_logp) for a
        # preempted candidate awaiting its resume; with continuous admission
        # the groups wait in their own queue until their lazy prefill
        if continuous:
            pending: deque = deque()
            group_queue: deque = deque(g for g in range(b) if row_alive[g])
        else:
            pending = deque(c for c in range(total) if row_alive[c // n])
            group_queue = deque()
        finished = np.array([not row_alive[c // n] for c in range(total)])
        # a group's chain hold drops when its LAST candidate finishes (a
        # preempted candidate must still find the chain at its resume)
        group_left = np.array([n if row_alive[g] else 0 for g in range(b)])
        host_cand = np.full(r_slots, total, np.int64)  # the device's `cand`
        epoch = np.zeros(r_slots, np.int64)
        counters = dict(resumes=0, groups_prefilled=0, backfill=0, warm_tokens=0,
                        warm_prefills=0)
        dispatched = 0

        def mark_finished(c: int) -> None:
            if finished[c]:
                return
            finished[c] = True
            if sharing:
                g = c // n
                group_left[g] -= 1
                if group_left[g] == 0 and g in pool.chains:
                    if cache_write[0]:
                        # the finished chain's full pages become radix
                        # inventory; the partial tail derefs as usual
                        pool.cache_chain(g, real_toks[g])
                    else:
                        pool.drop_prefix(g)

        def restore_uploads(uploads) -> None:
            t0r = time.perf_counter()
            for _node, page, payload in uploads:
                _restore_page_tiles(state.k_pages, state.v_pages, payload, page)
            self._sync()
            restore_ms.append((time.perf_counter() - t0r) * 1e3)

        def admit_group(g: int) -> bool:
            """Group ``g``'s lazy prefill into pool-allocated chain pages
            (through the radix cache when its prefix is resident or
            restorable), its logits row published, its candidates queued."""
            nonlocal t_prefill
            rl = int(real_len_h[g])
            n_chain = max(-(-rl // ps), 1)
            resident = []
            if cache_on:
                nodes, _hit = pool.radix_match(real_toks[g])
                if nodes:
                    resident, uploads = pool.restore_nodes(nodes)
                    if uploads:
                        restore_uploads(uploads)
            t0 = time.perf_counter()
            if resident:
                chain = pool.admit_cached(g, resident, n_chain, rl // ps)
                if chain is None:
                    return False
                hit = len(resident) * ps
                group_hit_tok[g] = hit
                row_ext = np.full(self.prompt_pages + 1, pool.scratch, np.int32)
                row_ext[:n_chain] = chain
                last_logits[g] = _warm_prefill(
                    model, lora_cell[0], state.k_pages, state.v_pages, row_ext,
                    real_toks[g][hit:rl], hit, page_size=ps, lora_scale=self.lora_scale,
                    pad_id=self.pad_id)
                counters["warm_tokens"] += hit
                counters["warm_prefills"] += 1
            else:
                chain = pool.alloc_prefix(g, n_chain, rl // ps)
                if chain is None:
                    return False
                if cache_on:
                    group_hit_tok[g] = 0
                row = np.full((1, self.prompt_pages), pool.scratch, np.int32)
                row[0, :n_chain] = chain
                _, _, logits_g, _ = _paged_prefill(
                    model, lora_cell[0], ids[g:g + 1], mask[g:g + 1],
                    prompt_pages=self.prompt_pages, page_size=ps,
                    lora_scale=self.lora_scale, cache_dtype=self.cache_dtype,
                    attn_impl=self.attn_impl, kv_quant=self.kv_quant,
                    pools=(state.k_pages, state.v_pages), table=_to_device(row, dev))
                last_logits[g] = logits_g[0]
            # an honest prefill/decode split (an upper bound: the wait also
            # drains decode steps already queued)
            self._sync()
            t_prefill += time.perf_counter() - t0
            counters["groups_prefilled"] += 1
            pending.extend(range(g * n, (g + 1) * n))
            return True

        def admit_groups() -> str | None:
            """Keep the candidate queue stocked while the pool affords the
            head group's chain and a private region on top, with at most one
            chain admitted beyond the slots' spread. Returns the head
            group's decline reason, None once the queue is empty."""
            while group_queue:
                g = group_queue[0]
                if len(pending) >= r_slots:
                    return "no_slots"
                if len(pool.chains) >= r_slots + 1:
                    return "chain_cap"
                n_chain = max(-(-int(real_len_h[g]) // ps), 1)
                if pool.free_pages < n_chain + self.private_pages or not admit_group(g):
                    return "no_pages"
                group_queue.popleft()
            return None

        def ship_table(s) -> None:
            # admitted slots' rows reach the device before their first step
            s.page_indices.copy_(_to_device(pool.table, dev))

        def fill_idle(s, idle_slots) -> None:
            new_cand = np.full(r_slots, total, np.int64)
            admit_mask = np.zeros(r_slots, bool)
            src, dst = [], []
            resume = []
            for s_i in idle_slots:
                if not pending:
                    break
                entry = pending[0]
                c, prefix, plen, logp0 = (
                    entry if isinstance(entry, tuple) else (entry, None, 0, 0.0))
                pr = c // n
                rl = int(real_len_h[pr])
                # admission is gated on free pages; the queue is FIFO, so a
                # head that does not fit blocks the rest. Shared, the slot
                # aliases its group's chain and the imminent first write at
                # rl splits the chain's tail page as part of the admission
                if not pool.admit(int(s_i), pr, rl, admit_last_pos(rl, plen),
                                  first_write=rl if sharing else None):
                    break
                pending.popleft()
                new_cand[s_i] = c
                admit_mask[s_i] = True
                if sharing:
                    cow = pool.take_copy(int(s_i))
                    if cow is not None:
                        src.append(cow)
                        dst.append(pool.owned[int(s_i)][0])
                else:
                    src.append(pr * self.prompt_pages
                               + min(rl // ps, self.prompt_pages - 1))
                    dst.append(pool.owned[int(s_i)][0])
                if plen:
                    resume.append((int(s_i), c, prefix, plen, rl, logp0))
            if not admit_mask.any():
                return
            admit(s, new_cand, admit_mask, (np.asarray(src, np.int64),
                                            np.asarray(dst, np.int64)))
            host_cand[admit_mask] = new_cand[admit_mask]
            epoch[admit_mask] += 1
            if dispatched:
                counters["backfill"] += int(admit_mask.sum())
            ship_table(s)
            for s_i, c, prefix, plen, rl, logp0 in resume:
                counters["resumes"] += 1
                if self.kv_spill:
                    payload = self._kv_store.get(("preempt", c))
                    if payload is not None:
                        # the parked pages and logits row, copied back into
                        # the freshly granted pages in block order; a payload
                        # the byte cap dropped resumes by recompute below
                        t0r = time.perf_counter()
                        owned = pool.owned[s_i]
                        nv = int(payload["n_valid"])
                        for page, tiles in zip(owned[:nv], payload["tiles"]):
                            _restore_page_tiles(s.k_pages, s.v_pages, tiles, page)
                        s.logits[s_i].copy_(payload["logits"], non_blocking=True)
                        s.done[s_i] = False
                        s.gen_lengths[s_i] = plen
                        s.seq_lengths[s_i] = rl + plen
                        self._sync()
                        restore_ms.append((time.perf_counter() - t0r) * 1e3)
                        pool.note_restored(nv)
                        self._kv_store.drop(("preempt", c))
                        spilled_keys.discard(("preempt", c))
                        continue
                if spec:
                    # host-built n-gram row: packed prompt, then the prefix
                    row = np.zeros(s.seq_buf.shape[1], np.int32)
                    row[:rl] = real_toks[c // n]
                    row[rl:rl + plen] = prefix[:plen]
                    _spec_resume_fixup(model, lora_cell[0], s, s_i, c, prefix, plen, rl,
                                       row, logp0, page_size=ps, lora_scale=self.lora_scale)
                else:
                    _resume_fixup(model, lora_cell[0], s, s_i, prefix, plen, rl,
                                  page_size=ps, lora_scale=self.lora_scale)

        turn = dict(resumes=0, saved=0, window_short=0)
        window_declines: list[tuple[int, int]] = []  # (obs tokens, window needed)

        def try_turn_resume(s_i: int, c: int) -> bool:
            """Before a finished candidate is retired, offer its tokens to the
            turn hook. An observation that fits the window and the pool is
            appended in place: the slot keeps its occupant and pages, so
            the conversation's ``seq_len`` resident tokens are never
            prefilled again. Returns True when the slot resumed (the idle
            pass must not release it). A decline (no room in the window,
            no pages) goes back to the hook through ``declined``; it never
            preempts another slot, so a turn's continuation ranks below
            first-turn progress."""
            nonlocal budget
            # a blocking read of the candidate's current truth (done is
            # monotone per epoch, so it has finished); turn ends are rare
            # beside decode steps, the cost argument of preempt()
            gen_len = int(state.lengths_buf[c])
            if gen_len + 2 > max_steps:
                # no room for one observation token and one decode token:
                # the hook is not consulted, the driver scores the last turn
                # from the result tensors
                turn["window_short"] += 1
                return False
            tokens = state.out[c, :gen_len].cpu().numpy().astype(np.int32)
            obs = th(c, tokens)
            if obs is None:
                return False
            obs = np.asarray(obs, np.int32).ravel()
            t_obs = int(obs.size)
            if t_obs == 0 or gen_len + t_obs + 1 > max_steps:
                if t_obs > 0:
                    window_declines.append((t_obs, gen_len + t_obs + 1))
                th.declined(c)
                return False
            rl = int(real_len_h[c // n])
            seq_len = rl + gen_len
            if pool.ensure(s_i, admit_last_pos(rl, gen_len + t_obs)):
                th.declined(c)
                return False
            # pages ensure granted reach the device before the chunked
            # forward writes the observation's KV
            ship_table(state)
            obs_pad = np.full(max_steps, self.pad_id, np.int32)
            obs_pad[:t_obs] = obs
            _turn_resume_fixup(model, lora_cell[0], state, s_i, c, obs_pad, t_obs, gen_len,
                               seq_len, rl, page_size=ps, lora_scale=self.lora_scale,
                               max_steps=max_steps, capture_logprobs=self.capture_logprobs)
            # snapshots queued while the slot's done flag was set must not
            # retire the resumed occupant
            epoch[s_i] += 1
            # each resume may spend one more notice window of slot-steps
            # before the occupant's next EOS is seen
            budget += 2 * check
            turn["resumes"] += 1
            turn["saved"] += seq_len
            telemetry.counter_add(ENGINE_TURN_RESUMES)
            telemetry.counter_add(ENGINE_TURN_PREFILL_SAVED, float(seq_len))
            return True

        def preempt(s_i: int) -> None:
            """Evict slot ``s_i``'s occupant: requeue it at the FRONT with its
            generated prefix (for its resume; with host spill its written
            pages and logits row are parked first), free its pages, and kill
            the slot on the device with a dead admission."""
            c = int(host_cand[s_i])
            # a blocking read of the slot's current truth (the snapshot
            # lags): preemption is rare, the sync is the cost of exactness
            if bool(state.done[s_i]):
                mark_finished(c)
            else:
                plen = int(state.lengths_buf[c])
                if plen:
                    prefix = state.out[c].cpu().numpy().astype(np.int32)
                    # a speculative re-admission draws a new first token:
                    # keep the original behavior logprob for the resume
                    logp0 = float(state.logps_buf[c, 0]) if self.capture_logprobs else 0.0
                    if self.kv_spill:
                        rl_p = int(real_len_h[c // n])
                        owned = pool.owned[s_i]
                        nv = min((rl_p + plen - 1) // ps - rl_p // ps + 1, len(owned))
                        self._kv_store.put(("preempt", c), {
                            "tiles": [_page_tiles(state.k_pages, state.v_pages, page)
                                      for page in owned[:nv]],
                            "logits": state.logits[s_i], "n_valid": nv})
                        pool.note_spilled(nv)
                        spilled_keys.add(("preempt", c))
                    pending.appendleft((c, prefix, plen, logp0))
                else:
                    pending.appendleft(c)
                pool.preemptions += 1
            pool.release(s_i)
            kill = np.zeros(r_slots, bool)
            kill[s_i] = True
            admit(state, np.full(r_slots, total, np.int64), kill, _NO_COPIES)
            host_cand[s_i] = total
            epoch[s_i] += 1

        if continuous:
            admit_groups()
        fill_idle(state, range(r_slots))
        snapshots: deque = deque()
        # each slot serves <= ceil(total / R) occupants x max_steps, plus up
        # to 2·check of admission lag per handoff; a budgeted pool may
        # serialize candidates and recompute preempted prefixes, and
        # continuous admission gates on chains as a budget does: the fully
        # serial bound
        occupancies = -(-total // r_slots)
        budget = (max_steps + 2 * check) * (
            2 * (total + 2) if (budgeted or continuous) else occupancies + 2)
        since_host = stalled = 0
        spec_prev = (0, 0)
        spec_ema = None
        d_trace = [d_cell[0]]  # the draft length in force at each boundary
        while dispatched < budget and not finished.all():
            prev_lora = lora_cell[0]
            self._take_pending_lora(lora_cell, dispatched)
            if lora_cell[0] is not prev_lora:
                if spec and self.spec_drafter == "self":
                    # the superseded adapter is now the previous version
                    drafter_cell[0] = self._prev_lora
                    drafter_version = self._prev_lora_version
                if cache_on:
                    # KV cached under the superseded adapter is no longer
                    # exact: drop the cache and stop caching this round
                    pool.invalidate_cache()
                    cache_write[0] = False
            k = k_conf if chunked else 1
            step(state, k)
            dispatched += k
            since_host += k
            if since_host < check:
                continue
            since_host = 0
            snapshots.append((_Snapshot(state.done), _Snapshot(state.seq_lengths),
                              epoch.copy(), host_cand.copy()))
            if spec and self.spec_adapt:
                # the draft-length controller: the accept rate between
                # boundaries feeds an EMA; persistent waste halves d (floor
                # 1), recovery doubles it back toward the configured max.
                # It reads the two totals as they stand at this boundary
                # (the JAX package's one read a boundary): a wait for the
                # queued steps every `check` steps, never per step, and only
                # with spec_adapt on
                tot = _Snapshot(torch.stack([state.accept_total, state.draft_total])).read()
                acc_now, dtot_now = int(tot[0]), int(tot[1])
                d_acc, d_draft = acc_now - spec_prev[0], dtot_now - spec_prev[1]
                spec_prev = (acc_now, dtot_now)
                if d_draft > 0:
                    rate = d_acc / d_draft
                    spec_ema = rate if spec_ema is None else 0.5 * spec_ema + 0.5 * rate
                    if spec_ema < 0.35 and d_cell[0] > 1:
                        d_cell[0] = max(1, d_cell[0] // 2)
                    elif spec_ema > 0.75 and d_cell[0] < self.spec_draft:
                        d_cell[0] = min(self.spec_draft, d_cell[0] * 2)
                d_trace.append(d_cell[0])
            if len(snapshots) <= 1:
                continue
            # the snapshot taken one boundary ago: its copy finished while
            # the last `check` steps ran
            done_snap, seq_snap, snap_epoch, snap_cand = snapshots.popleft()
            done_h, seq_h = done_snap.read(), seq_snap.read()
            # a done flag is believed only if the slot was not refilled
            # since the snapshot (done is monotone per epoch)
            idle = [int(s_i) for s_i in np.nonzero(done_h)[0] if snap_epoch[s_i] == epoch[s_i]]
            for s_i in idle:
                c = snap_cand[s_i]
                if (th is not None and c < total and not finished[c]
                        and try_turn_resume(int(s_i), int(c))):
                    # the episode continues in place: occupant, pages and KV
                    # kept; the slot is neither released nor retired
                    continue
                if pool.owned[s_i] or pool.shared[s_i]:
                    pool.release(s_i)  # frees its pages, points it at scratch
                if c < total:
                    # after the release, so a finished group's chain frees
                    # the moment its hold drops
                    mark_finished(int(c))
                host_cand[s_i] = total
            table_dirty = bool(idle)
            if budgeted:
                # grant pass: extend every occupied slot to cover its write
                # frontier through the next grant window; preempt the
                # least-advanced occupant when the pool runs dry
                idle_set = set(idle)
                for s_i in range(r_slots):
                    if host_cand[s_i] >= total or s_i in idle_set:
                        continue
                    if snap_epoch[s_i] != epoch[s_i]:
                        continue  # admitted after the snapshot: its admit grant covers
                    rl = int(real_len_h[int(host_cand[s_i]) // n])
                    target = min(int(seq_h[s_i]) + lag_tokens,
                                 rl + max_steps + write_ceiling_extra)
                    while pool.ensure(s_i, target):
                        occupied = [v for v in range(r_slots)
                                    if host_cand[v] < total and v != s_i
                                    and snap_epoch[v] == epoch[v]]
                        victim = min(occupied, key=lambda v: int(seq_h[v]) - int(
                            real_len_h[int(host_cand[v]) // n])) if occupied else s_i
                        preempt(victim)
                        if victim == s_i:
                            break
                    table_dirty = True
            marks = pool.total_admissions + counters["groups_prefilled"]
            if continuous and group_queue:
                # freed pages may now fit the next group's prefill: the
                # backfill that replaces the fixed episode batch
                admit_groups()
            idle_free = [v for v in idle if host_cand[v] >= total]
            if pending:
                fill_idle(state, idle_free)
                table_dirty = True
            if table_dirty:
                ship_table(state)
            if continuous:
                # wedge detector: no live slot, work queued, and this
                # boundary admitted nothing: name the stall after a few
                # boundaries of grace instead of spinning the step budget
                if (pool.total_admissions + counters["groups_prefilled"] == marks
                        and (pending or group_queue)
                        and (host_cand >= total).all()):
                    stalled += 1
                    if stalled > 4:
                        if group_queue:
                            rl_h = int(real_len_h[group_queue[0]])
                        else:
                            e0 = pending[0]
                            rl_h = int(real_len_h[(e0[0] if isinstance(e0, tuple)
                                                   else e0) // n])
                        need = max(-(-rl_h // ps), 1) + self.private_pages
                        raise RuntimeError(
                            f"continuous admission wedged: {int(finished.sum())}/"
                            f"{total} finished, {len(pending)} pending candidates + "
                            f"{len(group_queue)} queued groups, no live slot, and the "
                            f"pool ({pool.free_pages} free / {pool.universe_pages}) "
                            f"cannot admit the head; the head request needs {need} "
                            f"pages: raise max_kv_pages to at least {need}")
                else:
                    stalled = 0

        # a final blocking read closes the snapshot lag on the last occupants
        done_h = state.done.cpu().numpy()
        for s_i in np.nonzero(done_h)[0]:
            if host_cand[s_i] < total:
                mark_finished(int(host_cand[s_i]))
        alive_h = int(state.alive_steps)
        radix_delta = None
        if cache_on:
            # park every resident cached page in the host store: page ids
            # die with this round's pool, the index and payloads do not;
            # unconsumed preempt payloads drop (candidate ids are per round)
            pool.flush_cache()
            for key in spilled_keys:
                self._kv_store.drop(key)
            snap1 = self._radix.snapshot()
            radix_delta = {k: snap1[k] - radix_snap0[k] for k in snap1}
        self.last_pool_stats = {
            "pool_pages": pool_pages, "worst_case_pages": worst_pool,
            "peak_pages_used": pool.peak_pages_used, "preemptions": pool.preemptions,
            "resumes": counters["resumes"], "budgeted": budgeted, "cb_mode": self.cb_mode,
            "cow_splits": pool.cow_splits,
            "peak_shared_pages": pool.peak_shared_pages if sharing else None,
            "pages_shared_frac": (round(pool.peak_shared_pages
                                        / max(pool.peak_pages_used, 1), 4)
                                  if sharing else None),
            "prefill_shared_frac": (round(pool.prefix_admissions
                                          / max(pool.total_admissions, 1), 4)
                                    if sharing else None),
            "backfill_admissions": counters["backfill"],
            "groups_prefilled": counters["groups_prefilled"] if continuous else None,
            "slot_idle_frac": (round(1.0 - alive_h / (r_slots * dispatched), 4)
                               if dispatched else None),
            "prefix_cache": cache_on,
            "radix_hit_rate": (round(radix_delta["hit_tok"]
                                     / max(radix_delta["lookup_tok"], 1), 4)
                               if cache_on else None),
            "prefill_tok_saved": radix_delta["prefill_tok_saved"] if cache_on else None,
            "radix_evictions": radix_delta["evictions"] if cache_on else None,
            "spilled_pages": radix_delta["spilled_pages"] if cache_on else None,
            "restored_pages": radix_delta["restored_pages"] if cache_on else None,
            "spill_restore_ms_p50": (round(float(np.percentile(restore_ms, 50)), 3)
                                     if cache_on and restore_ms else None),
            # in-place turn resumes and the conversation tokens they kept
            # resident (None: no turn hook, the single-turn round)
            "turn_resumes": turn["resumes"] if th is not None else None,
            "turn_prefill_saved_tokens": turn["saved"] if th is not None else None,
        }
        if not finished.all():
            raise RuntimeError(
                f"refill scheduler exhausted its step budget ({budget}) with "
                f"{int((~finished).sum())}/{total} candidates unfinished")
        if th is not None and turn["resumes"] == 0 and (window_declines
                                                        or turn["window_short"]):
            # every turn continuation this round was declined for want of
            # window room: the round ran single-turn. One warning naming the
            # observation length seen and the least window that would do
            if window_declines:
                detail = (f"observed observation length up to "
                          f"{max(t for t, _ in window_declines)} tokens; minimum viable "
                          f"max_new_tokens window: {max(w for _, w in window_declines)}")
            else:
                detail = (f"every finished candidate was within 2 tokens of the window, "
                          f"so no observation could seat at all (max_new_tokens={max_steps})")
            warnings.warn(
                f"multi-turn window exhausted: all "
                f"{len(window_declines) + turn['window_short']} turn continuations this "
                f"round were declined for max_new_tokens room — the round degraded to "
                f"single-turn. {detail} (need gen_len + obs_tokens + 1 <= max_new_tokens)",
                RuntimeWarning, stacklevel=3)
        # host copies: a chunked engine's state is the next round's
        out = _host(state.out[:total]).reshape(b, n, max_steps)
        lengths = _host(state.lengths_buf[:total]).reshape(b, n)
        logps = (_host(state.logps_buf[:total]).reshape(b, n, max_steps)
                 if self.capture_logprobs else None)
        gen_tokens = int(lengths.sum())
        if spec:
            # acceptance accounting off the device-carried histogram, read
            # once at round end
            hist_h = _host(state.emit_hist)
            drafted = int(state.draft_total)
            steps_alive = int(hist_h.sum())
            emitted = int((hist_h * np.arange(hist_h.size)).sum())
            self.last_spec_stats = {
                "drafter": self.spec_drafter, "spec_draft": self.spec_draft,
                "draft_len_final": d_cell[0],
                "draft_len_switches": sum(a != b_ for a, b_ in zip(d_trace, d_trace[1:])),
                "draft_len_trace": d_trace,
                "accept_rate": int(state.accept_total) / drafted if drafted else 0.0,
                "accepted": int(state.accept_total),
                "tokens_per_verify_step": emitted / steps_alive if steps_alive else 0.0,
                "emit_hist": hist_h.tolist(), "drafted": drafted,
                "verify_impl": self.spec_verify, "verify_forwards": state.forwards,
                "draft_forwards": state.draft_forwards,
                "drafter_version": drafter_version,
                "target_version": (self.last_swap_versions[-1]
                                   if self.last_swap_versions else None),
            }
        decode_s = time.perf_counter() - t_decode0
        if continuous:
            # the lazy prefills ran inside the decode loop
            decode_s = max(decode_s - t_prefill, 1e-9)
        stats = accumulate_round_stats(
            self.last_round_stats, prefill_s=t_prefill, prefill_tokens=prefill_tokens,
            prompt_rows=b, decode_s=decode_s, gen_tokens=gen_tokens, gen_rows=total)
        stats["decode_forwards"] = state.forwards
        stats["graph_steps"] = (graphs.replays - replays0) * k_conf if chunked else 0
        stats["draft_forwards"] = getattr(state, "draft_forwards", 0)
        stats["sampler_calls"] = sampler_calls[0]
        # prompt tokens the radix cache saved, and the group prefills that ran
        # warm (the rest ran cold: K4 with attn_impl "splash")
        stats["prefill_tokens_skipped"] = counters["warm_tokens"]
        stats["warm_prefills"] = counters["warm_prefills"]
        self.last_round_stats = stats
        return GenerationResult(tokens=out, lengths=lengths, steps_dispatched=dispatched,
                                logprobs=logps, alive_slot_steps=alive_h)
