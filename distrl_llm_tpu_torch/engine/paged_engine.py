"""Paged-KV rollout engine, wave scheduler: packed prompts, ragged decode.

Counterpart of the JAX package's ``engine/paged_engine.py`` on its wave
path (``PagedGenerationEngine`` with ``scheduler="waves"``, the trainer's
``engine_impl="paged"`` engine when continuous batching is off).

* **Packed prefill.** Prompts lose their left padding; one forward runs
  over ``prompt_pages · page_size`` columns at positions ``0, 1, ...`` and
  writes every row's prompt K/V into its leading pages. Each row's sampling
  logits come from its last real position.
* **One pool, allocated once.** The page pool of every layer holds
  ``B · prompt_pages`` shared prompt pages and ``B · n · private_pages``
  private ones. Candidates share their prompt's FULL pages through the page
  table; the partial last prompt page is copied, in place, into each
  candidate's private region, which decode then extends. The page table is
  the JAX engine's, column for column.
* **Decode.** Each step samples from the carried logits (one launch of the
  fused sampler K1 on the GPU), then runs one forward that writes the token
  at ``seq_lengths`` and attends over ``seq_lengths + 1`` through
  ``paged_attention_op`` (one launch of K2 per layer on the GPU). Done rows
  stop advancing ``seq_lengths``: they rewrite one slot of their own private
  page and their output is discarded. The round's last step skips the
  forward, whose logits nothing reads; ``last_round_stats["decode_forwards"]``
  counts the forwards that ran.

Not ported yet: the refill scheduler (continuous batching, prefix sharing,
continuous admission, radix cache, host spill, speculative decoding, turn
and gateway hooks) and scan chunks. Their knobs raise
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import (
    GenerationResult, LoraMailbox, accumulate_round_stats, generate_in_waves,
    run_decode_loop,
)
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.ops.paged import (
    init_pages, is_quantized_pages, make_page_table, pages_per_seq,
)
from distrl_llm_tpu_torch.ops.sampling import sample_with_logprob
from distrl_llm_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

_REFILL_ITEM = "ROADMAP queue 1 item 7: refill scheduler and continuous admission"
_SPEC_ITEM = "ROADMAP queue 1 item 4: speculative decoding with kernel K5"


@dataclass
class _PagedDecodeState:
    """Decode state; every tensor is updated in place by the decode step."""

    out: torch.Tensor  # [Bn, T] int32, pad-filled
    logps: torch.Tensor  # [Bn, T] f32 raw-model logprob of each sampled token
    gen_lengths: torch.Tensor  # [Bn] generated token counts (incl. EOS)
    done: torch.Tensor  # [Bn] bool
    logits: torch.Tensor  # [Bn, V] f32 logits for the next token
    seq_lengths: torch.Tensor  # [Bn] tokens resident in the cache per row
    k_pages: list  # L × [K, total_pages, ps, hd] (or QuantizedPages)
    v_pages: list
    step: int = 0
    forwards: int = 0  # decode forwards run (each launches K2 once per layer)


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


def _paged_prefill(model: Decoder, lora, prompt_ids, prompt_mask, *,
                   prompt_pages: int, page_size: int, lora_scale: float,
                   cache_dtype, attn_impl: str, kv_quant: str = "none",
                   total_pages: int | None = None):
    """Pack prompts and run one forward over B rows into fresh page pools
    of ``total_pages`` pages (default ``B · prompt_pages``): row r's prompt
    lands in pages ``[r · prompt_pages, (r + 1) · prompt_pages)``. Returns
    (k_pages, v_pages, last-position logits [B, V], real lengths [B])."""
    cfg = model.cfg
    b, p = prompt_ids.shape
    packed_ids, packed_mask, real_len = _pack_rows(prompt_ids, prompt_mask)
    pad_to = prompt_pages * page_size
    packed_ids = torch.nn.functional.pad(packed_ids, (0, pad_to - p))
    packed_mask = torch.nn.functional.pad(packed_mask, (0, pad_to - p))
    total = b * prompt_pages if total_pages is None else total_pages
    if total < b * prompt_pages:
        raise ValueError(f"a pool of {total} pages cannot hold {b} prompts of "
                         f"{prompt_pages} pages")
    shape = (cfg.num_kv_heads, total, page_size, cfg.head_dim)
    dev = prompt_ids.device
    cache = {
        "k": [init_pages(shape, cache_dtype, dev, kv_quant) for _ in range(cfg.num_layers)],
        "v": [init_pages(shape, cache_dtype, dev, kv_quant) for _ in range(cfg.num_layers)],
        "lengths": real_len,
        "page_indices": torch.as_tensor(make_page_table(b, pad_to, page_size), device=dev),
    }
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
                  page_size: int, max_steps: int, pad_id: int):
    """Expand B prompts to B·n candidate rows that share their prompt's full
    pages. The pools already hold ``B · prompt_pages + B · n ·
    private_pages`` pages; each candidate's copy of its prompt's partial
    page goes, in place, to the first page of its private region (for a
    page-aligned prompt the copied page is never read). Returns (state,
    page_indices [B·n, prompt_pages + private_pages])."""
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
    state = _PagedDecodeState(
        out=torch.full((bn, max_steps), pad_id, dtype=torch.int32, device=dev),
        logps=torch.zeros((bn, max_steps), dtype=torch.float32, device=dev),
        gen_lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
        # rows with an empty prompt are batch padding, born done
        done=(~row_alive).repeat_interleave(n),
        logits=last_logits.repeat_interleave(n, dim=0),
        seq_lengths=real_len.to(torch.int32).repeat_interleave(n),
        k_pages=list(k_pages), v_pages=list(v_pages),
    )
    return state, page_indices


def _paged_forward(model: Decoder, lora, s: _PagedDecodeState, tok: torch.Tensor,
                   page_indices: torch.Tensor, *, page_size: int,
                   lora_scale: float) -> None:
    """The decode forward: write ``tok``'s K/V [Bn] at ``seq_lengths``,
    attend over ``seq_lengths + 1`` and carry the next logits in
    ``s.logits``. Advancing ``seq_lengths`` is the caller's."""
    cache = {"k": s.k_pages, "v": s.v_pages, "lengths": s.seq_lengths,
             "page_indices": page_indices}
    logits, _ = model(
        tok[:, None], positions=s.seq_lengths[:, None], lora=lora,
        lora_scale=lora_scale, kv_cache=cache, page_size=page_size,
    )
    s.logits = logits[:, 0]
    s.forwards += 1


def _paged_decode_step(model: Decoder, lora, s: _PagedDecodeState,
                       seeds: torch.Tensor, page_indices: torch.Tensor, *,
                       page_size: int, eos_ids: torch.Tensor, pad_id: int,
                       temperature: float, top_p: float, lora_scale: float,
                       top_p_impl: str, capture_logprobs: bool, last: bool) -> None:
    """One decode step over the paged cache, in place: sample, record, then
    (unless ``last``) forward the token, which writes its K/V at
    ``seq_lengths`` and attends over ``seq_lengths + 1``."""
    tok, logp = sample_with_logprob(
        s.logits, temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs,
    )
    alive = ~s.done
    tok = torch.where(s.done, pad_id, tok)
    s.out[:, s.step] = tok
    if capture_logprobs:
        s.logps[:, s.step] = torch.where(s.done, 0.0, logp)
    s.gen_lengths += alive.to(torch.int32)
    s.done |= torch.isin(tok, eos_ids)
    if not last:
        _paged_forward(model, lora, s, tok, page_indices, page_size=page_size,
                       lora_scale=lora_scale)
    # rows alive before this step hold one more resident token
    s.seq_lengths += alive.to(torch.int32)
    s.step += 1


class PagedGenerationEngine(LoraMailbox):
    """Drop-in for ``GenerationEngine`` with a packed paged KV cache (wave
    scheduler). ``generate`` takes left-padded prompts and returns
    per-candidate tokens, lengths and behavior logprobs."""

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
        scheduler: str = "waves",
        prefix_sharing: bool = False,
        continuous_admission: bool | None = None,
        prefix_cache: bool | None = None,
        kv_spill: bool = False,
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
        if scheduler == "refill" or prefix_sharing or continuous_admission \
                or prefix_cache or kv_spill:
            raise NotImplementedError(
                f"only the wave scheduler is ported ({_REFILL_ITEM})")
        if scheduler != "waves":
            raise ValueError(f"scheduler must be waves/refill, got {scheduler!r}")
        if spec_draft or spec_adapt or any(
                x is not None for x in (spec_ngram, spec_drafter, spec_verify)):
            raise NotImplementedError(f"speculative decoding is not ported ({_SPEC_ITEM})")
        if scan_chunk is not None and scan_chunk > 1:
            raise NotImplementedError(
                "scan chunks have no counterpart yet (ROADMAP: CUDA graphs over "
                "the decode step, a perf_opt PR)")
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
        self.prompt_buckets = [max_prompt_tokens]
        self.prompt_pages = pages_per_seq(max_prompt_tokens, page_size)
        # per-candidate private region: the partial prompt page (extended in
        # place by decode) and the decode pages; full prompt pages are shared
        self.private_pages = 1 + pages_per_seq(max_new_tokens, page_size)
        self.last_round_stats: dict | None = None

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
        with torch.inference_mode():
            return generate_in_waves(
                self._generate_wave, self.max_concurrent_rows, model, lora,
                prompt_ids, prompt_mask, sampling, seed, self.pad_id,
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

        t0 = time.perf_counter()
        k_pages, v_pages, last_logits, real_len = _paged_prefill(
            model, lora, ids, mask, prompt_pages=self.prompt_pages,
            page_size=self.page_size, lora_scale=self.lora_scale,
            cache_dtype=self.cache_dtype, attn_impl=self.attn_impl,
            kv_quant=self.kv_quant,
            total_pages=b * self.prompt_pages + b * n * self.private_pages,
        )
        self._sync()  # an honest prefill/decode timing split
        t_prefill = time.perf_counter() - t0

        t1 = time.perf_counter()
        state, page_indices = _paged_fanout(
            k_pages, v_pages, last_logits, real_len, mask.sum(dim=-1) > 0,
            n=n, b=b, prompt_pages=self.prompt_pages,
            private_pages=self.private_pages, page_size=self.page_size,
            max_steps=max_steps, pad_id=self.pad_id,
        )
        del k_pages, v_pages
        top_p_impl = sampling.resolved_top_p_impl()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bn = b * n
        lora_cell = [lora]

        def step(s: _PagedDecodeState, last: bool) -> None:
            # in-flight weight update: swap BEFORE sampling, so the recorded
            # swap step is the first position decoded under the new adapter
            self._take_pending_lora(lora_cell, s.step)
            seeds = torch.randint(-2**31, 2**31, (bn,), generator=gen,
                                  dtype=torch.int32, device=self.device)
            _paged_decode_step(
                model, lora_cell[0], s, seeds, page_indices,
                page_size=self.page_size, eos_ids=self.eos_ids,
                pad_id=self.pad_id, temperature=sampling.temperature,
                top_p=sampling.top_p, lora_scale=self.lora_scale,
                top_p_impl=top_p_impl, capture_logprobs=self.capture_logprobs,
                last=last,
            )

        state = run_decode_loop(step, state, max_steps, self.decode_chunk)
        out = state.out.cpu().numpy().reshape(b, n, max_steps)
        lengths = state.gen_lengths.cpu().numpy().reshape(b, n)
        logps = (state.logps.cpu().numpy().reshape(b, n, max_steps)
                 if self.capture_logprobs else None)
        stats = accumulate_round_stats(
            self.last_round_stats, prefill_s=t_prefill,
            prefill_tokens=prefill_tokens, prompt_rows=b,
            decode_s=time.perf_counter() - t1, gen_tokens=int(lengths.sum()),
            gen_rows=bn,
        )
        stats["decode_forwards"] = stats.get("decode_forwards", 0) + state.forwards
        self.last_round_stats = stats
        return GenerationResult(tokens=out, lengths=lengths,
                                steps_dispatched=state.step, logprobs=logps)
