"""The dense rollout engine: shared prefill + host-driven decode loop.

Counterpart of the JAX package's ``engine/engine.py`` (its host-dispatched
path; the XLA-only scan-chunk, compile-guard and autotune machinery has no
PyTorch counterpart and is left out).

* **Prefill once per prompt, decode n candidates.** Prompts are left-padded
  to a fixed length and prefilled at batch B; the KV cache is then repeated
  to B·n rows (row ``b*n + j`` is candidate j of prompt b).
* **In-place decode.** Each step samples from the carried logits, writes the
  token, and runs one forward that writes its K/V into the cache IN PLACE
  (slice assignment in ``models/transformer.py``); nothing cache-sized is
  ever copied after the candidate fan-out.
* **Early exit.** The host reads ``done.all()`` every ``min(decode_chunk,
  16)`` steps and stops once every row has hit EOS.
* **int8 KV cache** (``kv_quant="int8"``): the cache holds int8 values
  with one f32 scale per (row, kv head, position)
  (``models/transformer.py::init_kv_cache_int8``), 1 + 4/head_dim bytes
  an element against bf16's 2.
* **Sampling** goes through ``ops.sampling.sample_with_logprob``: one launch
  of the fused Hopper sampler per decode step on the GPU. Per-step, per-row
  int32 seeds are drawn on the engine's device from a per-wave generator
  derived from the caller's seed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.transformer import (
    Decoder, init_kv_cache, init_kv_cache_int8,
)
from distrl_llm_tpu_torch.ops.sampling import sample_with_logprob
from distrl_llm_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # [B, n, T] int32, pad-filled after EOS
    lengths: np.ndarray  # [B, n] generated token counts (incl. EOS)
    # decode steps dispatched for this round (one sampler launch each)
    steps_dispatched: int | None = None
    # RAW-model log-probabilities of the sampled tokens [B, n, T] f32
    logprobs: np.ndarray | None = None
    # sum over dispatched steps of the slots alive at that step (refill
    # scheduler only): tokens / alive_slot_steps is the per-slot emission
    # rate with the drain tail's idle slots left out
    alive_slot_steps: int | None = None


@dataclass
class _DecodeState:
    """Decode-loop state; every tensor is updated in place by ``_decode_step``."""

    out: torch.Tensor  # [Bn, T] int32
    logps: torch.Tensor  # [Bn, T] f32 raw-model logprob of each sampled token
    lengths: torch.Tensor  # [Bn] int32
    done: torch.Tensor  # [Bn] bool
    key_mask: torch.Tensor  # [Bn, Smax] int32
    logits: torch.Tensor  # [Bn, V] f32 logits for the next token
    cache: Params
    step: int = 0


def _prefill(model: Decoder, lora, prompt_ids, prompt_mask, *,
             max_total: int, lora_scale: float, cache_dtype, attn_impl: str,
             kv_quant: str = "none"):
    b, p = prompt_ids.shape
    if kv_quant == "int8":
        cache = init_kv_cache_int8(model.cfg, b, max_total, device=prompt_ids.device)
    else:
        cache = init_kv_cache(model.cfg, b, max_total, dtype=cache_dtype,
                              device=prompt_ids.device)
    key_mask = torch.nn.functional.pad(prompt_mask, (0, max_total - p))
    last_logits, cache = model(
        prompt_ids, attention_mask=key_mask, lora=lora, lora_scale=lora_scale,
        kv_cache=cache, cache_offset=0, attn_impl=attn_impl,
        logits_slice=(p - 1, 1),
    )
    return cache, key_mask, last_logits[:, 0]


def _decode_init(cache, key_mask, first_logits, row_alive, *, n: int,
                 max_steps: int, pad_id: int) -> _DecodeState:
    """Expand prefill state to candidate rows: row b*n + j is candidate j of
    prompt b (the one cache-sized copy of the round)."""
    rep = lambda t: t.repeat_interleave(n, dim=0)  # noqa: E731
    cache = {key: [rep(c) for c in layers] for key, layers in cache.items()}
    logits = rep(first_logits)
    bn, dev = logits.shape[0], logits.device
    return _DecodeState(
        out=torch.full((bn, max_steps), pad_id, dtype=torch.int32, device=dev),
        logps=torch.zeros((bn, max_steps), dtype=torch.float32, device=dev),
        lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
        # rows with an empty prompt are batch padding — born done, so they
        # never gate the early exit; their (garbage) logits still go through
        # the sampler, which returns an in-range index for any row
        done=rep(~row_alive),
        key_mask=rep(key_mask),
        logits=logits,
        cache=cache,
    )


def _decode_step(model: Decoder, lora, s: _DecodeState, seeds: torch.Tensor, *,
                 prompt_len: int, eos_ids: torch.Tensor, pad_id: int,
                 temperature: float, top_p: float, lora_scale: float,
                 attn_impl: str, top_p_impl: str, capture_logprobs: bool,
                 last: bool) -> None:
    """One decode step, in place: sample from the carried logits, record the
    token, then forward it (skipped on the round's last step, whose logits
    nothing reads)."""
    tok, logp = sample_with_logprob(
        s.logits, temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs,
    )
    alive = ~s.done
    tok = torch.where(s.done, pad_id, tok)
    s.out[:, s.step] = tok
    if capture_logprobs:
        s.logps[:, s.step] = torch.where(s.done, 0.0, logp)
    s.lengths += alive.to(torch.int32)
    # the sampled token occupies position prompt_len + step for rows that
    # were still alive; they attend to it on the next forward
    s.key_mask[:, prompt_len + s.step] = alive.to(s.key_mask.dtype)
    s.done |= torch.isin(tok, eos_ids)
    if not last:
        logits, _ = model(
            tok[:, None], attention_mask=s.key_mask, lora=lora,
            lora_scale=lora_scale, kv_cache=s.cache,
            cache_offset=prompt_len + s.step, attn_impl=attn_impl,
        )
        s.logits = logits[:, 0]
    s.step += 1


def _wave_seed(seed: int, wave: int) -> int:
    """Per-wave generator seed (the JAX engine's ``fold_in(rng, w)``)."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, wave]).generate_state(1)[0])


def generate_in_waves(inner_generate, max_rows: int, model, lora, prompt_ids,
                      prompt_mask, sampling: SamplingConfig, seed: int,
                      pad_id: int) -> GenerationResult:
    """Cap concurrent candidate rows at ``max_rows`` by running the round in
    sequential WAVES of whole prompt groups (vLLM's ``max_num_seqs``); the
    tail wave pads with dead rows so every wave has one shape."""
    b = prompt_ids.shape[0]
    n = max(sampling.n, 1)
    if not max_rows or b * n <= max_rows:
        return inner_generate(model, lora, prompt_ids, prompt_mask, sampling,
                              _wave_seed(seed, 0))
    per_wave = max(max_rows // n, 1)
    tokens, lengths, logps = [], [], []
    steps = 0
    for w in range(-(-b // per_wave)):
        lo = w * per_wave
        ids = np.asarray(prompt_ids[lo:lo + per_wave])
        mask = np.asarray(prompt_mask[lo:lo + per_wave])
        pad = per_wave - ids.shape[0]
        if pad:  # tail wave: dead rows keep the wave shape
            ids = np.concatenate(
                [ids, np.full((pad, ids.shape[1]), pad_id, np.int32)])
            mask = np.concatenate(
                [mask, np.zeros((pad, mask.shape[1]), np.int32)])
        res = inner_generate(model, lora, ids, mask, sampling, _wave_seed(seed, w))
        keep = per_wave - pad
        tokens.append(res.tokens[:keep])
        lengths.append(res.lengths[:keep])
        if res.logprobs is not None:
            logps.append(res.logprobs[:keep])
        steps += res.steps_dispatched
    return GenerationResult(
        tokens=np.concatenate(tokens, axis=0),
        lengths=np.concatenate(lengths, axis=0),
        steps_dispatched=steps,
        logprobs=np.concatenate(logps, axis=0) if logps else None,
    )


def run_decode_loop(step_fn, state: _DecodeState, max_steps: int,
                    decode_chunk: int) -> _DecodeState:
    """Call ``step_fn(state, last)`` up to ``max_steps`` times; every
    ``min(decode_chunk, 16)`` steps read ``done.all()`` (one host sync) and
    stop once every row is done."""
    check = max(1, min(decode_chunk, 16))
    for i in range(max_steps):
        step_fn(state, i == max_steps - 1)
        if (i + 1) % check == 0 and bool(state.done.all()):
            break
    return state


def accumulate_round_stats(stats: dict | None, *, prefill_s: float,
                           prefill_tokens: int, prompt_rows: int,
                           decode_s: float, gen_tokens: int,
                           gen_rows: int) -> dict:
    """Fold one wave's timing/token counts into the round's running stats
    (the ``last_round_stats`` contract)."""
    if stats is None:
        stats = {"prefill_s": 0.0, "prefill_tokens": 0, "prompt_rows": 0,
                 "decode_s": 0.0, "gen_tokens": 0, "gen_rows": 0}
    stats["prefill_s"] += prefill_s
    stats["prefill_tokens"] += prefill_tokens
    stats["prompt_rows"] += prompt_rows
    stats["decode_s"] += decode_s
    stats["gen_tokens"] += gen_tokens
    stats["gen_rows"] += gen_rows
    return stats


class LoraMailbox:
    """In-flight weight-update mailbox (PipelineRL): ``push_lora`` from the
    learner thread; the decode loop consumes it before the next step.
    ``_swapped_lora`` carries a consumed swap across the waves of a round;
    ``_reset_lora_mailbox_round`` runs at round entry."""

    def __init__(self):
        # single-slot pending mailbox: (adapter, version) written and
        # consumed as ONE reference under the lock
        self._pending: tuple | None = None
        self._pending_mu = threading.Lock()
        self._swapped_lora = None
        self.last_swap_steps: list[int] = []
        self.last_swap_versions: list[int | None] = []
        # the adapter the latest consumed swap superseded (the policy's
        # previous version) and its version: the speculative self-drafter's
        # draft model. Kept only when ``_track_prev_lora`` is set (an engine
        # running that drafter), since it holds a second adapter resident
        self._track_prev_lora = False
        self._prev_lora = None
        self._prev_lora_version: int | None = None

    def push_lora(self, lora, version: int | None = None) -> None:
        """The next dispatched decode step onwards samples under this
        adapter. KV already resident stays as the old adapter computed it;
        the swap log records (step, version)."""
        with self._pending_mu:
            self._pending = (lora, version)

    def _take_pending_lora(self, lora_cell: list, dispatched: int) -> None:
        with self._pending_mu:
            pending, self._pending = self._pending, None
        if pending is not None:
            lora, version = pending
            if self._track_prev_lora:
                self._prev_lora = lora_cell[0]
                self._prev_lora_version = (self.last_swap_versions[-1]
                                           if self.last_swap_versions else None)
            self._swapped_lora = lora
            lora_cell[0] = lora
            self.last_swap_steps.append(dispatched)
            self.last_swap_versions.append(version)

    def _round_entry_lora(self, lora):
        """Adapter a wave opens with: the in-round swap if one happened."""
        return self._swapped_lora if self._swapped_lora is not None else lora

    def _reset_lora_mailbox_round(self) -> None:
        self._swapped_lora = None


class GenerationEngine(LoraMailbox):
    """Rollout engine bound to (model config, shapes, eos/pad ids, device).

    ``generate`` is the ``vllm_generate`` equivalent: left-padded prompts in,
    per-candidate token arrays + lengths (+ behavior logprobs) out."""

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
        decode_chunk: int = 128,
        prompt_buckets: Sequence[int] | None = None,
        max_concurrent_rows: int = 0,  # 0 = unlimited (vLLM max_num_seqs)
        capture_logprobs: bool = False,
        kv_quant: str | None = None,  # None/"none" | "int8"
        device: str | torch.device | None = None,  # None = the GPU
    ):
        super().__init__()
        kv_quant = "none" if kv_quant is None else kv_quant
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be none/int8, got {kv_quant!r}")
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_prompt_tokens = max_prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.max_total = max_prompt_tokens + max_new_tokens
        cfg.check_within_window(self.max_total)
        self.eos_ids = torch.tensor(list(eos_token_ids), dtype=torch.int32,
                                    device=self.device)
        self.pad_id = int(pad_token_id)
        self.lora_scale = lora_scale
        self.cache_dtype = cache_dtype
        self.attn_impl = attn_impl
        self.decode_chunk = decode_chunk
        self.max_concurrent_rows = max_concurrent_rows
        self.capture_logprobs = capture_logprobs
        buckets = sorted(set(prompt_buckets or [])) or [max_prompt_tokens]
        if any(bb <= 0 or bb > max_prompt_tokens for bb in buckets):
            raise ValueError(f"buckets must be in (0, {max_prompt_tokens}]: {buckets}")
        if buckets[-1] != max_prompt_tokens:
            buckets.append(max_prompt_tokens)
        self.prompt_buckets = buckets
        self.last_round_stats: dict | None = None

    def bucket_for(self, prompt_mask) -> int:
        """The smallest bucket holding the longest real prompt."""
        if len(self.prompt_buckets) == 1:
            return self.prompt_buckets[0]
        longest = int(np.asarray(prompt_mask).sum(axis=-1).max())
        return next(bb for bb in self.prompt_buckets if bb >= max(longest, 1))

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
        lora = self._round_entry_lora(lora)
        # prompts are left-padded, so a bucket keeps the trailing columns
        bucket = self.bucket_for(prompt_mask)
        ids = torch.as_tensor(np.asarray(prompt_ids)[:, p - bucket:],
                              dtype=torch.int32).to(self.device)
        mask = torch.as_tensor(np.asarray(prompt_mask)[:, p - bucket:],
                               dtype=torch.int32).to(self.device)
        prefill_tokens = int(np.asarray(prompt_mask).sum())

        t0 = time.perf_counter()
        cache, key_mask, last_logits = _prefill(
            model, lora, ids, mask, max_total=bucket + self.max_new_tokens,
            lora_scale=self.lora_scale, cache_dtype=self.cache_dtype,
            attn_impl=self.attn_impl, kv_quant=self.kv_quant,
        )
        self._sync()  # an honest prefill/decode timing split
        t_prefill = time.perf_counter() - t0

        state = _decode_init(cache, key_mask, last_logits, mask.sum(dim=-1) > 0,
                             n=sampling.n, max_steps=max_steps, pad_id=self.pad_id)
        del cache
        top_p_impl = sampling.resolved_top_p_impl()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bn = state.out.shape[0]
        lora_cell = [lora]
        t1 = time.perf_counter()

        def step(s: _DecodeState, last: bool) -> None:
            # in-flight weight update: swap BEFORE sampling, so the recorded
            # swap step is the first position decoded under the new adapter
            self._take_pending_lora(lora_cell, s.step)
            seeds = torch.randint(-2**31, 2**31, (bn,), generator=gen,
                                  dtype=torch.int32, device=self.device)
            _decode_step(
                model, lora_cell[0], s, seeds, prompt_len=bucket,
                eos_ids=self.eos_ids, pad_id=self.pad_id,
                temperature=sampling.temperature, top_p=sampling.top_p,
                lora_scale=self.lora_scale, attn_impl=self.attn_impl,
                top_p_impl=top_p_impl, capture_logprobs=self.capture_logprobs,
                last=last,
            )

        state = run_decode_loop(step, state, max_steps, self.decode_chunk)
        out = state.out.cpu().numpy().reshape(b, sampling.n, max_steps)
        lengths = state.lengths.cpu().numpy().reshape(b, sampling.n)
        logps = (state.logps.cpu().numpy().reshape(b, sampling.n, max_steps)
                 if self.capture_logprobs else None)
        self.last_round_stats = accumulate_round_stats(
            self.last_round_stats, prefill_s=t_prefill,
            prefill_tokens=prefill_tokens, prompt_rows=b,
            decode_s=time.perf_counter() - t1, gen_tokens=int(lengths.sum()),
            gen_rows=b * sampling.n,
        )
        return GenerationResult(tokens=out, lengths=lengths,
                                steps_dispatched=state.step, logprobs=logps)
