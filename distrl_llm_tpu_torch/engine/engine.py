"""The dense rollout engine: shared prefill + host-driven decode loop.

Counterpart of the JAX package's ``engine/engine.py`` (its autotune
machinery and its chunked programs' compile guard have no counterpart here).

* **Prefill once per prompt, decode n candidates.** Prompts are left-padded
  to a fixed length and prefilled at batch B; the KV cache is then repeated
  to B·n rows (row ``b*n + j`` is candidate j of prompt b).
* **In-place decode.** Each step samples from the carried logits, writes the
  token, and runs one forward that writes its K/V into the cache IN PLACE
  (slice assignment in ``models/transformer.py``); nothing cache-sized is
  ever copied after the candidate fan-out.
* **Early exit.** The host reads ``done.all()`` every ``min(decode_chunk,
  16)`` steps and stops once every row has hit EOS.
* **Scan chunks** (``scan_chunk`` = k > 1): the decode steps run k at a
  time, each chunk captured once as a CUDA graph and replayed
  (``engine/decode_graph.py``; on the CPU the same chunk runs eagerly), over
  a decode state the engine keeps at fixed addresses across waves and
  rounds. The scaffold is the JAX package's: ``pick_chunk`` sizes the
  chunk, ``max_steps // k`` chunks run with one asynchronous ``done``
  snapshot each (the one before it is read), in-flight adapter swaps land
  at chunk boundaries (``make_swap_aware_chunk_step``), and
  ``run_nondivisor_tail`` finishes the rest step by step. A chunk's k
  seed vectors are drawn before it, with the per-step loop's k calls.
* **int8 KV cache** (``kv_quant="int8"``): the cache holds int8 values
  with one f32 scale per (row, kv head, position)
  (``models/transformer.py::init_kv_cache_int8``), 1 + 4/head_dim bytes
  an element against bf16's 2.
* **Sampling** goes through ``ops.sampling.sample_with_logprob``: one launch
  of the fused Hopper sampler per decode step on the GPU. Per-step, per-row
  int32 seeds are drawn on the engine's device from a per-wave generator
  derived from the caller's seed.

The decode step keeps its step index on the device (``_DecodeState.step``)
and writes by index tensor, so the same step runs eagerly and in a graph.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.decode_graph import DecodeGraphs, tensors_key
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
    """Decode-loop state; every tensor is updated in place by ``_decode_step``
    and keeps its address (what a captured chunk reads it by)."""

    out: torch.Tensor  # [Bn, T] int32
    logps: torch.Tensor  # [Bn, T] f32 raw-model logprob of each sampled token
    lengths: torch.Tensor  # [Bn] int32
    done: torch.Tensor  # [Bn] bool
    key_mask: torch.Tensor  # [Bn, Smax] int32
    logits: torch.Tensor  # [Bn, V] f32 logits for the next token
    cache: Params
    step: torch.Tensor  # [1] int64: the next step's index, on the device
    seeds: torch.Tensor | None = None  # [scan_chunk, Bn] int32: a chunk's seeds


def _repeat_rows(src: torch.Tensor, n: int, dst: torch.Tensor | None) -> torch.Tensor:
    """``src`` with each row repeated ``n`` times (row b*n + j is row b),
    written into ``dst`` in place when given."""
    if dst is None:
        return src.repeat_interleave(n, dim=0)
    rows = (src.shape[0], n, *src.shape[1:])
    dst.view(rows).copy_(src.unsqueeze(1).expand(rows))
    return dst


def is_eos(tok: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    """``tok`` in the EOS set, elementwise, by comparing every token with
    every EOS id: what ``torch.isin`` computes, but capturable by a CUDA
    graph at any EOS set's size (past a few dozen ids ``torch.isin`` sorts,
    and its unique step waits on the host, which a capture refuses)."""
    return (tok.unsqueeze(-1) == eos_ids).any(dim=-1)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that owns its memory: the chunked engines' state
    is reused by the next round, and a CPU tensor's ``.numpy()`` would
    share it."""
    return t.to("cpu", copy=True).numpy()


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
                 max_steps: int, pad_id: int, into: _DecodeState | None = None
                 ) -> _DecodeState:
    """Expand prefill state to candidate rows: row b*n + j is candidate j of
    prompt b (the one cache-sized copy of the round). With ``into`` (a
    state of the right shapes, its buffers at least ``max_steps`` wide) the
    expansion is written into its tensors in place and it is returned."""
    if into is None:
        bn, dev = first_logits.shape[0] * n, first_logits.device
        s = _DecodeState(
            out=torch.full((bn, max_steps), pad_id, dtype=torch.int32, device=dev),
            logps=torch.zeros((bn, max_steps), dtype=torch.float32, device=dev),
            lengths=torch.zeros((bn,), dtype=torch.int32, device=dev),
            done=None, key_mask=None, logits=None,
            cache={key: [None] * len(layers) for key, layers in cache.items()},
            step=torch.zeros((1,), dtype=torch.int64, device=dev),
        )
    else:
        s = into
        s.out.fill_(pad_id)
        s.logps.zero_()
        s.lengths.zero_()
        s.step.zero_()
    for key, layers in cache.items():
        for i, c in enumerate(layers):
            s.cache[key][i] = _repeat_rows(c, n, s.cache[key][i])
    s.logits = _repeat_rows(first_logits, n, s.logits)
    # rows with an empty prompt are batch padding — born done, so they never
    # gate the early exit; their (garbage) logits still go through the
    # sampler, which returns an in-range index for any row
    s.done = _repeat_rows(~row_alive, n, s.done)
    s.key_mask = _repeat_rows(key_mask, n, s.key_mask)
    return s


def _decode_buffers(cfg: ModelConfig, bn: int, *, max_total: int, max_steps: int,
                    scan_chunk: int, cache_dtype, kv_quant: str,
                    device) -> _DecodeState:
    """Zeroed decode state for ``bn`` rows: what ``_decode_init(into=...)``
    fills, allocated once and kept at its addresses for captured chunks."""
    cache = (init_kv_cache_int8(cfg, bn, max_total, device=device) if kv_quant == "int8"
             else init_kv_cache(cfg, bn, max_total, dtype=cache_dtype, device=device))
    return _DecodeState(
        out=torch.zeros((bn, max_steps), dtype=torch.int32, device=device),
        logps=torch.zeros((bn, max_steps), dtype=torch.float32, device=device),
        lengths=torch.zeros((bn,), dtype=torch.int32, device=device),
        done=torch.zeros((bn,), dtype=torch.bool, device=device),
        key_mask=torch.zeros((bn, max_total), dtype=torch.int32, device=device),
        logits=torch.zeros((bn, cfg.vocab_size), dtype=torch.float32, device=device),
        cache=cache,
        step=torch.zeros((1,), dtype=torch.int64, device=device),
        seeds=torch.zeros((scan_chunk, bn), dtype=torch.int32, device=device),
    )


def _decode_step(model: Decoder, lora, s: _DecodeState, seeds: torch.Tensor, *,
                 prompt_len: int, eos_ids: torch.Tensor, pad_id: int,
                 temperature: float, top_p: float, lora_scale: float,
                 attn_impl: str, top_p_impl: str, capture_logprobs: bool,
                 last: bool) -> None:
    """One decode step, in place: sample from the carried logits, record the
    token, then forward it (skipped on the round's last step, whose logits
    nothing reads). The step index is ``s.step`` on the device: nothing is
    read back to the host, so the step runs inside a captured graph too."""
    tok, logp = sample_with_logprob(
        s.logits, temperature, top_p, seeds, top_p_impl=top_p_impl,
        capture_logprob=capture_logprobs,
    )
    alive = ~s.done
    tok = torch.where(s.done, pad_id, tok)
    s.out.index_copy_(1, s.step, tok[:, None])
    if capture_logprobs:
        s.logps.index_copy_(1, s.step, torch.where(s.done, 0.0, logp)[:, None])
    s.lengths += alive.to(torch.int32)
    # the sampled token occupies position prompt_len + step for rows that
    # were still alive; they attend to it on the next forward
    position = s.step + prompt_len
    s.key_mask.index_copy_(1, position, alive.to(s.key_mask.dtype)[:, None])
    s.done |= is_eos(tok, eos_ids)
    if not last:
        logits, _ = model(
            tok[:, None], attention_mask=s.key_mask, lora=lora,
            lora_scale=lora_scale, kv_cache=s.cache,
            cache_offset=position, attn_impl=attn_impl,
        )
        s.logits.copy_(logits[:, 0])
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


# ------------------------------------------------------------ scan chunks
# The JAX package's chunked-dispatch scaffold (engine/engine.py:474-560),
# shared by the dense engine and the paged engine's wave scheduler. The
# chunk body is unguarded: done rows are per-row no-ops, and the host never
# dispatches a chunk that crosses ``max_steps``.


def pick_chunk(scan_chunk: int, max_steps: int) -> int:
    """Steps per chunk for a wave of ``max_steps``: the largest divisor of
    ``max_steps`` that is <= ``scan_chunk``, unless it would lose more than
    half the requested amortization (a prime ``max_steps``); then
    ``min(scan_chunk, max_steps)``, and ``run_nondivisor_tail`` runs the
    rest."""
    k = max(1, min(scan_chunk, max_steps))
    best = max((d for d in range(1, k + 1) if max_steps % d == 0), default=1)
    return best if best * 2 > k else k


def make_swap_aware_chunk_step(mailbox, lora_cell: list, steps_seen: list, k: int,
                               run_chunk: Callable[[Any, Any], None]):
    """The chunk dispatch: consume an in-flight adapter swap at the chunk
    boundary (the recorded swap step is the first position decoded under the
    new adapter), count the chunk's ``k`` steps, then ``run_chunk(lora,
    state)``. A swap to an adapter at other addresses makes the chunk runner
    warm and capture that adapter's chunk anew (the JAX package's
    ``rebuild``); the port has no per-step fallback to switch to."""
    def step(s):
        mailbox._take_pending_lora(lora_cell, steps_seen[0])
        steps_seen[0] += k
        run_chunk(lora_cell[0], s)

    return step


def run_nondivisor_tail(mailbox, lora_cell: list, steps_seen: list, rem: int, state,
                        run_step: Callable[[Any, Any], None]):
    """Finish a chunked wave's ``rem`` remaining steps one at a time (none
    once every row is done: one ``done`` read at the tail's entry),
    consuming pending adapters before each step as the per-step loop does."""
    if not rem or bool(state.done.all()):
        return state
    for _ in range(rem):
        mailbox._take_pending_lora(lora_cell, steps_seen[0])
        steps_seen[0] += 1
        run_step(lora_cell[0], state)
    return state


class _Snapshot:
    """A copy of a small device tensor taken now and read later: on the GPU
    an asynchronous copy into pinned memory behind an event, so taking it
    does not wait for the device."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t.clone(), None

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def run_chunk_loop(chunk_step, state, chunks: int):
    """Dispatch up to ``chunks`` chunks; after each, snapshot ``done``
    asynchronously and read the snapshot before it (the JAX package's
    ``run_decode_loop`` at check 1): the read waits on a chunk that finished
    while this one was queued, never on the chunk just dispatched. Stops
    once a snapshot shows every row done, one chunk late."""
    snapshots: deque = deque()
    for _ in range(chunks):
        chunk_step(state)
        snapshots.append(_Snapshot(state.done))
        if len(snapshots) > 1 and snapshots.popleft().read().all():
            break
    return state


def run_decode(engine, state, step_fn: Callable[[Any, torch.Tensor, bool], None], *,
               lora_cell: list, gen: torch.Generator, max_steps: int, chunked: bool,
               key: tuple | None) -> tuple[int, int, int]:
    """A wave's decode loop over ``state`` (which has ``done``, ``out`` and,
    chunked, ``seeds``); ``step_fn(lora, seeds, last)`` runs one decode step
    in place. Returns (steps dispatched, decode forwards run, steps run by
    graph replays).

    Step by step (``chunked`` False): ``run_decode_loop``, an adapter swap
    consumed before each step, one seed vector drawn per step. Chunked: k =
    ``pick_chunk(engine.scan_chunk, max_steps)``; ``max_steps // k`` chunks
    of k whole steps (each forwards its token) through
    ``engine.decode_graphs`` under ``key`` + (k, the adapter's tensors),
    the k seed vectors drawn into ``state.seeds`` before each chunk by the
    step-by-step loop's k calls; then ``run_nondivisor_tail``. The host
    checks at each chunk that it ends within the state's ``out`` columns."""
    bn, dev = state.done.shape[0], state.done.device
    steps_seen, forwards = [0], [0]

    def draw(out=None):
        return torch.randint(-2**31, 2**31, (bn,), generator=gen, dtype=torch.int32,
                             device=dev, out=out)

    def one_step(lora, s, last):
        step_fn(lora, draw(), last)
        forwards[0] += not last

    if not chunked:
        def step(s, last):
            # in-flight weight update: swap BEFORE sampling, so the recorded
            # swap step is the first position decoded under the new adapter
            engine._take_pending_lora(lora_cell, steps_seen[0])
            steps_seen[0] += 1
            one_step(lora_cell[0], s, last)

        run_decode_loop(step, state, max_steps, engine.decode_chunk)
        return steps_seen[0], forwards[0], 0

    k = pick_chunk(engine.scan_chunk, max_steps)
    graphs = engine.decode_graphs
    replays = graphs.replays

    def run_chunk(lora, s):
        if steps_seen[0] > s.out.shape[1]:
            raise ValueError(f"decode overflow: a chunk would end at step {steps_seen[0]}, "
                             f"past the {s.out.shape[1]} steps the decode state holds")
        for i in range(k):
            draw(s.seeds[i])

        def body():
            for i in range(k):
                step_fn(lora, s.seeds[i], False)

        graphs.run(key + (k, tensors_key(lora)), body, dev)
        forwards[0] += k

    full, rem = divmod(max_steps, k)
    run_chunk_loop(make_swap_aware_chunk_step(engine, lora_cell, steps_seen, k, run_chunk),
                   state, full)
    run_nondivisor_tail(engine, lora_cell, steps_seen, rem, state,
                        lambda lora, s: one_step(lora, s, steps_seen[0] == max_steps))
    return steps_seen[0], forwards[0], (graphs.replays - replays) * k


def add_decode_counts(stats: dict, *, forwards: int, graph_steps: int) -> dict:
    """Fold one wave's decode forwards and graph-replayed steps into the
    round's stats (``decode_forwards``, ``graph_steps``)."""
    stats["decode_forwards"] = stats.get("decode_forwards", 0) + forwards
    stats["graph_steps"] = stats.get("graph_steps", 0) + graph_steps
    return stats


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
    ``_reset_lora_mailbox_round`` runs at round entry.

    ``lora_swap_hook(dropped, taken)``, when set, runs on the decoding
    thread as a swap is consumed, under the mailbox's lock (so a
    ``push_lora`` never lands between the take and the hook): ``taken`` is
    read from the next step on, ``dropped`` (the superseded adapter, or with
    ``_track_prev_lora`` the previous one that falls out; None if none) is
    read no more. The trainer's adapter ring (``rollout/adapter_ring.py``)
    orders its copies against the decoding stream there."""

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
        self.lora_swap_hook = None

    def push_lora(self, lora, version: int | None = None) -> None:
        """The next dispatched decode step onwards samples under this
        adapter. KV already resident stays as the old adapter computed it;
        the swap log records (step, version)."""
        with self._pending_mu:
            self._pending = (lora, version)

    def discard_pending_at_or_below(self, version: int) -> None:
        """Drop a pending swap whose version the adapter a round opens with
        already covers (a remote worker's weight bus pushes every update into
        the mailbox, so the entry version would replay as a step-0 swap).
        Atomic with ``push_lora``: a strictly newer push survives."""
        with self._pending_mu:
            pending = self._pending
            if pending is not None and pending[1] is not None and int(pending[1]) <= int(version):
                self._pending = None

    def _take_pending_lora(self, lora_cell: list, dispatched: int) -> None:
        with self._pending_mu:
            pending, self._pending = self._pending, None
            if pending is not None and self.lora_swap_hook is not None:
                self.lora_swap_hook(
                    self._prev_lora if self._track_prev_lora else lora_cell[0], pending[0])
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


class ScanChunks:
    """What the dense engine and the paged engine's wave and refill
    schedulers share for scan chunks: ``scan_chunk``, the chunk runner
    ``decode_graphs`` and the static decode state its graphs read
    (``_chunk_state``: (shape key, state), one at a time)."""

    def _init_scan_chunks(self, scan_chunk: int | None) -> None:
        if scan_chunk is not None and scan_chunk < 0:
            raise ValueError(f"scan_chunk must be >= 0, got {scan_chunk}")
        self.scan_chunk = scan_chunk or 0
        self.decode_graphs = DecodeGraphs()
        self._chunk_state: tuple | None = None

    @property
    def scan_chunk_active(self) -> bool | None:
        """Whether chunked decode ran as scan chunks: None with
        ``scan_chunk`` <= 1 or before any chunk; on the GPU True once a
        captured chunk was replayed (False while every chunk ran eagerly:
        each key's first); on the CPU, where nothing is graphed, True once a
        chunk ran."""
        g = self.decode_graphs
        if self.scan_chunk <= 1 or not (g.replays or g.eager_chunks):
            return None
        return g.replays > 0 if self.device.type == "cuda" else True

    def release_decode_graphs(self) -> None:
        """Free the captured chunks and the decode state they read (the
        next chunked round allocates and captures them again)."""
        self.decode_graphs.clear()
        self._chunk_state = None


class GenerationEngine(LoraMailbox, ScanChunks):
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
        # decode steps per chunk, each chunk a CUDA graph replay on the GPU;
        # None, 0 and 1 run one step at a time
        scan_chunk: int | None = None,
        prompt_buckets: Sequence[int] | None = None,
        max_concurrent_rows: int = 0,  # 0 = unlimited (vLLM max_num_seqs)
        capture_logprobs: bool = False,
        kv_quant: str | None = None,  # None/"none" | "int8"
        device: str | torch.device | None = None,  # None = the GPU
    ):
        super().__init__()
        self._init_scan_chunks(scan_chunk)
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

    def _static_state(self, bucket: int, bn: int) -> _DecodeState:
        """The decode state captured chunks read, for ``bn`` rows at
        ``bucket``: kept across waves and rounds of that shape; another
        shape frees it, and the graphs over it, first."""
        key = (bucket, bn)
        if self._chunk_state is None or self._chunk_state[0] != key:
            self.release_decode_graphs()
            self._chunk_state = (key, _decode_buffers(
                self.cfg, bn, max_total=bucket + self.max_new_tokens,
                max_steps=self.max_new_tokens, scan_chunk=self.scan_chunk,
                cache_dtype=self.cache_dtype, kv_quant=self.kv_quant, device=self.device))
        return self._chunk_state[1]

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
        """Wait for the round's own work: the calling thread's stream, never
        the whole device (the trainer's learner may be running on another
        stream)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _generate_wave(self, model, lora, prompt_ids, prompt_mask,
                       sampling: SamplingConfig, seed: int) -> GenerationResult:
        b, p = prompt_ids.shape
        if p != self.max_prompt_tokens:
            raise ValueError(
                f"prompts must be padded to {self.max_prompt_tokens}, got {p}")
        max_steps = min(sampling.max_tokens, self.max_new_tokens)
        n = sampling.n
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

        chunked = self.scan_chunk > 1 and max_steps > 1
        state = _decode_init(cache, key_mask, last_logits, mask.sum(dim=-1) > 0,
                             n=n, max_steps=max_steps, pad_id=self.pad_id,
                             into=self._static_state(bucket, b * n) if chunked else None)
        del cache
        top_p_impl = sampling.resolved_top_p_impl()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        lora_cell = [lora]
        t1 = time.perf_counter()
        step_kw = dict(prompt_len=bucket, eos_ids=self.eos_ids, pad_id=self.pad_id,
                       temperature=sampling.temperature, top_p=sampling.top_p,
                       lora_scale=self.lora_scale, attn_impl=self.attn_impl,
                       top_p_impl=top_p_impl, capture_logprobs=self.capture_logprobs)

        def step_fn(lo, seeds, last):
            _decode_step(model, lo, state, seeds, last=last, **step_kw)

        key = (("dense", bucket, b * n, top_p_impl, sampling.temperature, sampling.top_p,
                tensors_key(model)) if chunked else None)
        steps, forwards, graph_steps = run_decode(
            self, state, step_fn, lora_cell=lora_cell, gen=gen, max_steps=max_steps,
            chunked=chunked, key=key)
        out = _host(state.out[:, :max_steps]).reshape(b, n, max_steps)
        lengths = _host(state.lengths).reshape(b, n)
        logps = (_host(state.logps[:, :max_steps]).reshape(b, n, max_steps)
                 if self.capture_logprobs else None)
        stats = accumulate_round_stats(
            self.last_round_stats, prefill_s=t_prefill,
            prefill_tokens=prefill_tokens, prompt_rows=b,
            decode_s=time.perf_counter() - t1, gen_tokens=int(lengths.sum()),
            gen_rows=b * n,
        )
        add_decode_counts(stats, forwards=forwards, graph_steps=graph_steps)
        self.last_round_stats = stats
        return GenerationResult(tokens=out, lengths=lengths,
                                steps_dispatched=steps, logprobs=logps)
