"""Speculative decoding for the paged refill engine: prompt-lookup drafts.

Counterpart of the JAX package's ``engine/speculative.py``. Math-RL rollouts
repeat prompt material (numbers, expressions, format tags), so an n-gram
lookup over the row's own sequence proposes the next ``d`` tokens for free
(prompt-lookup decoding): find the latest earlier occurrence of the last
``k`` tokens and draft whatever followed it. The model verifies the whole
block ``[last_tok, draft]`` in one forward (the projections batch over
``[R, d+1]`` positions, attention runs kernel K5 once per layer), and a
rejection-sampling acceptance keeps the output distribution identical to
plain sampling (exact equality under greedy):

* a point-mass draft t_i is accepted with probability p_i(t_i) under the
  model's post-temperature/top-p distribution;
* the first rejected position resamples from norm(p_i − onehot(t_i));
* if the whole draft survives, one bonus token samples from the final
  distribution, so a step emits between 1 and d+1 tokens.

Randomness comes in as tensors, not keys: uniforms ``u [R, d]`` for the
acceptance tests and Gumbel noise ``g [R, V]`` for the one categorical draw,
``argmax(log p + g)`` (how ``jax.random.categorical`` draws). The JAX
package draws them from ``fold_in(rng, 0)`` and ``fold_in(rng, 1)``; the
tests hand both packages the same draws, the engine draws them from its
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from distrl_llm_tpu_torch.ops.sampling import TOP_P_IMPLS


def sampling_probs(logits: torch.Tensor, temperature: float, top_p: float,
                   top_p_impl: str = "bisect") -> torch.Tensor:
    """The categorical distribution the sampler draws from, as explicit
    probabilities [..., V] f32 (greedy → one-hot argmax). The acceptance
    test must use this distribution, not the raw softmax, or speculative
    sampling would change what plain decoding samples."""
    if temperature == 0.0:
        idx = logits.argmax(dim=-1)
        return torch.nn.functional.one_hot(idx, logits.shape[-1]).float()
    if top_p_impl not in TOP_P_IMPLS:
        raise ValueError(f"unknown top_p_impl {top_p_impl!r}")
    lg = logits.float()
    scaled = lg / torch.full_like(lg[..., :1], max(temperature, 1e-6))
    shape = scaled.shape
    filtered = TOP_P_IMPLS[top_p_impl](scaled.reshape(-1, shape[-1]), top_p)
    return torch.softmax(filtered.reshape(shape), dim=-1)


def propose_ngram_drafts(seq_buf: torch.Tensor, buf_len: torch.Tensor, *,
                         k: int, d: int) -> torch.Tensor:
    """Prompt-lookup proposal over ``seq_buf`` [R, W] (each row's tokens so
    far, ``buf_len`` [R] of them valid): the latest j < buf_len − k with
    ``seq_buf[j:j+k]`` equal to the last k tokens; the draft is the d tokens
    that followed it. Rows with no match draft their last token repeated.
    Returns [R, d] int32."""
    r, w = seq_buf.shape
    dev = seq_buf.device
    lens = buf_len.long()
    tail_idx = (lens[:, None] - k + torch.arange(k, device=dev)[None, :]).clamp(0, w - 1)
    tail = torch.gather(seq_buf, 1, tail_idx)  # [R, k]
    n_win = w - k + 1
    match = torch.ones((r, n_win), dtype=torch.bool, device=dev)
    for i in range(k):
        match &= seq_buf[:, i:i + n_win] == tail[:, i:i + 1]
    j = torch.arange(n_win, device=dev)[None, :]
    match &= j < (lens - k)[:, None]  # strictly before the tail
    found = match.any(dim=1)
    # the latest match: the first True of the reversed row
    last_j = (n_win - 1) - match.flip(1).to(torch.int8).argmax(dim=1)
    cont_idx = (last_j[:, None] + k + torch.arange(d, device=dev)[None, :]).clamp(0, w - 1)
    cont = torch.gather(seq_buf, 1, cont_idx)  # [R, d]
    last_tok = torch.gather(seq_buf, 1, (lens - 1).clamp(0, w - 1)[:, None])
    return torch.where(found[:, None], cont, last_tok.expand_as(cont)).to(torch.int32)


def spec_accept(u: torch.Tensor, g: torch.Tensor, probs: torch.Tensor,
                draft: torch.Tensor, draft_probs: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling over ``probs`` [R, d+1, V] (``probs[:,
    i]`` judges ``draft[:, i]``, ``probs[:, d]`` is the bonus slot) with
    uniforms ``u`` [R, d] and Gumbel noise ``g`` [R, V]. Returns (emit
    [R, d+1], n_emit [R], n_accept [R]) int32: ``emit[:, :n_emit]`` are the
    step's new tokens, the accepted draft prefix and one resampled or bonus
    token; ``n_accept`` in [0, d] is the sampler's accepted prefix before
    any EOS or budget truncation the caller applies.

    Without ``draft_probs`` the proposal is a point mass (the n-gram
    drafter): t_i is accepted when u < p_i(t_i), and the residual zeroes
    the drafted token. With ``draft_probs`` q [R, d, V] this is
    full-distribution speculative sampling: accept when u · q_i(t_i) <
    p_i(t_i) (no division by a zero q), and resample the first rejection
    from norm(max(p − q, 0)), falling back to p where the residual is empty
    (p == q up to rounding). Both leave the output distribution that of
    plain sampling from p."""
    r, dp1, v = probs.shape
    d = dp1 - 1
    dev = probs.device
    draft = draft.long()
    p_draft = torch.gather(probs[:, :d], 2, draft[..., None])[..., 0]
    if draft_probs is None:
        accept = u < p_draft  # [R, d]
    else:
        q_draft = torch.gather(draft_probs, 2, draft[..., None])[..., 0]
        accept = u * q_draft < p_draft
    m = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [R] prefix length

    rows = torch.arange(r, device=dev)
    final_probs = probs[rows, m]  # [R, V] at the first rejected / bonus slot
    rejected = m < d
    at = torch.clamp(m, max=d - 1)
    if draft_probs is None:
        drop = torch.gather(draft, 1, at[:, None])[:, 0]
        onehot_drop = torch.nn.functional.one_hot(drop, v).bool()
        final_probs = torch.where(rejected[:, None] & onehot_drop, 0.0, final_probs)
    else:
        q_at = draft_probs[rows, at]  # [R, V]
        resid = torch.clamp(final_probs - q_at, min=0.0)
        resid_ok = resid.sum(dim=-1, keepdim=True) > 0
        final_probs = torch.where(
            rejected[:, None], torch.where(resid_ok, resid, final_probs), final_probs)
    final_probs = final_probs / torch.clamp(
        final_probs.sum(dim=-1, keepdim=True), min=1e-20)
    final_tok = (g + torch.log(torch.clamp(final_probs, min=1e-30))).argmax(dim=-1)

    pos = torch.arange(dp1, device=dev)[None, :]
    draft_padded = torch.nn.functional.pad(draft, (0, 1))
    emit = torch.where(pos < m[:, None], draft_padded, 0)
    emit = torch.where(pos == m[:, None], final_tok[:, None], emit)
    return emit.to(torch.int32), (m + 1).to(torch.int32), m.to(torch.int32)


def draw_uniforms(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniforms in (0, 1) f32: [0, 1) from the generator with 0 moved to
    the smallest normal float, so ``-log(-log u)`` is finite."""
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_min_(torch.finfo(torch.float32).tiny)


def draw_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise f32, ``-log(-log u)`` of ``draw_uniforms``."""
    return -torch.log(-torch.log(draw_uniforms(shape, generator, device)))


@dataclass
class SpecRefillState:
    """Refill decode state for speculative mode, updated in place. Unlike
    the plain refill state it carries no logits: the carried quantity is
    ``last_tok`` (emitted but not yet resident in the KV cache; the next
    verify forward processes it first), plus each slot's token sequence
    for the n-gram lookup.

    ``out``, ``logps_buf`` and ``lengths_buf`` hold one extra row (index
    ``total``) and ``seq_buf`` one extra slot row (index R): writes of dead
    slots and of positions past a step's emission land there and are never
    read, the counterpart of the JAX package's ``mode="drop"`` scatters.
    Every tensor keeps its address (what a captured chunk reads it by); the
    host counts ``step`` and the forwards, which no step body reads."""

    out: torch.Tensor  # [total + 1, T] int32, pad-filled
    logps_buf: torch.Tensor  # [total + 1, T] f32 behavior logprobs (raw basis)
    lengths_buf: torch.Tensor  # [total + 1] int32 per-candidate generated counts
    cand: torch.Tensor  # [R] int64 candidate per slot (== total: dead slot)
    done: torch.Tensor  # [R] bool
    last_tok: torch.Tensor  # [R] int32 pending token (counted, not resident)
    seq_buf: torch.Tensor  # [R + 1, W] int32 prompt + generated tokens
    seq_lengths: torch.Tensor  # [R] int32 tokens resident in the cache
    gen_lengths: torch.Tensor  # [R] int32 generated tokens incl. last_tok
    page_indices: torch.Tensor  # [R, width] int32
    k_pages: list
    v_pages: list
    # acceptance accounting, carried on the device: emit_hist[n] counts the
    # alive slot-steps that emitted exactly n tokens; draft_total sums
    # alive · d; accept_total sums the sampler's accepted prefix lengths
    emit_hist: torch.Tensor  # [d + 2] int64
    draft_total: torch.Tensor  # [] int64
    accept_total: torch.Tensor  # [] int64
    alive_steps: torch.Tensor  # [] int64 sum over steps of alive slots
    step: int = 0
    forwards: int = 0  # verify forwards run (each launches K5 once per layer)
    draft_forwards: int = 0  # self-drafter decode forwards (K2 once per layer each)
    gen: torch.Generator | None = None  # chunked: the round's generator, reseeded
