"""Policy-gradient and GRPO losses over recomputed answer logprobs.

Counterpart of the JAX package's ``learner/losses.py``:

* **Fixed-shape logprob recompute**: the prompt left-padded, the answer
  right-padded, one forward over the concatenation; token t's logprob comes
  from the logit at position P−1+t.
* **PG loss** ``−(((logp·mask).Σ/mask.Σ)·coeff).mean()`` over real rows,
  coeff = reward − baseline.
* **GRPO loss** with the ratio ``exp(logp − logp.detach())`` (1 at compute
  time, gradient ∇logp · adv); the PPO-clip and AIPO (truncated importance
  sampling) surrogates over engine-captured behavior logprobs; the k3 KL
  to the frozen base.

Per-token logprobs are ``gathered_logit − logsumexp``. ``logit_chunk`` > 0
runs the lm_head projection and logsumexp per time-chunk under
``torch.utils.checkpoint``, so the live logits buffer is ``[B, C, V]``
instead of ``[B, T, V]`` in the forward and the backward (the chunk
recomputes its logits from its ``[B, C, D]`` hidden slice); T is padded up
to a chunk multiple and the padded positions are sliced off.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.ops.linear import linear


def _logprobs_from_logits(logits: torch.Tensor, ids: torch.Tensor,
                          return_entropy: bool):
    """logits f32 [B, T, V], ids [B, T] → logprobs [B, T] (and entropy
    ``lse − Σ softmax·logits``)."""
    gathered = torch.gather(logits, -1, ids.long()[..., None])[..., 0]
    lse = torch.logsumexp(logits, dim=-1)
    if not return_entropy:
        return gathered - lse
    entropy = lse - (torch.softmax(logits, dim=-1) * logits).sum(-1)
    return gathered - lse, entropy


def answer_logprobs(
    model: Decoder,
    prompt_ids: torch.Tensor,  # [B, P] left-padded
    prompt_mask: torch.Tensor,  # [B, P]
    answer_ids: torch.Tensor,  # [B, T] right-padded
    answer_mask: torch.Tensor,  # [B, T]
    *,
    lora=None,
    lora_scale: float = 1.0,
    remat: bool = True,
    attn_impl: str = "reference",
    lora_dropout: float = 0.0,
    dropout_seed: int | None = None,
    logit_chunk: int = 0,  # 0 = dense [B, T, V]; >0 = chunked CE (module doc)
    return_entropy: bool = False,  # also return per-position vocab entropy
):
    """Per-token logprobs of the answer under the current policy, [B, T]
    f32 (and the full-vocab entropy per position with ``return_entropy``)."""
    full_ids = torch.cat([prompt_ids, answer_ids], dim=1)
    full_mask = torch.cat([prompt_mask, answer_mask], dim=1)
    p = prompt_ids.shape[1]
    t = answer_ids.shape[1]
    fwd = dict(attention_mask=full_mask, lora=lora, lora_scale=lora_scale,
               remat=remat, attn_impl=attn_impl, logits_slice=(p - 1, t),
               lora_dropout=lora_dropout, dropout_seed=dropout_seed)
    if logit_chunk <= 0 or logit_chunk >= t:
        pred, _ = model(full_ids, **fwd)  # [B, T, V] f32
        return _logprobs_from_logits(pred, answer_ids, return_entropy)

    x, _ = model(full_ids, skip_lm_head=True, **fwd)  # [B, T, D]
    chunk = logit_chunk
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    ids = answer_ids
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        ids = torch.nn.functional.pad(answer_ids, (0, pad))
    lm_head = model.lm_head_weight()

    def chunk_logprobs(x_c, ids_c):
        logits = linear(x_c, lm_head).float()  # [B, C, V]
        return _logprobs_from_logits(logits, ids_c, return_entropy)

    def run(*args):  # the backward recomputes the chunk's logits
        if torch.is_grad_enabled():
            return checkpoint(chunk_logprobs, *args, use_reentrant=False)
        return chunk_logprobs(*args)

    outs = [run(x[:, i * chunk:(i + 1) * chunk], ids[:, i * chunk:(i + 1) * chunk])
            for i in range(n_chunks)]
    if not return_entropy:
        return torch.cat(outs, dim=1)[:, :t]
    return (torch.cat([o[0] for o in outs], dim=1)[:, :t],
            torch.cat([o[1] for o in outs], dim=1)[:, :t])


def _masked_mean_seq(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(x·mask).Σ/mask.Σ per row, guarding empty answers."""
    denom = torch.clamp(mask.sum(-1), min=1.0)
    return (x * mask).sum(-1) / denom


def _row_mean(per_row: torch.Tensor, sample_mask: torch.Tensor | None) -> torch.Tensor:
    if sample_mask is None:
        return per_row.mean()
    denom = torch.clamp(sample_mask.sum(), min=1.0)
    return (per_row * sample_mask).sum() / denom


def pg_loss(logprobs, answer_mask, coeffs, sample_mask=None):
    """Vanilla PG: mean over rows of −(mean answer logprob)·coeff."""
    return -_row_mean(_masked_mean_seq(logprobs, answer_mask) * coeffs, sample_mask)


def grpo_loss(logprobs, answer_mask, advantages, sample_mask=None):
    """Single-update GRPO: ratio ≡ 1 at compute time, gradient through
    exp(logp − logp.detach())."""
    ratio = torch.exp(logprobs - logprobs.detach())
    return -_row_mean(_masked_mean_seq(ratio, answer_mask) * advantages, sample_mask)


def grpo_clip_loss(logprobs, behavior_logps, answer_mask, advantages,
                   sample_mask=None, clip_ratio: float = 0.2):
    """PPO-clip surrogate over raw-basis importance ratios:
    −mean_rows(mean_t min(ratio·A, clip(ratio, 1±ε)·A))."""
    ratio = torch.exp(logprobs - behavior_logps)
    clipped = torch.clamp(ratio, 1.0 - clip_ratio, 1.0 + clip_ratio)
    adv = advantages[:, None]
    surrogate = torch.minimum(ratio * adv, clipped * adv)
    return -_row_mean(_masked_mean_seq(surrogate, answer_mask), sample_mask)


def grpo_aipo_loss(logprobs, behavior_logps, answer_mask, advantages,
                   sample_mask=None, is_cap: float = 2.0, version_lag=None,
                   max_staleness: int = 0):
    """Truncated-importance-sampling policy gradient (AIPO):
    −mean_rows(mean_t min(exp(logp − logp_behavior), C)·A), tokens whose
    version lag exceeds ``max_staleness`` masked out."""
    ratio = torch.clamp(torch.exp(logprobs - behavior_logps), max=is_cap)
    mask = answer_mask
    if version_lag is not None and max_staleness > 0:
        mask = mask * (version_lag <= max_staleness).to(mask.dtype)
    return -_row_mean(_masked_mean_seq(ratio * advantages[:, None], mask), sample_mask)


def kl_to_ref(logprobs, ref_logps, answer_mask, sample_mask=None):
    """Per-token KL(π‖π_ref) by the k3 estimator exp(ref − cur) − (ref −
    cur) − 1, masked-meaned per row, then averaged over real rows. The
    exponent is zeroed at masked pads BEFORE exp (garbage pad logprobs
    would overflow it and poison the mean through inf·0)."""
    diff = (ref_logps - logprobs) * answer_mask
    k3 = torch.exp(diff) - diff - 1.0
    return _row_mean(_masked_mean_seq(k3, answer_mask), sample_mask)


def entropy_bonus(logprobs_full: torch.Tensor, alpha: float) -> torch.Tensor:
    """Entropy regularizer over the vocab distribution (API parity; never
    enabled by the trainer)."""
    probs = torch.exp(logprobs_full)
    return alpha * (-(probs * logprobs_full).sum(-1)).mean()
