"""Masked GQA attention, plain PyTorch (the JAX package's XLA paths).

Queries keep the JAX layout ``[B, Sq, H, D]``. Grouped query heads contract
against their kv head directly (``[B, K, G·Sq, D] @ [B, K, D, Sk]``), never
materializing a repeated K/V. The decode cache is ``[B, K, S, D]`` — PyTorch's
natural layout for a batched matmul over keys.

The int8 dense decode cache stores each (row, kv head, position)'s head
vector as int8 with one f32 absmax scale (``quantize_kv_position``), and
``attention_cached_quant`` reads it with the scales folded into the scores
and the probabilities (the JAX package's "dot" formulation).

``attention(..., impl=...)`` dispatches: "reference" is the plain path
below; "flash" and "splash" both go to kernel K4
(``ops/flash_attention.py``), which computes their one function with GQA
native; "ring" and "ulysses" raise ``NotImplementedError`` naming ROADMAP
item 10b (sequence parallelism).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative for masked logits; avoids NaNs from true -inf


def _gqa_attention(q, k, v, mask, scale):
    """q [B, Sq, H, D]; k, v [B, K, Sk, D]; mask [B, 1|H, Sq, Sk] (True =
    attend). Scores in the input dtype, softmax in f32, probabilities cast
    back to the value dtype for the PV product (the JAX order)."""
    b, sq, h, d = q.shape
    kh = k.shape[1]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).reshape(b, kh, g * sq, d)
    logits = (qg @ k.transpose(-1, -2)).reshape(b, kh, g, sq, -1).float() * scale
    if mask is not None:
        m = (mask[:, :, None] if mask.shape[1] == 1
             else mask.reshape(b, kh, g, *mask.shape[2:]))
        logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = probs.reshape(b, kh, g * sq, -1) @ v  # [B, K, G·Sq, D]
    return out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def attention_reference(q, k, v, mask, scale: float | None = None):
    """q [B, Sq, H, D], k/v [B, Sk, K, D] (training/prefill layout)."""
    return _gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask, scale)


def causal_padding_mask(attention_mask: torch.Tensor, q_len: int,
                        q_offset: int = 0) -> torch.Tensor:
    """[B, 1, Sq, Sk] boolean mask combining causality with key padding.
    ``q_offset`` is the absolute position of the first query row."""
    sk = attention_mask.shape[-1]
    dev = attention_mask.device
    q_pos = q_offset + torch.arange(q_len, device=dev)[:, None]
    k_pos = torch.arange(sk, device=dev)[None, :]
    causal = k_pos <= q_pos
    pad = attention_mask[:, None, None, :].bool()
    return causal[None, None] & pad


def attention_cached(q, k, v, mask, scale: float | None = None):
    """Masked GQA attention against a ``[B, K, Sk, D]`` KV cache (the JAX
    ``attention_cached`` "dot" formulation; "mulred" exists there only for
    XLA layout reasons inside scan programs)."""
    return _gqa_attention(q, k, v, mask, scale)


def quantize_kv_position(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (B, K, position) over head_dim for the dense
    decode cache: [B, K, S, hd] → (int8 [B, K, S, hd], f32 scales
    [B, K, S, 1]). ``s = max|x| / 127`` and ``x / s`` are true divisions of
    two tensors (a division by a Python scalar runs as a reciprocal
    multiply on CUDA, which rounds otherwise); the quotient rounds half to
    even and is clamped to [-127, 127] before the cast, so the result is
    the JAX package's bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q8 = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
    return q8, s


def attention_cached_quant(q, k8, k_scale, v8, v_scale, mask,
                           scale: float | None = None):
    """Masked GQA attention against an int8 dense cache: k8/v8 int8
    [B, K, Sk, D], scales f32 [B, K, Sk, 1]. The k scale multiplies the f32
    scores after the contraction over D, the v scale the softmax
    probabilities before the PV product (the JAX ``attention_cached_quant``
    "dot" formulation, f32 throughout). Returns q's dtype."""
    b, sq, h, d = q.shape
    kh = k8.shape[1]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    qg = q.float().reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).reshape(b, kh, g * sq, d)
    logits = (qg @ k8.float().transpose(-1, -2)).reshape(b, kh, g, sq, -1)
    logits = logits * k_scale[..., 0][:, :, None, None, :]
    logits = logits * scale
    if mask is not None:
        m = (mask[:, :, None] if mask.shape[1] == 1
             else mask.reshape(b, kh, g, *mask.shape[2:]))
        logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * v_scale[..., 0][:, :, None, None, :]
    out = probs.reshape(b, kh, g * sq, -1) @ v8.float()
    return (out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
            .reshape(b, sq, h, d).to(q.dtype))


def attention(q, k, v, mask, scale: float | None = None,
              impl: str = "reference", key_valid: torch.Tensor | None = None):
    """Dispatching front door. ``key_valid`` [B, Sk] is the validity vector
    flash/splash consume (they read no [B, 1, Sq, Sk] mask); "reference"
    reads ``mask``. Unlike the JAX package there is no probe and no fallback
    chain: on a CUDA tensor K4 launches or raises."""
    if impl in ("flash", "splash"):
        # imported here: ops/flash_attention.py imports this module
        from distrl_llm_tpu_torch.ops.flash_attention import flash_attention

        if key_valid is None:
            key_valid = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
        return flash_attention(q, k, v, key_valid, scale=scale)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet (ROADMAP: queue 1, "
            "item 10b: ring/ulysses sequence parallelism)")
    if impl != "reference":
        raise ValueError(f"unknown attn_impl {impl!r}")
    return attention_reference(q, k, v, mask, scale=scale)
