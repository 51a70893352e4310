"""Linear projection and the inference-time LoRA delta.

Weights keep the JAX package's ``[in, out]`` layout, so ``y = x @ w`` and one
numpy tree feeds both packages. Quantized weight containers (the QLoRA base)
are not ported yet (ROADMAP: QLoRA with kernel K3).
"""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ b) for a plain ``[in, out]`` weight."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized base weights are not ported yet (ROADMAP: QLoRA "
            "with kernel K3)"
        )
    y = x @ w
    if b is not None:
        y = y + b
    return y


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: float) -> torch.Tensor:
    """LoRA contribution (x @ A) @ B · scale in the activation dtype.
    A: [in, r], B: [r, out], scale = alpha / r. Factors stored at higher
    precision are cast to the activation dtype (no-op when they match).
    Inference only: LoRA dropout belongs to the learner slice."""
    return (x @ a.to(x.dtype) @ b.to(x.dtype)) * scale
