"""Linear projection and the inference-time LoRA delta.

Weights keep the JAX package's ``[in, out]`` layout, so ``y = x @ w`` and one
numpy tree feeds both packages. A quantized weight container (the QLoRA base,
``ops/quant.py``) goes to kernel K3 (``ops/quant_matmul.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from distrl_llm_tpu_torch.ops import quant_matmul as _qmm


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ b). ``w`` is a plain ``[in, out]`` weight or a quantized
    container: then K3 without an adapter on CUDA tensors, its plain
    version (the container math: ``q · scale`` in f32, one cast, ``x @ w``,
    then ``+ b``) on CPU tensors."""
    if isinstance(w, dict):
        return _qmm.quant_matmul(x, w, b)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: float, dropout_rate: float = 0.0,
               dropout_seed: int | None = None) -> torch.Tensor:
    """LoRA contribution (x @ A) @ B · scale in the activation dtype.
    A: [in, r], B: [r, out], scale = alpha / r. Factors stored at higher
    precision are cast to the activation dtype (no-op when they match).

    ``dropout_rate`` with a ``dropout_seed`` is peft-style LoRA dropout: the
    adapter INPUT is dropped with inverted scaling, the base path is
    untouched. The keep mask comes from a generator seeded with
    ``dropout_seed`` at this call, never from the global RNG, so the same
    seed gives the same mask, also when ``torch.utils.checkpoint``
    recomputes the layer. Callers derive one seed per (step seed,
    microbatch, layer, target): ``dropout_stream``. Inference passes no
    seed and pays nothing."""
    if dropout_rate > 0.0 and dropout_seed is not None:
        gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        u = torch.rand(x.shape, generator=gen, device=x.device)
        x = torch.where(u < 1.0 - dropout_rate, x / (1.0 - dropout_rate),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    return (x @ a.to(x.dtype) @ b.to(x.dtype)) * scale


def dropout_stream(seed: int, *path: int) -> int:
    """A 63-bit generator seed derived from ``seed`` and a path of small
    integers (microbatch, layer, target stream): distinct paths give
    independent streams."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *path]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)
