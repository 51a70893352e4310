"""Device resolution for the port's entry points: the GPU unless asked."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a usable GPU raises — the
    port never carries on silently on the CPU; callers that want the CPU (the
    tests, the plain reference versions) pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev
