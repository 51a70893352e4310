"""LoRA adapters over the frozen base decoder.

Rank-r adapters on the q/k/v/o/gate/up/down projections with alpha scaling
(rsLoRA off) and zero-init B, so step 0 is the base model. An adapter is a
nested dict of tensors with the JAX package's keys and stacked ``[L, ...]``
factors: ``{"layers": {target: {"a": [L, in, r], "b": [L, r, out]}}}``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from distrl_llm_tpu_torch.models.configs import ModelConfig

Params = dict[str, Any]

# layer-param key → (in_dim_attr, out_dim_attr) resolved against ModelConfig
TARGET_DIMS = {
    "wq": ("hidden_size", "q_dim"),
    "wk": ("hidden_size", "kv_dim"),
    "wv": ("hidden_size", "kv_dim"),
    "wo": ("q_dim", "hidden_size"),
    "w_gate": ("hidden_size", "intermediate_size"),
    "w_up": ("hidden_size", "intermediate_size"),
    "w_down": ("intermediate_size", "hidden_size"),
}

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def target_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """Each projection's ``[in, out]`` shape under ``cfg``."""
    return {t: (getattr(cfg, i), getattr(cfg, o)) for t, (i, o) in TARGET_DIMS.items()}


def lora_scale(rank: int, alpha: float) -> float:
    return alpha / rank


def init_lora_params(
    generator: torch.Generator,
    cfg: ModelConfig,
    rank: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """A ~ N(0, 1/r), B = 0, on the generator's device."""
    dev = generator.device
    layers: Params = {}
    for target in targets:
        d_in = getattr(cfg, TARGET_DIMS[target][0])
        d_out = getattr(cfg, TARGET_DIMS[target][1])
        a = torch.randn((cfg.num_layers, d_in, rank), generator=generator,
                        device=dev) * (rank**-0.5)
        layers[target] = {
            "a": a.to(dtype),
            "b": torch.zeros((cfg.num_layers, rank, d_out), dtype=dtype,
                             device=dev),
        }
    return {"layers": layers}


@torch.no_grad()
def merge_lora(model, lora: Params, alpha: float):
    """A copy of the dense ``Decoder`` ``model`` with the adapter folded into
    its projections (W + A @ B · alpha / r) — the reference's save_pretrained
    artifact (distributed_actor.py:263-264). The rank comes from the
    adapter's shapes so the scale cannot silently mismatch. A quantized base
    raises, as in the JAX package."""
    import copy

    from distrl_llm_tpu_torch.ops.quant import QUANT_TARGETS

    if model.quant is not None and set(lora["layers"]) & set(QUANT_TARGETS):
        raise NotImplementedError("cannot merge LoRA into quantized base weights")
    rank = next(iter(lora["layers"].values()))["a"].shape[-1]
    scale = lora_scale(rank, alpha)
    merged = copy.deepcopy(model)
    for target, ab in lora["layers"].items():
        for i, layer in enumerate(merged.layers):
            w = getattr(layer, target)
            a, b = ab["a"][i].to(w.dtype), ab["b"][i].to(w.dtype)
            w.add_((a @ b) * scale)
    return merged
