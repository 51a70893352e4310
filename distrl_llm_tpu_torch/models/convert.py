"""Weights carried across from the JAX package's trees.

``params_from_numpy`` takes a param tree with the JAX package's
``init_params`` keys (``embed``, ``final_norm``, optional ``lm_head``, and
``layers`` of stacked ``[L, ...]`` arrays) as nested dicts of numpy arrays and
returns the port's ``Decoder``. ``lora_from_numpy`` does the same for an
adapter tree (``{"layers": {target: {"a", "b"}}}``), and ``lora_to_numpy``
carries an adapter back (to compare adapters after a learner step). The
caller converts on the JAX side (``jax.tree_util.tree_map(np.asarray,
tree)``), so the port never sees a JAX array.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.lora import TARGET_DIMS
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.utils.device import resolve_device

Tree = Mapping[str, Any]


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = np.require(src, requirements=["C", "W"])  # copies only if needed
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"{name}: shape {tuple(src.shape)} does not match the config's "
            f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(src))


@torch.no_grad()
def params_from_numpy(tree: Tree, cfg: ModelConfig,
                      dtype: torch.dtype = torch.float32,
                      device: str | torch.device | None = None) -> Decoder:
    """JAX-layout numpy param tree → ``Decoder`` on ``device`` (default the
    GPU). Raises on a missing or unexpected key and on any shape mismatch."""
    model = Decoder(cfg, dtype=dtype, device=resolve_device(device))
    top = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_word_embeddings else {"lm_head"})
    if set(tree) != top:
        raise ValueError(f"param tree keys {sorted(tree)} != {sorted(top)}")
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_word_embeddings:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    layers = tree["layers"]
    names = [n for n, _ in model.layers[0].named_parameters()]
    if set(layers) != set(names):
        raise ValueError(
            f"layer keys {sorted(layers)} != {sorted(names)} for this config")
    for name in names:
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(
                f"layers.{name}: leading axis {stacked.shape[0]} != "
                f"num_layers {cfg.num_layers}")
        for i, layer in enumerate(model.layers):
            _copy(getattr(layer, name), stacked[i], f"layers.{name}[{i}]")
    return model


def lora_from_numpy(tree: Tree, cfg: ModelConfig,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None) -> dict:
    """JAX-layout numpy adapter tree → the port's adapter dict of tensors on
    ``device`` (default the GPU), shapes checked against ``cfg``."""
    dev = resolve_device(device)
    out = {}
    for target, ab in tree["layers"].items():
        if target not in TARGET_DIMS:
            raise ValueError(f"unknown LoRA target {target!r}")
        d_in = getattr(cfg, TARGET_DIMS[target][0])
        d_out = getattr(cfg, TARGET_DIMS[target][1])
        a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
        rank = a.shape[-1]
        if a.shape != (cfg.num_layers, d_in, rank) or b.shape != (
                cfg.num_layers, rank, d_out):
            raise ValueError(
                f"LoRA {target}: shapes {a.shape}/{b.shape} do not fit the "
                f"config at rank {rank}")
        # always a copy: the learner updates the adapter in place, which
        # must never write into the caller's numpy arrays
        out[target] = {"a": torch.tensor(a, dtype=dtype, device=dev),
                       "b": torch.tensor(b, dtype=dtype, device=dev)}
    return {"layers": out}


def lora_to_numpy(lora: dict) -> dict:
    """The port's adapter dict → a JAX-layout numpy tree (f32 copies on the
    host), the inverse of ``lora_from_numpy``."""
    return {"layers": {t: {k: x.detach().float().cpu().numpy() for k, x in ab.items()}
                       for t, ab in lora["layers"].items()}}
