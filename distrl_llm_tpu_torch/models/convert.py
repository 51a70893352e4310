"""Weights carried across from the JAX package's trees.

``params_from_numpy`` takes a param tree with the JAX package's
``init_params`` keys (``embed``, ``final_norm``, optional ``lm_head``, and
``layers`` of stacked ``[L, ...]`` arrays) as nested dicts of numpy arrays
(or of CPU tensors, as ``models/loading.py`` reads a bf16 checkpoint) and
returns the port's ``Decoder``. A projection may be a quantized container
(the QLoRA base): ``{"q": int8 [L, G, g, N], "scale": f32 [L, G, 1, N]}``
for int8, ``{"q4": int8 [L, G, g/2, N], "scale"}`` for int4 (the JAX
package's ``pack_params_int4`` transport form). ``lora_from_numpy`` does the
same for an adapter tree (``{"layers": {target: {"a", "b"}}}``), and
``lora_to_numpy`` carries an adapter back (to compare adapters after a
learner step). ``params_to_numpy`` carries a dense model back as the JAX
tree (to compare full fine-tuning's trained weights), and
``param_stacks`` lists a model's parameters as the JAX tree's leaves (one
stacked ``[L, ...]`` leaf per layer parameter), the order and grouping
full fine-tuning's Adam8bit keeps its state in. The caller converts on the
JAX side (``jax.tree_util.tree_map(np.asarray, tree)``), so the port never
sees a JAX array.

Over a learner mesh (``parallel/partition.py``): ``lora_from_numpy(...,
mesh=)`` returns the adapter sharded over the mesh's fsdp axis, and
``lora_to_numpy`` / ``params_to_numpy`` take a sharded adapter or model and
gather it whole (a collective: every fsdp rank must call them). Every
conversion still copies.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.lora import TARGET_DIMS, target_shapes
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.ops.quant import QUANT_TARGETS, is_quantized
from distrl_llm_tpu_torch.utils.device import resolve_device

Tree = Mapping[str, Any]


def _copy(dst: torch.Tensor, src, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"{name}: shape {tuple(src.shape)} does not match the config's "
            f"{tuple(dst.shape)}")
    if not torch.is_tensor(src):
        src = torch.from_numpy(np.require(src, requirements=["C", "W"]))  # copies only if needed
    elif (src.device != dst.device and src.dim() >= 2 and not src.is_contiguous()
          and src.mT.is_contiguous()):
        # a transposed view (a checkpoint's [out, in] weight read as [in,
        # out]): its contiguous bytes go across, the transpose runs where
        # they land (the host would make a strided copy first)
        src = src.mT.to(dst.device).mT
    dst.copy_(src)


def _is_int8(x) -> bool:
    return x.dtype == (torch.int8 if torch.is_tensor(x) else np.int8)


def _tree_quant(layers: Tree, cfg: ModelConfig) -> tuple[int, int | None] | None:
    """(bits, group size) of a tree's quantized projections, None when they
    are dense; group None means per-column scales (one group per input
    dim). Raises on a mix of forms."""
    found = {name: w for name, w in layers.items() if is_quantized(w)}
    if not found:
        return None
    if set(found) != set(QUANT_TARGETS):
        raise ValueError(f"quantized layer keys {sorted(found)} != {sorted(QUANT_TARGETS)}")
    bits = {4 if "q4" in w else 8 for w in found.values()}
    if len(bits) != 1:
        raise ValueError("the tree mixes int8 and int4 containers")
    groups = {name: np.shape(w["q4"])[-2] * 2 if "q4" in w else np.shape(w["q"])[-2]
              for name, w in found.items()}
    shapes = target_shapes(cfg)
    if all(g == shapes[name][0] for name, g in groups.items()):
        return bits.pop(), None
    if len(set(groups.values())) != 1:
        raise ValueError(f"the tree's containers have different group sizes {groups}")
    return bits.pop(), groups.popitem()[1]


@torch.no_grad()
def params_from_numpy(tree: Tree, cfg: ModelConfig,
                      dtype: torch.dtype = torch.float32,
                      device: str | torch.device | None = None) -> Decoder:
    """JAX-layout numpy param tree → ``Decoder`` on ``device`` (default the
    GPU), quantized when the tree's projections are. Raises on a missing or
    unexpected key and on any shape or payload-type mismatch."""
    quant = _tree_quant(tree["layers"], cfg) if "layers" in tree else None
    model = Decoder(cfg, dtype=dtype, device=resolve_device(device), quant=quant)
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
    if quant is not None:
        names += list(QUANT_TARGETS)
    if set(layers) != set(names):
        raise ValueError(
            f"layer keys {sorted(layers)} != {sorted(names)} for this config")
    for name in names:
        if quant is None or name not in QUANT_TARGETS:
            leaves = {name: layers[name]}
        else:
            leaves = {f"{name}_{key}": arr for key, arr in layers[name].items()}
            if set(leaves) - {f"{name}_q", f"{name}_q4", f"{name}_scale"}:
                raise ValueError(f"layers.{name}: container keys {sorted(layers[name])}")
        for attr, stacked in leaves.items():
            if not torch.is_tensor(stacked):
                stacked = np.asarray(stacked)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(
                    f"layers.{attr}: leading axis {stacked.shape[0]} != "
                    f"num_layers {cfg.num_layers}")
            for i, layer in enumerate(model.layers):
                dst = getattr(layer, attr)
                if dst.dtype == torch.int8 and not _is_int8(stacked):
                    raise ValueError(f"layers.{attr}: payload {stacked.dtype}, want int8 "
                                     "(int4 goes as the nibble-packed q4)")
                _copy(dst, stacked[i], f"layers.{attr}[{i}]")
    return model


def lora_from_numpy(tree: Tree, cfg: ModelConfig,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None, mesh=None):
    """JAX-layout numpy adapter tree → the port's adapter dict of tensors on
    ``device`` (default the GPU), shapes checked against ``cfg``; with
    ``mesh`` (a learner ``RoleMesh``) this rank's ``ShardedLora``."""
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
    if mesh is not None:
        from distrl_llm_tpu_torch.parallel.partition import shard_tree

        return shard_tree({"layers": out}, mesh)
    return {"layers": out}


def lora_to_numpy(lora) -> dict:
    """The port's adapter dict (or ``ShardedLora``, gathered) → a JAX-layout
    numpy tree (f32 copies on the host), the inverse of ``lora_from_numpy``.
    Always a copy: an f32 CPU tensor's ``.numpy()`` shares its memory, and
    the optimizer updates the adapter in place."""
    if not isinstance(lora, dict):  # a ShardedLora
        lora = lora.full()
    return {"layers": {t: {k: x.detach().to("cpu", torch.float32, copy=True).numpy()
                           for k, x in ab.items()}
                       for t, ab in lora["layers"].items()}}


def param_stacks(model: Decoder) -> dict[str, list[torch.Tensor]]:
    """A dense model's parameters as the JAX tree's leaves, in its order
    (sorted keys): ``embed``, ``final_norm``, ``layers.<name>`` (the L
    per-layer tensors of one stacked leaf), ``lm_head`` (untied only). The
    tied embedding is one leaf: the LM head reads ``embed``."""
    if model.quant is not None:
        raise ValueError("a quantized model has no dense parameter tree")
    out = {"embed": [model.embed], "final_norm": [model.final_norm]}
    for name in sorted(n for n, _ in model.layers[0].named_parameters()):
        out[f"layers.{name}"] = [getattr(layer, name) for layer in model.layers]
    if model.lm_head is not None:
        out["lm_head"] = [model.lm_head]
    return out


def params_to_numpy(model: Decoder) -> dict:
    """A dense ``Decoder`` → the JAX-layout numpy param tree, the inverse of
    ``params_from_numpy`` (stacked ``[L, ...]`` layer leaves, the tied
    embedding once), copied to the host in the model's dtype widened to f32
    where numpy has no such type (bf16). Always a copy: the optimizer
    updates the parameters in place. A ``ShardedDecoder`` is gathered whole,
    a parameter at a time."""
    from distrl_llm_tpu_torch.parallel.partition import ShardedDecoder

    def host(x: torch.Tensor) -> np.ndarray:
        return (x.float() if x.dtype == torch.bfloat16 else x).to("cpu", copy=True).numpy()

    if isinstance(model, ShardedDecoder):  # its parameters are on the meta device
        whole = {n: host(t) for n, t in model.full_named()}
        name_of = {id(p): n for n, p in model.named_parameters()}

        def value(t: torch.Tensor) -> np.ndarray:
            return whole[name_of[id(t)]]
    else:
        def value(t: torch.Tensor) -> np.ndarray:
            return host(t.detach())

    tree: dict = {"layers": {}}
    for key, ts in param_stacks(model).items():
        if key.startswith("layers."):
            tree["layers"][key.split(".", 1)[1]] = np.stack([value(t) for t in ts])
        else:
            tree[key] = value(ts[0])
    return tree
