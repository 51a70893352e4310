"""HF checkpoint <-> the port's ``Decoder``.

The JAX package's ``models/loading.py``: transformers-style state dicts
(Qwen2 / Llama safetensors) map onto the stacked ``[L, ...]`` layout of that
package's param tree, which ``models/convert.py`` turns into a ``Decoder``.
The safetensors files are read and written by the port's own codec
(``utils/safetensors_io.py``), so no ``safetensors`` package is needed, and a
bf16 checkpoint stays bf16 (torch tensors throughout, no numpy dtype).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Any, Mapping

import torch

from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import params_from_numpy
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.utils import safetensors_io

Params = dict[str, Any]

# the JAX layer key -> its HF name; HF Linear stores [out, in], the port [in, out]
_HF_LAYER_MAP = {
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
    "bq": "self_attn.q_proj.bias",
    "bk": "self_attn.k_proj.bias",
    "bv": "self_attn.v_proj.bias",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}


def _get(sd: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    if name in sd:
        return sd[name]
    # some exports drop the "model." prefix
    alt = name.removeprefix("model.")
    if alt in sd:
        return sd[alt]
    raise KeyError(name)


def params_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig,
                           dtype: torch.dtype = torch.float32) -> Params:
    """HF-named state dict (CPU tensors) -> the JAX package's stacked param
    tree, as CPU tensors of ``dtype``."""

    def stack(key: str, hf_name: str) -> torch.Tensor:
        out = torch.stack([_get(sd, f"model.layers.{i}.{hf_name}")
                           for i in range(cfg.num_layers)]).to(dtype)
        if key.startswith("w"):  # weights: HF [out, in] -> [in, out]
            out = out.transpose(1, 2)
        return out

    params: Params = {
        "embed": _get(sd, "model.embed_tokens.weight").to(dtype),
        "final_norm": _get(sd, "model.norm.weight").to(dtype),
        "layers": {key: stack(key, hf_name) for key, hf_name in _HF_LAYER_MAP.items()
                   if cfg.attention_bias or not key.startswith("b")},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _get(sd, "lm_head.weight").to(dtype).T
    return params


def load_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory's .safetensors shards, on the
    host. Honors ``model.safetensors.index.json`` when present."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    sd: dict[str, torch.Tensor] = {}
    for shard in shards:
        sd.update(safetensors_io.load_file(os.path.join(path, shard)))
    return sd


def state_dict_from_params(model: Decoder) -> dict[str, torch.Tensor]:
    """A dense ``Decoder`` -> HF-named state dict (the exact inverse of
    ``params_from_state_dict``), tensors on the model's device."""
    cfg = model.cfg
    if model.quant is not None:
        raise NotImplementedError("cannot export quantized base weights as an HF checkpoint")
    sd: dict[str, torch.Tensor] = {}
    for i, layer in enumerate(model.layers):
        for key, hf_name in _HF_LAYER_MAP.items():
            w = getattr(layer, key, None)
            if w is None:
                continue
            w = w.detach()
            sd[f"model.layers.{i}.{hf_name}"] = w.T.contiguous() if key.startswith("w") else w
    sd["model.embed_tokens.weight"] = model.embed.detach()
    sd["model.norm.weight"] = model.final_norm.detach()
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = model.lm_head.detach().T.contiguous()
    return sd


def save_hf_checkpoint(model: Decoder, path: str, *, lora: Params | None = None,
                       lora_alpha: float = 16.0) -> None:
    """Write an HF-format checkpoint directory (model.safetensors +
    config.json), optionally with the LoRA adapter MERGED into the base — the
    reference's ``save_pretrained`` snapshot (distributed_actor.py:263-264),
    loadable by ``load_pretrained`` here, in the JAX package, or by
    transformers."""
    from distrl_llm_tpu_torch.models.lora import merge_lora

    cfg = model.cfg
    if lora is not None:
        model = merge_lora(model, lora, lora_alpha)
    os.makedirs(path, exist_ok=True)
    sd = state_dict_from_params(model)
    safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    model_type = cfg.model_type
    arch = {
        "qwen2": "Qwen2ForCausalLM",
        "llama": "LlamaForCausalLM",
        "mistral": "MistralForCausalLM",
        "gemma": "GemmaForCausalLM",
    }.get(model_type, "LlamaForCausalLM")
    hf_cfg = {
        "model_type": model_type,
        "architectures": [arch],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": str(model.embed.dtype).removeprefix("torch."),
    }
    if cfg.hidden_act == "gelu_tanh":
        hf_cfg["hidden_act"] = "gelu_pytorch_tanh"
    if cfg.sliding_window is not None:
        hf_cfg["sliding_window"] = cfg.sliding_window
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def load_pretrained(path: str, cfg: ModelConfig | None = None,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None) -> tuple[Decoder, ModelConfig]:
    """Load an HF-format local checkpoint directory into a ``Decoder`` of
    ``dtype`` on ``device`` (default the GPU); ``cfg`` defaults to its
    ``config.json``."""
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = ModelConfig.from_hf_config(SimpleNamespace(**json.load(f)))
    params = params_from_state_dict(load_safetensors_dir(path), cfg, dtype=dtype)
    return params_from_numpy(params, cfg, dtype=dtype, device=device), cfg
