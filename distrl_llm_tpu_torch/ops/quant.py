"""Weight-only int8/int4 quantization of the frozen base (the QLoRA base).

Counterpart of the JAX package's ``ops/quant.py``, the equivalent of the
reference's 4-bit bitsandbytes base (``LOAD_IN_4BIT``). A quantized weight
is a dict, groupwise symmetric absmax over the input dim:

* int8: ``{"q": int8 [..., G, g, N], "scale": f32 [..., G, 1, N]}``;
* int4: ``{"q4": int8 [..., G, g/2, N], "scale"}``, the nibble form of
  ``pack_int4`` (PyTorch has no int4 type). The values k = 2i and k = 2i + 1
  of a group share byte i: the low nibble holds the even k, the high nibble
  the odd one. The payload stays in this form end to end: kernel K3
  (``ops/quant_matmul.py``) unpacks it in registers.

``quantize`` gives the JAX package's ``q`` and ``scale`` bit for bit: both
divisions are true divisions of two tensors (PyTorch computes ``tensor /
python_scalar`` on CUDA as a multiply by the reciprocal, which rounds
differently from XLA's division) and the values are clamped before the cast
to int8. Only the seven layer projections are quantized; embeddings,
lm_head, norms and biases stay in the working dtype.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

# the projections eligible for quantization: the set LoRA adapts
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BASE_QUANTS = ("none", "int8", "int4")


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and "scale" in w


def is_quantized_tree(params) -> bool:
    """True if any layer projection of a JAX-layout tree ``{"layers": ...}``
    is a quantized container (a ``Decoder`` says so in ``.quant``)."""
    layers = params.get("layers", {}) if isinstance(params, dict) else {}
    return any(is_quantized(w) for w in layers.values())


def quant_bits(w: Params) -> int:
    return 4 if "q4" in w else 8


def group_size_of(w: Params) -> int:
    """The container's group size g (the packed int4 dim holds g / 2)."""
    return w["q4"].shape[-2] * 2 if "q4" in w else w["q"].shape[-2]


def quantize(w: torch.Tensor, bits: int = 8, group_size: int | None = None) -> Params:
    """Quantize [..., in, out] → ``{"q": int8 [..., G, g, out], "scale": f32
    [..., G, 1, out]}`` (int8) or ``{"q4": int8 [..., G, g/2, out], "scale"}``
    (int4). Symmetric absmax per (group, out column); ``group_size`` divides
    the input dim, None means one group (per-column scales)."""
    if bits == 8:
        qmax = 127.0
    elif bits == 4:
        qmax = 7.0
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    *lead, d_in, d_out = w.shape
    g = group_size or d_in
    if d_in % g != 0:
        raise ValueError(f"group_size {g} does not divide input dim {d_in}")
    if bits == 4 and g % 2:
        raise ValueError(f"int4 packs two values a byte: group_size {g} must be even")
    grouped = w.float().reshape(*lead, d_in // g, g, d_out)
    absmax = grouped.abs().amax(dim=-2, keepdim=True)  # [..., G, 1, out]
    scale = absmax / torch.full_like(absmax, qmax)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale, torch.zeros_like(scale))
    q = torch.round(grouped * inv).clamp_(-qmax, qmax).to(torch.int8)
    if bits == 4:
        return {"q4": pack_int4(q), "scale": scale}
    return {"q": q, "scale": scale}


def unpacked(w: Params) -> torch.Tensor:
    """The container's values as int8 [..., G, g, out]."""
    return unpack_int4(w["q4"]) if "q4" in w else w["q"]


def dequantize(w: Params, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[..., G, g, out] quantized → [..., in, out] dense in ``dtype``:
    ``q · scale`` in f32, one cast."""
    full = unpacked(w).float() * w["scale"]
    *lead, groups, g, d_out = full.shape
    return full.reshape(*lead, groups * g, d_out).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (range [-8, 7], any int dtype) two per byte along the
    group axis (-2) → int8 [..., G, g/2, out]: low nibble the even k, high
    nibble the odd k. Requires an even group dim."""
    q8 = q.to(torch.int8)
    g = q8.shape[-2]
    if g % 2 != 0:
        raise ValueError(f"pack_int4 needs an even group dim, got {g}")
    lo = q8[..., 0::2, :] & 0x0F
    hi = (q8[..., 1::2, :] & 0x0F) << 4
    return lo | hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 nibble-packed [..., G, g/2, out] → int8 values in [-8, 7]
    [..., G, g, out], sign-extended by arithmetic shifts."""
    p8 = packed.to(torch.int8)
    lo = (p8 << 4) >> 4
    hi = p8 >> 4
    *lead, gh, out = p8.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, gh * 2, out)


def quant_bits_for(config_value: str) -> int | None:
    """Map the ``base_quant`` setting ({"none", "int8", "int4"}) to bits."""
    return {"none": None, "int8": 8, "int4": 4}[config_value]


def default_group_size(bits: int) -> int | None:
    """int4 needs blockwise scales for accuracy (bitsandbytes uses 64); int8
    is fine with per-column scales."""
    return 64 if bits == 4 else None


@torch.no_grad()
def quantize_params(model, bits: int = 8, group_size: int | None = None):
    """Quantize a dense ``Decoder``'s seven projections in place, one layer
    at a time, freeing each dense weight as it goes. Returns the model."""
    if model.quant is not None:
        raise ValueError(f"the model is already quantized ({model.quant})")
    for layer in model.layers:
        for name in QUANT_TARGETS:
            layer.set_quantized(name, quantize(getattr(layer, name), bits, group_size))
    model.quant = (bits, group_size)
    return model


def quantize_base(model, base_quant: str, quant_group_size: int | None = None,
                  train_mode: str = "lora"):
    """Quantize ``model`` in place as the JAX package's ``base_quant`` /
    ``quant_group_size`` settings ask (its ``TrainConfig`` rules and
    ``Trainer.from_pretrained``); "none" leaves it dense. A group size needs
    ``base_quant``, must be >= 1 and divide every projection's input dim;
    unset, it is ``default_group_size(bits)``; full fine-tuning trains the
    base weights, which therefore cannot be quantized. Returns the model."""
    cfg = model.cfg
    if base_quant not in BASE_QUANTS:
        raise ValueError(f"base_quant must be none/int8/int4, got {base_quant!r}")
    if quant_group_size is not None and quant_group_size < 1:
        raise ValueError(f"quant_group_size must be >= 1, got {quant_group_size}")
    bits = quant_bits_for(base_quant)
    if bits is None:
        if quant_group_size is not None:
            raise ValueError(
                "quant_group_size configures base_quant's groupwise scales — "
                "set base_quant int8/int4 (it would be silently ignored)")
        return model
    if train_mode == "full":
        raise ValueError("full fine-tuning trains the base weights — they cannot "
                         "be quantized (base_quant must be 'none')")
    group = quant_group_size or default_group_size(bits)
    if group is not None:
        for dim in sorted({cfg.hidden_size, cfg.q_dim, cfg.intermediate_size}):
            if dim % group:
                raise ValueError(f"quant_group_size {group} does not divide the "
                                 f"projection input dim {dim}")
    return quantize_params(model, bits, group)
