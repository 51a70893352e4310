"""GQA decoder (Qwen2 / Llama-3 / Mistral / Gemma-1 family) as ``nn.Module``s.

Counterpart of the JAX package's ``models/transformer.py``. Weights keep its
``[in, out]`` layout and names (``wq``, ``bq``, ``w_gate``, ...), one
``DecoderLayer`` per layer instead of a stacked ``[L, ...]`` tree. LoRA
adapters stay stacked dicts (``models/lora.py``) and are sliced per layer.

The dense KV cache is ``{"k": [L × [B, K, Smax, hd]], "v": ...}``. The forward
writes the new positions into it IN PLACE (slice assignment, or
``index_copy_`` at a device-tensor offset: the graphed decode step's) and
returns the same dict — the port has no functional-update constraint, so no
cache-sized copy is ever made.

A PAGED cache (``ops/paged.py``: per-layer page pools, bf16/f32 or int8
``QuantizedPages``, plus ``"lengths"`` [B] and ``"page_indices"`` [B, pps])
switches to the packed path: prefill (S > 1) writes the prompt pages and
attends over the input; decode (S = 1) writes the token at ``lengths`` and
runs ``paged_attention_op`` (kernel K2 on the GPU) over ``lengths + 1``.
``paged_verify`` (the speculative verify forward) writes S tokens' K/V at
``lengths + i`` and runs ``paged_verify_op`` (kernel K5, one launch per
layer, or S launches of K2 with ``paged_verify_impl="unrolled"``); the
projections, the MLP and the LM head batch over the ``[B, S]`` block.
``paged_chunked`` (the continuation prefill that resumes a preempted
sequence) writes the valid tokens of the block the same way and attends
over each row's dense-gathered context (``chunked_context_attention``).
``paged_prefix`` (the warm prefill through a radix-cache hit) writes the
valid tokens of the suffix block the same way and attends over the row's
dense-gathered packed window in the compute dtype with the plain
``attention_reference`` under the mask ``key position <= query position``;
its ``page_indices`` carry one trailing scratch column that the gather
drops. The write slots and the attended lengths are computed once per
forward, not per layer.

Ported: the no-cache (prefill/self-attention, training), dense-cache and
paged (prefill, decode) branches. ``attn_impl`` "flash" and "splash" run
kernel K4 (``ops/flash_attention.py``) on the uncached forward and the paged
prefill, fed the ``[B, S]`` key-validity vector (no ``[B, 1, S, S]`` mask is
built for them), and "flash" on the dense-cache prefill at
``cache_offset == 0``, as in the JAX package.

Training: the adapter's stacked f32 factors are the leaves that train (the
per-layer factors are ``unbind`` views, so every layer's grad lands in its
stacked leaf); the base stays frozen. ``remat`` wraps each layer in
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint(..., nothing_saveable)``; LoRA dropout draws its masks from
seeds derived per (layer, target), so the recompute draws the same masks.

A quantized base (QLoRA, ``ops/quant.py``) keeps the seven projections as
int8 or int4 containers: each runs kernel K3 (``ops/quant_matmul.py``), with
the adapter's delta fused into its epilogue unless LoRA dropout is on (then
K3 without the adapter, plus ``lora_delta``), as the JAX ``_proj`` does.

An int8 dense cache (``init_kv_cache_int8``: int8 ``[B, K, Smax, hd]``
with f32 ``"k_scale"``/``"v_scale"`` ``[B, K, Smax, 1]``) quantizes each
new position's head vector (``ops/attention.py::quantize_kv_position``)
and attends through ``attention_cached_quant``, as the JAX dense-cache
int8 branch does. Ring and ulysses raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.lora import target_shapes
from distrl_llm_tpu_torch.ops import quant_matmul as _qmm
from distrl_llm_tpu_torch.ops.attention import (
    attention, attention_cached, attention_cached_quant, attention_reference,
    causal_padding_mask, quantize_kv_position,
)
from distrl_llm_tpu_torch.ops.linear import dropout_stream, linear, lora_delta
from distrl_llm_tpu_torch.ops.paged import (
    chunked_context_attention, gather_pages_dense, paged_attention_op,
    paged_verify_op, token_slots, tokens_slots, write_prompt_to_pages,
    write_token_at,
)

Params = dict[str, Any]

# stable per-target stream ids so each projection's dropout mask differs
_TARGET_STREAM = {
    "wq": 0, "wk": 1, "wv": 2, "wo": 3, "w_gate": 4, "w_up": 5, "w_down": 6,
}
ATTN_IMPLS = ("reference", "flash", "splash", "ring", "ulysses")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if offset:  # Gemma stores the norm weight as a delta around 1
        w = w + 1.0
    return (x * w).to(orig_dtype)


def _write_window(cache: torch.Tensor, new: torch.Tensor, offset) -> None:
    """``cache[:, :, offset:offset + S] = new`` ([B, K, S, ...]) in place. A
    device-tensor ``offset`` ([1] int64: the graphed decode step's) writes
    through ``index_copy_``, which reads it on the device."""
    s = new.shape[2]
    if isinstance(offset, torch.Tensor):
        cache.index_copy_(2, offset + torch.arange(s, device=offset.device),
                          new.to(cache.dtype))
    else:
        cache[:, :, offset:offset + s] = new


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, S] → (cos, sin) each [B, S, head_dim/2], f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta**exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [B, S, H, D] by per-position angles (HF rotate-half convention)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention + gated MLP, each with a
    residual; every projection may carry a LoRA delta.

    With ``quant`` = (bits, group size) the seven projections are quantized
    containers (``ops/quant.py``), held as buffers ``{name}_q`` (int8) or
    ``{name}_q4`` (int4 nibble form) and ``{name}_scale`` that get no grad,
    and the dense parameter of that name is None; ``weight(name)`` returns
    either form."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device | str | None = None,
                 quant: tuple[int, int | None] | None = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.attn_norm = param(D)
        self.mlp_norm = param(D)
        for name, (d_in, d_out) in target_shapes(cfg).items():
            if quant is None:
                setattr(self, name, param(d_in, d_out))
                continue
            bits, group = quant
            g = group or d_in
            key, rows = ("q4", g // 2) if bits == 4 else ("q", g)
            self.set_quantized(name, {
                key: torch.empty((d_in // g, rows, d_out), dtype=torch.int8, device=device),
                "scale": torch.empty((d_in // g, 1, d_out), dtype=torch.float32,
                                     device=device)})
        if cfg.attention_bias:
            self.bq = param(cfg.q_dim)
            self.bk = param(cfg.kv_dim)
            self.bv = param(cfg.kv_dim)
        else:
            self.bq = self.bk = self.bv = None

    def set_quantized(self, name: str, container: Params) -> None:
        """Replace projection ``name`` by a quantized container (its dense
        parameter is dropped)."""
        self.register_parameter(name, None)
        for key in ("q", "q4", "scale"):
            if key in container:
                self.register_buffer(f"{name}_{key}", container[key])

    def weight(self, name: str):
        """Projection ``name``: the dense ``[in, out]`` parameter or the
        quantized container dict."""
        w = getattr(self, name)
        if w is not None:
            return w
        key = "q4" if hasattr(self, f"{name}_q4") else "q"
        return {key: getattr(self, f"{name}_{key}"), "scale": getattr(self, f"{name}_scale")}

    def _proj(self, h, name: str, bias, lora: Params | None, lora_scale: float,
              lora_dropout: float = 0.0, layer_seed: int | None = None):
        w = self.weight(name)
        has_lora = lora is not None and name in lora
        if has_lora and isinstance(w, dict) and (lora_dropout <= 0.0 or layer_seed is None):
            # a quantized base with an adapter and no dropout: one K3 launch
            # with the LoRA delta in its epilogue (dropout perturbs the
            # adapter INPUT, which the epilogue cannot express)
            return _qmm.quant_matmul(h, w, bias, lora[name]["a"], lora[name]["b"],
                                     lora_scale)
        y = linear(h, w, bias)
        if has_lora:
            seed = (dropout_stream(layer_seed, _TARGET_STREAM[name])
                    if layer_seed is not None else None)
            y = y + lora_delta(h, lora[name]["a"], lora[name]["b"], lora_scale,
                               dropout_rate=lora_dropout, dropout_seed=seed)
        return y

    def forward(
        self,
        x: torch.Tensor,  # [B, S, D]
        lora: Params | None,  # this layer's {target: {"a", "b"}} or None
        cache_k,  # [B, K, Smax, hd] dense or a page pool; written in place
        cache_v,
        *,
        cos: torch.Tensor,
        sin: torch.Tensor,
        mask: torch.Tensor | None,
        cache_offset: int | torch.Tensor,
        lora_scale: float,
        attn_impl: str,
        page_indices: torch.Tensor | None = None,  # [B, pps] — paged-cache mode
        page_size: int = 0,
        paged_mode: str = "prefill",  # "prefill" | "decode" | "verify" | "chunked" | "prefix"
        verify_impl: str = "fused",  # paged_verify_op's sweep
        # decode: lengths + 1; verify, chunked: lengths (resident before the block)
        attn_lengths: torch.Tensor | None = None,
        # decode, verify, chunked: (page, slot) of each written token, and
        # the [B·S] token indices written (None: all of them)
        write_at: tuple | None = None,
        key_valid: torch.Tensor | None = None,  # [B, Sk] for flash/splash
        lora_dropout: float = 0.0,
        layer_seed: int | None = None,  # this layer's dropout seed (training)
        cache_k_scale: torch.Tensor | None = None,  # int8 dense cache scales
        cache_v_scale: torch.Tensor | None = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape

        def proj(inp, name, bias=None):
            return self._proj(inp, name, bias, lora, lora_scale, lora_dropout, layer_seed)

        h = rms_norm(x, self.attn_norm, cfg.rms_norm_eps, offset=cfg.rmsnorm_offset)
        q = proj(h, "wq", self.bq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = proj(h, "wk", self.bk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = proj(h, "wv", self.bv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache_k is not None and page_indices is not None:
            if paged_mode != "prefill":
                # the block's tokens go to each row's pages at lengths + i
                # first (the verify and the resume read them back)
                page, slot, sel = write_at
                kf = k.reshape(b * s, cfg.num_kv_heads, cfg.head_dim)
                vf = v.reshape(b * s, cfg.num_kv_heads, cfg.head_dim)
                if sel is not None:
                    kf, vf = kf[sel], vf[sel]
                write_token_at(cache_k, kf, page, slot)
                write_token_at(cache_v, vf, page, slot)
            if paged_mode == "decode":
                # attend over the row's [0, length + 1) prefix
                att = paged_attention_op(
                    q[:, 0], cache_k, cache_v, attn_lengths, page_indices)[:, None]
            elif paged_mode == "verify":
                # draft position i attends [0, lengths + i + 1)
                att = paged_verify_op(q, cache_k, cache_v, attn_lengths, page_indices,
                                      verify_impl=verify_impl)
            elif paged_mode == "chunked":
                att = chunked_context_attention(
                    q, gather_pages_dense(cache_k, page_indices),
                    gather_pages_dense(cache_v, page_indices), attn_lengths,
                    key_valid[:, :s])
            elif paged_mode == "prefix":
                # the packed window in the compute dtype (the trailing
                # scratch column dropped), the plain attention the JAX
                # package reaches here: its kernels refuse Sq != Sk
                ctx = page_indices[:, :-1]
                att = attention_reference(
                    q, gather_pages_dense(cache_k, ctx, dtype=q.dtype),
                    gather_pages_dense(cache_v, ctx, dtype=q.dtype), mask)
            else:
                # packed prefill: write the prompt pages, attend over the input
                write_prompt_to_pages(cache_k, k, page_indices, page_size)
                write_prompt_to_pages(cache_v, v, page_indices, page_size)
                att = attention(q, k, v, mask, impl=attn_impl, key_valid=key_valid)
        elif cache_k is not None:
            # in-place cache write of the new positions, then attention over
            # the whole window (positions not yet written are masked off)
            if cache_k_scale is not None:
                # int8 cache: each position's head vector with its own scale
                k8, ks = quantize_kv_position(k.transpose(1, 2))
                v8, vs = quantize_kv_position(v.transpose(1, 2))
                for cache, new in ((cache_k, k8), (cache_k_scale, ks), (cache_v, v8),
                                   (cache_v_scale, vs)):
                    _write_window(cache, new, cache_offset)
            else:
                _write_window(cache_k, k.transpose(1, 2), cache_offset)
                _write_window(cache_v, v.transpose(1, 2), cache_offset)
            if (s > 1 and attn_impl == "flash"
                    and not isinstance(cache_offset, torch.Tensor) and cache_offset == 0):
                # prefill: the cache holds nothing beyond the prompt being
                # written, so this is self-attention over the input: K4 on
                # the fresh k/v, the cache only written
                att = attention(q, k, v, None, impl="flash", key_valid=key_valid[:, :s])
            elif cache_k_scale is not None:
                att = attention_cached_quant(q, cache_k, cache_k_scale, cache_v,
                                             cache_v_scale, mask)
            else:
                att = attention_cached(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)
        else:
            att = attention(q, k, v, mask, impl=attn_impl, key_valid=key_valid)
        att = att.reshape(b, s, cfg.q_dim)
        x = x + proj(att, "wo")

        h = rms_norm(x, self.mlp_norm, cfg.rms_norm_eps, offset=cfg.rmsnorm_offset)
        gate = proj(h, "w_gate")
        gate = (F.silu(gate) if cfg.hidden_act == "silu"
                else F.gelu(gate, approximate="tanh"))  # Gemma gelu_pytorch_tanh
        up = proj(h, "w_up")
        return x + proj(gate * up, "w_down")


class Decoder(nn.Module):
    """Embedding, ``num_layers`` decoder layers, final norm, LM head (or the
    tied embedding). Parameters are created uninitialized; fill them with
    ``init_params`` or ``models.convert.params_from_numpy``. ``quant`` =
    (bits, group size) builds the layers with quantized projections
    (``DecoderLayer``); ``ops/quant.py::quantize_params`` converts a dense
    model in place. ``self.quant`` records which form the model has."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 quant: tuple[int, int | None] | None = None):
        super().__init__()
        self.cfg = cfg
        self.quant = quant
        # bumped by whoever rewrites the weights in place (full fine-tuning's
        # push): what an engine's prefix cache keys its cached KV on
        self.weights_version = 0
        D = cfg.hidden_size
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, D, dtype=dtype, device=device),
            requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.empty(D, dtype=dtype, device=device), requires_grad=False)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else nn.Parameter(torch.empty(D, cfg.vocab_size, dtype=dtype,
                                          device=device), requires_grad=False)
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device, quant) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S]
        *,
        attention_mask: torch.Tensor | None = None,  # [B, Sk]; 1 = attendable
        lora: Params | None = None,
        lora_scale: float = 1.0,
        kv_cache: Params | None = None,  # init_kv_cache dict, written in place
        cache_offset: int | torch.Tensor = 0,  # or [1] int64 on the device
        attn_impl: str = "reference",
        logits_slice: tuple[int, int] | None = None,  # (start, length) along seq
        positions: torch.Tensor | None = None,  # [B, S] absolute positions
        logits_positions: torch.Tensor | None = None,  # [B] per-row gather
        page_size: int = 0,  # paged-cache mode (ops/paged.py)
        paged_verify: bool = False,  # speculative draft-block verify
        paged_verify_impl: str = "fused",  # verify sweep: "fused" (K5) | "unrolled"
        paged_chunked: bool = False,  # continuation (chunked) prefill over pages
        paged_prefix: bool = False,  # warm (radix-hit) suffix prefill over pages
        remat: bool = False,  # checkpoint each layer (training, no cache)
        lora_dropout: float = 0.0,  # adapter-input dropout (training)
        dropout_seed: int | None = None,  # this forward's dropout seed
        skip_lm_head: bool = False,  # return final-norm hidden states
    ) -> tuple[torch.Tensor, Params | None]:
        """Returns (logits f32 [B, S, V], kv_cache); with ``skip_lm_head``
        the final-norm hidden states [B, S, D] in the model dtype instead
        (the learner's chunked logprob path projects them itself).

        Without a cache: causal self-attention over the input (prefill /
        training). With a dense cache: new K/V are written at
        ``cache_offset`` and queries attend to every cache key that
        ``attention_mask`` (length Smax) marks valid. RoPE positions default
        to ``cache_offset + arange(S)`` — they COUNT left-pad columns, as the
        JAX package's do. ``cache_offset`` may be a [1] int64 device tensor
        (the decode step of a captured graph): the cache write, the RoPE
        positions and the causal mask then read it on the device, and the
        caller checks the cache's capacity (the engines: at each chunk).

        With a paged cache (``page_size`` > 0): prefill (S > 1) self-attends
        over the packed input (``attention_mask`` [B, S]) while writing the
        prompt pages; decode (S = 1) attends over each row's ``[0, lengths +
        1)``. The paged engine passes packed ``positions``.
        ``logits_positions`` projects only one position per row (the packed
        prefill's last real token). ``paged_verify``: the S-token block at
        each row's ``lengths`` (positions ``lengths + i``), query i attending
        ``[0, lengths + i + 1)``. ``paged_chunked``: the same block with
        ``attention_mask`` [B, S] marking its real tokens; padding tokens
        write nothing. ``paged_prefix``: the same block written over cached
        pages, query i (at ``positions``) attending the row's packed
        window ``[0, lengths + i]``; ``page_indices`` has one trailing
        scratch column.

        Training: ``remat`` checkpoints each layer of the uncached forward
        while grad is enabled; ``lora_dropout`` with a ``dropout_seed``
        drops the adapter input, one seed per layer and target derived from
        it."""
        cfg = self.cfg
        b, s = input_ids.shape
        dev = input_ids.device
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not ported yet (ROADMAP: queue 1, "
                "item 10b: ring/ulysses sequence parallelism)")
        paged = kv_cache is not None and "page_indices" in kv_cache
        if (paged_verify or paged_chunked or paged_prefix) and not paged:
            raise ValueError("paged_verify, paged_chunked and paged_prefix need a "
                             "paged cache")
        if paged_verify + paged_chunked + paged_prefix > 1:
            raise ValueError("paged_verify, paged_chunked and paged_prefix exclude "
                             "each other")
        if paged:
            if page_size <= 0:
                raise ValueError("a paged cache needs page_size > 0")
        elif kv_cache is not None:
            smax = kv_cache["k"][0].shape[2]
            if not isinstance(cache_offset, torch.Tensor) and cache_offset + s > smax:
                raise ValueError(
                    f"KV cache overflow: offset {cache_offset} + seq {s} > "
                    f"capacity {smax}")
        if positions is None:
            positions = (cache_offset + torch.arange(s, dtype=torch.int32, device=dev)
                         )[None, :].expand(b, s)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

        x = F.embedding(input_ids, self.embed)
        if cfg.scale_embeddings:  # Gemma: hidden states enter at sqrt(D) scale
            x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)

        # a paged cache attends raggedly by length (decode) or over the
        # packed input (prefill): the dense key window is the input itself
        sk = smax if (kv_cache is not None and not paged) else s
        cfg.check_within_window(sk)
        if attention_mask is None:
            attention_mask = torch.ones((b, sk), dtype=torch.int32, device=dev)
        # flash/splash (K4) take the [B, S] validity vector: the [B, 1, S, S]
        # mask is built only where a path reads it (the JAX needs_dense_mask)
        kernel_attn = attn_impl in ("flash", "splash")
        needs_dense_mask = ((kv_cache is not None and not paged)
                            or (paged and s > 1 and not kernel_attn and not paged_verify
                                and not paged_chunked and not paged_prefix)
                            or (kv_cache is None and not kernel_attn))
        mask = (causal_padding_mask(attention_mask, q_len=s,
                                    q_offset=0 if paged else cache_offset)
                if needs_dense_mask else None)
        paged_kw = {}
        if paged:
            # the write slots and the attended lengths, shared by every layer
            table = kv_cache["page_indices"]
            paged_kw = {"page_indices": table, "page_size": page_size}
            lengths = kv_cache.get("lengths")
            if paged_verify or paged_chunked or paged_prefix:
                sel = (None if paged_verify else
                       torch.nonzero(attention_mask[:, :s].reshape(-1) > 0)[:, 0])
                page, slot = tokens_slots(lengths, table, page_size, s)
                if sel is not None:
                    page, slot = page[sel], slot[sel]
                mode = ("verify" if paged_verify else
                        "chunked" if paged_chunked else "prefix")
                paged_kw.update(paged_mode=mode, verify_impl=paged_verify_impl,
                                write_at=(page, slot, sel),
                                attn_lengths=lengths.to(torch.int32))
                if paged_prefix:
                    # query i sits at lengths + i and sees the packed window
                    # up to itself (the cold prefill's causal rows)
                    jpos = torch.arange((table.shape[1] - 1) * page_size, device=dev)
                    qpos = lengths.long()[:, None] + torch.arange(s, device=dev)[None, :]
                    mask = (jpos[None, None, :] <= qpos[:, :, None])[:, None]
            elif s == 1:  # decode: one write slot per row
                paged_kw.update(paged_mode="decode",
                                write_at=(*token_slots(lengths, table, page_size), None),
                                attn_lengths=(lengths + 1).to(torch.int32))

        layer_loras = _split_lora(lora, cfg.num_layers)
        dropping = lora_dropout > 0.0 and dropout_seed is not None
        ckpt = remat and kv_cache is None and torch.is_grad_enabled()
        for i in range(len(self.layers)):
            layer = self._layer_call(i)
            kw = dict(cos=cos, sin=sin, mask=mask, cache_offset=cache_offset,
                      lora_scale=lora_scale, attn_impl=attn_impl,
                      key_valid=attention_mask,
                      lora_dropout=lora_dropout if dropping else 0.0,
                      layer_seed=dropout_stream(dropout_seed, i) if dropping else None,
                      **paged_kw)
            ck = kv_cache["k"][i] if kv_cache is not None else None
            cv = kv_cache["v"][i] if kv_cache is not None else None
            if kv_cache is not None and "k_scale" in kv_cache:
                kw.update(cache_k_scale=kv_cache["k_scale"][i],
                          cache_v_scale=kv_cache["v_scale"][i])
            if ckpt:
                x = checkpoint(layer, x, layer_loras[i], ck, cv, use_reentrant=False, **kw)
            else:
                x = layer(x, layer_loras[i], ck, cv, **kw)

        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps, offset=cfg.rmsnorm_offset)
        if logits_slice is not None:
            # project only the needed positions (prefill needs the last one)
            x = x[:, logits_slice[0]:logits_slice[0] + logits_slice[1]]
        elif logits_positions is not None:
            # per-row gather: packed prompts end at different columns
            x = x[torch.arange(b, device=dev), logits_positions.long()][:, None]
        if skip_lm_head:
            return x, kv_cache
        return linear(x, self.lm_head_weight()).float(), kv_cache

    def _layer_call(self, i: int):
        """What runs layer ``i`` (a subclass that keeps its weights elsewhere
        gathers them here: ``parallel/partition.py::ShardedDecoder``)."""
        return self.layers[i]

    def lm_head_weight(self) -> torch.Tensor:
        """The ``[D, V]`` output projection (the embedding's transpose when
        tied)."""
        return self.embed.T if self.cfg.tie_word_embeddings else self.lm_head


def _split_lora(lora: Params | None, num_layers: int) -> list[Params | None]:
    """Stacked adapter dict → per-layer ``{target: {"a", "b"}}`` views.
    ``unbind`` makes all L views in one op, and its backward stacks the L
    per-layer grads into the stacked leaf's grad once."""
    if lora is None:
        return [None] * num_layers
    split = {t: (ab["a"].unbind(0), ab["b"].unbind(0)) for t, ab in lora["layers"].items()}
    return [{t: {"a": a[i], "b": b_[i]} for t, (a, b_) in split.items()}
            for i in range(num_layers)]


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype = torch.float32) -> Decoder:
    """Random init on the generator's device with HF-comparable scales:
    N(0, 0.02) projections and embeddings, unit norms, zero biases."""
    model = Decoder(cfg, dtype=dtype, device=generator.device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_norm", "mlp_norm", "final_norm"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str | None = None) -> Params:
    """Per-layer lists of zeroed ``[B, K, Smax, hd]`` buffers."""
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
    }


def init_kv_cache_int8(cfg: ModelConfig, batch: int, max_seq: int,
                       device: torch.device | str | None = None) -> Params:
    """int8 dense decode cache: per-layer zeroed int8 ``[B, K, Smax, hd]``
    values and f32 ``[B, K, Smax, 1]`` scales (``"k_scale"``/``"v_scale"``),
    1 + 4/hd bytes an element against bf16's 2 (the JAX package's
    ``init_kv_cache_int8`` in the port's ``[.., S, hd]`` layout)."""
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    sshape = (batch, cfg.num_kv_heads, max_seq, 1)
    cache = {kv: [torch.zeros(shape, dtype=torch.int8, device=device)
                  for _ in range(cfg.num_layers)] for kv in ("k", "v")}
    cache.update({f"{kv}_scale": [torch.zeros(sshape, dtype=torch.float32, device=device)
                                  for _ in range(cfg.num_layers)] for kv in ("k", "v")})
    return cache
