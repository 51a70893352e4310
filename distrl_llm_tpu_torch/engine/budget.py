"""Device-memory budget -> KV page-pool sizing (the ``--actor_gpu_usage``
contract).

The JAX package's ``engine/budget.py`` on the GPU. The reference passes
``--actor_gpu_usage`` to vLLM's ``gpu_memory_utilization``
(train_distributed.py:34-35), which sizes the KV block pool as usable =
usage x device memory - weights - activation workspace, blocks = usable /
block bytes. ``kv_pool_pages`` converts the same fraction into the paged
engine's ``max_kv_pages``, against the card's memory
(``torch.cuda.mem_get_info``). A CPU device has no such budget: the caller
passes ``hbm_bytes``.
"""

from __future__ import annotations

import logging

import torch

from distrl_llm_tpu_torch.ops.paged import pages_per_seq

log = logging.getLogger(__name__)

# slice of the budget held back for decode activations and workspace (vLLM
# hides the analogous costs inside its profiling run; a fixed fraction is
# the static-shape equivalent)
ACTIVATION_RESERVE = 0.08


def device_hbm_bytes(device: str | torch.device | None = None) -> int:
    """The card's memory capacity (``torch.cuda.mem_get_info``'s total)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"{dev} has no device-memory budget; pass hbm_bytes explicitly")
    return int(torch.cuda.mem_get_info(dev)[1])


def tree_bytes(model: torch.nn.Module) -> int:
    """Bytes a model holds: its parameters and buffers (a quantized base
    counts its int8 payload and f32 scales, the buffers it stores)."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def page_bytes(model_cfg, page_size: int, kv_quant: str = "none") -> int:
    """Bytes one KV page costs across ALL layers (k + v)."""
    per_layer_one = model_cfg.num_kv_heads * page_size * model_cfg.head_dim
    if kv_quant == "int8":
        # int8 payload + f32 per-token absmax scales [K, P, ps, 1]
        one = per_layer_one * 1 + model_cfg.num_kv_heads * page_size * 4
    else:
        one = per_layer_one * 2  # bf16
    return one * 2 * model_cfg.num_layers


def kv_pool_pages(
    model_cfg,
    *,
    gpu_usage: float,
    param_bytes: int,
    batch_prompts: int,
    max_prompt_tokens: int,
    max_new_tokens: int,
    page_size: int,
    kv_quant: str = "none",
    spec_draft: int = 0,
    hbm_bytes: int | None = None,
    device: str | torch.device | None = None,
    continuous: bool = False,
    prefix_cache: bool = False,
) -> int:
    """Pages available to the refill decode pool under ``gpu_usage``.

    Subtracts, in order: the (1 - usage) exclusion the knob demands, the
    activation reserve, resident weights, and the shared prompt page region
    (batch_prompts x prompt_pages, which prefill owns regardless of the
    pool). With ``continuous`` (continuous admission) prompt chains are
    allocated from the pool, so no static region is subtracted and the
    single-sequence floor carries one prompt chain; ``prefix_cache`` keeps
    one more chain resident in the same pool, so it raises the floor by
    another. Clamped below at that floor, so a too-small budget degrades to
    serial decoding instead of refusing to run (with a warning naming the
    shortfall). ``hbm_bytes`` defaults to ``device``'s memory."""
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes(device)
    pb = page_bytes(model_cfg, page_size, kv_quant)
    prompt_pages = pages_per_seq(max_prompt_tokens, page_size)
    shared_bytes = 0 if continuous else batch_prompts * prompt_pages * pb
    budget = int(hbm * (gpu_usage - ACTIVATION_RESERVE) - param_bytes - shared_bytes)
    pool = budget // pb if budget > 0 else 0
    private_pages = 1 + pages_per_seq(max_new_tokens + max(spec_draft, 0), page_size)
    floor = (1 + private_pages + (prompt_pages if continuous else 0)
             + (prompt_pages if prefix_cache else 0))
    if pool < floor:
        log.warning(
            "gpu_usage=%.2f leaves %d KV pages (< single-sequence minimum %d) "
            "after %.2f GiB weights on %.2f GiB of device memory; clamping — "
            "decode will serialize",
            gpu_usage, pool, floor, param_bytes / 1024**3, hbm / 1024**3,
        )
        return floor
    return pool
