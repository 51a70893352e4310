"""The paged wave engine with the round's rows split over the rollout ranks.

Counterpart of the JAX package's ``engine/sharded_paged.py``, one
``shard_map`` program over the rollout mesh's dp axis in which each dp
shard owns a LOCAL page pool and local page tables. Here each rollout rank
(one card) runs the port's paged wave engine over its share of the round's
rows, with its own page pool and page tables, kernels K1 and K2 on its own
card:

* the rows are padded (dead rows, mask 0) to a multiple of dp, and dp rank
  d takes the d-th contiguous share, as ``P("dp")`` lays them out;
* each rank samples from its own generator, seeded from (seed, dp index),
  the counterpart of folding ``axis_index("dp")`` into the step rng, so
  rows on different ranks draw independent noise;
* after the round (outside any captured decode chunk: a CUDA graph must not
  capture a collective) the shares are all-gathered over the dp group and
  concatenated in row order, the padding rows dropped.

Every rank of the rollout mesh must call ``generate``. Scope as in JAX: the
wave scheduler over a dp-only mesh (any other axis above 1 raises), no
speculative decoding; the trainer routes the whole round here (no hybrid
actor/learner split).
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import GenerationResult
from distrl_llm_tpu_torch.engine.paged_engine import PagedGenerationEngine


def rank_seed(seed: int, index: int) -> int:
    """The sampling seed of dp rank ``index`` for a round seeded ``seed``."""
    return int(np.random.SeedSequence((int(seed), int(index))).generate_state(
        1, np.uint64)[0] >> np.uint64(2))


class ShardedPagedEngine:
    """Paged wave generation with the rows split over ``mesh``'s dp ranks;
    other attributes are this rank's engine's (``local``)."""

    def __init__(self, cfg, mesh, *, spec_draft: int | None = None, **kwargs):
        if spec_draft:
            raise NotImplementedError(
                "speculative decoding runs on the refill scheduler of one engine; "
                "ShardedPagedEngine runs the wave scheduler over dp ranks")
        other = {k: v for k, v in mesh.shape.items() if k != "dp" and v > 1}
        if other:
            raise ValueError(
                f"ShardedPagedEngine shards over dp only; non-trivial axes {other} "
                "belong to per-replica engines")
        self.cfg = cfg
        self.mesh = mesh
        self.dp = mesh.dp
        self.local = PagedGenerationEngine(cfg, scheduler="waves", **kwargs)

    def __getattr__(self, name):  # the rest of the engine interface is the local engine's
        if name == "local":
            raise AttributeError(name)
        return getattr(self.local, name)

    @property
    def lora_swap_hook(self):
        return self.local.lora_swap_hook

    @lora_swap_hook.setter
    def lora_swap_hook(self, hook) -> None:  # the trainer's ring hears of the local swaps
        self.local.lora_swap_hook = hook

    def generate(self, model, lora, prompt_ids, prompt_mask, sampling: SamplingConfig,
                 seed: int) -> GenerationResult:
        b, p = prompt_ids.shape
        ids, mask = np.asarray(prompt_ids), np.asarray(prompt_mask)
        pad = (-b) % self.dp
        if pad:
            ids = np.concatenate([ids, np.zeros((pad, p), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, p), mask.dtype)])
        per = (b + pad) // self.dp
        d = self.mesh.coordinate()[0]
        res = self.local.generate(model, lora, ids[d * per:(d + 1) * per],
                                  mask[d * per:(d + 1) * per], sampling, rank_seed(seed, d))
        if self.mesh.device_mesh is None:
            return res
        shares = [None] * self.dp
        dist.all_gather_object(shares, (res.tokens, res.lengths, res.logprobs,
                                        res.steps_dispatched), group=self.mesh.group("dp"))
        logps = [s[2] for s in shares]
        return GenerationResult(
            tokens=np.concatenate([s[0] for s in shares])[:b],
            lengths=np.concatenate([s[1] for s in shares])[:b],
            steps_dispatched=sum(s[3] for s in shares),
            logprobs=None if logps[0] is None else np.concatenate(logps)[:b])
