"""The rollout regimes' data plane: versioned trajectories, a bounded
trajectory buffer, a bounded-staleness admission policy and the producer
service that decouples generation from learning (``rollout_mode="async"``),
the counterpart of the JAX package's ``rollout/``; and the ring of pushed
adapters both overlapped modes sample from.

* :mod:`trajectory` — the versioned Trajectory record (tokens, per-token
  behavior logprobs and policy-version tags);
* :mod:`buffer` — bounded FIFO with watermarked backpressure,
  staleness-aware eviction and drop accounting;
* :mod:`staleness` — drop or down-weight beyond ``max_staleness``;
* :mod:`service` — the producer thread streaming completed groups into the
  buffer;
* :mod:`adapter_ring` — the learner's pushes copied into persistent
  buffers, ordered against the rollout's CUDA stream by events.
"""

from distrl_llm_tpu_torch.rollout.adapter_ring import AdapterRing
from distrl_llm_tpu_torch.rollout.buffer import TrajectoryBuffer
from distrl_llm_tpu_torch.rollout.service import RolloutService
from distrl_llm_tpu_torch.rollout.staleness import StalenessPolicy
from distrl_llm_tpu_torch.rollout.trajectory import (
    Trajectory,
    round_to_trajectories,
    trajectories_to_candidates,
    version_tags_for_round,
)

__all__ = [
    "AdapterRing",
    "Trajectory",
    "TrajectoryBuffer",
    "RolloutService",
    "StalenessPolicy",
    "round_to_trajectories",
    "trajectories_to_candidates",
    "version_tags_for_round",
]
