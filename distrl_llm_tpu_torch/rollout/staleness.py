"""Bounded-staleness admission policy: drop or down-weight trajectories
whose sampling policy lags the learner by more than K optimizer steps (JAX
``rollout/staleness.py``).

The regime knob of the async rollout service (LlamaRL's AIPO section /
Laminar's bounded-staleness scheduler): ``max_staleness=K`` bounds how
off-policy trained data may be. The two modes split the enforcement level:

* ``mode="drop"`` — TOKEN-level bound: a group is admitted as long as ANY
  of its real tokens is within K (keyed on ``Trajectory.max_version``, the
  freshest token), and the AIPO objective's per-token version-lag mask
  (learner/losses.py::grpo_aipo_loss) removes the individual tokens beyond
  K — so a mixed-version trajectory from in-flight weight swaps trains its
  fresh segment instead of being discarded whole. Only groups with NO
  token inside the bound are dropped (counted, never silent).
* ``mode="downweight"`` — GROUP-level fade: everything trains, but a group
  whose STALEST token (``Trajectory.min_version``) lags beyond K has its
  flattened update coefficients scaled by ``downweight ** (lag − K)`` — a
  geometric fade that keeps overflow data contributing without letting it
  dominate. The token mask is disabled in this mode (the trainer passes
  ``max_staleness=0`` to the objective): masking the very tokens the fade
  admitted would silently turn downweight back into drop.

Either way the per-token importance ratio stays exact — both objectives
ratio against the behavior logprob captured from the adapter that actually
sampled each token.

Every admission decision is telemetered: the realized stalest-token lag of
each admitted group feeds the ``rollout/staleness`` histogram, drops feed
``rollout/dropped_stale``. The lineage ledger's admission stamps are ROADMAP
queue 1 item 11(b).
"""

from __future__ import annotations

from typing import Sequence

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.rollout.buffer import ROLLOUT_DROPPED_STALE
from distrl_llm_tpu_torch.rollout.trajectory import Trajectory

# the admitted-group stalest-token-lag histogram. Single owner here:
# admission is the one place a group's realized lag is decided.
ROLLOUT_STALENESS = "rollout/staleness"


class StalenessPolicy:
    """Admission policy over pulled trajectory groups."""

    def __init__(self, max_staleness: int, *, mode: str = "drop",
                 downweight: float = 0.5):
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}"
            )
        if mode not in ("drop", "downweight"):
            raise ValueError(
                f"staleness mode must be 'drop' or 'downweight', got {mode!r}"
            )
        if not 0.0 < downweight <= 1.0:
            raise ValueError(
                f"downweight must be in (0, 1], got {downweight}"
            )
        self.max_staleness = max_staleness
        self.mode = mode
        self.downweight = downweight
        self.dropped = 0  # cumulative, run-total
        self.admitted = 0

    def lag_of(self, traj: Trajectory, learner_version: int) -> int:
        """Stalest-token lag of a group: learner version minus the OLDEST
        version any of its real tokens was sampled under — what the
        staleness histogram reports and the downweight fade keys on.
        Negative lag (trajectory tagged ahead of the learner) is
        version-bookkeeping corruption upstream; clamp to 0 so the
        histogram stays interpretable — the trainer's StaleWeightsError is
        the detector for that bug."""
        return max(learner_version - traj.min_version, 0)

    def freshest_lag_of(self, traj: Trajectory, learner_version: int) -> int:
        """Freshest-token lag — what drop-mode admission keys on: a group
        is trainable iff at least one token is within the bound (the AIPO
        per-token mask trims the rest)."""
        return max(learner_version - traj.max_version, 0)

    def admit(
        self, trajs: Sequence[Trajectory], learner_version: int
    ) -> tuple[list[Trajectory], list[float]]:
        """Filter/weight one pulled batch. Returns (kept, group_weights).
        Drop mode: groups with no token inside the bound vanish (counted);
        admitted groups carry weight 1.0 — their stale-beyond-K tokens are
        removed per-token by the objective's version-lag mask, not here.
        Downweight mode: everything is kept; weights fade geometrically by
        the stalest-token lag beyond the bound."""
        kept: list[Trajectory] = []
        weights: list[float] = []
        for traj in trajs:
            lag = self.lag_of(traj, learner_version)
            if (
                self.mode == "drop"
                and self.freshest_lag_of(traj, learner_version)
                > self.max_staleness
            ):
                self.dropped += 1
                telemetry.counter_add(ROLLOUT_DROPPED_STALE)
                continue
            telemetry.hist_observe(ROLLOUT_STALENESS, float(lag))
            self.admitted += 1
            kept.append(traj)
            weight = (
                self.downweight ** (lag - self.max_staleness)
                if self.mode == "downweight" and lag > self.max_staleness
                else 1.0
            )
            weights.append(weight)
        return kept, weights
