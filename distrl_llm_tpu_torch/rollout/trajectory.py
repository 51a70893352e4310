"""The versioned Trajectory record: one task group's rollout, self-describing
enough to train on at any later optimizer step (JAX
``rollout/trajectory.py:27-231``, the same records and functions).

A Trajectory is one PROMPT GROUP (the n candidates sampled for one task) —
the unit the buffer stores and the staleness policy admits, because GRPO's
advantages are group-normalized and splitting a group across updates would
change the baseline.

Per-token POLICY-VERSION TAGS generalize the in-flight-update machinery:
``push_lora`` already captures behavior logprobs per sampling adapter; the
tags record WHICH adapter (the learner's ``weight_version``) sampled each
position, so a trajectory that spans K in-flight weight swaps carries its
full provenance. The learner derives per-token version lag from them
(``UpdateBatch.version_lag``) and the AIPO/truncated-IS objective drops or
down-weights stale-beyond-K tokens (learner/losses.py::grpo_aipo_loss).

The multi-turn fields (``loss_mask``, ``rewards``, the turn provenance in
``meta``) and the turn-aware version bounds are carried as data: the
environments' driver (``env/driver.py``) fills them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np


@dataclass
class Trajectory:
    """One task group's completed rollout.

    ``tokens``/``lengths``/``behavior_logps`` are the ENGINE's raw arrays
    (GenerationResult row ``b``): training on them instead of retokenized
    text keeps per-token importance ratios aligned (trainer.py contract).
    ``version_tags`` is [n, T] int32 — the policy version that sampled each
    position (columns past a row's length are padding and carry whatever the
    round-level tags say; masked out downstream).
    """

    problem: str
    solution: str
    answers: list[str]  # n decoded candidate strings
    token_lengths: list[int]  # per-candidate generated token counts
    tokens: np.ndarray | None = None  # [n, T] raw engine ids
    lengths: np.ndarray | None = None  # [n]
    behavior_logps: np.ndarray | None = None  # [n, T] f32
    version_tags: np.ndarray | None = None  # [n, T] int32
    # multi-turn env rounds: [n, T] 1 on policy-generated spans,
    # 0 on environment-injected observation tokens — those never train and
    # never vote in the staleness verdict (their "version" is the injection
    # step, not a sampling event)
    loss_mask: np.ndarray | None = None
    # env-scored rounds carry their (n, 2) rewards with them (column 0 =
    # summed per-turn shaped rewards, column 1 = terminal accuracy): the
    # environment consumed each turn as it happened, so the consumer side
    # must not re-score decoded text
    rewards: np.ndarray | None = None
    produced_version: int = 0  # weight version at round entry
    episode: int = 0
    batch_index: int = 0
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.answers)

    def _version_bounds(self) -> tuple[int, int]:
        """(oldest, newest) policy version over REAL tokens, computed once
        and cached — the buffer's eviction scan reads these under its lock
        every learner iteration, and a trajectory's tags are immutable
        after construction, so the O(n·T) reduction must not repeat."""
        cached = self.__dict__.get("_version_bounds_cache")
        if cached is not None:
            return cached
        if self.version_tags is None:
            bounds = (self.produced_version, self.produced_version)
        else:
            tags = np.asarray(self.version_tags)
            if self.lengths is None:
                mask = np.ones(tags.shape, bool)
            else:
                mask = np.arange(tags.shape[1])[None, :] < np.asarray(
                    self.lengths
                )[:, None]
            if self.loss_mask is not None:
                # turn-aware verdicts: only POLICY tokens vote —
                # env-injected observation spans are excluded, so a stale
                # observation cannot age a group whose policy spans are fresh
                mask = mask & (np.asarray(self.loss_mask) > 0)
            bounds = (
                (int(tags[mask].min()), int(tags[mask].max()))
                if mask.any()
                else (self.produced_version, self.produced_version)
            )
        self.__dict__["_version_bounds_cache"] = bounds
        return bounds

    @property
    def min_version(self) -> int:
        """Oldest policy version any REAL token was sampled under — what
        the staleness histogram reports and the downweight fade keys on
        (the group is only as fresh as its stalest token)."""
        return self._version_bounds()[0]

    @property
    def max_version(self) -> int:
        """Newest policy version any REAL token was sampled under — what
        drop-mode admission keys on (a group is worth training if ANY of
        its tokens is within the staleness bound; the AIPO objective's
        per-token lag mask trims the rest)."""
        return self._version_bounds()[1]


def version_tags_for_round(
    n_rows: int,
    max_steps: int,
    base_version: int,
    swap_events: Sequence[tuple[int, int]] = (),
) -> np.ndarray:
    """[n_rows, max_steps] per-position policy-version tags for one round.

    ``swap_events`` is [(step, version), ...] in dispatch order, with the
    engine mailbox's recorded semantics (LoraMailbox._take_pending_lora): a swap recorded at step ``s`` lands on
    the FORWARD of step ``s``, whose logits sample the token at position
    ``s+1`` — so positions <= s were decoded under the pre-swap adapter and
    positions > s under the new one. Step indices are dense-engine decode
    positions; for the refill scheduler they are dispatch steps, an
    approximation that is exact for rows admitted at round start (the
    behavior logprobs, not the tags, are what keep per-token ratios exact).
    """
    tags = np.full((n_rows, max_steps), base_version, np.int32)
    for step, version in swap_events:
        if step + 1 < max_steps:
            tags[:, step + 1:] = version
    return tags


def round_to_trajectories(
    cand: dict[str, Any],
    *,
    base_version: int,
    swap_events: Sequence[tuple[int, int]] = (),
    episode: int = 0,
    batch_index: int = 0,
) -> list[Trajectory]:
    """Split one rollout round's candidate dict (trainer._generate_round
    output shape) into per-group Trajectory records tagged with the policy
    versions that sampled them."""
    has_raw = "answer_tokens" in cand
    out: list[Trajectory] = []
    for j in range(len(cand["answers"])):
        tokens = lengths = logps = tags = None
        if has_raw:
            tokens = np.asarray(cand["answer_tokens"][j])
            lengths = np.asarray(cand["gen_lengths"][j])
            logps = np.asarray(cand["behavior_logps"][j])
            if "version_tags" in cand:  # the round already tagged itself
                tags = np.asarray(cand["version_tags"][j])
            else:
                tags = version_tags_for_round(
                    tokens.shape[0], tokens.shape[1], base_version, swap_events
                )
        # env-routed rounds: per-group loss masks, pre-computed
        # rewards and per-turn provenance ride the trajectory
        loss_mask = (
            np.asarray(cand["loss_mask"][j]) if "loss_mask" in cand else None
        )
        rewards = (
            np.asarray(cand["rewards"][j]) if "rewards" in cand else None
        )
        meta: dict[str, Any] = {}
        if "turns" in cand:
            meta["turns"] = cand["turns"][j]
        if "env_name" in cand:
            meta["env_name"] = cand["env_name"]
        out.append(Trajectory(
            problem=cand["problem"][j][0],
            solution=cand["solution"][j][0],
            answers=list(cand["answers"][j]),
            token_lengths=list(cand["token_lengths"][j]),
            tokens=tokens,
            lengths=lengths,
            behavior_logps=logps,
            version_tags=tags,
            loss_mask=loss_mask,
            rewards=rewards,
            produced_version=base_version,
            episode=episode,
            batch_index=batch_index,
            meta=meta,
        ))
    return out


def trajectories_to_candidates(
    trajs: Sequence[Trajectory],
    group_weights: Sequence[float] | None = None,
) -> dict[str, Any]:
    """Reassemble pulled trajectories into the candidate-dict shape the
    trainer's reward/shaping/update pipeline consumes (the inverse of
    ``round_to_trajectories``). ``group_weights`` (the staleness policy's
    down-weights) ride along and are folded into the flattened update
    coefficients by ``shaping.flatten_for_update``."""
    cand: dict[str, Any] = {
        "answers": [t.answers for t in trajs],
        "problem": [[t.problem] * t.n for t in trajs],
        "solution": [[t.solution] * t.n for t in trajs],
        "token_lengths": [t.token_lengths for t in trajs],
    }
    if all(t.tokens is not None for t in trajs) and trajs:
        cand["answer_tokens"] = [t.tokens for t in trajs]
        cand["behavior_logps"] = [t.behavior_logps for t in trajs]
        cand["gen_lengths"] = [t.lengths for t in trajs]
        cand["version_tags"] = [t.version_tags for t in trajs]
    if all(t.loss_mask is not None for t in trajs) and trajs:
        cand["loss_mask"] = [t.loss_mask for t in trajs]
    if all(t.rewards is not None for t in trajs) and trajs:
        # env-scored groups: the trainer's reward pass must not re-score
        cand["rewards"] = [t.rewards for t in trajs]
    if trajs and all("turns" in t.meta for t in trajs):
        # per-turn provenance + env label resurface so consumed batches
        # keep their env/* metrics and lineage columns in async mode
        cand["turns"] = [t.meta["turns"] for t in trajs]
        env_name = next(
            (t.meta.get("env_name") for t in trajs if t.meta.get("env_name")),
            None,
        )
        if env_name is not None:
            cand["env_name"] = env_name
    if group_weights is not None:
        cand["group_weights"] = [float(w) for w in group_weights]
    return cand
