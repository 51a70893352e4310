"""Driver-side reward shaping: baselines, GRPO advantages, top-k filtering.

Host code copied from the JAX package's ``shaping.py`` (the port imports
nothing of that package; numpy only). It yields the learner's
coefficients: reward − group mean for PG, normalized advantages for GRPO.

Parity with the reference Trainer's inline numpy blocks
(distributed_trainer.py:262–294). Shaping runs on the host between the rollout
round and the learner step; arrays are small (batch·n scalars) so there is
nothing to jit here.

Contract recap (SURVEY §3.6.7): per-candidate rewards arrive as (n, 2) arrays —
column 0 format, column 1 accuracy. Training consumes the row sum; metrics
split the columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, MutableMapping, Sequence

import numpy as np


@dataclass
class ShapingStats:
    """Per-round metric accumulators matching the reference's lists
    (distributed_trainer.py:256–260)."""

    mean_acc: list[float] = field(default_factory=list)
    max_acc: list[float] = field(default_factory=list)
    min_acc: list[float] = field(default_factory=list)
    mean_format: list[float] = field(default_factory=list)
    mean_token_length: list[float] = field(default_factory=list)


def shape_rewards(
    candidates: Sequence[MutableMapping[str, Any]],
    learner_type: str,
) -> ShapingStats:
    """Shape each task group's (n, 2) rewards in place and collect metrics.

    PG: ``rewards`` ← per-candidate summed reward, plus a ``baselines`` list of
    group means (subtracted later in the learner — distributed_trainer.py:277–279).
    GRPO: ``rewards`` ← (r − mean)/(std + 1e-8) group-normalized advantages
    (:273, :275–276). Metrics mirror :266–272.
    """
    stats = ShapingStats()
    for cand in candidates:
        baselines, summed, advantages = [], [], []
        for group_reward, group_tokens in zip(cand["rewards"], cand["token_lengths"]):
            group_reward = np.asarray(group_reward)
            total = group_reward.sum(axis=1)
            mean = float(np.mean(total))
            baselines.append(mean)
            summed.append(total)
            advantages.append((total - mean) / (np.std(total) + 1e-8))

            stats.mean_acc.append(float(np.mean(group_reward[:, 1])))
            stats.max_acc.append(float(np.max(group_reward[:, 1])))
            stats.min_acc.append(float(np.min(group_reward[:, 1])))
            stats.mean_format.append(float(np.mean(group_reward[:, 0])))
            stats.mean_token_length.append(float(np.mean(group_tokens)))

        if learner_type == "grpo":
            cand["rewards"] = advantages
        else:
            cand["baselines"] = baselines
            cand["rewards"] = summed
    return stats


def topk_filter(candidates: Sequence[MutableMapping[str, Any]], topk: int) -> None:
    """Keep the top-k candidates per task group by shaped reward, in place
    (distributed_trainer.py:281–294). Answers and rewards are selected by
    argsort; problems are truncated, not reordered — safe because every entry
    in a group is the identical prompt (SURVEY §3.6.5)."""
    for cand in candidates:
        kept_answers, kept_rewards, kept_problems = [], [], []
        kept_tokens, kept_logps, kept_lens, kept_tags = [], [], [], []
        kept_masks = []
        has_raw = "answer_tokens" in cand
        has_tags = "version_tags" in cand
        has_mask = "loss_mask" in cand
        for j, rewards in enumerate(cand["rewards"]):
            idx = np.argsort(rewards)[-topk:]
            kept_answers.append([cand["answers"][j][i] for i in idx])
            kept_rewards.append(np.asarray(rewards)[idx])
            kept_problems.append(cand["problem"][j][:topk])
            if has_raw:  # raw engine tokens/logps follow the same selection
                kept_tokens.append(np.asarray(cand["answer_tokens"][j])[idx])
                kept_logps.append(np.asarray(cand["behavior_logps"][j])[idx])
                kept_lens.append(np.asarray(cand["gen_lengths"][j])[idx])
            if has_tags:  # policy-version tags stay row-aligned too
                kept_tags.append(np.asarray(cand["version_tags"][j])[idx])
            if has_mask:  # per-turn loss masks stay row-aligned too
                kept_masks.append(np.asarray(cand["loss_mask"][j])[idx])
        cand["answers"] = kept_answers
        cand["rewards"] = kept_rewards
        cand["problem"] = kept_problems
        if has_raw:
            cand["answer_tokens"] = kept_tokens
            cand["behavior_logps"] = kept_logps
            cand["gen_lengths"] = kept_lens
        if has_tags:
            cand["version_tags"] = kept_tags
        if has_mask:
            cand["loss_mask"] = kept_masks


def flatten_for_update(
    candidates: Sequence[MutableMapping[str, Any]], learner_type: str
) -> tuple[list[str], list[str], np.ndarray, dict | None]:
    """Flatten shaped candidates into (problems, answers, coefficients,
    raw_rollout) lists for the learner. PG applies reward − baseline here
    (distributed_actor.py:399–406); GRPO passes advantages through (:495–504).

    ``raw_rollout`` (None when the engine captured no logprobs) carries the
    engine's own answer token ids and behavior logprobs row-aligned with the
    text lists — the PPO-clip objective trains on these instead of
    retokenized text. When present, per-token policy-version tags
    (rollout/trajectory.py) ride along as ``version_tags``.

    ``group_weights`` on a candidate dict (the async staleness policy's
    down-weights, one per task group) scale that group's flattened
    coefficients — absent (every sync/pipelined round) the math is
    untouched."""
    problems: list[str] = []
    answers: list[str] = []
    coeffs: list[float] = []
    tokens: list[np.ndarray] = []
    logps: list[np.ndarray] = []
    tags: list[np.ndarray] = []
    masks: list[np.ndarray] = []
    lens: list[int] = []
    has_raw = all("answer_tokens" in c for c in candidates) and candidates
    has_tags = has_raw and all("version_tags" in c for c in candidates)
    has_mask = has_raw and all("loss_mask" in c for c in candidates)
    for cand in candidates:
        gw = cand.get("group_weights")
        if learner_type == "grpo":
            for j, (a, p, r) in enumerate(
                zip(cand["answers"], cand["problem"], cand["rewards"])
            ):
                problems.extend(p)
                answers.extend(a)
                w = 1.0 if gw is None else float(gw[j])
                coeffs.extend((np.asarray(r) * w).tolist())
                if has_raw:
                    tokens.extend(np.asarray(cand["answer_tokens"][j]))
                    logps.extend(np.asarray(cand["behavior_logps"][j]))
                    lens.extend(np.asarray(cand["gen_lengths"][j]).tolist())
                if has_tags:
                    tags.extend(np.asarray(cand["version_tags"][j]))
                if has_mask:
                    masks.extend(np.asarray(cand["loss_mask"][j]))
        else:
            for j, (a, p, r, b) in enumerate(
                zip(
                    cand["answers"], cand["problem"], cand["rewards"],
                    cand["baselines"],
                )
            ):
                problems.extend(p)
                answers.extend(a)
                w = 1.0 if gw is None else float(gw[j])
                coeffs.extend(((np.asarray(r) - b) * w).tolist())
                if has_raw:
                    tokens.extend(np.asarray(cand["answer_tokens"][j]))
                    logps.extend(np.asarray(cand["behavior_logps"][j]))
                    lens.extend(np.asarray(cand["gen_lengths"][j]).tolist())
                if has_tags:
                    tags.extend(np.asarray(cand["version_tags"][j]))
                if has_mask:
                    masks.extend(np.asarray(cand["loss_mask"][j]))
    raw = None
    if has_raw and tokens:
        raw = {
            "answer_tokens": np.asarray(tokens),
            "behavior_logps": np.asarray(logps, dtype=np.float32),
            "lengths": np.asarray(lens, dtype=np.int32),
        }
        if has_tags and tags:
            raw["version_tags"] = np.asarray(tags, dtype=np.int32)
        if has_mask and masks:
            # multi-turn env rounds (ISSUE 17): 1 on policy spans, 0 on
            # env-injected observation tokens — the learner multiplies this
            # into its answer mask so injected tokens never train
            raw["loss_mask"] = np.asarray(masks, dtype=np.int32)
    return problems, answers, np.asarray(coeffs, dtype=np.float32), raw
