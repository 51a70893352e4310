"""Rule-based rewards for R1-style math reasoning completions.

Behavioral parity with the reference's reward_functions.py (BY571/DistRL-LLM):
the public contract is ``reward_function(completions, solutions) ->
np.ndarray[N, 2]`` with column 0 = format reward (soft format + XML tag count)
and column 1 = accuracy (exact answer match) — reward_functions.py:44–49.
Training consumes the row *sum*; logging and eval read the columns separately
(distributed_trainer.py:267–274, :403–405), so the 2-column shape is load-bearing.

Deliberate parity quirks preserved (SURVEY §2a#9):
  * ``soft_format_reward`` uses ``re.match`` with no DOTALL — the pattern is
    anchored at the start of the completion and ``.`` does not cross newlines
    (reward_functions.py:20–24), so multi-line ``<think>`` bodies score 0.
  * ``count_xml`` penalises trailing text after ``</answer>`` at 0.001/char
    (reward_functions.py:26–38).

Host-side addition: reward computation was the reference's trainer-side hot
loop (single-threaded regex over batch·n completions). ``RewardComputer`` fans
batches out over host processes. This module is host code copied from the JAX
package's ``rewards.py``; the port imports nothing of that package.
"""

from __future__ import annotations

import multiprocessing
import re
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import Sequence

import numpy as np

_SOFT_FORMAT_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>")


def extract_xml_answer(text: str) -> str:
    """Text between the last ``<answer>`` and the next ``</answer>``, stripped
    (reward_functions.py:4–7)."""
    tail = text.rsplit("<answer>", 1)[-1]
    return tail.split("</answer>", 1)[0].strip()


def correctness_reward(completions: Sequence[str], solutions: Sequence[str]) -> np.ndarray:
    """1.0 per exact string match of the extracted answer (reward_functions.py:9–11)."""
    return np.asarray(
        [1.0 if extract_xml_answer(c) == s else 0.0 for c, s in zip(completions, solutions)],
        dtype=np.float64,
    )


def soft_format_reward(completions: Sequence[str]) -> np.ndarray:
    """0.1 if the completion starts with single-line think/answer tags
    (reward_functions.py:20–24; anchored match, no DOTALL — parity quirk)."""
    return np.asarray(
        [0.1 if _SOFT_FORMAT_RE.match(c) else 0.0 for c in completions], dtype=np.float64
    )


def strict_format_reward(completions: Sequence[str]) -> np.ndarray:
    """Strict newline-delimited variant (reward_functions.py:14–18). Defined for
    API parity; the reference never wires it into ``reward_function``."""
    pattern = re.compile(r"^<think>\n.*?\n</think>\n<answer>\n.*?\n</answer>\n$")
    return np.asarray(
        [0.1 if pattern.match(c) else 0.0 for c in completions], dtype=np.float64
    )


def _count_xml(text: str) -> float:
    """Per-tag shaping: +0.05 per well-formed tag occurrence, minus a length
    penalty for text trailing the closing answer tag (reward_functions.py:26–38)."""
    score = 0.0
    if text.count("<think>\n") == 1:
        score += 0.05
    if text.count("\n</think>\n") == 1:
        score += 0.05
    if text.count("\n<answer>\n") == 1:
        score += 0.05
        score -= len(text.split("\n</answer>\n")[-1]) * 0.001
    if text.count("\n</answer>") == 1:
        score += 0.05
        score -= (len(text.split("\n</answer>")[-1]) - 1) * 0.001
    return score


def xmlcount_reward(completions: Sequence[str]) -> np.ndarray:
    return np.asarray([_count_xml(c) for c in completions], dtype=np.float64)


def reward_function(completions: Sequence[str], solutions: Sequence[str]) -> np.ndarray:
    """The (N, 2) reward contract: column 0 = format (soft + xmlcount),
    column 1 = accuracy (reward_functions.py:44–49)."""
    accuracy = correctness_reward(completions, solutions)
    fmt = soft_format_reward(completions) + xmlcount_reward(completions)
    return np.column_stack((fmt, accuracy))


def strict_reward_function(
    completions: Sequence[str], solutions: Sequence[str]
) -> np.ndarray:
    """(N, 2) contract with the strict newline-delimited format gate in
    column 0 — makes ``strict_format_reward`` a selectable scorer
    (``format_reward="strict"``) instead of dead parity code. Module-level so
    ``RewardComputer``'s process pool can pickle it."""
    accuracy = correctness_reward(completions, solutions)
    fmt = strict_format_reward(completions) + xmlcount_reward(completions)
    return np.column_stack((fmt, accuracy))


def soft_format_scorer(completions: Sequence[str]) -> np.ndarray:
    """Format column of :func:`reward_function` alone (soft + xmlcount)."""
    return soft_format_reward(completions) + xmlcount_reward(completions)


def strict_format_scorer(completions: Sequence[str]) -> np.ndarray:
    """Format column of :func:`strict_reward_function` alone."""
    return strict_format_reward(completions) + xmlcount_reward(completions)


_FORMAT_SCORERS = {"soft": soft_format_scorer, "strict": strict_format_scorer}
_REWARD_FUNCTIONS = {"soft": reward_function, "strict": strict_reward_function}


def make_format_scorer(name: str = "soft"):
    """Per-completion format scorer used by env-routed scoring (column 0)."""
    try:
        return _FORMAT_SCORERS[name]
    except KeyError:
        raise ValueError(
            f"unknown format scorer {name!r}; available: soft, strict"
        ) from None


def make_reward_function(name: str = "soft"):
    """Select the (N, 2) reward function by format gate. ``"soft"`` returns
    :func:`reward_function` itself — the identical object, so the default
    config keeps byte-identity with pre-env trainers."""
    try:
        return _REWARD_FUNCTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown format reward {name!r}; available: soft, strict"
        ) from None


def _reward_task(fn, args: tuple[Sequence[str], Sequence[str]]) -> np.ndarray:
    return fn(*args)


class RewardComputer:
    """Host-parallel reward evaluation over many (completions, solutions) groups.

    The reference computes rewards serially in the trainer process
    (distributed_trainer.py:205–219). On a host with dozens of cores we fan
    groups out across processes; for small workloads the serial path avoids
    pool overhead.

    ``reward_fn`` is the function actually evaluated — the trainer builds the
    computer around its ``reward_function`` argument (the reference's
    ``Trainer(train_ds, test_ds, reward_fn, config)`` contract,
    distributed_trainer.py:14), defaulting to the parity ``reward_function``.
    The parallel path pickles the fn to worker processes, so custom fns must
    be module-level for ``num_workers > 0`` (closures work on the serial path).
    """

    def __init__(self, num_workers: int = 0, parallel_threshold: int = 256,
                 reward_fn=None):
        self.num_workers = num_workers
        self.parallel_threshold = parallel_threshold
        # distinguishes "caller explicitly chose a fn" from the default, so a
        # Trainer can refuse a genuine conflict without mutating a computer
        # that is shared across Trainers
        self.fn_explicit = reward_fn is not None
        self.reward_fn = reward_fn if reward_fn is not None else reward_function
        self._pool: ProcessPoolExecutor | None = None

    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            # spawn, not fork: the trainer has a live CUDA context by the time
            # rewards are computed, and forking after CUDA init is unsupported.
            ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(max_workers=self.num_workers, mp_context=ctx)
        return self._pool

    def __call__(
        self,
        groups: Sequence[tuple[Sequence[str], Sequence[str]]],
        reward_fn=None,
    ) -> list[np.ndarray]:
        fn = reward_fn if reward_fn is not None else self.reward_fn
        total = sum(len(c) for c, _ in groups)
        if self.num_workers and total >= self.parallel_threshold:
            task = partial(_reward_task, fn)
            return list(self._ensure_pool().map(task, groups))
        return [fn(c, s) for c, s in groups]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
