"""The single-turn math environment: the trainer's scoring behind the
protocol (the JAX package's ``env/math_env.py``).

``env="math"`` is the default and takes the trainer's single-turn path (no
driver is armed; ``RewardComputer`` scores whole groups). This class
expresses the same task through the protocol, scoring one completion as
the batch ``reward_function`` does: one step, reward = the format column,
accuracy in ``info``.
"""

from __future__ import annotations

from typing import Any

from distrl_llm_tpu_torch.env.base import EnvStep
from distrl_llm_tpu_torch.rewards import make_reward_function


class MathSingleTurnEnv:
    """One completion, one regex-scored step, done."""

    name = "math"

    def __init__(self, format_scorer: str = "soft", max_turns: int = 1):
        del max_turns  # always single-turn
        self._reward_fn = make_reward_function(format_scorer)
        self._task: dict[str, Any] | None = None
        self._stepped = False

    def reset(self, task: dict[str, Any]) -> str:
        self._task = dict(task)
        self._stepped = False
        return str(task.get("problem", ""))

    def step(self, completion: str) -> EnvStep:
        if self._task is None:
            raise RuntimeError("step() before reset()")
        if self._stepped:
            raise RuntimeError("math env is single-turn; episode already done")
        self._stepped = True
        row = self._reward_fn([completion], [str(self._task.get("solution", ""))])
        fmt, acc = float(row[0, 0]), float(row[0, 1])
        return EnvStep(observation=None, reward=fmt, done=True, info={"accuracy": acc})
