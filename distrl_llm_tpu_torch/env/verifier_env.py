"""The verifier-feedback environment: critique, re-prompt, reward the
improvement (the JAX package's ``env/verifier_env.py``).

Each turn the verifier extracts the model's answer and checks it against
the solution; when it is wrong and turns remain, it injects a critique and
asks for another try. The turn's reward is the change in the format score
from the previous attempt (the first turn: the score itself); terminal
accuracy rides in ``info["accuracy"]``. With the paged engine's turn hook
each retry continues the same KV: the critique is appended to the resident
conversation, not prefilled again.
"""

from __future__ import annotations

from typing import Any

from distrl_llm_tpu_torch.env.base import EnvStep
from distrl_llm_tpu_torch.rewards import (
    correctness_reward, extract_xml_answer, make_format_scorer,
)


class VerifierFeedbackEnv:
    """Multi-turn verifier loop: a wrong answer gets a critique and a retry."""

    name = "verifier"

    def __init__(self, format_scorer: str = "soft", max_turns: int = 4):
        self.max_turns = max(1, int(max_turns))
        self._fmt = make_format_scorer(format_scorer)
        self._task: dict[str, Any] | None = None
        self._turn = 0
        self._prev_score: float | None = None

    def reset(self, task: dict[str, Any]) -> str:
        self._task = dict(task)
        self._turn = 0
        self._prev_score = None
        return str(task.get("problem", ""))

    def step(self, completion: str) -> EnvStep:
        if self._task is None:
            raise RuntimeError("step() before reset()")
        self._turn += 1
        score = float(self._fmt([completion])[0])
        reward = score if self._prev_score is None else score - self._prev_score
        self._prev_score = score
        acc = float(correctness_reward([completion], [str(self._task.get("solution", ""))])[0])
        if acc == 1.0 or self._turn >= self.max_turns:
            return EnvStep(None, reward, True,
                           {"accuracy": acc, "verdict": "correct" if acc == 1.0 else "incorrect"})
        answer = extract_xml_answer(completion) or "<missing>"
        critique = (
            f"\nVerifier: answer {answer!r} is incorrect. Re-check your reasoning "
            "and reply again with <think>...</think> then <answer>...</answer>.\n"
        )
        return EnvStep(critique, reward, False,
                       {"tool_call_id": f"verify-{self._turn}", "verdict": "incorrect"})
