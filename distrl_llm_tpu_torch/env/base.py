"""The environment protocol of multi-turn rollouts (the JAX package's
``env/base.py``).

An :class:`Environment` owns the task's half of an episode: it hands the
rollout driver the first observation (the prompt), scores each policy turn
and decides whether to inject a new observation (tool output, a verifier's
critique) or end the episode. The engine's half, keeping the conversation's
KV resident across turns, is the paged engine's ``turn_hook``
(``engine/paged_engine.py``); the glue is ``env/driver.py``.

* ``reset(task) -> str``: the first observation. The shipped environments
  return ``task["problem"]`` verbatim, so the prompt is encoded on the
  trainer's usual path.
* ``step(completion) -> EnvStep``: consume one policy turn.
  ``observation`` is the text injected before the next turn, or ``None``
  once the episode is over; ``reward`` is the turn's shaped reward (column
  0 of the (n, 2) reward contract), and terminal accuracy rides in
  ``info["accuracy"]`` (column 1).

Environments are cheap, single-use and stateful: the driver builds one per
candidate per round. They run on the host between engine turns and touch no
tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable


@dataclass
class EnvStep:
    """What consuming one policy turn gives: ``observation`` (the next
    turn's injected, loss-masked context, or ``None`` when done), the
    turn's shaped ``reward`` (never terminal accuracy, which belongs in
    ``info["accuracy"]``) and ``info``: ``tool_call_id`` for tool
    environments, ``verdict`` for the verifier, ``accuracy`` at the end."""

    observation: str | None
    reward: float
    done: bool
    info: dict[str, Any] = field(default_factory=dict)


@dataclass
class TurnRecord:
    """One policy turn of an episode, in answer-token coordinates:
    ``policy_span`` is the half-open [start, end) of the tokens the policy
    generated this turn, ``env_span`` the observation injected after it
    (``None`` on the last turn). Spans index the engine's per-candidate
    answer row, which the loss mask and the provenance share."""

    index: int
    policy_span: tuple[int, int]
    env_span: tuple[int, int] | None
    reward: float
    tool_call_id: str | None
    info: dict[str, Any] = field(default_factory=dict)


@dataclass
class EpisodeState:
    """The driver's record of one candidate's episode across turns."""

    task: dict[str, Any]
    turns: list[TurnRecord] = field(default_factory=list)
    done: bool = False
    truncated: bool = False
    accuracy: float = 0.0

    @property
    def total_reward(self) -> float:
        return float(sum(t.reward for t in self.turns))

    @property
    def num_turns(self) -> int:
        return len(self.turns)


@runtime_checkable
class Environment(Protocol):
    """The protocol every pluggable environment implements."""

    name: str

    def reset(self, task: dict[str, Any]) -> str:
        """Begin an episode; return the first observation (the prompt)."""
        ...

    def step(self, completion: str) -> EnvStep:
        """Consume one policy completion; return the next observation."""
        ...
