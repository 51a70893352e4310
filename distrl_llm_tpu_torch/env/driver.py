"""The multi-turn rollout driver: the glue between the environments and the
engine (the JAX package's ``env/driver.py``).

The paged engine has a ``turn_hook`` (``engine/paged_engine.py``): when a
candidate's generation hits EOS with the hook armed, the refill scheduler's
idle pass calls ``hook(cand_id, gen_tokens)``. Observation tokens returned
make the engine resume the same slot: the observation is appended to the
resident KV (one chunked forward over its tokens, no second prefill of the
conversation) and decoding continues. ``None`` lets the candidate finish.
The engine calls ``hook.declined(cand_id)`` when it took an observation but
could not seat it (no token room, no pages), so the driver can take the
span back.

:class:`EnvRolloutDriver` is that hook. A round, it owns one environment per
candidate, tracks each turn's token spans in answer-token coordinates, times
``env.step`` and, once the engine returns, assembles:

* a ``loss_mask`` [rows, max_new_tokens]: 1 on the policy's spans, 0 on the
  injected tokens (observations never train);
* per group, (n, 2) rewards: column 0 the summed per-turn shaped rewards,
  column 1 terminal accuracy (the single-turn contract);
* per candidate, the turns' provenance (index, spans, tool-call id).

A group closes when all its candidates finish, whatever their turn counts:
the engine's per-candidate finish accounting handles episodes of different
lengths, so no slot waits on a group.

Its ``env/*`` series go to the port's telemetry registry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.env.base import EpisodeState, TurnRecord
from distrl_llm_tpu_torch.env.registry import get_env_class

# env/* telemetry series (this module is their one owner)
ENV_TURNS = "env/turns"  # histogram: policy turns per finished episode
ENV_STEP_MS = "env/step_ms"  # histogram: env.step wall time
ENV_TOOL_CALLS = "env/tool_calls"  # counter: sandboxed tool executions
ENV_EPISODES = "env/episodes"  # counter: episodes finished
ENV_RESUME_DECLINED = "env/resume_declined"  # counter: the engine declined a turn


@dataclass
class _Episode:
    env: Any
    state: EpisodeState
    synthetic: bool = False  # a batch-padding row: never stepped, never scored
    prev_len: int = 0  # answer-token cursor: where the current turn starts


@dataclass
class EnvRoundStats:
    env_name: str
    turns_mean: float
    turns_max: int
    env_step_ms_p50: float
    tool_calls: int
    resume_declined: int


@dataclass
class EnvRoundResult:
    loss_mask: np.ndarray  # [rows, max_new_tokens] int32
    group_rewards: list[np.ndarray]  # per group: (n, 2) float64
    turns: np.ndarray  # [rows] int32 policy-turn counts
    turn_provenance: list[list[dict[str, Any]]]  # per candidate row
    stats: EnvRoundStats
    episodes: list[EpisodeState] = field(default_factory=list)
    # per candidate row: the conversation in answer-token coordinates
    # (policy spans and injected observations, up to the last cursor); a
    # later round continuing it prompts with ``prompt_ids + history[c]``
    history: list[np.ndarray] = field(default_factory=list)


class EnvRolloutDriver:
    """One per trainer; ``begin_round`` readies it as the engine's turn hook."""

    def __init__(self, env_name: str, tokenizer: Any, *, max_turns: int, max_new_tokens: int,
                 format_scorer: str = "soft", env_kwargs: dict[str, Any] | None = None):
        self.env_name = env_name
        self.tokenizer = tokenizer
        self.max_turns = max(1, int(max_turns))
        self.max_new_tokens = int(max_new_tokens)
        self.format_scorer = format_scorer
        self.env_kwargs = dict(env_kwargs or {})
        self._cls = get_env_class(env_name)
        self._episodes: list[_Episode] = []
        self._n = 0
        self._step_ms: list[float] = []
        self._tool_calls = 0
        self._declined = 0

    # -- a round ----------------------------------------------------------

    def begin_round(self, problems: list[str], solutions: list[str],
                    n_candidates: int) -> "EnvRolloutDriver":
        """One environment per candidate row (group-major, ``row = g * n +
        i``). Batch-padding entries (empty problems) get synthetic episodes,
        born done, that the hook ends at first contact without an
        environment step."""
        self._episodes = []
        self._n = int(n_candidates)
        self._step_ms = []
        self._tool_calls = 0
        self._declined = 0
        for problem, solution in zip(problems, solutions):
            task = {"problem": problem, "solution": solution}
            synthetic = problem == ""
            for _ in range(n_candidates):
                env = self._cls(format_scorer=self.format_scorer, max_turns=self.max_turns,
                                **self.env_kwargs)
                state = EpisodeState(task=dict(task))
                if synthetic:
                    state.done = True
                else:
                    env.reset(task)
                self._episodes.append(_Episode(env=env, state=state, synthetic=synthetic))
        return self

    # -- the engine's turn-hook contract ----------------------------------

    def __call__(self, cand_id: int, gen_tokens: np.ndarray) -> np.ndarray | None:
        """Consume one finished turn; return observation tokens or ``None``."""
        ep = self._episodes[cand_id]
        if ep.state.done:
            return None
        gen_len = int(len(gen_tokens))
        step = self._step_env(ep, gen_tokens, gen_len)
        if step.done or step.observation is None:
            self._finish_episode(ep, step.info)
            return None
        if len(ep.state.turns) >= self.max_turns:
            # the environment wanted another turn but the budget is spent
            self._finish_episode(ep, step.info, truncated=True)
            return None
        obs_ids = self._encode(step.observation)
        if obs_ids.size == 0:
            self._finish_episode(ep, step.info, truncated=True)
            return None
        ep.state.turns[-1].env_span = (gen_len, gen_len + int(obs_ids.size))
        ep.prev_len = gen_len + int(obs_ids.size)
        return obs_ids

    def declined(self, cand_id: int) -> None:
        """The engine could not seat the observation just returned."""
        ep = self._episodes[cand_id]
        if ep.state.turns and ep.state.turns[-1].env_span is not None:
            ep.prev_len = ep.state.turns[-1].policy_span[1]
            ep.state.turns[-1].env_span = None
        self._declined += 1
        telemetry.counter_add(ENV_RESUME_DECLINED)
        self._finish_episode(ep, {}, truncated=True)

    # -- internals --------------------------------------------------------

    def _encode(self, text: str) -> np.ndarray:
        try:
            ids = self.tokenizer.encode(text, add_special_tokens=False)
        except TypeError:
            ids = self.tokenizer.encode(text)
        return np.asarray(ids, dtype=np.int32)

    def _decode(self, tokens: np.ndarray) -> str:
        try:
            return self.tokenizer.decode(tokens, skip_special_tokens=True)
        except TypeError:
            return self.tokenizer.decode(tokens)

    def _step_env(self, ep: _Episode, gen_tokens: np.ndarray, gen_len: int):
        completion = self._decode(np.asarray(gen_tokens[ep.prev_len:gen_len]))
        t0 = time.perf_counter()
        step = ep.env.step(completion)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._step_ms.append(dt_ms)
        telemetry.hist_observe(ENV_STEP_MS, dt_ms)
        tool_call_id = step.info.get("tool_call_id")
        if tool_call_id is not None and "tool_output" in step.info:
            self._tool_calls += 1
            telemetry.counter_add(ENV_TOOL_CALLS)
        ep.state.turns.append(TurnRecord(
            index=len(ep.state.turns), policy_span=(ep.prev_len, gen_len), env_span=None,
            reward=float(step.reward), tool_call_id=tool_call_id, info=dict(step.info)))
        return step

    def _finish_episode(self, ep: _Episode, info: dict[str, Any],
                        truncated: bool = False) -> None:
        ep.state.done = True
        ep.state.truncated = truncated
        ep.state.accuracy = float(info.get("accuracy", 0.0))
        telemetry.counter_add(ENV_EPISODES)
        telemetry.hist_observe(ENV_TURNS, float(ep.state.num_turns))

    # -- after the round --------------------------------------------------

    def finish_round(self, tokens: np.ndarray, lengths: np.ndarray) -> EnvRoundResult:
        """Score the stragglers and assemble masks, rewards and provenance.
        A candidate the engine finished without consulting the hook (the
        final sweep, a window with no room) still owes its last turn to the
        environment: it is scored here from the result tensors."""
        rows = len(self._episodes)
        width = self.max_new_tokens
        for c, ep in enumerate(self._episodes):
            if ep.state.done:
                continue
            gen_len = int(lengths[c])
            if gen_len > ep.prev_len or not ep.state.turns:
                step = self._step_env(ep, np.asarray(tokens[c][:gen_len]), gen_len)
                self._finish_episode(
                    ep, step.info, truncated=not (step.done or step.observation is None))
            else:
                self._finish_episode(ep, {}, truncated=True)

        loss_mask = np.zeros((rows, width), dtype=np.int32)
        turns = np.zeros(rows, dtype=np.int32)
        history: list[np.ndarray] = []
        for c, ep in enumerate(self._episodes):
            # the transcript runs to the last turn's end (lengths[c] may run
            # past it when the engine decoded beyond the last consulted turn)
            end = int(lengths[c])
            for turn in ep.state.turns:
                end = max(end, turn.policy_span[1])
                if turn.env_span is not None:
                    end = max(end, turn.env_span[1])
            row = np.asarray(tokens[c])
            history.append(row[: min(end, row.shape[0])].astype(np.int32))
        provenance: list[list[dict[str, Any]]] = []
        group_rewards: list[np.ndarray] = []
        for c, ep in enumerate(self._episodes):
            turns[c] = ep.state.num_turns
            cand_turns: list[dict[str, Any]] = []
            for turn in ep.state.turns:
                s, e = turn.policy_span
                loss_mask[c, max(0, s):min(width, e)] = 1
                cand_turns.append({
                    "turn": turn.index,
                    "tool_call_id": turn.tool_call_id,
                    "policy_span": [int(turn.policy_span[0]), int(turn.policy_span[1])],
                    "env_span": (None if turn.env_span is None
                                 else [int(turn.env_span[0]), int(turn.env_span[1])]),
                    "reward": float(turn.reward),
                })
            provenance.append(cand_turns)
        n = max(1, self._n)
        for g in range(rows // n):
            block = self._episodes[g * n:(g + 1) * n]
            rew = np.zeros((n, 2), dtype=np.float64)
            for i, ep in enumerate(block):
                rew[i, 0] = ep.state.total_reward
                rew[i, 1] = ep.state.accuracy
            group_rewards.append(rew)

        real = [ep for ep in self._episodes if not ep.synthetic]
        counts = [ep.state.num_turns for ep in real] or [0]
        stats = EnvRoundStats(
            env_name=self.env_name,
            turns_mean=float(np.mean(counts)),
            turns_max=int(np.max(counts)),
            env_step_ms_p50=float(np.median(self._step_ms)) if self._step_ms else 0.0,
            tool_calls=self._tool_calls,
            resume_declined=self._declined,
        )
        return EnvRoundResult(loss_mask=loss_mask, group_rewards=group_rewards, turns=turns,
                              turn_provenance=provenance, stats=stats,
                              episodes=[ep.state for ep in self._episodes], history=history)
