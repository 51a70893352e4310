"""Parity of the port's multi-turn environments (``distrl_llm_tpu_torch/env``)
with the JAX package's ``env/``: the registry, the three environments, the
sandbox, the rollout driver and the trainer's turn counts.

Every case runs the port's class and the JAX class on the same inputs and
compares what they return: each ``EnvStep`` (observation, reward, done,
info), the sandbox's output character for character, and the driver's
``EnvRoundResult`` (loss mask, group rewards, turns, provenance, history,
stats without the env.step times) for the same scripted token streams
through one tokenizer. Rewards are float64 sums of the same float64
scores: compared exactly.

The port's sandbox sets its limits in the child (a prelude that then
replaces itself with ``python -I -c <code>``) where the JAX package uses a
``preexec_fn``, which is unsafe beside other threads; the outputs are held
equal here, and once more from a worker thread while another thread runs.
"""

import threading

import numpy as np
import pytest

from distrl_llm_tpu import env as jenv
from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.env import code_env as jcode
from distrl_llm_tpu_torch import env as tenv
from distrl_llm_tpu_torch import trainer as ttrainer
from distrl_llm_tpu_torch.env import code_env as tcode
from distrl_llm_tpu_torch.tokenizer import CharTokenizer

WELL_FORMED = "<think>plan</think>\n<answer>42</answer>"
WIDTH = 256  # the verifier's critique is ~130 characters


def _step_tuple(step):
    return (step.observation, step.reward, step.done, step.info)


# ------------------------------------------------------------- registry


def test_registry_matches_jax():
    assert tenv.env_names() == jenv.env_names() == ("code", "math", "verifier")
    for name in tenv.env_names():
        cls, jcls = tenv.get_env_class(name), jenv.get_env_class(name)
        assert cls.name == jcls.name == name
        assert isinstance(cls(), tenv.Environment)
    with pytest.raises(ValueError) as jerr:
        jenv.get_env_class("chess")
    with pytest.raises(ValueError) as err:
        tenv.get_env_class("chess")
    assert str(err.value) == str(jerr.value)
    assert "code, math, verifier" in str(err.value)


# --------------------------------------------------------- environments

# (env name, constructor kwargs, solution, the completions of one episode)
SESSIONS = [
    ("math", {}, "42", [WELL_FORMED]),
    ("math", {"format_scorer": "strict"}, "42", ["<answer>41</answer>"]),
    ("code", {"max_turns": 3}, "42", ["<tool>print(6*7)</tool>", "<answer>42</answer>"]),
    ("code", {"max_turns": 3}, "42", ["hmm", "<tool>print(1)</tool> then <tool>print(2)</tool>",
                                      "<answer>2</answer>"]),
    ("code", {"max_turns": 2}, "42", ["<tool>print(1)</tool>", "<tool>print(2)</tool>"]),
    ("code", {"max_turns": 4}, "7", ["<tool>raise ValueError('boom')</tool>",
                                     "<tool>import sys; sys.exit(3)</tool>",
                                     "<tool>print('x' * 10000)</tool>", "<answer>7</answer>"]),
    ("code", {"max_turns": 3, "output_limit": 32}, "", ["<tool>print('y' * 100)</tool>",
                                                        "<tool>pass</tool>", "done"]),
    ("verifier", {"max_turns": 3}, "42", ["<think>a</think>\n<answer>41</answer>",
                                          WELL_FORMED]),
    ("verifier", {"max_turns": 4}, "nope", ["no tags here", "<think>a</think>\n<answer>x</answer>",
                                            "no tags here", "<answer>y</answer>"]),
    ("verifier", {"max_turns": 2, "format_scorer": "strict"}, "42",
     ["<answer>1</answer>", "<answer>2</answer>"]),
]


@pytest.mark.parametrize("name,kw,solution,completions", SESSIONS,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(SESSIONS)])
def test_environment_steps_match_jax(name, kw, solution, completions):
    task = {"problem": "p", "solution": solution}
    env, jenv_ = tenv.get_env_class(name)(**kw), jenv.get_env_class(name)(**kw)
    assert env.reset(task) == jenv_.reset(task) == "p"
    for completion in completions:
        got, want = env.step(completion), jenv_.step(completion)
        assert _step_tuple(got) == _step_tuple(want), completion
        if got.done:
            break
    assert got.done


@pytest.mark.parametrize("name", ["math", "code", "verifier"])
def test_step_before_reset_raises_as_jax(name):
    with pytest.raises(RuntimeError) as jerr:
        jenv.get_env_class(name)().step("x")
    with pytest.raises(RuntimeError) as err:
        tenv.get_env_class(name)().step("x")
    assert str(err.value) == str(jerr.value)


def test_math_env_second_step_raises_as_jax():
    for mod in (tenv, jenv):
        env = mod.MathSingleTurnEnv()
        env.reset({"problem": "p", "solution": "1"})
        env.step("x")
        with pytest.raises(RuntimeError, match="single-turn"):
            env.step("y")


# ---------------------------------------------------------------- sandbox

SNIPPETS = [
    ("print(6*7)", {}),
    ("raise ValueError('boom')", {}),
    ("import sys; print('out'); print('err', file=sys.stderr); sys.exit(2)", {}),
    ("print('x' * 10000)", {"output_limit": 32}),
    ("pass", {}),
    ("import os; print(os.getcwd(), sorted(os.environ))", {}),
    ("import sys; print(sys.flags.isolated, sys.flags.no_user_site)", {}),
    ("import resource as r; print(r.getrlimit(r.RLIMIT_CPU), r.getrlimit(r.RLIMIT_AS), "
     "r.getrlimit(r.RLIMIT_FSIZE))", {}),
    ("x = bytearray(1 << 30); print(len(x))", {}),
    ("while True: pass", {"timeout_s": 0.5}),
    ("def f(:", {}),
]


@pytest.mark.parametrize("code,kw", SNIPPETS, ids=range(len(SNIPPETS)))
def test_sandbox_output_matches_jax(code, kw):
    assert tcode.run_sandboxed(code, **kw) == jcode.run_sandboxed(code, **kw)


def test_sandbox_runs_from_a_thread_beside_a_busy_one():
    """The rollout thread of the overlapped modes runs the environments
    while the learner's thread works: the sandbox there gives what it gives
    alone, with no fork-time lock to inherit."""
    stop = threading.Event()
    spinning = threading.Thread(target=lambda: [None for _ in iter(stop.is_set, True)],
                                daemon=True)
    spinning.start()
    out = {}
    try:
        worker = threading.Thread(target=lambda: out.update(
            a=tcode.run_sandboxed("print(6*7)"),
            b=tcode.run_sandboxed("raise ValueError('boom')")))
        worker.start()
        worker.join(30)
        assert not worker.is_alive(), "the sandbox hung on a thread"
    finally:
        stop.set()
        spinning.join(5)
    assert out == {"a": jcode.run_sandboxed("print(6*7)"),
                   "b": jcode.run_sandboxed("raise ValueError('boom')")}


# ----------------------------------------------------------------- driver


def _drivers(env="code", max_turns=3, **kw):
    tok = CharTokenizer(256)
    return tok, [mod.EnvRolloutDriver(env, tok, max_turns=max_turns, max_new_tokens=WIDTH, **kw)
                 for mod in (tenv, jenv)]


def _enc(tok, text):
    return np.asarray(tok.encode(text), np.int32)


def _row(*parts):
    full = np.concatenate(parts).astype(np.int32)
    tokens = np.zeros((1, WIDTH), np.int32)
    tokens[0, :full.size] = full
    return full, tokens


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got.loss_mask, want.loss_mask)
    assert got.loss_mask.dtype == want.loss_mask.dtype
    assert len(got.group_rewards) == len(want.group_rewards)
    for g, w in zip(got.group_rewards, want.group_rewards):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(got.turns, want.turns)
    assert got.turn_provenance == want.turn_provenance
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for field in ("env_name", "turns_mean", "turns_max", "tool_calls", "resume_declined"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    assert [(e.done, e.truncated, e.accuracy, e.num_turns, e.total_reward)
            for e in got.episodes] == [(e.done, e.truncated, e.accuracy, e.num_turns,
                                        e.total_reward) for e in want.episodes]


def _tool_round_trip(tok, drv):
    drv.begin_round(["compute 6*7"], ["42"], 1)
    turn1 = _enc(tok, "<tool>print(6*7)</tool>")
    obs = drv(0, turn1)
    turn2 = _enc(tok, "<answer>42</answer>")
    full, tokens = _row(turn1, obs, turn2)
    assert drv(0, full) is None
    return drv.finish_round(tokens, np.asarray([full.size]))


def _padding_rows(tok, drv):
    drv.begin_round(["q", ""], ["42", ""], 2)
    assert drv(0, _enc(tok, "<answer>1</answer>")) is not None
    for c in (2, 3):
        assert drv(c, np.asarray([5], np.int32)) is None
    return drv.finish_round(np.zeros((4, WIDTH), np.int32), np.asarray([18, 1, 1, 1]))


def _turn_budget(tok, drv):
    drv.begin_round(["q"], ["42"], 1)
    t1 = _enc(tok, "<answer>1</answer>")
    obs = drv(0, t1)
    full, tokens = _row(t1, obs, _enc(tok, "<answer>2</answer>"))
    assert drv(0, full) is None
    return drv.finish_round(tokens, np.asarray([full.size]))


def _declined(tok, drv):
    drv.begin_round(["q"], ["42"], 1)
    t1 = _enc(tok, "<answer>1</answer>")
    assert drv(0, t1) is not None
    drv.declined(0)
    return drv.finish_round(np.zeros((1, WIDTH), np.int32), np.asarray([t1.size]))


def _stale_cursor(tok, drv):
    """A length cursor that stopped before the last observation must not
    cut the history."""
    drv.begin_round(["compute 6*7"], ["42"], 1)
    turn1 = _enc(tok, "<tool>print(6*7)</tool>")
    obs = drv(0, turn1)
    full, tokens = _row(turn1, obs, _enc(tok, "<answer>42</answer>"))
    assert drv(0, full) is None
    return drv.finish_round(tokens, np.asarray([turn1.size]))


def _stragglers(tok, drv):
    """Candidates the engine finished without consulting the hook owe their
    last turn to the environment."""
    drv.begin_round(["q"], ["42"], 2)
    rows = [tok.encode(WELL_FORMED), tok.encode("wrong")]
    tokens = np.zeros((2, WIDTH), np.int32)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = r
    return drv.finish_round(tokens, np.asarray([len(r) for r in rows]))


def _mid_episode_stragglers(tok, drv):
    """Two groups of two: one episode granted a critique and then cut by the
    window (its continuation scored at the round's end), one never
    consulted, one finished by the hook, one cursor with nothing past the
    observation."""
    drv.begin_round(["q1", "q2"], ["42", "7"], 2)
    t1 = _enc(tok, "<answer>1</answer>")
    obs = drv(0, t1)
    full0, _ = _row(t1, obs, _enc(tok, "<think>x</think>\n<answer>4"))
    assert drv(2, _enc(tok, "<think>b</think>\n<answer>7</answer>")) is None
    t3 = _enc(tok, "<answer>3</answer>")
    obs3 = drv(3, t3)
    tokens = np.zeros((4, WIDTH), np.int32)
    tokens[0, :full0.size] = full0
    tokens[1, :5] = _enc(tok, "hello")
    tokens[2, :5] = 9
    row3 = np.concatenate([t3, obs3])
    tokens[3, :row3.size] = row3
    return drv.finish_round(tokens, np.asarray([full0.size, 5, 5, row3.size]))


DRIVER_CASES = [
    ("code", 3, {}, _tool_round_trip),
    ("verifier", 3, {}, _padding_rows),
    ("verifier", 2, {}, _turn_budget),
    ("verifier", 3, {}, _declined),
    ("code", 3, {}, _stale_cursor),
    ("math", 1, {}, _stragglers),
    ("verifier", 3, {"format_scorer": "strict"}, _mid_episode_stragglers),
    ("code", 2, {"env_kwargs": {"output_limit": 8}}, _tool_round_trip),
]


@pytest.mark.parametrize("env,max_turns,kw,script", DRIVER_CASES,
                         ids=[f"{c[0]}-{c[3].__name__.strip('_')}" for c in DRIVER_CASES])
def test_driver_round_matches_jax(env, max_turns, kw, script):
    tok, (drv, jdrv) = _drivers(env, max_turns, **kw)
    got, want = script(tok, drv), script(tok, jdrv)
    _assert_results_equal(got, want)
    if script is _tool_round_trip and not kw:
        # the observation is masked out of the loss, the turns are not
        g1, e1 = got.turn_provenance[0][0]["env_span"]
        assert got.loss_mask[0, :g1].all() and not got.loss_mask[0, g1:e1].any()
        assert got.stats.tool_calls == 1 and got.group_rewards[0][0, 1] == 1.0


def test_driver_writes_the_env_series_as_jax():
    """The driver's ``env/*`` series in each package's registry: the same
    counters and histograms (times aside)."""
    from distrl_llm_tpu import telemetry as jtel
    from distrl_llm_tpu_torch import telemetry as ttel

    tok, (drv, jdrv) = _drivers("code", 3)
    ttel.reset()
    jtel.reset()
    _tool_round_trip(tok, drv)
    _tool_round_trip(tok, jdrv)
    got = {k: v for k, v in ttel.metrics_snapshot().items()
           if k.startswith("env/") and not k.startswith("env/step_ms_")}
    want = {k: v for k, v in jtel.metrics_snapshot().items()
            if k.startswith("env/") and not k.startswith("env/step_ms_")}
    assert got == want and got["env/tool_calls"] == 1.0 and got["env/episodes"] == 1.0


# ---------------------------------------------------- trainer turn counts


@pytest.mark.parametrize("candidates", [
    [{"turns": [[[{"turn": 0}], [{"turn": 0}, {"turn": 1}]], [[{"turn": 0}] * 2, []]]},
     {"no_turns_key": True}],
    [{"x": 1}],
    [{"turns": []}],
    [{"turns": [[[{"turn": 0}] * 3]]}, {"turns": [None, [[]]]}],
])
def test_env_turn_counts_match_jax(candidates):
    assert ttrainer._env_turn_counts(candidates) == jtrainer._env_turn_counts(candidates)
