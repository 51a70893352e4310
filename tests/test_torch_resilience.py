"""The port's resilience primitives (``distributed/resilience.py``) against
the JAX package's, in one process with no workers: the classification of
worker tracebacks, the fault injector's decisions and event log for a
schedule and seed, the parse errors, the faulty connection's semantics over
a stub, the environment install, and ``RetryPolicy``'s delays and
validation. The live control plane's uses of them are held in
``tests/test_torch_control_plane.py``.
"""

import random

import pytest

from distrl_llm_tpu.distributed import control_plane as jcp
from distrl_llm_tpu.distributed import resilience as jres
from distrl_llm_tpu_torch.distributed import control_plane as tcp
from distrl_llm_tpu_torch.distributed import resilience as tres


def _tb(last_line: str) -> str:
    return ("Traceback (most recent call last):\n"
            '  File "worker.py", line 1, in handler\n'
            f"{last_line}\n")


TRACEBACKS = [
    _tb("OSError: [Errno 11] Resource temporarily unavailable"),
    _tb("ConnectionError: injected transient fault 1/2 for 'a'"),
    _tb("ConnectionResetError: peer reset"),
    _tb("TimeoutError: slow filesystem"),
    _tb("BrokenPipeError: [Errno 32] Broken pipe"),
    _tb("builtins.EOFError: stream ended"),
    _tb("ValueError: unknown op 'nope'"),
    _tb("RuntimeError: worker started without --serve-model"),
    _tb("TypeError: generate() missing argument"),
    _tb("AssertionError"),
    _tb("torch.OutOfMemoryError: CUDA out of memory"),
    _tb("RuntimeError: [transient] page pool still warming"),
    _tb("ValueError: first line\n  a continuation line\n"),
    _tb("distrl_llm_tpu_torch.distributed.weight_bus.WeightVersionError: [transient] v3"),
    "",
    "\n\n   \n",
    "ConnectionRefusedError",
]


@pytest.mark.parametrize("text", TRACEBACKS)
def test_classification_matches_jax(text):
    assert tres.classify_worker_error(text) == jres.classify_worker_error(text)


def test_the_transient_flavors_and_the_fatal_ones():
    assert tres.classify_worker_error(TRACEBACKS[1])
    assert not tres.classify_worker_error(TRACEBACKS[6])
    assert tres.classify_worker_error(TRACEBACKS[11])  # the marker wins


def test_exceptions_match_jax():
    for mod in (tres, jres):
        e = mod.WorkerError(("h", 1), "ValueError: x", transient=False)
        assert isinstance(e, RuntimeError) and not e.transient
    assert str(tres.WorkerError(("h", 1), "tb", transient=True)) == str(
        jres.WorkerError(("h", 1), "tb", transient=True))
    for kw in (dict(workers=[("a", 1), ("b", 2)], attempts=3), dict(message="all lost")):
        t, j = tres.ShardFailedError(4, **kw), jres.ShardFailedError(4, **kw)
        assert str(t) == str(j) and t.shard_index == j.shard_index == 4
        assert t.workers == j.workers and t.attempts == j.attempts
    names = [n for n in dir(jres) if n.startswith("CP_")]
    assert [getattr(tres, n) for n in names] == [getattr(jres, n) for n in names]
    assert tres.FAULT_SCHEDULE_ENV == jres.FAULT_SCHEDULE_ENV


SCHEDULES = [
    "seed=7;recv:2=close;send:3=drop;send:*=delay:0.0@0.4",
    "seed=8;recv:2=close;send:3=drop;send:*=delay:0.0@0.4",
    "send:1=drop;send:2=close;recv:1=error",
    "seed=3;weights.send:2=close;send:*=error@0.3;weights.recv:*=drop@0.5;recv:4=delay:0.0",
    "seed=11; dispatch.send:1=drop ; recv:*=close@0.25",
    "",
]


@pytest.mark.parametrize("spec", SCHEDULES)
def test_fault_injector_decisions_match_jax(spec):
    """The same schedule and the same call sequence over both channels give
    the same decision at every call and the same event log."""
    calls = random.Random(5).choices(
        [("send", "dispatch"), ("recv", "dispatch"), ("send", "weights"),
         ("recv", "weights")], k=60)
    t, j = tres.FaultInjector(spec), jres.FaultInjector(spec)
    assert t.seed == j.seed
    for op, channel in calls:
        assert t.decide(op, channel) == j.decide(op, channel)
    assert t.events == j.events


def test_seed_argument_overrides_the_schedule_in_both():
    spec = "seed=1;send:*=drop@0.5"
    t, j = tres.FaultInjector(spec, seed=9), jres.FaultInjector(spec, seed=9)
    assert [t.decide("send") for _ in range(20)] == [j.decide("send") for _ in range(20)]


@pytest.mark.parametrize("spec", [
    "recv:1=explode", "recv:*=drop", "recv:1=delay", "peek:1=drop", "send:x=drop",
    "send:1=drop@1.5", ".send:1=drop", "send=drop", "seed=x",
])
def test_bad_schedules_raise_in_both(spec):
    with pytest.raises(ValueError) as je:
        jres.FaultInjector(spec)
    with pytest.raises(ValueError) as te:
        tres.FaultInjector(spec)
    assert str(te.value) == str(je.value)


class _StubConn:
    """Records the ops that reach the wire."""

    fd = 7

    def __init__(self):
        self.sent, self.recvd, self.closed = [], 0, False

    def send(self, msg_type, req_id, payload=b"", timeout_ms=30_000):
        self.sent.append((msg_type, req_id))

    def recv(self, timeout_ms):
        self.recvd += 1
        return (2, 1, b"")

    def close(self):
        self.closed = True


def _drive(mod, dead_error):
    fi = mod.FaultInjector("send:1=drop;send:2=close;recv:1=error;recv:2=drop;"
                           "weights.send:1=error")
    stub = _StubConn()
    conn = mod.FaultyConnection(stub, fi)
    wconn = mod.FaultyConnection(_StubConn(), fi, channel="weights")
    out = [conn.fd]
    for call in (lambda: conn.send(1, 1), lambda: conn.send(1, 2), lambda: conn.recv(100),
                 lambda: conn.recv(100), lambda: wconn.send(8, 3), lambda: conn.send(1, 4),
                 lambda: conn.recv(100)):
        try:
            out.append(("ok", call()))
        except dead_error as e:
            out.append(("dead", str(e)))
    return out + [stub.sent, stub.recvd, stub.closed, fi.events]


def test_faulty_connection_matches_jax():
    assert _drive(tres, tcp.WorkerDeadError) == _drive(jres, jcp.WorkerDeadError)


def test_env_install_roundtrip(monkeypatch):
    monkeypatch.setenv(tres.FAULT_SCHEDULE_ENV, "send:1=drop")
    try:
        tres.install(None)
        tres._env_checked = False  # read the environment again
        stub = _StubConn()
        wrapped = tres.wrap_connection(stub, channel="weights")
        assert isinstance(wrapped, tres.FaultyConnection) and wrapped.channel == "weights"
        assert tres.active_injector().schedule == "send:1=drop"
        tres.install(None)
        assert tres.wrap_connection(stub) is stub
    finally:
        tres.install(None)


@pytest.mark.parametrize("kw", [
    {}, dict(base_s=0.25, seed=3407), dict(jitter=0.0), dict(jitter=0.3, seed=11),
    dict(base_s=0.1, multiplier=3.0, max_backoff_s=1.0, seed=7, max_call_retries=5),
    dict(max_shard_attempts=2, call_budget_s=1.0, round_budget_s=9.0),
])
def test_retry_policy_matches_jax(kw):
    t, j = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert [t.backoff(a) for a in range(-1, 10)] == [j.backoff(a) for a in range(-1, 10)]
    for f in ("max_call_retries", "call_budget_s", "round_budget_s", "max_shard_attempts"):
        assert getattr(t, f) == getattr(j, f)


@pytest.mark.parametrize("bad", [dict(max_call_retries=-1), dict(max_shard_attempts=0),
                                 dict(base_s=-1.0), dict(max_backoff_s=-0.5)])
def test_retry_policy_validation_matches_jax(bad):
    with pytest.raises(ValueError) as je:
        jres.RetryPolicy(**bad)
    with pytest.raises(ValueError) as te:
        tres.RetryPolicy(**bad)
    assert str(te.value) == str(je.value)
