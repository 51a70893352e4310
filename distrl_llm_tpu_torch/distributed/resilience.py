"""Resilience primitives of the distributed rollout path (JAX
``distributed/resilience.py``).

* :class:`RetryPolicy`: seeded exponential backoff with jitter plus
  per-call and per-round deadline budgets. Seeded, so two policies built
  from the same fields replay the same delays for the same call order (the
  async rollout service's restarts use it too, ``rollout/service.py``).
* :class:`WorkerError` / :func:`classify_worker_error`: a worker-side
  exception (a ``MSG_ERROR`` frame) classified transient or fatal by its
  exception type: transport and timeout flavors retry under the policy,
  deterministic program errors (ValueError, an unknown op, ...) propagate.
* :class:`ShardFailedError`: the poison-shard quarantine signal: a shard
  that failed on K distinct workers names itself instead of grinding every
  worker to unhealthy.
* :class:`FaultInjector`: wraps a control-plane ``Connection`` to delay,
  drop, close or fail frames on a scripted schedule, from
  ``DISTRL_FAULT_SCHEDULE`` (so worker processes and the driver share one
  spec string) or ``install()``.

The ``cp/*`` series names are the JAX package's; the port's registry
(``telemetry.py``) records them. Its spans carry no attributes.
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

# -------------------------------------------------------- telemetry contract

CP_HEALTHY_GAUGE = "cp/healthy_workers"
CP_RECONNECTS = "cp/reconnects"
CP_RESUBMITS = "cp/resubmits"
CP_RETRIES = "cp/retries"
CP_POISON_SHARDS = "cp/poison_shards"
CP_DEGRADED_GROUPS = "cp/degraded_groups"
CP_REJOIN_EPOCH = "cp/rejoin_epoch"  # gauge: bumps per re-admit
CP_QUARANTINES = "cp/quarantines"  # proactive demotions of a live worker
CP_RETIRES = "cp/retires"  # intentional scale-in: terminal, never re-dialed
# the weight bus (weight_bus.py)
CP_DISPATCH_BYTES = "cp/dispatch_bytes"        # counter: MSG_DISPATCH payload bytes
CP_WEIGHT_BYTES = "cp/weight_bytes_sent"       # counter: MSG_WEIGHTS payload bytes
CP_WEIGHT_PUSHES = "cp/weight_pushes"          # counter: per-worker weight pushes
CP_WEIGHT_FULL_SYNCS = "cp/weight_full_syncs"  # counter: full-tensor (non-delta) sends
CP_WEIGHT_REREQUESTS = "cp/weight_rerequests"  # counter: unknown-version re-pushes
CP_WEIGHT_BROADCAST_MS = "cp/weight_broadcast_ms"  # hist: push -> last worker ack
# RPC latency histograms (control_plane.py)
CP_RPC_DISPATCH_MS = "cp/rpc_dispatch_ms"  # hist: dispatch -> result frame
CP_RPC_PING_MS = "cp/rpc_ping_ms"          # hist: health-check round trip

FAULT_SCHEDULE_ENV = "DISTRL_FAULT_SCHEDULE"


# --------------------------------------------------------------- exceptions


class WorkerError(RuntimeError):
    """A worker-side exception shipped back as an ERROR frame; ``transient``
    says whether the control plane may retry it under its policy."""

    def __init__(self, address: tuple[str, int] | str, traceback_text: str,
                 *, transient: bool):
        super().__init__(f"worker {address} raised:\n{traceback_text}")
        self.address = address
        self.traceback_text = traceback_text
        self.transient = transient


class ShardFailedError(RuntimeError):
    """A shard failed on K distinct workers (or exhausted its attempt cap);
    names the shard so the caller can drop its groups instead of the run."""

    def __init__(self, shard_index: int, *, workers=(), attempts: int = 0,
                 message: str | None = None):
        self.shard_index = shard_index
        self.workers = tuple(workers)
        self.attempts = attempts
        if message is None:
            message = (
                f"shard {shard_index} quarantined after failing on "
                f"{len(self.workers)} distinct worker(s) "
                f"({', '.join(str(w) for w in self.workers)}; "
                f"{attempts} failed attempt(s))"
            )
        super().__init__(message)


# exception type names a retry can plausibly outlive (transport hiccups,
# timeouts, resource pressure); everything else is deterministic and fatal
_TRANSIENT_TYPES = frozenset({
    "OSError", "IOError", "ConnectionError", "ConnectionResetError",
    "ConnectionAbortedError", "ConnectionRefusedError", "BrokenPipeError",
    "TimeoutError", "EOFError", "InterruptedError", "BlockingIOError",
})

_EXC_LINE = re.compile(r"^([A-Za-z_][A-Za-z0-9_.]*)(?::|$)")


def classify_worker_error(traceback_text: str) -> bool:
    """True when a worker traceback's final exception type is transient, or
    its message carries the literal marker ``[transient]``."""
    if "[transient]" in traceback_text:
        return True
    for line in reversed(traceback_text.strip().splitlines()):
        line = line.strip()
        if not line:
            continue
        m = _EXC_LINE.match(line)
        if m:
            return m.group(1).rsplit(".", 1)[-1] in _TRANSIENT_TYPES
        # a continuation line of a multi-line message: keep scanning upward
    return False


# -------------------------------------------------------------- retry policy


@dataclass
class RetryPolicy:
    """Seeded exponential backoff and deadline budgets for control-plane RPC.

    ``backoff(attempt)`` draws its jitter from a private, lock-guarded
    ``random.Random(seed)``: two policies with the same fields replay the
    same delays for the same call order (when several threads share one
    policy, the sequence is reproducible, its assignment to threads not)."""

    max_call_retries: int = 2       # transient retries per RPC (after try 1)
    base_s: float = 0.05            # first backoff delay
    multiplier: float = 2.0
    max_backoff_s: float = 2.0      # delay cap
    jitter: float = 0.1             # +/- fraction applied to each delay
    seed: int = 0
    call_budget_s: float | None = None   # wall budget across one RPC's retries
    round_budget_s: float | None = None  # wall budget for a dispatch round
    max_shard_attempts: int = 6     # failed dispatches per shard before quarantine

    _rng: random.Random = field(init=False, repr=False, compare=False)
    _rng_mu: threading.Lock = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.max_call_retries < 0:
            raise ValueError(f"max_call_retries must be >= 0, got {self.max_call_retries}")
        if self.base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.max_shard_attempts < 1:
            raise ValueError(
                f"max_shard_attempts must be >= 1, got {self.max_shard_attempts}")
        self._rng = random.Random(self.seed)
        self._rng_mu = threading.Lock()

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): exponential with the
        seeded jitter, capped at ``max_backoff_s``."""
        d = min(self.base_s * self.multiplier ** max(attempt, 0), self.max_backoff_s)
        if self.jitter:
            with self._rng_mu:
                jitter_draw = self._rng.random()
            d *= 1.0 + self.jitter * (2.0 * jitter_draw - 1.0)
        return max(d, 0.0)


# ------------------------------------------------------------ fault injection


@dataclass
class _Rule:
    op: str                  # "send" | "recv"
    index: int | None        # 1-based call number; None = probabilistic
    action: str              # "delay" | "drop" | "close" | "error"
    arg: float | None = None  # delay seconds
    prob: float | None = None
    channel: str | None = None  # None matches every connection


def _parse_schedule(spec: str) -> tuple[int, list[_Rule]]:
    """Parse a schedule spec. Grammar (``;``-separated items)::

        seed=SEED
        OP:N=ACTION            # the Nth OP call (1-based) takes ACTION
        OP:*=ACTION@P          # every OP call takes ACTION with prob P
        CHANNEL.OP:N=ACTION    # the Nth OP call ON THAT CHANNEL only
        CHANNEL.OP:*=ACTION@P  # per-channel probabilistic rule

    OP is ``send``/``recv``, ACTION is ``drop`` | ``close`` | ``error`` |
    ``delay:SECONDS``, CHANNEL ``dispatch`` (the control-plane RPC, which
    every unprefixed rule also matches) or ``weights`` (the weight bus's
    connections). Channel rules count their channel's calls only."""
    seed = 0
    rules: list[_Rule] = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        if item.startswith("seed="):
            seed = int(item[len("seed="):])
            continue
        try:
            lhs, rhs = item.split("=", 1)
            op, idx = lhs.split(":", 1)
            op = op.strip()
            channel = None
            if "." in op:
                channel, _, op = op.partition(".")
                channel = channel.strip()
                op = op.strip()
                if not channel:
                    raise ValueError("empty channel selector")
            if op not in ("send", "recv"):
                raise ValueError(f"op must be send/recv, got {op!r}")
            prob = None
            if "@" in rhs:
                rhs, p = rhs.rsplit("@", 1)
                prob = float(p)
                if not 0.0 <= prob <= 1.0:
                    raise ValueError(f"probability must be in [0, 1], got {prob}")
            action, _, argtxt = rhs.partition(":")
            action = action.strip()
            if action not in ("delay", "drop", "close", "error"):
                raise ValueError(f"unknown action {action!r}")
            arg = float(argtxt) if argtxt else None
            if action == "delay" and arg is None:
                raise ValueError("delay needs an argument (delay:SECONDS)")
            index = None if idx.strip() == "*" else int(idx)
            if index is None and prob is None:
                raise ValueError("wildcard rules need a probability (@P)")
            rules.append(_Rule(op, index, action, arg, prob, channel))
        except ValueError as e:
            raise ValueError(f"bad fault-schedule item {item!r}: {e}") from e
    return seed, rules


class FaultInjector:
    """Deterministic frame-level fault injection on a scripted schedule,
    installed process-wide (``install()`` or ``DISTRL_FAULT_SCHEDULE``).
    Unprefixed rules advance process-global per-op counters, channel rules
    per-channel ones; probabilistic rules draw from the seeded rng on every
    matching call. ``events`` logs each decision as ``(op, n, action)``, or
    ``("<channel>.<op>", n_channel, action)`` for a channel rule."""

    def __init__(self, schedule: str = "", seed: int | None = None):
        sched_seed, self.rules = _parse_schedule(schedule)
        self.schedule = schedule
        self.seed = sched_seed if seed is None else seed
        self._rng = random.Random(self.seed)
        self._counts = {"send": 0, "recv": 0}
        self._chan_counts: dict[tuple[str, str], int] = {}
        self._mu = threading.Lock()
        self.events: list[tuple[str, int, str]] = []

    @classmethod
    def from_env(cls) -> "FaultInjector | None":
        spec = os.environ.get(FAULT_SCHEDULE_ENV, "")
        return cls(spec) if spec else None

    def decide(self, op: str, channel: str = "dispatch") -> tuple[str, float | None] | None:
        """Advance the counters; (action, arg) when a rule fires, else None."""
        with self._mu:
            self._counts[op] += 1
            n = self._counts[op]
            key = (channel, op)
            n_chan = self._chan_counts.get(key, 0) + 1
            self._chan_counts[key] = n_chan
            fired: tuple[str, float | None] | None = None
            fired_scoped = False
            for r in self.rules:
                if r.op != op:
                    continue
                if r.channel is not None and r.channel != channel:
                    continue
                r_n = n if r.channel is None else n_chan
                if r.index is not None:
                    if r.index == r_n and fired is None:
                        fired = (r.action, r.arg)
                        fired_scoped = r.channel is not None
                else:
                    draw = self._rng.random()
                    if draw < r.prob and fired is None:
                        fired = (r.action, r.arg)
                        fired_scoped = r.channel is not None
            if fired is not None:
                self.events.append((
                    f"{channel}.{op}" if fired_scoped else op,
                    n_chan if fired_scoped else n,
                    fired[0],
                ))
            return fired


_installed: FaultInjector | None = None
_env_checked = False


def install(injector: FaultInjector | None) -> None:
    """Install (or clear, with None) the process-wide injector."""
    global _installed, _env_checked
    _installed = injector
    _env_checked = True  # an explicit install wins over the environment


def active_injector() -> FaultInjector | None:
    global _installed, _env_checked
    if not _env_checked:
        _env_checked = True
        _installed = FaultInjector.from_env()
    return _installed


class FaultyConnection:
    """Connection proxy applying an injector's schedule to send/recv:
    ``delay`` sleeps then forwards; ``drop`` discards the frame (send:
    pretend-ok; recv: consume and report a timeout); ``close`` closes the
    socket and raises ``WorkerDeadError``; ``error`` raises it without
    closing."""

    def __init__(self, inner, injector: FaultInjector, channel: str = "dispatch"):
        self._inner = inner
        self._injector = injector
        self.channel = channel

    @property
    def fd(self):
        return self._inner.fd

    def _dead(self, what: str):
        from distrl_llm_tpu_torch.distributed.control_plane import WorkerDeadError

        return WorkerDeadError(f"injected fault: {what}")

    def _fault(self, op: str):
        fault = self._injector.decide(op, self.channel)
        if fault is None:
            return None
        action, arg = fault
        if action == "delay":
            time.sleep(arg or 0.0)
        elif action == "close":
            self._inner.close()
            raise self._dead(f"{op} close")
        elif action == "error":
            raise self._dead(f"{op} error")
        return action

    def send(self, msg_type: int, req_id: int, payload: bytes = b"",
             timeout_ms: int = 30_000) -> None:
        if self._fault("send") == "drop":
            return  # frame silently discarded
        self._inner.send(msg_type, req_id, payload, timeout_ms)

    def recv(self, timeout_ms: int):
        if self._fault("recv") == "drop":
            # consume the frame if one arrives, then report a timeout
            self._inner.recv(timeout_ms)
            return None
        return self._inner.recv(timeout_ms)

    def close(self) -> None:
        self._inner.close()


def wrap_connection(conn, channel: str = "dispatch"):
    """Wrap a Connection with the active injector, if any. Called wherever
    a control-plane connection is made, driver and worker side alike; the
    weight bus dials with ``channel="weights"``."""
    injector = active_injector()
    if injector is None:
        return conn
    return FaultyConnection(conn, injector, channel)
