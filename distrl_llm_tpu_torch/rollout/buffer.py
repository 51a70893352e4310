"""Bounded trajectory buffer: FIFO with watermarked backpressure,
staleness-aware eviction, and drop accounting (JAX ``rollout/buffer.py``).

The decoupling piece of the async regime (LlamaRL's rollout queue /
Laminar's trajectory store, scaled to one process): producers (the rollout
service thread, which may itself fan out to control-plane workers) stream
completed groups in; the learner pulls batches on its own cadence.

Flow control is two-sided:

* **Backpressure (producer side)** — ``put`` blocks once occupancy reaches
  the HIGH watermark and wakes when the learner drains it to the LOW
  watermark (hysteresis, so a fast producer doesn't thrash on the
  boundary). Every blocking wait increments ``rollout/backpressure_waits``.
* **Staleness eviction (learner side)** — ``evict_stale`` drops queued
  groups whose version lag already exceeds the bound BEFORE the learner
  wastes an update on data the admission policy would reject; eviction
  order is FIFO (oldest — and therefore stalest-by-construction — first).
  Drops are counted (``rollout/dropped_stale``), never silent.

Telemetry: ``rollout/buffer_occupancy`` gauge on every mutation (a Perfetto
counter track while tracing), plus the counters above, all riding the
MetricsSink snapshot like every other registry series.

The buffer is checkpointable: ``state_dict``/``load_state`` round-trip the
queued trajectories (numpy + str payloads) so a resumed run neither loses
nor re-generates in-flight data (checkpoint.py sidecar).

Not ported: the lineage ledger's hooks (enqueue, dequeue and drop stamps on
a group's lineage record), which belong to ROADMAP queue 1 item 11(b).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.rollout.trajectory import Trajectory


# telemetry series owned by the buffer (one defining owner per name;
# staleness.py imports ROLLOUT_DROPPED_STALE rather than re-spelling it)
ROLLOUT_BUFFER_OCCUPANCY = "rollout/buffer_occupancy"    # gauge
ROLLOUT_BACKPRESSURE_WAITS = "rollout/backpressure_waits"  # counter
ROLLOUT_DROPPED_CAPACITY = "rollout/dropped_capacity"    # counter
ROLLOUT_DROPPED_STALE = "rollout/dropped_stale"          # counter


class BufferClosed(RuntimeError):
    """put() after close() — the producer outlived the consumer."""


class TrajectoryBuffer:
    """Bounded FIFO of Trajectory groups with watermarked backpressure."""

    def __init__(
        self,
        capacity: int,
        *,
        high_watermark: int | None = None,
        low_watermark: int | None = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.high_watermark = (
            high_watermark if high_watermark is not None else capacity
        )
        self.low_watermark = (
            low_watermark if low_watermark is not None
            else max(self.high_watermark // 2, 1)
        )
        if not 0 < self.high_watermark <= capacity:
            raise ValueError(
                f"high_watermark must be in (0, capacity={capacity}], got "
                f"{self.high_watermark}"
            )
        if not 0 < self.low_watermark <= self.high_watermark:
            raise ValueError(
                f"low_watermark must be in (0, high_watermark="
                f"{self.high_watermark}], got {self.low_watermark}"
            )
        self._q: deque[Trajectory] = deque()
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._drained = threading.Condition(self._mu)
        self._closed = False
        # producers past the high watermark stay blocked until the learner
        # drains to the low watermark, even if a single get dips below high
        self._gated = False
        # drop accounting — cumulative, never reset (the per-step telemetry
        # counters report deltas; these are the run totals artifacts quote)
        self.dropped_stale = 0
        self.dropped_capacity = 0
        self.backpressure_waits = 0
        self.total_put = 0
        self.total_got = 0

    # ------------------------------------------------------------- producer

    def put(self, traj: Trajectory, *, block: bool = True,
            timeout: float | None = None) -> bool:
        """Append one group. Blocks while the backpressure gate is closed
        (occupancy reached the high watermark and hasn't drained to the low
        one yet). With ``block=False`` (or on timeout) a gated put drops the
        OLDEST queued group instead — FIFO eviction with capacity-drop
        accounting — so a producer that must not stall still makes progress.
        Returns False only when the entry itself was not stored (closed
        buffer raises instead: that is a lifecycle bug, not flow control)."""
        with self._mu:
            if self._closed:
                raise BufferClosed("put() on a closed TrajectoryBuffer")
            if len(self._q) >= self.high_watermark:
                self._gated = True
            if self._gated and block:
                waited = False
                deadline = None
                if timeout is not None:
                    deadline = time.monotonic() + timeout
                while self._gated and not self._closed:
                    if not waited:
                        waited = True
                        self.backpressure_waits += 1
                        telemetry.counter_add(ROLLOUT_BACKPRESSURE_WAITS)
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                    self._drained.wait(remaining)
                if self._closed:
                    raise BufferClosed("put() on a closed TrajectoryBuffer")
            # non-blocking (or timed-out) put while gated: evict oldest to
            # stay WITHIN the high watermark — the backpressure bound must
            # hold for unwilling-to-wait producers too, not just capacity
            # (with the default high == capacity the two limits coincide)
            limit = self.high_watermark if self._gated else self.capacity
            while len(self._q) >= limit:
                self._q.popleft()
                self.dropped_capacity += 1
                telemetry.counter_add(ROLLOUT_DROPPED_CAPACITY)
            self._q.append(traj)
            self.total_put += 1
            if len(self._q) >= self.high_watermark:
                self._gated = True
            self._occupancy_gauge_locked()
            self._not_empty.notify_all()
            return True

    def set_watermarks(self, high: int, low: int | None = None) -> None:
        """Retune the backpressure watermarks at runtime (the JAX package's
        staleness governor shrinks the high watermark under policy-lag
        pressure and regrows it on sustained headroom). Same validation as
        construction; ``low`` defaults to ``high // 2``. The gate is
        recomputed immediately: a shrink below the current occupancy gates
        producers now, a regrow past it releases them."""
        high = int(high)
        low = max(high // 2, 1) if low is None else int(low)
        if not 0 < high <= self.capacity:
            raise ValueError(
                f"high_watermark must be in (0, capacity={self.capacity}], "
                f"got {high}"
            )
        if not 0 < low <= high:
            raise ValueError(
                f"low_watermark must be in (0, high_watermark={high}], "
                f"got {low}"
            )
        with self._mu:
            self.high_watermark = high
            self.low_watermark = low
            if len(self._q) >= high:
                self._gated = True
            else:
                self._maybe_open_gate_locked()

    def close(self) -> None:
        """No more puts; blocked getters drain the remainder then get []."""
        with self._mu:
            self._closed = True
            self._not_empty.notify_all()
            self._drained.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # -------------------------------------------------------------- learner

    def get_batch(self, k: int, timeout: float | None = None) -> list[Trajectory]:
        """Pop up to ``k`` groups FIFO. Blocks until ``k`` are available, the
        buffer closes (returns the remainder, possibly < k, then [] forever),
        or ``timeout`` elapses (returns whatever is there)."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        deadline = None
        if timeout is not None:
            deadline = time.monotonic() + timeout
        with self._mu:
            while len(self._q) < k and not self._closed:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                self._not_empty.wait(remaining)
            out = [self._q.popleft() for _ in range(min(k, len(self._q)))]
            self.total_got += len(out)
            self._maybe_open_gate_locked()
            self._occupancy_gauge_locked()
            return out

    def evict_stale(self, learner_version: int, max_staleness: int) -> int:
        """Drop queued groups with NO token left inside the staleness bound
        (freshest-token lag beyond ``max_staleness`` — the same predicate
        drop-mode admission uses, so eviction never discards a group
        admission would have trained). Returns the drop count; each drop
        feeds ``rollout/dropped_stale``. Survivors are NOT observed into
        the staleness histogram here — the admission policy (staleness.py)
        owns that series, once per group actually handed to the learner, so
        eviction can run every loop without double-counting."""
        dropped = 0
        with self._mu:
            kept: deque[Trajectory] = deque()
            for traj in self._q:
                lag = learner_version - traj.max_version
                if lag > max_staleness:
                    dropped += 1
                    telemetry.counter_add(ROLLOUT_DROPPED_STALE)
                else:
                    kept.append(traj)
            self._q = kept
            if dropped:
                self.dropped_stale += dropped
                self._maybe_open_gate_locked()
                self._occupancy_gauge_locked()
                self._drained.notify_all()
        return dropped

    # ----------------------------------------------------------- accounting

    def __len__(self) -> int:
        with self._mu:
            return len(self._q)

    def stats(self) -> dict[str, int]:
        with self._mu:
            return {
                "occupancy": len(self._q),
                "capacity": self.capacity,
                "high_watermark": self.high_watermark,
                "low_watermark": self.low_watermark,
                "total_put": self.total_put,
                "total_got": self.total_got,
                "dropped_stale": self.dropped_stale,
                "dropped_capacity": self.dropped_capacity,
                "backpressure_waits": self.backpressure_waits,
            }

    def _maybe_open_gate_locked(self) -> None:
        if self._gated and len(self._q) <= self.low_watermark:
            self._gated = False
            self._drained.notify_all()

    def _occupancy_gauge_locked(self) -> None:
        telemetry.gauge_set(ROLLOUT_BUFFER_OCCUPANCY, float(len(self._q)))

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> dict[str, Any]:
        """Picklable snapshot: queued trajectories + cumulative counters
        (numpy/str payloads only — the checkpoint sidecar pickles it)."""
        with self._mu:
            return {
                "trajectories": list(self._q),
                "dropped_stale": self.dropped_stale,
                "dropped_capacity": self.dropped_capacity,
                "backpressure_waits": self.backpressure_waits,
                "total_put": self.total_put,
                "total_got": self.total_got,
            }

    def load_state(self, state: dict[str, Any]) -> None:
        with self._mu:
            if self._closed:
                raise BufferClosed("load_state() on a closed TrajectoryBuffer")
            self._q = deque(state.get("trajectories", ()))
            self.dropped_stale = int(state.get("dropped_stale", 0))
            self.dropped_capacity = int(state.get("dropped_capacity", 0))
            self.backpressure_waits = int(state.get("backpressure_waits", 0))
            self.total_put = int(state.get("total_put", 0))
            self.total_got = int(state.get("total_got", 0))
            self._gated = len(self._q) >= self.high_watermark
            self._occupancy_gauge_locked()
            self._not_empty.notify_all()
