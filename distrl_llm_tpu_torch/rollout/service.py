"""RolloutService: the producer thread that runs generation continuously
and streams completed groups into the trajectory buffer (JAX
``rollout/service.py``).

The async regime's generation half (``--rollout_mode async``): while the
learner pulls batches from the buffer on its own cadence, this thread walks
the episode/batch stream and keeps the rollout engine busy. The produce
callable is the TRAINER's round machinery, so every engine rides through
unchanged; the trainer runs it on the rollout's own CUDA stream.

Flow control comes from the buffer: ``put`` blocks at the high watermark
(backpressure), so a producer outrunning the learner parks on the buffer
instead of piling up device-resident rounds. ``pause``/``resume`` hand the
learner exclusive ENGINE access for evals (the engines are not re-entrant):
the producer holds a busy lock only while generating — never while parked
at the pause gate or blocked in ``put`` — and ``pause`` acquires it, so it
returns the moment the engine is actually free and never mid-round.

Producer failures run through a SUPERVISED RESTART BUDGET first: a failed
produce round is retried in place with the retry policy's seeded backoff up
to ``max_restarts`` times across the run (``rollout/producer_restarts``
counts them) — transient rollout failures (a worker pool mid-rejoin, an RPC
hiccup) no longer kill the regime. Only once the budget is exhausted is the
exception captured, the buffer closed so the learner wakes and drains, and
``raise_if_failed`` re-raises it in the trainer — a genuinely dead producer must
still fail the run loudly, not starve it quietly.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Iterable, Iterator

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy
from distrl_llm_tpu_torch.rollout.buffer import BufferClosed, TrajectoryBuffer
from distrl_llm_tpu_torch.rollout.trajectory import Trajectory

log = logging.getLogger(__name__)

# produce(episode, batch_index, batch) -> completed trajectory groups
ProduceFn = Callable[[int, int, dict[str, Any]], "list[Trajectory]"]

# supervised-restart counter (one owner)
ROLLOUT_PRODUCER_RESTARTS = "rollout/producer_restarts"


class RolloutService:
    """Continuous generation producer over an episode/batch stream."""

    def __init__(
        self,
        produce: ProduceFn,
        buffer: TrajectoryBuffer,
        batches: Iterable[tuple[int, int, dict[str, Any]]],
        *,
        name: str = "rollout-service",
        max_restarts: int = 0,
        retry_policy: RetryPolicy | None = None,
    ):
        self._produce = produce
        self.buffer = buffer
        self._batches: Iterator = iter(batches)
        self._name = name
        # supervised restart budget: failed produce rounds retry in place
        # (with seeded backoff) this many times TOTAL before the failure
        # closes the buffer and surfaces via raise_if_failed
        self.max_restarts = max(int(max_restarts), 0)
        self.restarts_used = 0
        self._retry = retry_policy or RetryPolicy()
        self._resume_gate = threading.Event()
        self._resume_gate.set()
        self._stop = False
        # held exactly while the produce callable runs (the engine is in
        # use); pause() acquires it for exclusive learner-side engine access
        self._busy = threading.Lock()
        self._paused = False
        self.error: BaseException | None = None
        # next (episode, batch_index) the producer will generate — the
        # resume cursor the checkpoint sidecar stores (everything BEFORE it
        # is either consumed or sitting in the buffer snapshot)
        self.cursor: tuple[int, int] | None = None
        self.rounds_produced = 0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "RolloutService":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            for episode, bi, batch in self._batches:
                self.cursor = (episode, bi)
                # pause gate: park BETWEEN rounds (never holding _busy) so
                # the learner's pause() returns as soon as the engine idles
                while not self._resume_gate.wait(timeout=0.1):
                    if self._stop:
                        return
                if self._stop:
                    return
                while True:
                    try:
                        with self._busy, telemetry.span("rollout/produce"):
                            trajs = self._produce(episode, bi, batch)
                        break
                    except BufferClosed:
                        raise  # consumer shut down — never a restart case
                    except BaseException as e:  # noqa: BLE001 — budgeted
                        if self._stop or self.restarts_used >= self.max_restarts:
                            raise
                        self.restarts_used += 1
                        telemetry.counter_add(ROLLOUT_PRODUCER_RESTARTS)
                        log.warning(
                            "rollout producer failed on (episode %d, batch "
                            "%d); restart %d/%d: %r", episode, bi,
                            self.restarts_used, self.max_restarts, e,
                        )
                        time.sleep(
                            self._retry.backoff(self.restarts_used - 1)
                        )
                self.rounds_produced += 1
                for traj in trajs:
                    # backpressure: blocks at the buffer's high watermark
                    # (engine idle here — _busy is NOT held)
                    self.buffer.put(traj)
                # cursor advances only once the round is FULLY buffered: a
                # checkpoint taken mid-put re-produces this batch on resume
                # (benign duplicates) instead of losing its tail
                self.cursor = (episode, bi + 1)
                if self._stop:
                    return
        except BufferClosed:
            pass  # consumer shut down first — a clean stop, not a failure
        except BaseException as e:  # noqa: BLE001 — re-raised by raise_if_failed
            self.error = e
            log.exception("rollout service failed; closing buffer")
        finally:
            self.buffer.close()  # wakes the learner to drain / observe error

    # ------------------------------------------------------------- control

    def pause(self) -> None:
        """Stop producing at the next round boundary and block until the
        engine is free — after this returns the engine is exclusively the
        caller's until ``resume``. Not reentrant (one learner thread)."""
        if self._paused:
            return
        self._resume_gate.clear()
        self._busy.acquire()  # waits out at most the round in flight
        self._paused = True

    def resume(self) -> None:
        if not self._paused:
            return
        self._paused = False
        self._busy.release()
        self._resume_gate.set()

    def stop(self) -> None:
        """Stop after the current round; never joins a possibly-hung
        generation (same policy as the trainer's pipelined pool — a hung
        engine's documented recovery is process restart)."""
        self._stop = True
        if self._paused:
            self.resume()
        self._resume_gate.set()
        self.buffer.close()

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def raise_if_failed(self) -> None:
        if self.error is not None:
            # re-raise the ORIGINAL exception (not a wrapper): the trainer's
            # EngineHangError handler must still see its type to checkpoint
            # before exit (train()'s documented hang recovery)
            raise self.error
