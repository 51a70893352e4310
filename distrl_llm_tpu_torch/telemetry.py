"""Phase spans: the trainer's phase timings.

``PhaseSpans`` is the JAX package's ``telemetry.PhaseSpans``: ``with
phases("generation"): ...`` then ``phases.metrics()`` gives the reference's
exact ``timing/generation_duration`` names (distributed_trainer.py:348-366).
Each phase is also a ``torch.profiler.record_function("driver/<phase>")``
range, so a profiler trace shows the trainer's phases beside the kernels. A
phase's duration is host wall time: the trainer ends each phase on finished
device work (host tokens, ``float(loss)``). The rest of the JAX package's
telemetry (span traces, counters and gauges, the registry) is ROADMAP queue
1 item 11.
"""

from __future__ import annotations

import time

import torch


class PhaseSpans:
    """Times named phases: ``with phases("update"): ...``."""

    def __init__(self):
        self._durations: dict[str, float] = {}
        self._active: str | None = None
        self._range: torch.profiler.record_function | None = None
        self._t0 = 0

    def __call__(self, phase: str) -> "PhaseSpans":
        self._active = phase
        return self

    def __enter__(self) -> "PhaseSpans":
        self._range = torch.profiler.record_function(f"driver/{self._active}")
        self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        assert self._active is not None and self._range is not None
        self._durations[self._active] = (time.time_ns() - self._t0) / 1e9
        self._range.__exit__(*exc)
        self._active = self._range = None

    def metrics(self) -> dict[str, float]:
        return {f"timing/{k}_duration": v for k, v in self._durations.items()}
