"""Phase spans and the metrics registry.

* ``PhaseSpans`` is the JAX package's ``telemetry.PhaseSpans``: ``with
  phases("generation"): ...`` then ``phases.metrics()`` gives the
  reference's exact ``timing/generation_duration`` names
  (distributed_trainer.py:348-366). Each phase is also a
  ``torch.profiler.record_function`` range under the JAX package's span
  name, so a profiler trace shows the trainer's phases beside the kernels.
  A phase's duration is host wall time: the trainer ends each phase on
  finished device work (host tokens, ``float(loss)``).
* The registry the rollout modules write (JAX ``telemetry.py:285-450``):
  ``span`` (a ``record_function`` range), ``counter_add``, ``gauge_set``,
  ``hist_observe``, ``metrics_snapshot`` (counters report and reset their
  delta, gauges their last value, histograms count/mean/p50/p90/max) and
  ``reset``. One lock guards it: the rollout thread and the learner write
  at once. The trainer merges each snapshot into its metrics record.

The rest of the JAX package's telemetry (Chrome trace export, the obs blob,
remote tracks, the device-peak table) is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import threading
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


# ---------------------------------------------------------------- registry


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        # weighted observations: (value, count) per hist_observe call
        self.hists: dict[str, list[tuple[float, int]]] = {}
        self.touched: set[str] = set()  # series with data since the last snapshot


_REG = _Registry()


def reset() -> None:
    """Drop every recorded series (tests)."""
    global _REG
    _REG = _Registry()


def span(name: str) -> torch.profiler.record_function:
    """A named range on the profiler's trace: ``with span("rollout/produce"):
    ...``."""
    return torch.profiler.record_function(name)


def counter_add(name: str, value: float = 1.0) -> None:
    """Monotonic counter; ``metrics_snapshot`` reports and resets its delta."""
    reg = _REG
    with reg.lock:
        reg.counters[name] = reg.counters.get(name, 0.0) + value
        reg.touched.add(name)


def gauge_set(name: str, value: float) -> None:
    """Last-value gauge (``rollout/buffer_occupancy``)."""
    reg = _REG
    with reg.lock:
        reg.gauges[name] = value
        reg.touched.add(name)


def hist_observe(name: str, value: float, *, count: int = 1) -> None:
    """Histogram observation (``rollout/staleness``), ``count`` times."""
    if count < 1:
        return
    reg = _REG
    with reg.lock:
        reg.hists.setdefault(name, []).append((value, count))
        reg.touched.add(name)


def metrics_snapshot() -> dict[str, float]:
    """Flat metric dict for the sink: counters report-and-reset their delta,
    gauges report their last value, histograms report
    ``_count/_mean/_p50/_p90/_max`` and reset. Only series touched since the
    previous snapshot appear."""
    reg = _REG
    out: dict[str, float] = {}
    with reg.lock:
        for name in sorted(reg.touched):
            if name in reg.counters:
                out[name] = reg.counters.pop(name)
            elif name in reg.gauges:
                out[name] = reg.gauges[name]
            elif name in reg.hists:
                pairs = sorted(reg.hists.pop(name))
                n = sum(c for _, c in pairs)

                def at(idx: int, pairs=pairs) -> float:
                    cum = 0
                    for v, c in pairs:
                        cum += c
                        if idx < cum:
                            return v
                    return pairs[-1][0]

                out[f"{name}_count"] = float(n)
                out[f"{name}_mean"] = sum(v * c for v, c in pairs) / n
                out[f"{name}_p50"] = at(n // 2)
                out[f"{name}_p90"] = at(min(int(n * 0.9), n - 1))
                out[f"{name}_max"] = pairs[-1][0]
        reg.touched.clear()
    return out
