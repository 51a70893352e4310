"""Metrics sinks: the reference's wandb contract behind a pluggable interface.

Copied from the JAX package's ``metrics.py``: the exact metric names and step
semantics of the reference (distributed_trainer.py:237-239, :348-366,
:412-415) through wandb when it is importable, a JSONL file otherwise, a null
sink or an in-memory one for tests. ``wandb`` is imported only when a wandb
sink is made.

Metric-name contract:
  train (per batch step, distributed_trainer.py:348-366):
    loss, mean_accuracy_reward, min_accuracy_reward, max_accuracy_reward,
    mean_format_reward, mean_token_length, episode, total_batch_steps,
    total_samples_processed, timing/update_duration, timing/reward_duration,
    timing/generation_duration
  eval (distributed_trainer.py:412-415):
    eval/pass@1(mean{n}), eval/BoN({n}), eval/mean_token_length,
    timing/eval_duration
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Protocol


class MetricsSink(Protocol):
    def log(self, metrics: Mapping[str, Any], step: int) -> None: ...
    def finish(self) -> None: ...


class NullSink:
    """Discard everything (tests, dry runs)."""

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class MemorySink:
    """Keep everything in a list (assertions in tests)."""

    def __init__(self):
        self.records: list[tuple[int, dict[str, Any]]] = []

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        self.records.append((step, dict(metrics)))

    def finish(self) -> None:
        pass


class JsonlSink:
    """Append one JSON object per log call — the offline-host default."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        rec = {"_step": step, "_ts": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def finish(self) -> None:
        self._f.close()


class WandbSink:
    """The reference sink: wandb.init(name, config, project) ->
    run.log(metrics, step) -> finish (distributed_trainer.py:237-239)."""

    def __init__(self, run_name: str | None, project: str, config: Mapping[str, Any]):
        import wandb

        self._run = wandb.init(name=run_name, config=dict(config), project=project)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        self._run.log(dict(metrics), step=step)

    def finish(self) -> None:
        self._run.finish()


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return float(v) if hasattr(v, "__float__") else str(v)


def make_sink(
    backend: str,
    *,
    run_name: str | None,
    project: str,
    config: Mapping[str, Any],
    run_dir: str = ".",
) -> MetricsSink:
    """``auto`` -> wandb if importable and logged in, else jsonl."""
    if backend == "null":
        return NullSink()
    if backend == "jsonl":
        return JsonlSink(os.path.join(run_dir, "metrics.jsonl"))
    if backend in ("wandb", "auto"):
        try:
            return WandbSink(run_name, project, config)
        except Exception:
            if backend == "wandb":
                raise
            return JsonlSink(os.path.join(run_dir, "metrics.jsonl"))
    raise ValueError(f"unknown metrics backend {backend!r}")
