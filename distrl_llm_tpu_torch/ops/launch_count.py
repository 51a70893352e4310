"""The kernel wrappers' launch counts, safe across threads.

Each wrapper keeps its count as a module-level int (``fused_sample_launches``
in ``ops/sampling.py``, ...) that callers read and reset, and adds to it
through :func:`add` at the one place it launches its kernel. Two host
threads launch at once when a rollout overlaps an update (the trainer's
pipelined and async modes), so:

* every addition is made under one lock, and is also tallied per thread
  (:func:`thread_counts`): a caller that wants one thread's launches (a
  round on the rollout thread, the learner on the others) reads its tally's
  delta;
* while a thread captures a CUDA graph (``engine/decode_graph.py``) its
  additions go to the capture's own dict (:func:`diverted`): a capture
  launches nothing, and a replay adds the captured counts with
  :func:`add_counts`. Launches made by other threads meanwhile are counted
  as usual.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections import Counter

_mu = threading.Lock()
_tls = threading.local()
# thread ident -> Counter of (module, counter name) -> launches
_by_thread: dict[int, Counter] = {}


def add(module: str, name: str, n: int = 1) -> None:
    """Add ``n`` launches to ``module``'s counter ``name`` (the calling
    thread's capture dict instead while it captures)."""
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        sink[(module, name)] += n
        return
    mod = sys.modules[module]
    ident = threading.get_ident()
    with _mu:
        setattr(mod, name, getattr(mod, name) + n)
        _by_thread.setdefault(ident, Counter())[(module, name)] += n


def add_counts(counts) -> None:
    """Add a {(module, counter name): launches} dict to the counters and to
    the calling thread's tally (a replay adds its capture's counts)."""
    if not counts:
        return
    ident = threading.get_ident()
    with _mu:
        tally = _by_thread.setdefault(ident, Counter())
        for (module, name), n in counts.items():
            mod = sys.modules[module]
            setattr(mod, name, getattr(mod, name) + n)
            tally[(module, name)] += n


@contextlib.contextmanager
def diverted():
    """Within, the calling thread's launches go to the yielded Counter, not
    to the counters: what a CUDA graph capture records."""
    prev = getattr(_tls, "sink", None)
    sink: Counter = Counter()
    _tls.sink = sink
    try:
        yield sink
    finally:
        _tls.sink = prev


def thread_counts(ident: int | None = None) -> Counter:
    """A copy of the launches thread ``ident`` (default the caller) made
    since the process started, by (module, counter name)."""
    ident = threading.get_ident() if ident is None else ident
    with _mu:
        return Counter(_by_thread.get(ident, ()))


def all_thread_counts() -> dict[int, Counter]:
    """Copies of every thread's tally, by thread ident."""
    with _mu:
        return {k: Counter(v) for k, v in _by_thread.items()}
