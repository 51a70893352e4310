"""The pushed weights under the overlapped rollout modes: copies into a
small ring of persistent buffers, ordered against the rollout's stream.

In the pipelined and async modes a generation round runs while the learner
updates. Adam8bit updates the adapter in place, so a round must not read the
learner's tensors (the JAX package copies its pushed tree for the same
reason, JAX ``trainer.py:944-949``). A fresh copy per push would put the
adapter at new addresses each step, and a CUDA graph reads its adapter by
address (``engine/decode_graph.py``): every step would pay an eager chunk
and a capture, and the engine's graphs would pile up. So each push copies
into one of ``size`` buffers allocated once (two; three when the
speculative self-drafter keeps the previous adapter resident), and the
graph keys of a shape stay bounded by the ring's size.

* **Holds.** A buffer is read while a round holds it: from the round's
  entry (``acquire``, the published adapter) or from an in-flight swap that
  took it (``swap_hook``, run by the engine's mailbox as the swap is
  consumed, on whatever thread decodes the round), until the swap that
  drops it or the round's end (``release_round``, given the handle
  ``acquire`` returned): holds are kept per round, never per thread. With
  the self-drafter the dropped adapter is the previous one the engine lets
  go of; the superseded one stays held as the new previous adapter. A push writes a buffer that is neither published
  nor held, waiting on the host for one when there is none (a round that
  has not yet reached the boundary where it lets go). A round that opens
  with an adapter no buffer holds (a remote worker's dispatch naming a
  version that later pushes overwrote, or shipping an adapter of its own)
  has it copied into a free buffer that it holds (``acquire(load=)``).
* **Device order.** Every hand-off between the learner's stream and the
  rollout's is a CUDA event, never a device-wide synchronize: the push waits
  (on the learner's stream) for the events the rollout recorded on its own
  stream when it let go of the buffer, copies, and records a ready event
  that the rollout's stream waits on before its first read. On the CPU the
  host order suffices.
* **Identity.** Each push publishes a new dict over the buffer's tensors:
  the engine's radix cache keys cached KV on the adapter object's identity.
* **Any tree of weights.** The buffers may be modules instead of adapter
  dicts: full fine-tuning's rollout copies, ``Decoder``s at the rollout's
  dtype that the caller hands in (``buffers=``), each push casting the f32
  masters into one of them, parameter by parameter. A module is published
  as itself with its ``weights_version`` bumped: each copy carries its own
  version, so the engine's prefix cache, which keys cached KV on the model
  object and its version, never serves KV written under another copy or
  an older push, and each copy is one key of the engine's graphs.
"""

from __future__ import annotations

import threading

import torch


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return [tree["layers"][t][k] for t in sorted(tree["layers"]) for k in ("a", "b")]


class _Round:
    """A round's hold: the buffer it reads now (None once released, or
    after a swap to an adapter the ring does not track)."""

    __slots__ = ("buf",)

    def __init__(self, buf: int | None):
        self.buf = buf


class AdapterRing:
    """``size`` persistent weight buffers on ``device``; the learner
    ``push``es into them, rounds ``acquire`` the published one. Adapter
    buffers are allocated at their first push; module buffers (``buffers``,
    ``size`` of them) are the caller's."""

    def __init__(self, size: int, device: torch.device, *,
                 buffers: list[torch.nn.Module] | None = None):
        if size < 2:
            raise ValueError(f"an adapter ring needs at least 2 buffers, got {size}")
        if buffers is not None and len(buffers) != size:
            raise ValueError(f"a ring of {size} buffers was given {len(buffers)}")
        self.size = size
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._bufs: list = list(buffers) if buffers is not None else [None] * size
        # the latest published dict over each buffer and its version
        self._dicts: list[dict | None] = [None] * size
        self._versions: list[int | None] = [None] * size
        self._holds = [0] * size
        self._ready: list = [None] * size  # recorded after the buffer's last write
        self._released: list[list] = [[] for _ in range(size)]  # since that write
        self._published: int | None = None
        self._writing: int | None = None  # the buffer a push is copying into
        self._live: _Round | None = None  # the round in flight on the engine
        self._cv = threading.Condition()
        self.pushes = 0
        self.push_waits = 0  # pushes that waited on the host for a free buffer
        # per push: (buffer written, version, every buffer's holds when it
        # was chosen, the released events its copy waited on)
        self.books: list[tuple[int, int, tuple, int]] = []

    # ------------------------------------------------------------- learner

    def push(self, tree, version: int):
        """Copy ``tree`` ({"layers": {target: {"a", "b"}}}, or a module whose
        parameters match the module buffers') into a free buffer on the
        calling thread's stream, casting to the buffer's dtype, publish it
        as ``version`` and return what rounds read: a new dict over that
        buffer's tensors, or the module buffer itself."""
        with self._cv:
            while True:
                free = self._free()
                if free:
                    break
                self.push_waits += 1
                self._cv.wait()
            j = free[0]
            self._writing = j
            waits, self._released[j] = self._released[j], []
            self.books.append((j, version, tuple(self._holds), len(waits)))
        published = self._write(j, tree, waits)
        with self._cv:
            self._dicts[j], self._versions[j] = published, version
            self._published, self._writing = j, None
            self.pushes += 1
        return published

    def _write(self, j: int, tree, waits: list):
        """Copy ``tree`` into buffer ``j`` on the calling stream after the
        ``waits`` events, record its ready event; returns the buffer's new
        published form."""
        stream = torch.cuda.current_stream(self.device) if self._cuda else None
        for event in waits:
            stream.wait_event(event)
        if self._bufs[j] is None:
            self._bufs[j] = {"layers": {t: {k: torch.empty_like(x, requires_grad=False)
                                            for k, x in ab.items()}
                                        for t, ab in tree["layers"].items()}}
        with torch.no_grad():
            for dst, src in zip(_leaves(self._bufs[j]), _leaves(tree), strict=True):
                dst.copy_(src)
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(stream)
        buf = self._bufs[j]
        if isinstance(buf, torch.nn.Module):
            buf.weights_version += 1
            published = buf
        else:
            published = {"layers": {t: dict(ab) for t, ab in buf["layers"].items()}}
        with self._cv:
            self._ready[j] = ready
        return published

    def _free(self) -> list[int]:
        """Buffers a copy may write, the one after the published first:
        neither published nor held nor being written."""
        start = 0 if self._published is None else self._published + 1
        order = [(start + i) % self.size for i in range(self.size)]
        return [j for j in order if j != self._published and j != self._writing
                and self._holds[j] == 0]

    # ------------------------------------------------------------- rollout

    def acquire(self, version: int | None = None, *, load=None) -> tuple:
        """At a round's entry: hold the published buffer (with ``version``,
        the buffer that holds that version: a remote worker's round opens
        with the version its dispatch names, which a later push may already
        have superseded) and order the calling stream after its copy;
        returns (adapter, version, the round's handle for
        ``release_round``). With ``load`` (a callable returning the adapter
        tree), an adapter no buffer holds (a ``version`` later pushes
        overwrote, or with ``version`` None one a dispatch ships of its own)
        is copied into a free buffer that is not published and held by the
        round, so that the round still reads the ring's addresses; without
        it such a version raises ``LookupError``. The engine runs one round
        at a time, so the swaps its mailbox reports belong to this round
        until it is released, whichever thread decodes it (the hang
        detector's runs the round on a thread of its own)."""
        with self._cv:
            if self._live is not None:
                raise RuntimeError("a round acquired the adapter ring while another "
                                   "round on its engine was in flight")
            j = self._published
            if version is not None and j is not None and self._versions[j] != version:
                j = next((i for i, v in enumerate(self._versions) if v == version), None)
            if version is None and load is not None:
                j = None
            if j is None:
                if load is None:
                    if self._published is None:
                        raise RuntimeError("no adapter was pushed into the ring")
                    raise LookupError(f"no ring buffer holds adapter version {version}")
                free = self._free()
                if not free:  # no round is in flight to let go of one
                    raise RuntimeError(f"no free ring buffer for adapter version {version}: "
                                       f"holds {self._holds}")
                j = free[0]
                self._holds[j] += 1
                self._live = handle = _Round(j)
                waits, self._released[j] = self._released[j], []
            else:
                self._holds[j] += 1
                self._live = handle = _Round(j)
                ready, d, v = self._ready[j], self._dicts[j], self._versions[j]
                waits = None
        if waits is not None:
            try:
                d, v = self._write(j, load(), waits), version
            except BaseException:
                self.release_round(handle)
                raise
            with self._cv:
                self._dicts[j], self._versions[j] = d, v
            return d, v, handle
        self._wait_ready(ready)
        return d, v, handle

    def swap_hook(self, dropped, taken) -> None:
        """The engine mailbox's ``lora_swap_hook``: hold what the swap took,
        let go of what it dropped (either may be an adapter the ring never
        published: a test's or a tool's; those are not tracked). What it
        took is what the round in flight reads from then on."""
        with self._cv:
            jt = self._index_of(taken)
            ready = None
            if jt is not None:
                self._holds[jt] += 1
                ready = self._ready[jt]
            if self._live is not None:
                self._live.buf = jt
            jd = self._index_of(dropped)
            if jd is not None:
                self._release_locked(jd)
        self._wait_ready(ready)

    def release_round(self, handle: _Round) -> None:
        """At a round's end, on the thread that acquired it: let go of the
        buffer it read last (the acquired one, or what its last swap took)."""
        with self._cv:
            if self._live is handle:
                self._live = None
            j, handle.buf = handle.buf, None
            if j is not None:
                self._release_locked(j)

    # ------------------------------------------------------------- helpers

    def _index_of(self, d) -> int | None:
        if d is None:
            return None
        return next((j for j, pub in enumerate(self._dicts) if pub is d), None)

    def _release_locked(self, j: int) -> None:
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._released[j].append(event)
        self._holds[j] -= 1
        if self._holds[j] < 0:
            raise RuntimeError(f"adapter ring buffer {j} released more often than held")
        self._cv.notify_all()

    def _wait_ready(self, ready) -> None:
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)

    def holds(self) -> list[int]:
        with self._cv:
            return list(self._holds)
