"""The versioned weight bus (JAX ``distributed/weight_bus.py``): one delta
push per learner version instead of the adapter in every dispatch.

* **Wire codec.** ``encode_update`` / ``decode_update`` ship an adapter
  tree once per version, delta-encoded against the worker's last acked
  version. Per leaf the encoder tries, in order, a bf16 delta (``new -
  prev``, 2 bytes an element), an f32 delta, and the full tensor, checking
  each candidate's reconstruction bit for bit before choosing it, so the
  decoded tree is byte-identical to the learner's. A crc32 checksum of the
  target tree rides along; a worker whose decode mismatches raises
  ``WeightChecksumError`` and the sender falls back to a full push. The
  choice of mode, the bytes and the checksum are the JAX codec's on every
  leaf: bf16 rounds with torch (round to nearest even, as ``ml_dtypes``
  does), a bf16 leaf travels as its 2-byte pattern under the dtype name
  ``"bfloat16"``, and the port decodes it into a CPU ``torch.bfloat16``
  tensor. Leaves go in ``jax.tree_util``'s flatten order (dict keys
  sorted), so a checksum here equals the JAX one on the same tree.
* **AdapterCache**: the worker's versioned 2-slot cache (current +
  superseded); dispatches name ``{weight_version: v}`` and ``wait_for``
  bridges the race where a dispatch lands before its broadcast.
* **WeightBus**: the driver's broadcaster, over connections of its own
  (separate from the dispatch channel, so a push lands mid-round): a
  single-slot mailbox drained by a sender thread (the learner never blocks
  on the wire, the newest push supersedes an unsent one), per-version
  parallel fan-out with the control plane's retry backoff, per-worker acked
  (version, tree) state feeding the next delta, full resync on first
  contact, rejoin and unknown-version re-requests.

Series: ``cp/weight_bytes_sent``, ``cp/weight_pushes``,
``cp/weight_full_syncs``, ``cp/weight_rerequests`` and the
``cp/weight_broadcast_ms`` histogram (push to last worker ack).
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.distributed import resilience
from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy

log = logging.getLogger(__name__)

# how long a dispatch naming a not-yet-arrived version waits for the
# broadcast before raising the (transient) WeightVersionError
WEIGHT_WAIT_ENV = "DISTRL_WEIGHT_WAIT_S"
DEFAULT_WEIGHT_WAIT_S = 30.0

WEIGHT_PUSH_SPAN = "cp/weight_push"
BF16 = "bfloat16"


class WeightVersionError(RuntimeError):
    """A worker was asked for an adapter version it does not hold;
    ``[transient]``, so the driver retries after re-pushing it."""

    def __init__(self, message: str):
        super().__init__(f"[transient] {message}")


class WeightChecksumError(RuntimeError):
    """A decoded adapter's checksum mismatched the sender's; the sender
    falls back to a full-tensor push."""

    def __init__(self, message: str):
        super().__init__(f"[transient] {message}")


# ------------------------------------------------------------------- trees


def _flatten(tree) -> tuple[list, Any]:
    """Leaves in ``jax.tree_util`` order (dict keys sorted, sequences in
    order, None holds nothing) and the structure to rebuild them into."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = _flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            sub, d = _flatten(x)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, None, tuple(defs))
    if tree is None:
        return [], ("none", None, ())
    return [tree], ("leaf", None, ())


def _unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind, keys, subs = d
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, children))
        return tuple(children) if kind == "tuple" else children

    return build(treedef)


def _leaf(x) -> tuple[np.ndarray, str]:
    """(C-contiguous host array, dtype name) of a leaf: a bf16 leaf (a torch
    tensor, or an ``ml_dtypes`` array of a JAX tree) as its uint16 bit
    pattern named ``"bfloat16"``."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), BF16
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == BF16:
        return np.ascontiguousarray(a.view(np.uint16)), BF16
    return a, a.dtype.name


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to nearest even, as ``ml_dtypes`` and torch cast."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _to_f32(a: np.ndarray, dtype: str) -> np.ndarray:
    return _bf16_to_f32(a) if dtype == BF16 else a.astype(np.float32, copy=False)


def _from_f32(x: np.ndarray, dtype: str) -> np.ndarray:
    return _f32_to_bf16(x) if dtype == BF16 else x.astype(dtype, copy=False)


def _same_bits(x: np.ndarray, y: np.ndarray) -> bool:
    """Bit-for-bit equality (the JAX codec compares ``tobytes()``: -0.0 is
    not 0.0, and a NaN equals its own pattern)."""
    unsigned = f"u{x.dtype.itemsize}"
    return np.array_equal(np.ascontiguousarray(x).view(unsigned),
                          np.ascontiguousarray(y).view(unsigned))


def _floating(dtype: str) -> bool:
    return dtype == BF16 or np.issubdtype(np.dtype(dtype), np.floating)


def checksum_tree(tree) -> int:
    """crc32 over the tree's leaves in flatten order (dtype name and shape
    included, so a reshaped or recast tree never collides)."""
    crc = 0
    for x in _flatten(tree)[0]:
        a, dtype = _leaf(x)
        crc = zlib.crc32(f"{dtype}{a.shape}".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def _encode_leaf(new, prev) -> dict:
    """One leaf's wire record: the cheapest encoding whose reconstruction
    is bit-exact (checked here): bf16 delta, f32 delta, full. First contact
    (no prev) and shape or dtype drift are full."""
    a, dtype = _leaf(new)
    rec = {"dtype": dtype, "shape": tuple(a.shape)}
    if prev is not None:
        p, pdtype = _leaf(prev)
        if p.shape == a.shape and pdtype == dtype and _floating(dtype):
            return _encode_delta(rec, a, p, dtype)
    rec.update(mode="full", data=a.tobytes())
    return rec


def _encode_delta(rec: dict, a: np.ndarray, p: np.ndarray, dtype: str) -> dict:
    # an infinite or NaN leaf makes a NaN delta: that candidate fails the
    # bit check, as it should, so numpy's warnings about it are noise
    with np.errstate(invalid="ignore", over="ignore"):
        prev32 = _to_f32(p, dtype)
        delta32 = _to_f32(a, dtype) - prev32
        d16 = _f32_to_bf16(delta32)
        if _same_bits(_from_f32(prev32 + _bf16_to_f32(d16), dtype), a):
            rec.update(mode="delta_bf16", data=d16.tobytes())
            return rec
        if _same_bits(_from_f32(prev32 + delta32, dtype), a):
            rec.update(mode="delta_f32", data=delta32.tobytes())
            return rec
    rec.update(mode="full", data=a.tobytes())
    return rec


def _array(a: np.ndarray, dtype: str):
    """A decoded leaf: numpy, or a CPU bf16 tensor for a bf16 leaf."""
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _decode_leaf(rec: dict, prev):
    dtype, shape, mode = rec["dtype"], tuple(rec["shape"]), rec["mode"]
    wire = np.uint16 if dtype == BF16 else np.dtype(dtype)
    if mode == "full":
        return _array(np.frombuffer(rec["data"], dtype=wire).reshape(shape).copy(), dtype)
    if prev is None:
        raise WeightChecksumError(f"delta leaf ({mode}) arrived with no base tensor to "
                                  "apply it to")
    p, _ = _leaf(prev)
    prev32 = _to_f32(p, dtype)
    if mode == "delta_bf16":
        delta = _bf16_to_f32(np.frombuffer(rec["data"], dtype=np.uint16).reshape(shape))
    elif mode == "delta_f32":
        delta = np.frombuffer(rec["data"], dtype=np.float32).reshape(shape)
    else:
        raise ValueError(f"unknown weight-leaf mode {mode!r}")
    return _array(_from_f32(prev32 + delta, dtype), dtype)


def encode_update(new_tree, version: int, prev_tree=None,
                  base_version: int | None = None) -> dict:
    """One version's wire payload: per-leaf records (delta against
    ``prev_tree`` where bit-exact, full otherwise) and the target checksum;
    ``prev_tree=None`` (first contact, forced resync) encodes full. A full
    payload carries a pickled skeleton of plain containers and zero-size
    numpy leaves, so a cold worker rebuilds the tree's structure."""
    new_leaves, treedef = _flatten(new_tree)
    prev_leaves = [None] * len(new_leaves)
    if prev_tree is not None:
        p_leaves, p_def = _flatten(prev_tree)
        if p_def == treedef and len(p_leaves) == len(new_leaves):
            prev_leaves = p_leaves  # else structure drift: full
    records = [_encode_leaf(n, p) for n, p in zip(new_leaves, prev_leaves)]
    is_delta = base_version is not None and {r["mode"] for r in records} != {"full"}
    payload = {
        "version": int(version),
        "base_version": int(base_version) if is_delta else None,
        "leaves": records,
        "checksum": checksum_tree(new_tree),
        "delta": is_delta,
    }
    if not is_delta:
        # a bf16 leaf's skeleton is uint16: the skeleton carries structure
        # only, and pickles without ml_dtypes
        payload["tree_pickle"] = pickle.dumps(_unflatten(treedef, [
            np.zeros((), np.uint16 if r["dtype"] == BF16 else r["dtype"]) for r in records]))
    return payload


def decode_update(payload: dict, prev_tree=None) -> tuple[int, Any]:
    """Inverse of ``encode_update``: (version, tree), the tree checked
    against the sender's checksum (``WeightChecksumError`` on a mismatch)."""
    records = payload["leaves"]
    if payload.get("base_version") is not None:
        if prev_tree is None:
            raise WeightVersionError(
                f"update v{payload['version']} is a delta against "
                f"v{payload['base_version']}, which this worker does not hold")
        prev_leaves, treedef = _flatten(prev_tree)
        if len(prev_leaves) != len(records):
            raise WeightChecksumError(
                f"delta v{payload['version']} carries {len(records)} leaves but base "
                f"v{payload['base_version']} has {len(prev_leaves)}")
        tree = _unflatten(treedef, [_decode_leaf(r, p) for r, p in zip(records, prev_leaves)])
    else:
        flat, skel_def = _flatten(pickle.loads(payload["tree_pickle"]))
        if len(flat) != len(records):
            raise WeightChecksumError("structure skeleton does not match the leaf records")
        tree = _unflatten(skel_def, [_decode_leaf(r, None) for r in records])
    got = checksum_tree(tree)
    if got != payload["checksum"]:
        raise WeightChecksumError(
            f"decoded adapter v{payload['version']} checksum {got:#x} != sender's "
            f"{payload['checksum']:#x} (base v{payload.get('base_version')})")
    return int(payload["version"]), tree


def serialize_update(payload: dict) -> bytes:
    """Frame bytes for one update."""
    return pickle.dumps(payload)


def tree_leaves(tree) -> list:
    """The tree's leaves in flatten order (the order ``checksum_tree``
    hashes)."""
    return _flatten(tree)[0]


# ------------------------------------------------------ worker-side cache


class AdapterCache:
    """Versioned 2-slot adapter cache (current + superseded). ``put`` keeps
    the inserted version plus the highest other, so an out-of-order resync
    never evicts the version it just delivered."""

    def __init__(self, slots: int = 2):
        self._slots = max(int(slots), 1)
        self._entries: dict[int, Any] = {}
        self._cv = threading.Condition()

    def put(self, version: int, tree) -> None:
        with self._cv:
            self._entries[int(version)] = tree
            while len(self._entries) > self._slots:
                del self._entries[min(v for v in self._entries if v != int(version))]
            self._cv.notify_all()

    def get(self, version: int | None):
        if version is None:
            return None
        with self._cv:
            return self._entries.get(int(version))

    def wait_for(self, version: int, timeout_s: float):
        """The tree of ``version``, waiting out the dispatch-vs-broadcast
        race; ``WeightVersionError`` (transient) after ``timeout_s``."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self._cv:
            while int(version) not in self._entries:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise WeightVersionError(
                        f"unknown weight version v{version} (cache holds "
                        f"{sorted(self._entries)}) after {timeout_s:.1f}s — "
                        "WeightVersionError: re-push required")
                self._cv.wait(remaining)
            return self._entries[int(version)]

    def versions(self) -> list[int]:
        with self._cv:
            return sorted(self._entries)

    @property
    def current_version(self) -> int | None:
        with self._cv:
            return max(self._entries) if self._entries else None

    def previous(self) -> tuple[int, Any] | None:
        """The superseded slot (version, tree), if one is held."""
        with self._cv:
            if len(self._entries) < 2:
                return None
            v = sorted(self._entries)[-2]
            return v, self._entries[v]


def resolve_wait_s() -> float:
    try:
        return float(os.environ.get(WEIGHT_WAIT_ENV, DEFAULT_WEIGHT_WAIT_S))
    except ValueError:
        return DEFAULT_WEIGHT_WAIT_S


# ------------------------------------------------------- driver-side bus


class WeightBus:
    """Driver-side versioned broadcaster over out-of-band connections, one
    per worker. ``push`` never blocks on the wire: (tree, version) lands in
    a single-slot mailbox the sender thread consumes; a newer push
    supersedes an unsent one."""

    def __init__(self, addresses: Sequence[tuple[str, int]], *,
                 retry_policy: RetryPolicy | None = None,
                 connect_timeout_ms: int = 10_000,
                 ack_timeout_ms: int = 120_000,
                 connection_factory: Callable | None = None):
        self._addresses = [tuple(a) for a in addresses]
        self._members_mu = threading.Lock()
        self.retry = retry_policy or RetryPolicy()
        self._connect_timeout_ms = connect_timeout_ms
        self._ack_timeout_ms = ack_timeout_ms
        self._connection_factory = connection_factory or self._dial
        self._chan: dict[tuple, Any] = {}
        self._chan_mu: dict[tuple, threading.Lock] = {a: threading.Lock()
                                                      for a in self._addresses}
        self._chan_mu_guard = threading.Lock()
        self._acked: dict[tuple, tuple[int, Any]] = {}  # per worker: the next delta's base
        self._acked_mu = threading.Lock()
        # the last frame encoded, with what it was encoded from (_encoded)
        self._memo: tuple | None = None
        self._encode_mu = threading.Lock()
        self._req_id = 0
        self._id_mu = threading.Lock()
        # single-slot mailbox, swapped out whole under its lock
        self._pending: tuple | None = None
        self._pending_mu = threading.Lock()
        self._busy = False  # the sender is between taking a push and its record
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Condition()
        self.last_pushed_version: int | None = None
        self.last_acked_version: int | None = None
        self.last_broadcast_bytes = 0  # every worker's frames of the last broadcast
        self.last_broadcast_ms: float | None = None
        self.last_ack_ms: dict[str, float] = {}  # "host:port" -> ms, acked workers
        # the last broadcasts, each {"version", "ms", "bytes": {worker: frame
        # bytes}, "modes": {worker: "delta" | "full"}, "leaf_modes": {worker:
        # {leaf mode: leaves}}, "acked": [...]}
        self.history: collections.deque[dict] = collections.deque(maxlen=64)
        # on_broadcast(version, total_ms, acks_ms, complete) after each
        # broadcast attempt, and complete=True when a resync finishes one
        self.on_broadcast: Callable[[int, float | None, dict, bool], None] | None = None
        self._sender = threading.Thread(target=self._sender_loop, name="cp-weight-bus",
                                        daemon=True)
        self._sender.start()

    # ------------------------------------------------------------- plumbing

    def _dial(self, address: tuple[str, int]):
        from distrl_llm_tpu_torch.distributed.control_plane import dial

        return dial(address, self._connect_timeout_ms, channel="weights")

    def _next_id(self) -> int:
        with self._id_mu:
            self._req_id += 1
            return self._req_id

    def _channel(self, address: tuple):
        conn = self._chan.get(address)
        if conn is None:
            conn = self._connection_factory(address)
            self._chan[address] = conn
        return conn

    def _drop_channel(self, address: tuple) -> None:
        conn = self._chan.pop(address, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already tearing down
                pass

    # ---------------------------------------------------------- membership

    def member_addresses(self) -> list[tuple]:
        with self._members_mu:
            return list(self._addresses)

    def _is_member(self, address: tuple) -> bool:
        with self._members_mu:
            return tuple(address) in self._addresses

    def add_worker(self, address: tuple) -> bool:
        """Admit a broadcast target (before the control plane's admission
        hook resyncs it); False if already a member."""
        address = tuple(address)
        with self._members_mu:
            if address in self._addresses:
                return False
            self._addresses.append(address)
        with self._chan_mu_guard:
            self._chan_mu.setdefault(address, threading.Lock())
        return True

    def retire_worker(self, address: tuple) -> bool:
        """Remove a broadcast target: drop its channel and acked state, and
        wake a ``flush`` waiting on its ack."""
        address = tuple(address)
        with self._members_mu:
            if address not in self._addresses:
                return False
            self._addresses.remove(address)
        self._drop_channel(address)
        with self._acked_mu:
            self._acked.pop(address, None)
        self._refresh_acked()
        with self._done:
            self._done.notify_all()
        return True

    # --------------------------------------------------------------- pushes

    def push(self, tree_np, version: int) -> None:
        """Enqueue (tree, version) for broadcast; supersedes an unsent one."""
        with self._pending_mu:
            self._pending = (tree_np, int(version))
            self.last_pushed_version = int(version)
        self._wake.set()

    def _drained(self) -> bool:
        if self._pending is not None or self._busy:
            return False
        if self.last_pushed_version is None:
            return True
        targets = self.member_addresses()
        with self._acked_mu:
            return all(self._acked.get(a, (None, None))[0] == self.last_pushed_version
                       for a in targets)

    def flush(self, timeout_s: float = 60.0) -> bool:
        """Block until every worker acked the newest push (by broadcast or
        resync) and the broadcast in progress is recorded; False past the
        deadline."""
        deadline = time.monotonic() + timeout_s
        with self._done:
            while not self._drained():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._done.wait(min(remaining, 0.25))
        return True

    def _sender_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.1)
            if self._stop.is_set():
                return
            with self._pending_mu:
                pending, self._pending = self._pending, None
                self._busy = pending is not None
            self._wake.clear()
            if pending is None:
                continue
            try:
                self._broadcast(*pending)
            except Exception:  # noqa: BLE001 — the sender survives; acked state is the truth
                log.exception("weight broadcast failed")
            with self._done:
                self._busy = False
                self._done.notify_all()

    def _broadcast(self, tree_np, version: int) -> None:
        t0 = time.perf_counter()
        targets = self.member_addresses()
        record = {"version": int(version), "bytes": {}, "modes": {}, "leaf_modes": {},
                  "acked": []}

        def timed_push(a):
            tw = time.perf_counter()
            ok, nbytes, leaf_modes = self._push_worker(a, tree_np, version)
            return a, ok, nbytes, leaf_modes, (time.perf_counter() - tw) * 1e3

        total, oks, acks = 0, [], {}
        with ThreadPoolExecutor(max_workers=max(len(targets), 1),
                                thread_name_prefix="cp-weight-push") as pool:
            for a, ok, nbytes, leaf_modes, ack_ms in pool.map(timed_push, targets):
                name = f"{a[0]}:{a[1]}"
                oks.append(ok)
                total += nbytes
                record["bytes"][name], record["leaf_modes"][name] = nbytes, leaf_modes
                record["modes"][name] = (None if not leaf_modes else "full"
                                         if set(leaf_modes) == {"full"} else "delta")
                if ok:
                    acks[name] = ack_ms
                    record["acked"].append(name)
        ms = (time.perf_counter() - t0) * 1e3
        self.last_broadcast_bytes, self.last_ack_ms, self.last_broadcast_ms = total, acks, ms
        record["ms"] = ms
        self.history.append(record)
        telemetry.hist_observe(resilience.CP_WEIGHT_BROADCAST_MS, ms)
        if oks and all(oks):
            self.last_acked_version = int(version)
        else:
            self._refresh_acked()
        self._notify_broadcast(version, ms, acks, bool(oks) and all(oks))

    def _notify_broadcast(self, version: int, ms: float | None, acks: dict,
                          complete: bool) -> None:
        if self.on_broadcast is not None:
            try:
                self.on_broadcast(int(version), ms, dict(acks), complete)
            except Exception:  # noqa: BLE001 — bookkeeping never takes the sender down
                log.warning("on_broadcast hook failed", exc_info=True)

    def _encoded(self, tree_np, version: int, base: tuple | None) -> tuple[bytes, str, dict]:
        """(frame, "delta" | "full", {leaf mode: leaves}) of ``tree_np`` as
        ``version`` against ``base`` ((version, tree) or None). Workers that
        acked the same base get the same frame: a broadcast encodes it once
        (its pushes run on one thread each and wait here for the first)."""
        with self._encode_mu:
            memo = self._memo
            if (memo is not None and memo[0] is tree_np and memo[1] == version
                    and memo[2] == (None if base is None else base[0])
                    and memo[3] is (None if base is None else base[1])):
                return memo[4]
            payload = encode_update(tree_np, version, prev_tree=base[1] if base else None,
                                    base_version=base[0] if base else None)
            leaf_modes: dict[str, int] = {}
            for r in payload["leaves"]:
                leaf_modes[r["mode"]] = leaf_modes.get(r["mode"], 0) + 1
            out = (serialize_update(payload),
                   "delta" if payload["base_version"] is not None else "full", leaf_modes)
            self._memo = (tree_np, version, None if base is None else base[0],
                          None if base is None else base[1], out)
            return out

    def _push_worker(self, address: tuple, tree_np, version: int, *,
                     force_full: bool = False) -> tuple[bool, int, dict]:
        """Push one version to one worker, delta against its acked base,
        with policy-bounded retries; a checksum or unknown-base rejection
        falls back to a full push. (acked, bytes sent, {leaf mode: leaves}
        of the last frame sent)."""
        from distrl_llm_tpu_torch.distributed.control_plane import (
            MSG_ERROR, MSG_RESULT, MSG_WEIGHTS, WorkerDeadError,
        )

        address = tuple(address)
        host, port = address
        sent_total, full, leaf_modes = 0, force_full, {}
        with self._chan_mu_guard:
            mu = self._chan_mu.setdefault(address, threading.Lock())
        # the channel lock pins the wire for the whole push+ack exchange
        # (the sender thread and a resync are the only contenders)
        with mu:
            for attempt in range(self.retry.max_call_retries + 1):
                if not self._is_member(address):
                    return False, sent_total, leaf_modes  # retired mid-broadcast
                with self._acked_mu:
                    base = None if full else self._acked.get(address)
                frame, mode, leaf_modes = self._encoded(tree_np, version, base)
                rid = self._next_id()
                try:
                    with telemetry.span(WEIGHT_PUSH_SPAN):
                        conn = self._channel(address)
                        conn.send(MSG_WEIGHTS, rid, frame, timeout_ms=self._ack_timeout_ms)
                        sent_total += len(frame)
                        telemetry.counter_add(resilience.CP_WEIGHT_BYTES, len(frame))
                        telemetry.counter_add(resilience.CP_WEIGHT_PUSHES)
                        if mode == "full":
                            telemetry.counter_add(resilience.CP_WEIGHT_FULL_SYNCS)
                        back = conn.recv(self._ack_timeout_ms)
                        if back is None:
                            raise WorkerDeadError(
                                f"weight ack from {host}:{port} missed the "
                                f"{self._ack_timeout_ms}ms deadline")
                        msg_type, got_rid, body = back
                        if got_rid != rid:
                            raise WorkerDeadError(f"weight bus to {host}:{port}: "
                                                  "protocol violation")
                        if msg_type == MSG_ERROR:
                            tb = body.decode(errors="replace")
                            if "WeightChecksumError" in tb or "WeightVersionError" in tb:
                                # the worker's base is unusable or absent: full push
                                log.warning("weight push v%d to %s:%d rejected (%s); falling "
                                            "back to full tensor", version, host, port,
                                            tb.strip().splitlines()[-1])
                                with self._acked_mu:
                                    self._acked.pop(address, None)
                                full = True
                                continue
                            raise WorkerDeadError(f"weight push to {host}:{port} failed:\n{tb}")
                        if msg_type != MSG_RESULT:
                            raise WorkerDeadError(f"weight bus to {host}:{port}: unexpected "
                                                  f"frame type {msg_type}")
                        ack = pickle.loads(body)
                        if int(ack.get("version", -1)) != int(version):
                            raise WorkerDeadError(f"weight ack names v{ack.get('version')} "
                                                  f"!= pushed v{version}")
                    with self._acked_mu:
                        self._acked[address] = (int(version), tree_np)
                    return True, sent_total, leaf_modes
                except (WorkerDeadError, OSError) as e:
                    self._drop_channel(address)
                    if attempt >= self.retry.max_call_retries:
                        log.warning("weight push v%d to %s:%d exhausted retries: %s",
                                    version, host, port, e)
                        break
                    time.sleep(self.retry.backoff(attempt))
        # unreachable: the eventual rejoin resync starts from a full tensor
        with self._acked_mu:
            self._acked.pop(address, None)
        return False, sent_total, leaf_modes

    # ------------------------------------------------------------- resyncs

    def sync_worker(self, address: tuple, tree_np=None, version: int | None = None) -> bool:
        """Synchronous full push of one version to one worker (the rejoin
        hook and the unknown-version re-request); defaults to the newest
        pushed tree. True when acked."""
        if tree_np is None or version is None:
            pending = self._pending
            if pending is not None:
                tree_np, version = pending
            else:
                with self._acked_mu:
                    current = [(v, t) for v, t in self._acked.values()
                               if self.last_pushed_version is None
                               or v == self.last_pushed_version]
                if current:
                    version, tree_np = current[0]
        if tree_np is None or version is None:
            return True  # nothing ever pushed: nothing to resync
        self._drop_channel(tuple(address))
        ok, _, _ = self._push_worker(tuple(address), tree_np, int(version), force_full=True)
        if ok:
            self._refresh_acked()
            if self.last_acked_version == int(version):
                self._notify_broadcast(int(version), None, {}, True)
            with self._done:
                self._done.notify_all()
        return ok

    def _refresh_acked(self) -> None:
        """The all-workers-acked watermark from per-worker state."""
        if self.last_pushed_version is None:
            return
        targets = self.member_addresses()
        with self._acked_mu:
            if all(self._acked.get(a, (None, None))[0] == self.last_pushed_version
                   for a in targets):
                self.last_acked_version = self.last_pushed_version

    def acked_version(self, address: tuple) -> int | None:
        with self._acked_mu:
            entry = self._acked.get(tuple(address))
        return entry[0] if entry else None

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._sender.join(timeout=5)
        for address in list(self._chan):
            self._drop_channel(address)
