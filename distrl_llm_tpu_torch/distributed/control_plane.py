"""Driver <-> worker RPC on the C++ TCP transport (``native/csrc/
control_plane.cc``, the JAX package's source copied), the JAX package's
``distributed/control_plane.py``:

* ``WorkerServer``: the worker's serve loop. DISPATCH frames run a handler
  and answer RESULT (or ERROR with the traceback); PING answers PONG; each
  driver connection is served on a thread of its own, so the weight bus's
  MSG_WEIGHTS frames land while a dispatch runs on another connection.
* ``DriverClient``: round-robin shard dispatch over the workers, all at
  once, with deadlines; health pings; **resubmission** of a dead worker's
  shards to the others; bounded retry of transient worker errors
  (``resilience.classify_worker_error``); poison-shard quarantine
  (``ShardFailedError``, or a None slot with ``allow_partial``); the rejoin
  loop that re-dials unhealthy workers with the policy's seeded backoff and
  re-admits them cold (``rejoin_epoch`` bumps, the remote engine's warm
  keys reset); ``add_worker`` / ``retire_worker``.
* SIGTERM on a worker (``request_shutdown``) drains: the dispatch in flight
  still delivers its result, then the serve loop ends.

The frame numbers are the JAX package's, so a driver of either package
speaks to a worker of the other. This side sends plain MSG_RESULT and
MSG_DISPATCH frames; the telemetry envelopes a traced JAX peer sends
(MSG_RESULT_TLM, MSG_DISPATCH_CTX) are unwrapped and their blob dropped
(the trace planes are ROADMAP queue 1 item 11). Payloads are opaque bytes;
callers pickle.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import pickle
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.distributed import resilience
from distrl_llm_tpu_torch.distributed.resilience import (
    RetryPolicy, ShardFailedError, WorkerError, classify_worker_error,
)
from distrl_llm_tpu_torch.native.build import build_library

log = logging.getLogger(__name__)

MSG_DISPATCH = 1
MSG_RESULT = 2
MSG_PING = 3
MSG_PONG = 4
MSG_SHUTDOWN = 5
MSG_ERROR = 6
MSG_RESULT_TLM = 7  # pickle((telemetry blob, result bytes)), from a traced JAX worker
MSG_WEIGHTS = 8  # one versioned adapter update of the weight bus (weight_bus.py)
MSG_DISPATCH_CTX = 9  # pickle((trace context, payload)), from a traced JAX driver


class WorkerDeadError(RuntimeError):
    """A worker missed its deadline or its connection broke."""


class _Lib:
    _inst = None
    _mu = threading.Lock()

    @classmethod
    def get(cls):
        with cls._mu:
            if cls._inst is None:
                lib = ctypes.CDLL(build_library("control_plane.cc"))
                lib.cp_listen.restype = ctypes.c_int64
                lib.cp_listen.argtypes = [ctypes.c_int]
                lib.cp_bound_port.restype = ctypes.c_int
                lib.cp_bound_port.argtypes = [ctypes.c_int64]
                lib.cp_accept.restype = ctypes.c_int64
                lib.cp_accept.argtypes = [ctypes.c_int64, ctypes.c_int]
                lib.cp_connect.restype = ctypes.c_int64
                lib.cp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
                lib.cp_send.restype = ctypes.c_int
                lib.cp_send.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
                                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
                lib.cp_recv_header.restype = ctypes.c_int
                lib.cp_recv_header.argtypes = [
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int]
                lib.cp_recv_payload.restype = ctypes.c_int
                lib.cp_recv_payload.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                                ctypes.c_int64, ctypes.c_int]
                lib.cp_close.argtypes = [ctypes.c_int64]
                cls._inst = lib
            return cls._inst


def dial(address: tuple[str, int], timeout_ms: int, channel: str = "dispatch"):
    """A framed connection to ``address``, wrapped by the active fault
    injector; OSError when it cannot connect."""
    host, port = address
    fd = _Lib.get().cp_connect(host.encode(), int(port), timeout_ms)
    if fd < 0:
        raise OSError(f"cannot connect to worker {host}:{port}")
    return resilience.wrap_connection(Connection(fd), channel=channel)


class Connection:
    """One framed TCP connection."""

    def __init__(self, fd: int):
        self._lib = _Lib.get()
        self.fd = fd
        self._send_mu = threading.Lock()

    def send(self, msg_type: int, req_id: int, payload: bytes = b"",
             timeout_ms: int = 30_000) -> None:
        # one writer per fd for the whole native write: cp_send frames
        # header and payload in one call, and interleaved writes would
        # corrupt the framing
        with self._send_mu:
            rc = self._lib.cp_send(self.fd, msg_type, req_id, payload, len(payload),
                                   timeout_ms)
        if rc != 0:
            raise WorkerDeadError("send failed (peer gone or deadline hit)")

    def recv(self, timeout_ms: int) -> tuple[int, int, bytes] | None:
        """One frame, or None on timeout. Raises WorkerDeadError on close."""
        t, rid, ln = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_int64()
        rc = self._lib.cp_recv_header(self.fd, ctypes.byref(t), ctypes.byref(rid),
                                      ctypes.byref(ln), timeout_ms)
        if rc == -1:
            return None
        if rc != 0:
            raise WorkerDeadError("connection closed")
        buf = ctypes.create_string_buffer(ln.value) if ln.value else None
        if ln.value and self._lib.cp_recv_payload(self.fd, buf, ln.value, timeout_ms) != 0:
            raise WorkerDeadError("payload truncated")
        return t.value, rid.value, buf.raw if buf else b""

    def close(self) -> None:
        if self.fd >= 0:
            self._lib.cp_close(self.fd)
            self.fd = -1


class WorkerServer:
    """Worker-side serve loop: ``handler(payload) -> bytes`` per DISPATCH,
    ``weights_handler(payload) -> bytes`` per MSG_WEIGHTS; exceptions travel
    back as ERROR frames with the traceback. Connections are served
    concurrently, one thread each."""

    def __init__(self, port: int = 0):
        self._lib = _Lib.get()
        self._server_fd = self._lib.cp_listen(port)
        if self._server_fd < 0:
            raise OSError(f"cannot listen on port {port}")
        self.port = self._lib.cp_bound_port(self._server_fd)
        self._draining = False
        self._stopped = False
        self.weights_handler: Callable[[bytes], bytes] | None = None

    def request_shutdown(self) -> None:
        """Graceful preemption (SIGTERM): finish and deliver the dispatch in
        flight, then leave the serve loop. Only sets a flag the loop polls
        at its next frame boundary, so it is signal-safe."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def serve_forever(self, handler: Callable[[bytes], bytes],
                      accept_timeout_ms: int = 1000) -> None:
        """Accept driver connections and serve until SHUTDOWN or a drain."""
        threads: list[threading.Thread] = []
        try:
            while not (self._draining or self._stopped):
                fd = self._lib.cp_accept(self._server_fd, accept_timeout_ms)
                if fd == -1:
                    continue  # accept timeout; keep listening
                if fd < 0:
                    raise OSError("accept failed")
                conn = resilience.wrap_connection(Connection(fd))
                t = threading.Thread(target=self._conn_loop, args=(conn, handler),
                                     name="cp-serve", daemon=True)
                threads.append(t)
                t.start()
                threads = [t for t in threads if t.is_alive()]
        finally:
            self._lib.cp_close(self._server_fd)
            # the stop flag before the joins: on the accept-failure exit no
            # drain is set, and a healthy connection thread would serve on
            self._stopped = True
            # frames in flight deliver their results; idle connections
            # notice the flag within one 1 s recv timeout
            for t in threads:
                t.join()

    def _conn_loop(self, conn: Connection, handler) -> None:
        try:
            self._serve_conn(conn, handler)
        except WorkerDeadError:
            log.info("driver connection dropped; re-listening")
        finally:
            conn.close()

    def _reply(self, conn: Connection, req_id: int, fn, payload: bytes) -> None:
        try:
            result = fn(payload)
        except Exception:  # noqa: BLE001 — shipped to the driver
            conn.send(MSG_ERROR, req_id, traceback.format_exc().encode())
            return
        conn.send(MSG_RESULT, req_id, result)

    def _weights(self, payload: bytes) -> bytes:
        wh = self.weights_handler
        if wh is None:
            raise RuntimeError("worker has no weight-bus handler (started without "
                               "--serve-model)")
        return wh(payload)

    def _serve_conn(self, conn: Connection, handler) -> None:
        while True:
            frame = conn.recv(timeout_ms=1000)
            if frame is None:
                if self._draining or self._stopped:
                    return  # idle between frames: drain at once
                continue
            msg_type, req_id, payload = frame
            if msg_type == MSG_PING:
                conn.send(MSG_PONG, req_id)
            elif msg_type == MSG_SHUTDOWN:
                conn.send(MSG_PONG, req_id)
                self._stopped = True  # the accept loop and every sibling stop
                return
            elif msg_type == MSG_DISPATCH:
                self._reply(conn, req_id, handler, payload)
            elif msg_type == MSG_DISPATCH_CTX:
                # a traced JAX driver's envelope: the context is dropped
                self._reply(conn, req_id, lambda p: handler(pickle.loads(p)[1]), payload)
            elif msg_type == MSG_WEIGHTS:
                # on this connection's thread, beside any dispatch in flight
                self._reply(conn, req_id, self._weights, payload)
            else:
                log.warning("unexpected frame type %d", msg_type)
            if self._draining or self._stopped:
                return  # a drain landed while the frame ran; its result went out


@dataclass
class _Worker:
    address: tuple[str, int]
    conn: Connection | None
    healthy: bool = True
    cold: bool = False  # just (re)joined: its engine process builds its graphs anew
    retired: bool = False  # terminal: never re-dialed, never routed to


class DriverClient:
    """Driver-side dispatch and collect over N workers with failure
    handling. ``retry_policy`` governs transient-error retries, reconnect
    backoff and the deadline budgets; ``poison_threshold`` is K, the count
    of distinct workers a shard must fail on to be quarantined; ``rejoin``
    starts the background reconnect loop."""

    def __init__(self, addresses: Sequence[tuple[str, int]],
                 connect_timeout_ms: int = 10_000, *,
                 retry_policy: RetryPolicy | None = None,
                 poison_threshold: int = 3,
                 rejoin: bool = True,
                 rejoin_poll_s: float = 0.25):
        self._lib = _Lib.get()
        self._workers: list[_Worker] = []
        self._ids = itertools.count(1)
        self._dispatch_ids = itertools.count(1)
        self._id_mu = threading.Lock()
        self._workers_mu = threading.Lock()  # health and membership transitions
        self._connect_timeout_ms = connect_timeout_ms
        self.retry = retry_policy or RetryPolicy()
        self.poison_threshold = max(int(poison_threshold), 1)
        self.rejoin_epoch = 0  # bumps on every (re)admission
        self.membership_epoch = 0  # bumps on add_worker / retire_worker
        # rejoin_hook(address) runs after a PING-verified dial and before the
        # admission (the weight bus's full resync; False fails the attempt);
        # transient_hook(worker, error) before each same-worker retry of a
        # transient error (the bus re-pushes a version the worker lacked)
        self.rejoin_hook: Callable[[tuple[str, int]], bool] | None = None
        self.transient_hook: Callable[[_Worker, WorkerError], None] | None = None
        self.shutdown_hooks: list[Callable[[], None]] = []
        # per shard of the last dispatch_round: {worker, dispatch_id} of the
        # call that succeeded (None for a slot that never completed)
        self.last_dispatch_meta: list[dict | None] = []
        for address in addresses:
            self._workers.append(_Worker(tuple(address), dial(address, connect_timeout_ms)))
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)
        self._stop_rejoin = threading.Event()
        self._rejoin_thread: threading.Thread | None = None
        if rejoin:
            self._rejoin_poll_s = rejoin_poll_s
            self._rejoin_thread = threading.Thread(target=self._rejoin_loop,
                                                   name="cp-rejoin", daemon=True)
            self._rejoin_thread.start()

    @property
    def num_healthy(self) -> int:
        return sum(w.healthy for w in self._workers)

    @property
    def addresses(self) -> list[tuple[str, int]]:
        """Configured worker addresses, in construction order."""
        return [w.address for w in self._workers]

    def worker_states(self) -> list[dict]:
        """One dict per configured worker: address, healthy, cold, retired."""
        with self._workers_mu:
            return [{"address": f"{w.address[0]}:{w.address[1]}", "healthy": bool(w.healthy),
                     "cold": bool(w.cold), "retired": bool(w.retired)}
                    for w in self._workers]

    def _next_id(self) -> int:
        with self._id_mu:
            return next(self._ids)

    def _mark_unhealthy(self, w: _Worker, conn: Connection | None = None) -> None:
        """Close and demote a worker; with ``conn``, only if that is still
        its connection (a racing rejoin may have replaced it)."""
        with self._workers_mu:
            if conn is not None and w.conn is not conn:
                return
            w.healthy = False
            if w.conn is not None:
                w.conn.close()
                w.conn = None
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)

    # ---------------------------------------------------------------- rejoin

    def _rejoin_loop(self) -> None:
        """Re-dial unhealthy workers with the policy's backoff, keyed by
        address; a PING-verified connection re-admits the worker cold. A
        retired worker is never probed."""
        backoff: dict[tuple, tuple[int, float]] = {}
        while not self._stop_rejoin.wait(self._rejoin_poll_s):
            with self._workers_mu:
                snapshot = list(self._workers)
            for w in snapshot:
                if self._stop_rejoin.is_set():
                    break
                if w.retired or w.healthy:
                    backoff.pop(w.address, None)
                    continue
                attempt, next_t = backoff.get(w.address, (0, 0.0))
                if time.monotonic() < next_t:
                    continue
                if self._try_rejoin(w):
                    backoff.pop(w.address, None)
                else:
                    backoff[w.address] = (attempt + 1,
                                          time.monotonic() + self.retry.backoff(attempt))

    def _dial_verified(self, address: tuple[str, int]) -> Connection | None:
        """Dial, PING, and run the rejoin hook (the bus's full resync): the
        verified connection, or None."""
        try:
            conn = dial(address, self._connect_timeout_ms)
        except OSError:
            return None
        rid = self._next_id()
        try:
            conn.send(MSG_PING, rid)
            frame = conn.recv(timeout_ms=5000)
            ok = frame is not None and frame[0] == MSG_PONG and frame[1] == rid
        except WorkerDeadError:
            ok = False
        if ok and self.rejoin_hook is not None:
            # the joining worker's engine has no adapter cache: push the
            # current version before it is admitted
            try:
                ok = bool(self.rejoin_hook(tuple(address)))
            except Exception:  # noqa: BLE001 — a failed resync fails this attempt
                log.warning("join/rejoin hook failed for %s", address, exc_info=True)
                ok = False
        if not ok:
            conn.close()
            return None
        return conn

    def _try_rejoin(self, w: _Worker) -> bool:
        with telemetry.span("cp/reconnect"):
            conn = self._dial_verified(w.address)
            if conn is None:
                return False
            with self._workers_mu:
                if self._stop_rejoin.is_set() or w.retired:
                    conn.close()  # shutdown or a racing retire won
                    return False
                w.conn, w.cold, w.healthy = conn, True, True
                self.rejoin_epoch += 1
        telemetry.counter_add(resilience.CP_RECONNECTS)
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)
        telemetry.gauge_set(resilience.CP_REJOIN_EPOCH, self.rejoin_epoch)
        log.info("worker %s:%d rejoined (cold)", *w.address)
        return True

    # ----------------------------------------------------------- membership

    @staticmethod
    def _parse_address(address) -> tuple[str, int]:
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            return (host or "127.0.0.1", int(port))
        return (address[0], int(address[1]))

    def add_worker(self, address) -> bool:
        """Admit a new worker mid-run, cold: dial, PING, full resync through
        ``rejoin_hook``. False when it cannot be verified or is already an
        active member; a retired address is re-activated."""
        address = self._parse_address(address)
        with self._workers_mu:
            existing = next((w for w in self._workers if w.address == address), None)
            if existing is not None and not existing.retired:
                log.warning("add_worker(%s): already a member", address)
                return False
        conn = self._dial_verified(address)
        if conn is None:
            return False
        with self._workers_mu:
            if self._stop_rejoin.is_set():
                conn.close()
                return False
            target = next((w for w in self._workers if w.address == address), None)
            if target is None:
                target = _Worker(address, None, healthy=False)
                self._workers.append(target)
            elif not target.retired:
                conn.close()  # lost an add/add race
                return False
            target.retired, target.conn, target.cold, target.healthy = False, conn, True, True
            self.rejoin_epoch += 1
            self.membership_epoch += 1
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)
        telemetry.gauge_set(resilience.CP_REJOIN_EPOCH, self.rejoin_epoch)
        log.info("worker %s:%d added (cold)", *address)
        return True

    def retire_worker(self, address, drain: bool = True, timeout_ms: int = 5000) -> bool:
        """Intentional scale-in: the worker becomes retired (terminal), its
        shard in flight requeues to the others; ``drain`` sends MSG_SHUTDOWN
        over a connection of its own. False for an unknown or retired
        address."""
        address = self._parse_address(address)
        with self._workers_mu:
            target = next((w for w in self._workers if w.address == address), None)
            if target is None or target.retired:
                return False
            target.retired, target.healthy = True, False
            conn, target.conn = target.conn, None
            self.membership_epoch += 1
        if conn is not None:
            conn.close()
        if drain:
            # not on the dispatch connection: a drain thread may be blocked
            # in recv there
            try:
                dconn = dial(address, self._connect_timeout_ms)
            except OSError:
                dconn = None
            if dconn is not None:
                try:
                    dconn.send(MSG_SHUTDOWN, self._next_id())
                    dconn.recv(timeout_ms)
                except WorkerDeadError:
                    pass  # already gone: retired either way
                finally:
                    dconn.close()
        telemetry.counter_add(resilience.CP_RETIRES)
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)
        log.info("worker %s:%d retired", *address)
        return True

    # ---------------------------------------------------------------- health

    def quarantine_worker(self, address, *, min_healthy: int = 1) -> bool:
        """Proactive demotion of a live worker; the rejoin loop re-admits it
        cold. Refused when unknown, unhealthy or retired, when fewer than
        ``min_healthy`` would remain, or without a rejoin loop."""
        address = self._parse_address(address)
        if self._rejoin_thread is None:
            log.warning("refusing to quarantine %s: worker_rejoin is off", address)
            return False
        with self._workers_mu:
            target = next((w for w in self._workers if w.address == address), None)
            if target is None or not target.healthy or target.retired:
                return False
            if sum(w.healthy for w in self._workers) - 1 < max(int(min_healthy), 1):
                return False
            conn = target.conn
        self._mark_unhealthy(target, conn)
        telemetry.counter_add(resilience.CP_QUARANTINES)
        return True

    def ping_all(self, timeout_ms: int = 5000) -> list[bool]:
        """Health-check every worker, one thread each; a missed or
        mismatched PONG closes the connection (a late PONG would desync the
        request/response pairing)."""

        def ping(w: _Worker) -> bool:
            conn = w.conn
            if conn is None:
                return False  # the rejoin loop owns it
            rid = self._next_id()
            try:
                t0 = time.perf_counter()
                conn.send(MSG_PING, rid)
                frame = conn.recv(timeout_ms)
                ok = frame is not None and frame[0] == MSG_PONG and frame[1] == rid
                if ok:
                    telemetry.hist_observe(resilience.CP_RPC_PING_MS,
                                           (time.perf_counter() - t0) * 1e3)
            except WorkerDeadError:
                ok = False
            if ok:
                with self._workers_mu:
                    if w.conn is conn:
                        w.healthy = True
            else:
                self._mark_unhealthy(w, conn)
            return ok

        if not self._workers:
            return []
        with ThreadPoolExecutor(max_workers=len(self._workers),
                                thread_name_prefix="cp-ping") as pool:
            out = list(pool.map(ping, self._workers))
        telemetry.gauge_set(resilience.CP_HEALTHY_GAUGE, self.num_healthy)
        return out

    # -------------------------------------------------------------- dispatch

    def _call(self, w: _Worker, payload: bytes, timeout_ms: int) -> tuple[bytes, dict]:
        """One dispatch RPC: (result bytes, {worker, dispatch_id})."""
        rid = self._next_id()
        conn = w.conn  # one snapshot: a retire or demotion nulls it concurrently
        if conn is None:
            raise WorkerDeadError(f"worker {w.address} connection closed mid-round "
                                  "(retired or demoted)")
        with self._id_mu:
            dispatch_id = next(self._dispatch_ids)
        meta = {"worker": f"{w.address[0]}:{w.address[1]}", "dispatch_id": dispatch_id}
        with telemetry.span("cp/dispatch"):
            t0 = time.perf_counter()
            telemetry.counter_add(resilience.CP_DISPATCH_BYTES, len(payload))
            conn.send(MSG_DISPATCH, rid, payload)
            frame = conn.recv(timeout_ms)
        if frame is None:
            raise WorkerDeadError(f"worker {w.address} missed the {timeout_ms}ms deadline")
        msg_type, got_rid, body = frame
        if got_rid != rid or msg_type not in (MSG_RESULT, MSG_RESULT_TLM, MSG_ERROR):
            raise WorkerDeadError(f"worker {w.address} protocol violation")
        if msg_type == MSG_ERROR:
            tb = body.decode(errors="replace")
            raise WorkerError(w.address, tb, transient=classify_worker_error(tb))
        if msg_type == MSG_RESULT_TLM:
            _blob, body = pickle.loads(body)  # a traced JAX worker's spans: dropped
        telemetry.hist_observe(resilience.CP_RPC_DISPATCH_MS, (time.perf_counter() - t0) * 1e3)
        return body, meta

    def _call_with_retry(self, w: _Worker, payload: bytes, timeout_ms: int) -> tuple[bytes, dict]:
        """``_call`` plus the policy's bounded retry of transient worker
        errors on the same worker (it answered: it is alive), within the
        per-call budget; fatal errors and deaths propagate."""
        attempt = 0
        t0 = time.monotonic()
        while True:
            try:
                return self._call(w, payload, timeout_ms)
            except WorkerError as e:
                if not e.transient or attempt >= self.retry.max_call_retries:
                    raise
                delay = self.retry.backoff(attempt)
                budget = self.retry.call_budget_s
                if budget is not None and time.monotonic() - t0 + delay > budget:
                    raise
                attempt += 1
                telemetry.counter_add(resilience.CP_RETRIES)
                if self.transient_hook is not None:
                    try:
                        self.transient_hook(w, e)
                    except Exception:  # noqa: BLE001 — the retry is the recovery
                        log.warning("transient-error hook failed for %s", w.address,
                                    exc_info=True)
                with telemetry.span("cp/retry"):
                    log.warning("transient worker error on %s (retry %d/%d in %.3fs): %s",
                                w.address, attempt, self.retry.max_call_retries, delay,
                                e.traceback_text.strip().splitlines()[-1])
                    time.sleep(delay)

    def _drain(self, w: _Worker, idxs: list[int], shards, timeout_ms: int, results, meta):
        """One worker's queue, in order: (requeue, failures). Only the shard
        in flight at a worker's death is recorded against it (the poison
        signature); the rest of its queue just redistributes."""
        conn = w.conn
        requeue: list[int] = []
        failures: list[tuple[int, str]] = []
        for pos, i in enumerate(idxs):
            try:
                results[i], meta[i] = self._call_with_retry(w, shards[i], timeout_ms)
            except WorkerDeadError as e:
                log.warning("worker %s lost; resubmitting %d shard(s): %s",
                            w.address, len(idxs) - pos, e)
                self._mark_unhealthy(w, conn)
                failures.append((i, "dead"))
                requeue.extend(idxs[pos:])
                telemetry.counter_add(resilience.CP_RESUBMITS, len(idxs) - pos)
                break
            except WorkerError as e:
                if not e.transient:
                    raise  # deterministic program error: fail loudly
                log.warning("shard %d exhausted transient retries on worker %s; "
                            "requeueing", i, w.address)
                failures.append((i, "exhausted"))
                requeue.append(i)
                telemetry.counter_add(resilience.CP_RESUBMITS)
        return requeue, failures

    def dispatch_round(self, shards: Sequence[bytes], timeout_ms: int = 240_000,
                       allow_partial: bool = False) -> list[bytes]:
        """Dispatch shards round-robin over the healthy workers, every
        worker at once (one thread each, its shards in order over its one
        connection). A dead worker is marked unhealthy and its shards go to
        the others; the round fails only when none remain. A shard that
        fails on ``poison_threshold`` distinct workers (or
        ``retry.max_shard_attempts`` attempts) raises ``ShardFailedError``,
        or with ``allow_partial`` leaves None in its slot (the list stays
        aligned with ``shards``)."""
        results: list[bytes | None] = [None] * len(shards)
        meta: list[dict | None] = [None] * len(shards)
        shard_workers: dict[int, set] = {}
        shard_attempts: dict[int, int] = {}
        quarantined: set[int] = set()
        pending = list(range(len(shards)))
        t_round = time.monotonic()
        # the caller chose this round's deadline knowing the rejoin epoch:
        # workers cold at entry are covered; a worker that rejoins mid-round
        # stays cold and sits the round out while warm ones remain
        with self._workers_mu:
            for w in self._workers:
                w.cold = False
        while pending:
            budget = self.retry.round_budget_s
            if budget is not None and time.monotonic() - t_round > budget:
                raise WorkerDeadError(f"dispatch round exceeded its {budget:.0f}s budget "
                                      f"with {len(pending)} shard(s) still pending")
            with self._workers_mu:
                avail = [w for w in self._workers if w.healthy and w.conn and not w.retired]
                warm = [w for w in avail if not w.cold]
            healthy = warm or avail
            if not healthy:
                raise WorkerDeadError("no healthy workers remain")
            queues: dict[int, list[int]] = {id(w): [] for w in healthy}
            for k, i in enumerate(pending):
                # a requeued shard prefers workers it has not failed on, so
                # the K-distinct-workers poison signature can accumulate
                failed_on = shard_workers.get(i)
                candidates = ([w for w in healthy if w.address not in failed_on]
                              if failed_on else healthy) or healthy
                queues[id(candidates[k % len(candidates)])].append(i)
            outcomes = []
            first_exc: BaseException | None = None
            pool = ThreadPoolExecutor(max_workers=len(healthy), thread_name_prefix="cp-drain")
            try:
                futs = [(w, pool.submit(self._drain, w, queues[id(w)], shards, timeout_ms,
                                        results, meta))
                        for w in healthy if queues[id(w)]]
                for w, f in futs:
                    try:
                        outcomes.append((w, *f.result()))
                    except BaseException as e:  # noqa: BLE001 — surfaced below
                        if first_exc is None:
                            first_exc = e
            finally:
                # join every drain before surfacing: none may write into
                # ``results`` after this frame returns
                pool.shutdown(wait=True, cancel_futures=True)
            if first_exc is not None:
                raise first_exc
            pending = []
            for w, requeue, failures in outcomes:
                failed_here = set()
                for i, _kind in failures:
                    failed_here.add(i)
                    shard_workers.setdefault(i, set()).add(w.address)
                    shard_attempts[i] = shard_attempts.get(i, 0) + 1
                for i in requeue:
                    if i in failed_here and (
                            len(shard_workers[i]) >= self.poison_threshold
                            or shard_attempts[i] >= self.retry.max_shard_attempts):
                        telemetry.counter_add(resilience.CP_POISON_SHARDS)
                        err = ShardFailedError(i, workers=sorted(shard_workers[i]),
                                               attempts=shard_attempts[i])
                        if not allow_partial:
                            raise err
                        log.error("degrading: %s", err)
                        quarantined.add(i)
                    else:
                        pending.append(i)
        self.last_dispatch_meta = meta
        if allow_partial:
            return [None if i in quarantined else results[i] for i in range(len(shards))]
        return [r for r in results if r is not None]

    def dispatch_objects(self, shards: Sequence[Any], timeout_ms: int = 240_000,
                         allow_partial: bool = False) -> list[Any]:
        """pickle-in / pickle-out over ``dispatch_round``."""
        raw = self.dispatch_round([pickle.dumps(s) for s in shards], timeout_ms,
                                  allow_partial=allow_partial)
        return [pickle.loads(r) if r is not None else None for r in raw]

    def shutdown(self, timeout_ms: int = 5000) -> None:
        for hook in self.shutdown_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — shutdown must proceed
                log.warning("shutdown hook failed", exc_info=True)
        self._stop_rejoin.set()
        if self._rejoin_thread is not None:
            self._rejoin_thread.join(timeout=5)
            self._rejoin_thread = None
        # detach under the lock, then shut down: a rejoin still in flight
        # either admitted before (its connection gets MSG_SHUTDOWN) or meets
        # the stop flag and closes its own
        with self._workers_mu:
            conns = [w.conn for w in self._workers]
            for w in self._workers:
                w.conn, w.healthy = None, False
        for conn in conns:
            if conn is not None:
                try:
                    conn.send(MSG_SHUTDOWN, self._next_id())
                    conn.recv(timeout_ms)
                except WorkerDeadError:
                    pass
                conn.close()
