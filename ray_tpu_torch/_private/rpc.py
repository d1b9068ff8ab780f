"""Control-plane RPC: length-prefixed pickled frames over TCP.

Plays the role of the reference's gRPC layer (/root/reference/src/ray/rpc/
grpc_server.h:73, client_call.h) for the Python control daemons.  Design goals
match the reference's: full-duplex connections (either side can push), request
multiplexing over one socket, per-connection ordering (the property the actor
task queue relies on), and reconnect-free failure surfacing (a dropped
connection fails all in-flight calls with ``ConnectionError``).

The data plane (large objects) never travels here — it goes through the
shared-memory store / chunked transfer, mirroring the reference's strict
control/data plane split (SURVEY.md §1).

Fast path (docs/rpc_fastpath.md):

* **Pooled dispatch** — requests run on a shared bounded thread pool
  (``rpc_dispatch_threads``) instead of a freshly spawned thread per RPC;
  on a 1-core box the per-request ``Thread.start()`` dominated small-RPC
  cost.  Per-connection dispatch order is unchanged (one reader enqueues
  in arrival order and the pool queue is FIFO).
* **Fast-method registry** — a server may mark handlers that never block
  and never call back into the connection (heartbeats, kv_get, liveness
  probes); those run inline on the reader thread, skipping the pool hop
  entirely.  Under schedule fuzz (``rpc_fuzz_ms``>0) fast methods fall
  back to the pool so the fuzzer can still perturb their interleaving.
* **Frame coalescing + scatter/gather writes** — frames are encoded to an
  iovec (header / buffer-length table / pickle body / out-of-band
  protocol-5 buffers) and written with ``sendmsg``; no length-prefix
  concatenation copy.  Writers enqueue frames and the first writer in
  drains the whole queue in one syscall batch, so back-to-back frames
  (pipelined pushes, batched replies) coalesce into one send.
* **recv_into framing** — the reader receives headers and pickle bodies
  into one reusable growable buffer instead of recv()+join allocations;
  out-of-band buffers land in fresh buffers (objects may keep views).
* **Stable frames** (docs/object_transfer.md) — a sender that guarantees
  a frame's out-of-band buffers stay immutable until written (sealed shm
  slices) passes ``stable=True`` + an ``on_sent`` hook: the write queue
  skips the defensive copy queued frames normally pay and fires the hook
  exactly once when the frame drains (or is dropped on failure), so the
  raylet's chunk server holds its shm pin only for the write's lifetime.

The inline-handler contract (machine-enforced)
----------------------------------------------

A handler registered via ``fast_methods`` runs ON THE CONNECTION'S
READER THREAD.  While it runs, nothing else is read off that socket —
so the contract is strict:

* it may **buffer, mutate in-memory state under short locks, notify
  waiters, enqueue reply/push frames, and return a value or a
  ``Deferred``** (resolved later from another thread);
* it must **never wait on another thread's or the peer's progress**: no
  ``time.sleep``, no ``Future.result`` / ``Event.wait`` /
  ``Condition.wait``, no synchronous ``Connection.call`` (its response
  arrives on a reader — possibly THIS one), no ``ray_tpu_torch.get`` / store
  fetches, no socket receives, no pool submits that are awaited.

The failure shape is not a slowdown but a distributed deadlock: on a
full-duplex connection, an inline handler blocking on reply drain stops
the reader whose peer may be blocked symmetrically on us (observed in
the collective take-handler incident, util/collective/transport.py).
Enqueueing frames is fine — ``_send`` may opportunistically flush, but
that is the transport's own bounded tradeoff, not a wait on a peer.

Handlers that are fast only CONDITIONALLY (worker_main's ``push_tasks``
is inline only for ref-free frames) must encode the condition in the
registration predicate, so the slow variant takes the pooled path.

This contract is enforced by the ``inline-handler-purity`` raylint
checker (docs/static_analysis.md): every registered fast name is
resolved to its handler and the call graph walked for blocking
primitives; violations fail tier-1.  Justified exceptions carry an
inline ``# raylint: disable=...`` comment with the reason.
"""

from __future__ import annotations

import itertools
import os
import pickle
import queue
import random
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.logging_utils import get_logger
from ray_tpu_torch._private import runtime_metrics as rtm

logger = get_logger("rpc")

# hot-path instruments, bound once at import (docs/observability.md):
# record calls are attribute arithmetic, no-ops when telemetry is off.
# _TELEMETRY guards the few sites whose *argument* computation isn't
# free (byte sums), so the kill switch removes that cost too.
_TELEMETRY = rtm.enabled()
_M_DISPATCH = rtm.histogram_family(
    "ray_tpu_rpc_dispatch_ms", "per-method RPC handler latency (ms)")
_M_INLINE = rtm.counter(
    "ray_tpu_rpc_dispatch_inline_total",
    "requests run inline on the reader thread (fast-method registry)")
_M_POOLED = rtm.counter(
    "ray_tpu_rpc_dispatch_pooled_total",
    "requests dispatched through the shared thread pool")
_M_FRAMES_OUT = rtm.counter(
    "ray_tpu_rpc_frames_sent_total", "frames written to the wire")
_M_SEND_BATCHES = rtm.counter(
    "ray_tpu_rpc_send_batches_total",
    "sendmsg flush batches (frames/batches = write coalescing factor)")
_M_BYTES_OUT = rtm.counter(
    "ray_tpu_rpc_bytes_sent_total", "payload bytes written to the wire")
_M_BYTES_IN = rtm.counter(
    "ray_tpu_rpc_bytes_received_total", "payload bytes read off the wire")
_M_WQ_DEPTH = rtm.gauge(
    "ray_tpu_rpc_write_queue_depth",
    "high-water write-queue depth since the last flush", watermark=True)

# cached (generation, value) of CONFIG.rpc_fuzz_ms: the old per-dispatch
# `from ...config import CONFIG` + flag resolution (lock + env lookup +
# parse) was measurable on the RPC hot path.  CONFIG.generation() bumps
# on every set()/update(), so runtime overrides (ray_tpu_torch.init's
# system_config) still take effect; raw os.environ writes made after the
# first dispatch are not observed (set the flag via CONFIG instead).
_fuzz_gen = -1
_fuzz_ms = 0.0


def _fuzz_ms_now() -> float:
    global _fuzz_gen, _fuzz_ms
    gen = CONFIG.generation()
    if gen != _fuzz_gen:
        _fuzz_ms = CONFIG.rpc_fuzz_ms
        _fuzz_gen = gen
    return _fuzz_ms


def _maybe_fuzz() -> None:
    """Schedule fuzzing: jitter every RPC dispatch by up to
    ``rpc_fuzz_ms`` (config; default 0 = off).

    The single-language analog of the reference's TSAN/schedule-stress
    race tooling: a handler that only works because replies "usually
    arrive in order" fails under fuzz.  The race-sensitive suites
    (lease races, chaos, GCS fault tolerance) run under it in
    tests/test_sched_fuzz.py."""
    ms = _fuzz_ms_now()
    if ms > 0:
        time.sleep(random.uniform(0.0, ms / 1000.0))


# distributed-tracing context install around dispatch (lazy import: rpc
# is imported by everything, tracing_helper only needs CONFIG but the
# indirection keeps cold rpc startup free of it)
_trace_mod = None


def _trace_install(ctx):
    global _trace_mod
    if _trace_mod is None:
        from ray_tpu_torch.util.tracing import tracing_helper
        _trace_mod = tracing_helper
    return _trace_mod.install(ctx)


def _trace_uninstall(token) -> None:
    _trace_mod.uninstall(token)


# wire format: one frame is
#   <IIBQ>  (pickle_len, nbufs, kind, msg_id)
#   nbufs * <Q>  out-of-band buffer lengths
#   pickle body (protocol 5)
#   out-of-band buffers, concatenated
# kind/msg_id ride the fixed header (duplicating the pickled tuple) so
# the reader can route a response's out-of-band buffers to a registered
# buffer sink BEFORE unpickling — the bulk-data pull path receives chunk
# payloads straight into their shm destination offsets with recv_into
# (docs/object_transfer.md), no per-chunk allocation or copy.
# All peers are in-repo daemons spawned from the same tree (csrc/rpcnet.h
# is the C++ twin), so the format needs no version negotiation.
_HDR = struct.Struct("<IIBQ")
_BLEN = struct.Struct("<Q")
_REQUEST, _RESPONSE, _PUSH = 0, 1, 2

# sendmsg iovec batching cap: well under any platform IOV_MAX, large
# enough that a burst of small frames still coalesces into few syscalls
_IOV_BATCH = 64
# write-queue soft cap: beyond this, enqueuers block until the active
# flusher drains (backpressure instead of unbounded buffering)
_WQ_CAP = 1024
# out-of-band buffer count cap, enforced on BOTH sides: the sender falls
# back to in-band pickling past it, the receiver treats a bigger count
# as a garbled header (protocol-mismatch guard)
_NBUFS_MAX = 4096
# frame payload ceiling, enforced on BOTH sides: the sender fails the
# one oversized call with ValueError; the receiver treats a bigger
# header as garbled and drops the connection.  Control-plane payloads
# this large are a bug — bulk data belongs to the store/chunk transfer.
_BODY_MAX = 1 << 30


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """Handler raised on the remote side; wraps the original exception."""

    def __init__(self, cause: BaseException):
        super().__init__(repr(cause))
        self.cause = cause


class Deferred:
    """Out-of-band reply handle: a handler returns one of these and some
    other thread resolves it later, sending the response directly from
    the resolving thread.

    This removes the parked-thread pattern (handler blocks on an Event a
    worker loop sets, then wakes just to return) — on a contended box
    that wake-to-reply hop is a full context switch per RPC.  Resolution
    and binding race safely: whichever happens second sends the reply.

    ``resolve(value, stable=True, on_sent=cb)`` marks the reply frame's
    out-of-band buffers as immutable-until-sent: the write queue ships
    them zero-copy (no defensive materialization) and invokes ``cb``
    exactly once after the frame drains to the socket — or is dropped by
    a connection failure.  The raylet's chunk server uses this to pin a
    shm slice only for the lifetime of the write
    (docs/object_transfer.md)."""

    _UNSET = object()
    __slots__ = ("_lock", "_conn", "_msg_id", "_result")

    def __init__(self):
        self._lock = threading.Lock()
        self._conn: Optional["Connection"] = None
        self._msg_id: Optional[int] = None
        self._result = Deferred._UNSET

    def _bind(self, conn: "Connection", msg_id: int) -> None:
        with self._lock:
            self._conn, self._msg_id = conn, msg_id
            result = self._result
        if result is not Deferred._UNSET:
            ok, value, stable, on_sent = result
            conn._respond(msg_id, ok, value, stable=stable,
                          on_sent=on_sent)

    def resolve(self, value: Any, *, stable: bool = False,
                on_sent: Optional[Callable[[], None]] = None) -> None:
        self._finish(True, value, stable, on_sent)

    def fail(self, error: BaseException) -> None:
        self._finish(False, error, False, None)

    def _finish(self, ok: bool, value: Any, stable: bool,
                on_sent: Optional[Callable[[], None]]) -> None:
        with self._lock:
            if self._result is not Deferred._UNSET:
                if on_sent is not None:
                    _run_cb(on_sent)  # double-resolve must not leak pins
                return
            self._result = (ok, value, stable, on_sent)
            conn, msg_id = self._conn, self._msg_id
        if conn is not None:
            conn._respond(msg_id, ok, value, stable=stable, on_sent=on_sent)


def _run_cb(cb: Optional[Callable[[], None]]) -> None:
    if cb is None:
        return
    try:
        cb()
    except Exception:
        logger.exception("rpc on_sent callback failed")


# ---------------------------------------------------------------- dispatch
_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_pid = 0


def _dispatch_pool() -> ThreadPoolExecutor:
    """Process-wide bounded executor for RPC request handlers.

    Replaces thread-per-request: idle workers are reused, new ones spawn
    only when all are busy (up to ``rpc_dispatch_threads``).  Per-
    connection request order is preserved — the pool queue is FIFO and
    each connection's reader enqueues in arrival order.  A request can
    only wait on strictly-earlier traffic of its own connection (actor
    seqs, dependency-ordered pushes), which is already dispatched ahead
    of it, so the bound introduces no new deadlocks.

    Fork guard: a forked child (zygote workers) inherits the executor
    object but none of its threads — submitting into it would hang, so
    the pool is re-created when the pid changes."""
    global _pool, _pool_pid
    pid = os.getpid()
    if _pool is None or _pool_pid != pid:
        with _pool_lock:
            if _pool is None or _pool_pid != pid:
                _pool = ThreadPoolExecutor(
                    max_workers=max(1, CONFIG.rpc_dispatch_threads),
                    thread_name_prefix="rpc-dispatch")
                _pool_pid = pid
    return _pool


# ---------------------------------------------------------------- framing
def _encode_frame(obj: Any) -> list:
    """Pickle the (kind, msg_id, a, b) tuple ``obj`` into an iovec
    [header, lentable?, body, *buffers].

    Protocol-5 ``buffer_callback`` keeps large contiguous buffers (numpy
    arrays, PickleBuffer-wrapped blobs) out of the pickle stream: they
    ride the iovec zero-copy and ``sendmsg`` gathers them on the wire.
    Non-contiguous buffers fall back to in-band pickling."""
    pbufs: list = []
    try:
        body = pickle.dumps(obj, protocol=5, buffer_callback=pbufs.append)
        if len(pbufs) > _NBUFS_MAX:
            # a payload of thousands of small arrays: past the receiver's
            # header sanity cap, so carry it in band instead
            raise ValueError("too many out-of-band buffers")
        raws = [pb.raw() for pb in pbufs]
    except (BufferError, ValueError):
        body = pickle.dumps(obj, protocol=5)
        raws = []
    if len(body) > _BODY_MAX or sum(len(r) for r in raws) > _BODY_MAX:
        # fail THIS call (call_async surfaces it on the future) instead
        # of letting the receiver's header guard drop the connection
        raise ValueError(
            f"rpc frame exceeds {_BODY_MAX} bytes; move bulk data "
            f"through the object store")
    iov = [_HDR.pack(len(body), len(raws), obj[0], obj[1] or 0)]
    if raws:
        iov.append(b"".join(_BLEN.pack(len(r)) for r in raws))
    iov.append(body)
    iov.extend(raws)
    return iov


def _sendmsg_all(sock: socket.socket, bufs: list) -> None:
    """Scatter/gather send of the whole iovec, handling partial writes."""
    pending = deque(memoryview(b).cast("B") if not isinstance(b, bytes)
                    else memoryview(b) for b in bufs if len(b))
    while pending:
        sent = sock.sendmsg(list(itertools.islice(pending, _IOV_BATCH)))
        while sent:
            head = pending[0]
            if len(head) <= sent:
                sent -= len(head)
                pending.popleft()
            else:
                pending[0] = head[sent:]
                sent = 0


def _recv_exact_into(sock: socket.socket, buf: memoryview, n: int) -> None:
    got = 0
    while got < n:
        r = sock.recv_into(buf[got:n], n - got)
        if not r:
            raise ConnectionError("socket closed")
        got += r


def _grow(scratch: bytearray, n: int) -> bytearray:
    if len(scratch) < n:
        scratch = bytearray(max(n, 2 * len(scratch)))
    return scratch


def _normalize_fast(fast_methods):
    """None, a predicate f(method, payload) -> bool, or a name set."""
    if fast_methods is None or callable(fast_methods):
        return fast_methods
    return frozenset(fast_methods)


class Connection:
    """One duplex connection; used by both client and server sides."""

    def __init__(self, sock: socket.socket,
                 handler: Optional[Callable[["Connection", str, Any], Any]] = None,
                 push_handler: Optional[Callable[[str, Any], None]] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 fast_methods: Optional[Iterable[str]] = None):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._handler = handler
        self._push_handler = push_handler
        self._on_close = on_close
        # handlers that never block and never call back into this
        # connection run inline on the reader thread (no pool hop): a set
        # of method names, or a predicate ``f(method, payload) -> bool``
        # for payload-dependent decisions (e.g. ref-free task batches)
        self._fast_methods = _normalize_fast(fast_methods)
        self._ids = itertools.count(1)
        self._inflight: Dict[int, Future] = {}
        self._inflight_lock = threading.Lock()
        # buffer sinks (docs/object_transfer.md): msg_id -> f(lens) that
        # may hand the reader destination memoryviews for a response's
        # out-of-band buffers (recv_into shm, zero-copy).  _sink_active
        # marks the one the reader is currently receiving into so
        # discard_sinks can wait it out before its memory is released.
        self._sinks: Dict[int, Callable] = {}
        self._sink_lock = threading.Lock()
        self._sink_cv = threading.Condition(self._sink_lock)
        self._sink_active: Optional[int] = None
        self._closed = threading.Event()
        # write-side frame queue: the first writer in becomes the flusher
        # and drains everything queued behind it in coalesced sendmsg
        # batches; later writers enqueue and return (or block at _WQ_CAP)
        self._wq: deque = deque()
        self._wq_lock = threading.Lock()
        self._wq_cv = threading.Condition(self._wq_lock)
        self._flushing = False
        self._push_queue = None   # created lazily on first push
        self.peer: Any = None  # attachable identity (e.g. worker id)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # ------------------------------------------------------------------ send
    def _send(self, obj: Any, stable: bool = False,
              on_sent: Optional[Callable[[], None]] = None) -> None:
        """Enqueue one frame and flush opportunistically.

        If another thread is mid-flush it picks our frame up before it
        releases the socket, so back-to-back frames from concurrent
        writers coalesce into one ``sendmsg``.  Send failures close the
        connection; writers whose frames were queued behind a failed
        flush observe it through their futures (close() fails them).

        ``stable=True`` promises the frame's buffers stay immutable until
        ``on_sent`` fires, so a queued frame keeps its zero-copy views
        instead of being defensively materialized — the bulk-data path's
        contract (shm slices of sealed objects).  ``on_sent`` runs
        exactly once: after the frame hits the socket, or when it is
        dropped by a failed flush / close()."""
        try:
            iov = _encode_frame(obj)  # may raise (unpicklable payload)
        except BaseException:
            _run_cb(on_sent)  # frame never enqueued: release pins here
            raise
        with self._wq_lock:
            while (len(self._wq) >= _WQ_CAP and self._flushing
                   and not self._closed.is_set()):
                self._wq_cv.wait(1.0)
            if self._closed.is_set():
                _run_cb(on_sent)
                raise ConnectionError("connection closed")
            self._wq.append((iov, on_sent))
            _M_WQ_DEPTH.set_max(len(self._wq))
            if self._flushing:
                if not stable:
                    # the active flusher sends this frame after we return;
                    # materialize zero-copy views — the caller may mutate
                    # the backing buffer once its call returns
                    iov[:] = [b if isinstance(b, bytes) else bytes(b)
                              for b in iov]
                return
            self._flushing = True
        self._flush()

    def _drain_wq_locked(self) -> list:
        """_wq_lock held: clear the queue, returning its on_sent hooks."""
        cbs = [cb for _iov, cb in self._wq if cb is not None]
        self._wq.clear()
        self._wq_cv.notify_all()
        return cbs

    def _flush(self) -> None:
        while True:
            with self._wq_lock:
                if not self._wq or self._closed.is_set():
                    self._flushing = False
                    dropped = self._drain_wq_locked()
                    if self._closed.is_set():
                        for cb in dropped:
                            _run_cb(cb)
                        raise ConnectionError("connection closed")
                    return
                batch: list = []
                sent_cbs: list = []
                nframes = 0
                while self._wq and len(batch) < _IOV_BATCH:
                    iov, cb = self._wq.popleft()
                    batch.extend(iov)
                    if cb is not None:
                        sent_cbs.append(cb)
                    nframes += 1
                self._wq_cv.notify_all()
            if _TELEMETRY:
                _M_FRAMES_OUT.inc(nframes)
                _M_SEND_BATCHES.inc()
                _M_BYTES_OUT.inc(sum(len(b) for b in batch))
            try:
                _sendmsg_all(self._sock, batch)
            except BaseException:
                # a partial write leaves the stream desynced — the
                # connection is unusable regardless of the error type.
                # _flushing stays SET forever: a concurrent _send racing
                # the close() below must never become a new flusher and
                # splice a fresh header into the half-sent frame.  Its
                # frame lands in the queue unsent; close() fails its
                # future (pushes are fire-and-forget anyway) and wakes
                # cap-waiters.
                with self._wq_lock:
                    dropped = self._drain_wq_locked()
                for cb in itertools.chain(sent_cbs, dropped):
                    _run_cb(cb)
                self.close()
                raise
            for cb in sent_cbs:
                _run_cb(cb)

    def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        fut = self.call_async(method, payload)
        try:
            return fut.result(timeout)
        except (_FutureTimeout, TimeoutError):
            # Drop the abandoned future so a late response isn't delivered
            # to it and _inflight doesn't grow unbounded on timeouts.
            # NOTE: on 3.10 Future.result raises concurrent.futures
            # .TimeoutError, which is NOT the builtin TimeoutError (they
            # merged in 3.11) — catching only the builtin silently skipped
            # this reap and _inflight leaked one entry per timed-out call.
            msg_id = getattr(fut, "_rpc_msg_id", None)
            if msg_id is not None:
                with self._inflight_lock:
                    self._inflight.pop(msg_id, None)
                self.discard_sinks((msg_id,))
            raise

    def call_async(self, method: str, payload: Any = None,
                   buffer_sink: Optional[Callable] = None) -> Future:
        """``buffer_sink``: optional ``f(lens) -> list[memoryview] |
        None`` consulted when this call's response arrives carrying
        out-of-band buffers — returning destination views makes the
        reader ``recv_into`` them directly (the pull engine passes shm
        offsets).  The caller promises the views stay writable until the
        future resolves or ``discard_sinks`` returns."""
        fut: Future = Future()
        msg_id = next(self._ids)
        fut._rpc_msg_id = msg_id  # used by call() to reap timed-out futures
        with self._inflight_lock:
            if self._closed.is_set():
                fut.set_exception(ConnectionError("connection closed"))
                return fut
            self._inflight[msg_id] = fut
        if buffer_sink is not None:
            with self._sink_lock:
                self._sinks[msg_id] = buffer_sink
        try:
            self._send((_REQUEST, msg_id, method, payload))
        except OSError as e:
            self._reap_failed_send(msg_id)
            if not fut.done():  # close() may have failed it concurrently
                fut.set_exception(ConnectionError(str(e)))
        except Exception as e:  # e.g. unpicklable payload
            self._reap_failed_send(msg_id)
            if not fut.done():
                fut.set_exception(e)
        return fut

    def _reap_failed_send(self, msg_id: int) -> None:
        with self._inflight_lock:
            self._inflight.pop(msg_id, None)
        with self._sink_lock:
            self._sinks.pop(msg_id, None)

    def abandon(self, msg_ids: Iterable[int],
                timeout: float = 2.0) -> None:
        """Give up on outstanding ``call_async`` futures: drop their
        ``_inflight`` entries (a late response is discarded instead of
        delivered, and the map can't grow unbounded on a pooled
        connection to a wedged-but-alive peer) and withdraw their buffer
        sinks (``discard_sinks``)."""
        ids = list(msg_ids)
        with self._inflight_lock:
            for m in ids:
                self._inflight.pop(m, None)
        self.discard_sinks(ids, timeout)

    def discard_sinks(self, msg_ids: Iterable[int],
                      timeout: float = 2.0) -> None:
        """Withdraw buffer sinks: after this returns the reader will
        never again touch their destination views, so the caller may
        release the backing memory (abort a partially pulled shm
        create).  If the reader is mid-``recv_into`` one of them and
        doesn't finish within ``timeout`` (peer wedged mid-frame), the
        connection is closed — the shutdown unblocks the recv."""
        ids = set(msg_ids)
        if not ids:
            return
        with self._sink_lock:
            for m in ids:
                self._sinks.pop(m, None)
            deadline = time.monotonic() + timeout
            while self._sink_active in ids \
                    and time.monotonic() < deadline:
                self._sink_cv.wait(max(0.01,
                                       deadline - time.monotonic()))
        if self._sink_active in ids:
            self.close()  # unblocks the wedged recv; reader clears active
            with self._sink_lock:
                while self._sink_active in ids:
                    self._sink_cv.wait(1.0)

    def push(self, method: str, payload: Any = None) -> None:
        """Fire-and-forget message (pubsub notifications, log batches).

        A dead socket closes the connection (so later pushes fail fast
        and on_close/pubsub cleanup runs) and raises ConnectionError."""
        try:
            self._send((_PUSH, 0, method, payload))
        except OSError as e:
            self.close()
            raise ConnectionError(str(e)) from e

    # ------------------------------------------------------------------ recv
    def _take_sink(self, msg_id: int, lens: list) -> Optional[list]:
        """Reader side: destination views for this response's buffers if
        a sink is registered and accepts them; marks the sink active so
        discard_sinks won't let the memory go while we recv into it."""
        with self._sink_lock:
            sink = self._sinks.pop(msg_id, None)
            if sink is None:
                return None
            try:
                dests = sink(lens)
            except Exception:
                logger.exception("buffer sink failed")
                dests = None
            if dests is not None and (
                    len(dests) != len(lens)
                    or any(len(d) != n for d, n in zip(dests, lens))):
                # a miscounted/missized sink would desync the frame
                # stream and tear down the shared connection — fall back
                # to fresh storage instead of trusting it
                logger.error("buffer sink returned wrong shapes for "
                             "msg %d; ignoring it", msg_id)
                dests = None
            if dests is not None:
                self._sink_active = msg_id
            return dests

    def _sink_done(self) -> None:
        if self._sink_active is not None:
            with self._sink_lock:
                self._sink_active = None
                self._sink_cv.notify_all()

    def _read_loop(self) -> None:
        sock = self._sock
        scratch = bytearray(64 * 1024)
        try:
            while True:
                view = memoryview(scratch)
                _recv_exact_into(sock, view, _HDR.size)
                body_len, nbufs, kind, msg_id = _HDR.unpack_from(view)
                if body_len > _BODY_MAX or nbufs > _NBUFS_MAX:
                    # garbled header (e.g. a peer speaking an older frame
                    # layout): fail the connection instead of blocking on
                    # a bogus multi-GB read
                    raise ConnectionError("garbled rpc frame header")
                bufs = None
                lens = ()
                if nbufs:
                    lens_sz = _BLEN.size * nbufs
                    scratch = _grow(scratch, lens_sz)
                    view = memoryview(scratch)
                    _recv_exact_into(sock, view, lens_sz)
                    lens = [_BLEN.unpack_from(view, i * _BLEN.size)[0]
                            for i in range(nbufs)]
                    if sum(lens) > _BODY_MAX:
                        # same sanity bound as the header: a corrupt u64
                        # must not zero-fill a giant allocation
                        raise ConnectionError("garbled rpc buffer table")
                if len(scratch) < body_len:
                    scratch = _grow(scratch, body_len)
                view = memoryview(scratch)
                _recv_exact_into(sock, view, body_len)
                if nbufs:
                    # a registered buffer sink (pull engine) receives the
                    # payload straight into its shm destination offsets;
                    # otherwise out-of-band buffers get fresh storage —
                    # deserialized objects (numpy views) may keep
                    # references into them
                    bufs = self._take_sink(msg_id, lens) \
                        if kind == _RESPONSE else None
                    if bufs is not None:
                        for ln, dest in zip(lens, bufs):
                            _recv_exact_into(sock, dest, ln)
                    else:
                        bufs = []
                        for ln in lens:
                            b = bytearray(ln)
                            _recv_exact_into(sock, memoryview(b), ln)
                            bufs.append(b)
                kind, msg_id, a, b = pickle.loads(view[:body_len],
                                                  buffers=bufs)
                # the buffers are fully received and wrapped: a pending
                # discard_sinks may release their memory from here on
                self._sink_done()
                if _TELEMETRY:
                    _M_BYTES_IN.inc(_HDR.size + body_len +
                                    ((_BLEN.size * nbufs + sum(lens))
                                     if nbufs else 0))
                if kind == _REQUEST:
                    fm = self._fast_methods
                    if (fm is not None and _fuzz_ms_now() == 0
                            and (fm(a, b) if callable(fm) else a in fm)):
                        # registered non-blocking handler: run inline on
                        # the reader (the reply coalesces with whatever
                        # the previous frame left in the write queue)
                        _M_INLINE.inc()
                        self._handle_request(msg_id, a, b)
                    else:
                        _M_POOLED.inc()
                        _dispatch_pool().submit(
                            self._handle_request, msg_id, a, b)
                elif kind == _RESPONSE:
                    if self._sinks:
                        # an in-band reply (absent / spilled data) never
                        # consults its sink: drop the registration here
                        with self._sink_lock:
                            self._sinks.pop(msg_id, None)
                    with self._inflight_lock:
                        fut = self._inflight.pop(msg_id, None)
                    if fut is not None:
                        ok, value = a, b
                        if ok:
                            fut.set_result(value)
                        else:
                            fut.set_exception(RemoteError(value))
                else:  # _PUSH
                    if self._push_handler is not None:
                        # off the read loop: a push handler that makes a
                        # synchronous call on THIS connection would otherwise
                        # deadlock (its response can never be read). A serial
                        # queue keeps per-connection push ordering (pubsub
                        # state transitions rely on it).
                        self._enqueue_push(a, b)
        except (ConnectionError, OSError, EOFError, RuntimeError,
                pickle.UnpicklingError):
            # RuntimeError: dispatch pool shut down at interpreter exit
            pass
        finally:
            self._sink_done()  # a discard_sinks waiter must not hang
            self.close()

    def _enqueue_push(self, method: str, payload: Any) -> None:
        if self._push_queue is None:
            self._push_queue = queue.Queue()
            threading.Thread(target=self._push_loop, daemon=True).start()
        self._push_queue.put((method, payload))

    def _push_loop(self) -> None:
        # keeps draining after close(): pushes already received rode the
        # stream intact before the EOF, and droppers would lose delivered
        # results (core_worker's task_done stream relies on this — see
        # drain_pushes)
        while True:
            try:
                method, payload = self._push_queue.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    return  # closed AND backlog drained
                continue
            try:
                self._push_handler(method, payload)
            except Exception:
                logger.exception("push handler failed for %s", method)
            finally:
                self._push_queue.task_done()

    def drain_pushes(self, timeout: float = 5.0) -> None:
        """Block until every push received before the connection closed
        has been handed to the push handler.  Callers that reconcile
        state after a connection death (e.g. requeueing work the peer
        may have finished) must drain first or they race the serial push
        thread's backlog."""
        q = self._push_queue
        if q is None:
            return
        deadline = time.monotonic() + timeout
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    def _handle_request(self, msg_id: int, method: str, payload: Any) -> None:
        t0 = rtm.now()
        trace_token = None
        try:
            if self._handler is None:
                raise RpcError(f"no handler for {method}")
            _maybe_fuzz()
            if type(payload) is dict and "_trace_ctx" in payload:
                # distributed-tracing propagation (docs/observability.md):
                # a caller that stamped its trace context onto the payload
                # (streaming item reports, transfer-plane chunk fetches)
                # has the handler run inside that trace — spans it opens
                # join the request's trace with no per-method plumbing.
                # Popped before the handler, restored after: dispatch-pool
                # threads are reused and must not leak a context.
                trace_token = _trace_install(payload.pop("_trace_ctx"))
            result = self._handler(self, method, payload)
            if isinstance(result, Deferred):
                # the reply is sent by whichever thread resolves it;
                # latency here covers the synchronous handler part only
                result._bind(self, msg_id)
                _M_DISPATCH.observe_since(method, t0)
                return
            ok, value = True, result
        except BaseException as e:  # noqa: BLE001 - errors cross the wire
            ok, value = False, e
        finally:
            if trace_token is not None:
                _trace_uninstall(trace_token)
        _M_DISPATCH.observe_since(method, t0)
        self._respond(msg_id, ok, value)

    def _respond(self, msg_id: int, ok: bool, value: Any,
                 stable: bool = False,
                 on_sent: Optional[Callable[[], None]] = None) -> None:
        # _send owns on_sent once called: it fires the hook itself on
        # every failure path, so no branch here may re-run it
        try:
            self._send((_RESPONSE, msg_id, ok, value), stable=stable,
                       on_sent=on_sent)
        except OSError:
            self.close()
        except Exception as e:
            # Result/exception wasn't picklable — still answer the caller so
            # its call() never hangs.
            try:
                self._send((_RESPONSE, msg_id, False,
                            RpcError(f"unserializable reply: {e!r}")))
            except OSError:
                self.close()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._wq_lock:
            dropped = self._drain_wq_locked()
        for cb in dropped:
            _run_cb(cb)  # unsent stable frames must still release pins
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._inflight_lock:
            inflight, self._inflight = self._inflight, {}
        for fut in inflight.values():
            if not fut.done():
                fut.set_exception(ConnectionError("connection closed"))
        with self._sink_lock:
            self._sinks.clear()  # registered-but-unserved destinations
        if self._on_close is not None:
            cb, self._on_close = self._on_close, None
            try:
                cb(self)
            except Exception:
                logger.exception("on_close callback failed")

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class Server:
    """Pooled RPC server.

    ``handler(conn, method, payload)`` runs on a shared bounded dispatch
    pool (or inline on the reader for registered ``fast_methods``); per-
    connection request *dispatch* order is preserved by the reader loop, and
    handlers that need strict ordering (actor queues) do their own sequencing.
    """

    def __init__(self, handler: Callable[[Connection, str, Any], Any],
                 host: str = "127.0.0.1", port: int = 0,
                 on_disconnect: Optional[Callable[[Connection], None]] = None,
                 fast_methods: Optional[Iterable[str]] = None):
        self._handler = handler
        self._on_disconnect = on_disconnect
        self._fast_methods = _normalize_fast(fast_methods)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(512)
        self.address: Tuple[str, int] = self._listener.getsockname()
        self._conns: set[Connection] = set()
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                if self._stopped.is_set():
                    break
                # Transient failure (e.g. EMFILE): keep the server alive.
                logger.exception("accept() failed; retrying")
                time.sleep(0.1)
                continue
            conn = Connection(sock, handler=self._handler,
                              on_close=self._conn_closed,
                              fast_methods=self._fast_methods)
            self._register_conn(conn)

    def _register_conn(self, conn: Connection) -> bool:
        """Track a freshly accepted connection; closes it instead when
        stop() already ran.  An accept landing between stop()'s
        ``_stopped.set()`` and its ``connections()`` snapshot would
        otherwise never be closed — its live server-side reader then
        silently consumes the client's pushes forever, so the client
        never observes EOF and hangs instead of getting a
        ConnectionError."""
        with self._lock:
            if not self._stopped.is_set():
                self._conns.add(conn)
                return True
        conn.close()
        return False

    def _conn_closed(self, conn: Connection) -> None:
        with self._lock:
            self._conns.discard(conn)
        if self._on_disconnect is not None and not self._stopped.is_set():
            self._on_disconnect(conn)

    def connections(self) -> list[Connection]:
        with self._lock:
            return list(self._conns)

    def rebind(self, handler: Callable[[Connection, str, Any], Any],
               fast_methods=None) -> None:
        """Swap the dispatch handler (and fast registry) for this server
        AND its live connections — e.g. a worker extending its embedded
        core-worker server with task-execution methods after startup."""
        fast = _normalize_fast(fast_methods)
        self._handler = handler
        self._fast_methods = fast
        for conn in self.connections():
            conn._handler = handler
            conn._fast_methods = fast

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in self.connections():
            conn.close()


def connect(address: Tuple[str, int],
            push_handler: Optional[Callable[[str, Any], None]] = None,
            handler: Optional[Callable[[Connection, str, Any], Any]] = None,
            timeout: float = 30.0,
            on_close: Optional[Callable[[Connection], None]] = None,
            fast_methods: Optional[Iterable[str]] = None) -> Connection:
    sock = socket.create_connection(address, timeout=timeout)
    sock.settimeout(None)
    return Connection(sock, handler=handler, push_handler=push_handler,
                      on_close=on_close, fast_methods=fast_methods)
