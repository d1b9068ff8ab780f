"""Bulk object data plane: pipelined, multi-source, shm-direct pulls.

The inter-node twin of the control-plane fast path (docs/rpc_fastpath.md)
for large objects — the role the reference's ObjectManager/PullManager
pair plays (/root/reference/src/ray/object_manager/pull_manager.h:52,
object_manager.cc:338 chunked Push):

* **Pipelined windowed pulls** — up to ``object_pull_window`` chunk
  requests ride a pooled raylet connection concurrently, so a pull costs
  ``total/bandwidth`` instead of ``chunks * RTT``.
* **Multi-source striping** — when the location set holds several live
  copies, sources drain a shared offset queue (dynamic striping: a fast
  source simply serves more chunks).  A source dying or answering
  "absent" mid-transfer re-queues only its outstanding ranges onto the
  survivors; the transfer never restarts.
* **Shm-direct landing** — the destination buffer is allocated in the
  local shared-memory store up front and chunks are written at their
  final offsets; the object is sealed (published) once complete.  No
  whole-object heap copy exists on the client, and the pull budget
  accounts real shm bytes.  When the local store can't fit the object
  the engine degrades to a heap buffer instead of failing the get.
* **Budget admission** — multi-chunk pulls reserve their full size from
  a process-wide ``PullBudget`` before allocating.  An uncontended
  acquire keeps the already-fetched first chunk; a contended one drops
  it before parking (a parked waiter must hold no payload bytes).

Both the CoreWorker get path and the raylet's argument prefetch
(docs/object_transfer.md) drive this engine with their own store /
connection-cache / budget collaborators.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.logging_utils import get_logger
from ray_tpu_torch.exceptions import ObjectStoreFullError

logger = get_logger("transfer")

# data-plane telemetry (docs/observability.md): bound once, no-ops when
# RAY_TPU_TORCH_TELEMETRY=0
_M_PULLS = rtm.counter(
    "ray_tpu_pulls_total", "remote object pulls attempted by this process")
_M_PULL_BYTES = rtm.counter(
    "ray_tpu_pull_bytes_total", "object bytes pulled from remote nodes")
_M_CHUNK_RTT = rtm.histogram(
    "ray_tpu_pull_chunk_rtt_ms",
    "per-chunk request -> reply latency inside a pipelined pull (ms)")
_M_WINDOW = rtm.histogram(
    "ray_tpu_pull_inflight_window",
    "effective in-flight chunk window per pull (requests outstanding)",
    boundaries=rtm.COUNT_BOUNDARIES)
_M_FAILOVER = rtm.counter(
    "ray_tpu_pull_stripe_failovers_total",
    "mid-transfer source failures whose ranges re-queued onto survivors")
_M_BUDGET_WAIT = rtm.histogram(
    "ray_tpu_pull_budget_wait_ms",
    "time a multi-chunk pull waited for pull-budget admission (ms)")
_M_SOURCES = rtm.histogram(
    "ray_tpu_pull_sources",
    "distinct sources a completed multi-chunk pull striped across "
    "(collective broadcast fan-out rides this, docs/collective.md)",
    boundaries=rtm.COUNT_BOUNDARIES)


class PullBudget:
    """Admission control over concurrently buffered pull bytes (reference
    PullManager's bounded quota, pull_manager.h:52): N parallel gets of
    large objects queue here instead of overcommitting process memory.
    An object larger than the whole cap is admitted alone (capped at the
    full budget) so it can never deadlock."""

    def __init__(self, cap: int):
        self.cap = max(1, cap)
        self.used = 0
        self.cv = threading.Condition()
        self._waiters: deque = deque()  # FIFO tickets

    def acquire(self, n: int, deadline: Optional[float]) -> bool:
        n = min(n, self.cap)
        ticket = object()
        with self.cv:
            self._waiters.append(ticket)
            try:
                while True:
                    # strict FIFO: only the head ticket may admit — a big
                    # pull can't be starved by a stream of smaller ones
                    # slipping past it whenever they happen to fit
                    if self._waiters[0] is ticket and \
                            (self.used + n <= self.cap or self.used == 0):
                        self.used += n
                        return True
                    t = None if deadline is None \
                        else max(0.0, deadline - time.monotonic())
                    if t is not None and t <= 0:
                        return False
                    if not self.cv.wait(timeout=t if t is not None
                                        else 5.0) and deadline is not None:
                        return False
            finally:
                self._waiters.remove(ticket)
                self.cv.notify_all()

    def try_acquire(self, n: int) -> bool:
        """Non-blocking admit: True only when the quota (and FIFO head)
        admit immediately — the keep-the-first-chunk fast path."""
        return self.acquire(n, time.monotonic())

    def release(self, n: int) -> None:
        n = min(n, self.cap)
        with self.cv:
            self.used = max(0, self.used - n)
            self.cv.notify_all()


class ConnCache:
    """Tiny pooled-connection cache keyed by address (the raylet's analog
    of CoreWorker._owner_conn): one persistent duplex connection per
    peer instead of a TCP connect+close per pull."""

    def __init__(self):
        self._conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._lock = threading.Lock()

    def get(self, addr: Tuple[str, int]) -> rpc.Connection:
        addr = tuple(addr)
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
        conn = rpc.connect(addr, timeout=5.0)
        with self._lock:
            old = self._conns.get(addr)
            if old is not None and not old.closed:
                conn.close()
                return old
            self._conns[addr] = conn
        return conn

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass


class PullOutcome:
    """Result of one ObjectPuller.pull.

    status   -- "ok" | "absent" | "error"
    data     -- serialized payload on "ok": a pinned shm memoryview when
                ``published`` (caller owns the single store pin), else a
                heap bytes-like (small object or store-full fallback)
    absent   -- node hexes that authoritatively answered "no copy"
                (callers drop those locations)
    transient-- at least one source failed on transport (retryable)
    """

    __slots__ = ("status", "data", "meta", "published", "absent",
                 "transient", "bytes", "duration_s", "nsources")

    def __init__(self, status: str, data=None, meta: int = 0,
                 published: bool = False, absent: Optional[set] = None,
                 transient: bool = False, nbytes: int = 0,
                 duration_s: float = 0.0, nsources: int = 0):
        self.status = status
        self.data = data
        self.meta = meta
        self.published = published
        self.absent = absent if absent is not None else set()
        self.transient = transient
        self.bytes = nbytes
        self.duration_s = duration_s
        self.nsources = nsources


class _SourceState:
    __slots__ = ("node", "conn", "outcome", "served")

    def __init__(self, node: str, conn: rpc.Connection):
        self.node = node
        self.conn = conn
        self.outcome = "ok"
        self.served = 0   # chunks this source actually delivered


class _PullState:
    """Offset queue + progress shared by the per-source loops of one pull.

    ``inflight`` counts offsets issued to some source and not yet written
    or re-queued.  A source that drains the queue must NOT exit while a
    peer still holds in-flight offsets: if that peer dies, its ranges
    come back to ``pending`` and the survivor has to pick them up — so
    idle sources park on ``cv`` instead of returning."""

    __slots__ = ("cv", "pending", "inflight", "done")

    def __init__(self, pending: deque, done: int):
        self.cv = threading.Condition()
        self.pending = pending
        self.inflight = 0
        self.done = done


class ObjectPuller:
    """The pull engine.  Collaborators:

    store        -- SharedMemoryStore chunks land in
    resolve_addr -- node_hex -> (host, port) or None
    get_conn     -- (host, port) -> pooled rpc.Connection (may raise)
    budget       -- PullBudget or None (no admission control)
    """

    def __init__(self, store, resolve_addr: Callable, get_conn: Callable,
                 budget: Optional[PullBudget] = None):
        self._store = store
        self._resolve = resolve_addr
        self._get_conn = get_conn
        self._budget = budget

    # ------------------------------------------------------------- public
    def pull(self, oid: ObjectID, sources: Sequence[str],
             deadline: Optional[float] = None,
             publish_small: bool = False) -> PullOutcome:
        """Pull one object from any/all of ``sources`` (node hexes).

        ``publish_small=True`` lands even single-chunk objects in the
        local store (the prefetch path wants a local copy; the get path
        prefers returning the bytes without store churn).

        Tracing (docs/observability.md): when the calling thread carries
        a sampled trace context (a serve decode pulling its KV handoff,
        a task fetching an argument), the pull lands as a ``pull`` span
        in that trace — the "handoff pull" hop of a disaggregated serve
        request is this very call."""
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        ctx = trh.current_context()
        if ctx is None or not trh.ctx_sampled(ctx):
            return self._pull_impl(oid, sources, deadline, publish_small)
        t0 = time.time()
        out = self._pull_impl(oid, sources, deadline, publish_small,
                              trace_ctx={"trace_id": ctx["trace_id"],
                                         "span_id": ctx.get("span_id"),
                                         "sampled": True})
        trh.record_span({
            "trace_id": ctx["trace_id"], "span_id": trh.new_span_id(),
            "parent_id": ctx.get("span_id"),
            "name": f"pull:{oid.hex()[:12]}", "kind": "pull",
            "start": t0, "dur_ms": round(out.duration_s * 1e3, 3),
            "status": trh.OK if out.status == "ok" else trh.ERROR,
            "attrs": {"bytes": out.bytes, "nsources": out.nsources,
                      "pull_status": out.status}})
        return out

    def _pull_impl(self, oid: ObjectID, sources: Sequence[str],
                   deadline: Optional[float] = None,
                   publish_small: bool = False,
                   trace_ctx: Optional[dict] = None) -> PullOutcome:
        t_start = time.monotonic()
        _M_PULLS.inc()
        chunk = CONFIG.object_transfer_chunk_bytes
        absent: set = set()
        transient = False
        conns: Dict[str, rpc.Connection] = {}

        # --- discovery: first chunk from the first answering source ---
        first = None
        for nh in sources:
            conn = self._conn_for(nh, conns)
            if conn is None:
                transient = True
                continue
            try:
                req = {"object_id": oid.binary(), "offset": 0,
                       "length": chunk, "timeout": 0.0, "oob": True}
                if trace_ctx is not None:
                    # the serving raylet joins the trace for the
                    # dispatch (rpc.py installs/pops "_trace_ctx")
                    req["_trace_ctx"] = trace_ctx
                res = conn.call("fetch_object_chunk", req,
                                timeout=self._chunk_timeout(deadline))
            except (ConnectionError, rpc.RemoteError, TimeoutError,
                    OSError):
                transient = True
                continue
            if res is None or not res.get("data"):
                absent.add(nh)
                continue
            first = (nh, res)
            break
        if first is None:
            status = "absent" if absent and not transient else "error"
            return PullOutcome(status, absent=absent, transient=transient,
                               duration_s=time.monotonic() - t_start)
        nh0, res0 = first
        total = int(res0["total"])
        meta = int(res0.get("meta", 0))
        data0 = res0["data"]

        if len(data0) >= total and not publish_small:
            _M_PULL_BYTES.inc(total)
            return PullOutcome("ok", data=data0, meta=meta, absent=absent,
                               nbytes=total,
                               duration_s=time.monotonic() - t_start,
                               nsources=1)

        # --- admission: reserve the full buffer before allocating ---
        acquired = False
        if self._budget is not None:
            if self._budget.try_acquire(total):
                acquired = True  # uncontended: keep the first chunk
            else:
                # parked waiters hold no payload bytes; re-fetching one
                # chunk later is cheaper than cap-exempt memory per waiter
                data0 = None
                t_wait = rtm.now()
                if not self._budget.acquire(total, deadline):
                    return PullOutcome(
                        "error", absent=absent, transient=True,
                        duration_s=time.monotonic() - t_start)
                _M_BUDGET_WAIT.observe_since(t_wait)
                acquired = True
        try:
            return self._pull_body(oid, total, meta, data0, chunk, nh0,
                                   list(sources), conns, absent, transient,
                                   deadline, t_start, trace_ctx)
        finally:
            if acquired:
                self._budget.release(total)

    # ------------------------------------------------------------ internal
    def _chunk_timeout(self, deadline: Optional[float]) -> float:
        base = CONFIG.raylet_rpc_timeout_s
        if deadline is None:
            return base
        return max(0.001, min(base, deadline - time.monotonic()))

    def _conn_for(self, nh: str, conns: Dict[str, rpc.Connection]
                  ) -> Optional[rpc.Connection]:
        conn = conns.get(nh)
        if conn is not None and not conn.closed:
            return conn
        addr = self._resolve(nh)
        if addr is None:
            return None
        try:
            conn = self._get_conn(tuple(addr))
        except (ConnectionError, OSError, TimeoutError):
            return None
        conns[nh] = conn
        return conn

    def _alloc_dest(self, oid: ObjectID, total: int, meta: int,
                    deadline: Optional[float]):
        """-> (buffer, kind): kind is "created" (unsealed shm create the
        caller fills + seals), "sealed" (another local pull/put finished
        first: pinned view, done), or "heap" (store can't fit it)."""
        grace = time.monotonic() + 10.0
        while True:
            try:
                # never evict to make room: eviction destroys bytes, and
                # a victim that lives only in shm (the raylet spills
                # lazily, under a threshold) would be LOST — the heap
                # fallback below is the pressure valve, not other
                # objects' only copies
                return (self._store.create(oid, total, meta=meta,
                                           allow_evict=False),
                        "created")
            except FileExistsError:
                # a sealed copy already local, or a concurrent local pull
                # in flight: wait for its seal instead of transferring the
                # same bytes twice
                res = self._store.get(oid, timeout=0.2)
                if res is not None:
                    return res[0], "sealed"
                now = time.monotonic()
                if now >= grace or \
                        (deadline is not None and now >= deadline):
                    # the other creator looks wedged (or died without the
                    # abort running): don't hang the get on it
                    return bytearray(total), "heap"
            except (ObjectStoreFullError, OSError):
                # secondary copies are best-effort: degrade to heap
                # assembly rather than failing the get (the raylet's
                # spill loop may free room for the next pull)
                return bytearray(total), "heap"

    def _pull_body(self, oid, total, meta, data0, chunk, nh0, sources,
                   conns, absent, transient, deadline, t_start,
                   trace_ctx=None):
        dest, kind = self._alloc_dest(oid, total, meta, deadline)
        if kind == "sealed":
            return PullOutcome("ok", data=dest, meta=meta, published=True,
                               absent=absent, nbytes=total,
                               duration_s=time.monotonic() - t_start)
        mv = dest if isinstance(dest, memoryview) else memoryview(dest)
        if data0:
            mv[:len(data0)] = data0
            ps = _PullState(deque(range(len(data0), total, chunk)),
                            len(data0))
        else:
            ps = _PullState(deque(range(0, total, chunk)), 0)

        # stripe across live copies, primary-answering source first
        stripe = [nh for nh in sources
                  if nh not in absent and nh != nh0]
        stripe.insert(0, nh0)
        stripe = stripe[:max(1, CONFIG.object_pull_max_sources)]
        # the window is per source, not divided across the stripe: each
        # source's pipeline depth is what hides its RTT, so halving it
        # when a second copy appears would throw away the very
        # parallelism striping exists for
        window = max(1, CONFIG.object_pull_window)
        _M_WINDOW.observe(min(window * len(stripe),
                              len(ps.pending) + (1 if data0 else 0)))

        states: List[_SourceState] = []
        for nh in stripe:
            conn = self._conn_for(nh, conns)
            if conn is not None:
                states.append(_SourceState(nh, conn))
        if not states:
            self._discard_dest(oid, dest, kind)
            return PullOutcome("error", absent=absent, transient=True,
                               duration_s=time.monotonic() - t_start)

        threads = []
        for st in states[1:]:
            t = threading.Thread(
                target=self._source_loop,
                args=(st, oid, mv, total, chunk, window, ps, deadline,
                      len(states) > 1, trace_ctx),
                daemon=True, name="pull-stripe")
            t.start()
            threads.append(t)
        # the first (primary) source runs on the calling thread: the
        # single-source common case spawns no threads at all
        self._source_loop(states[0], oid, mv, total, chunk, window, ps,
                          deadline, len(states) > 1, trace_ctx)
        for t in threads:
            t.join()

        for st in states:
            if st.outcome == "absent":
                absent.add(st.node)
            elif st.outcome == "error":
                transient = True

        if ps.done >= total:
            _M_PULL_BYTES.inc(total)
            # only sources that actually delivered chunks count: an
            # idle secondary (primary drained the queue first) must not
            # inflate the striping fan-out this records
            _M_SOURCES.observe(
                sum(1 for st in states if st.served > 0))
            data, published = self._publish_dest(oid, dest, mv, kind)
            if data is None:
                # sealed copy vanished before we could pin it (freed or
                # evicted instantly): the caller retries
                return PullOutcome(
                    "error", absent=absent, transient=True,
                    duration_s=time.monotonic() - t_start)
            return PullOutcome("ok", data=data, meta=meta,
                               published=published, absent=absent,
                               transient=transient, nbytes=total,
                               duration_s=time.monotonic() - t_start,
                               nsources=len(states))
        # incomplete: every source died or answered absent mid-transfer
        self._discard_dest(oid, dest, kind)
        status = "absent" if absent and not transient else "error"
        return PullOutcome(status, absent=absent, transient=transient,
                           duration_s=time.monotonic() - t_start,
                           nsources=len(states))

    @staticmethod
    def _make_sink(dest_slice, used: list):
        """Buffer sink for one chunk request (rpc.call_async): the reply's
        single out-of-band buffer is received straight into the chunk's
        shm destination slice — no per-chunk allocation, no copy."""
        def sink(lens):
            if len(lens) == 1 and 0 < lens[0] <= len(dest_slice):
                used.append(lens[0])
                return [dest_slice[:lens[0]]]
            return None  # unexpected shape: fall back to fresh storage
        return sink

    def _source_loop(self, st: _SourceState, oid, mv, total, chunk,
                     window, ps: _PullState, deadline,
                     striped: bool, trace_ctx=None) -> None:
        """Drain the shared offset queue through one source, keeping up
        to ``window`` chunk requests in flight.  On failure the source's
        outstanding offsets go back on the queue for the survivors."""
        inflight: deque = deque()  # (offset, future, t_sent, used)

        def fail(outcome: str, popped=None, popped_fut=None) -> None:
            st.outcome = outcome
            # withdraw the shm destinations first: a late reply on a
            # still-live conn must never land after the buffer is gone
            # (and duplicate writes from a survivor are racy only on
            # paper — chunk content is immutable).  abandon() also reaps
            # the futures from the pooled connection's inflight map so a
            # wedged-but-alive peer can't leak a window per retry.
            ids = [f._rpc_msg_id for _o, f, _t, _u in inflight]
            if popped_fut is not None:
                ids.append(popped_fut._rpc_msg_id)
            try:
                # the timeout is how long a reader mid-recv into one of
                # our sinks gets to finish before the connection is
                # closed to unwedge it: the conn is POOLED, so closing
                # fails every concurrent pull/RPC sharing it — give a
                # slow-but-live link time to drain one chunk (8 MiB at
                # ~1 MB/s), pay the wait only in the true-wedge case,
                # and never overshoot the caller's get(timeout=)
                drain = 10.0
                if deadline is not None:
                    drain = min(drain,
                                max(0.1, deadline - time.monotonic()))
                st.conn.abandon(ids, timeout=drain)
            except Exception:
                pass
            with ps.cv:
                if popped is not None:
                    ps.pending.appendleft(popped)
                    ps.inflight -= 1
                for o, _fut, _t, _u in inflight:
                    ps.pending.appendleft(o)
                    ps.inflight -= 1
                ps.cv.notify_all()
            if striped:
                _M_FAILOVER.inc()
                # lifecycle event (docs/observability.md): which source
                # died mid-stripe and who absorbed its ranges is exactly
                # the evidence that evaporates otherwise
                from ray_tpu_torch._private import cluster_events as cev
                cev.emit(cev.TRANSFER_FAILOVER,
                         f"pull source {st.node[:8]} failed "
                         f"({outcome}); re-queued its outstanding "
                         "ranges on the survivors",
                         severity="WARNING", object_id=oid.hex(),
                         source_node=st.node, outcome=outcome)

        while True:
            while len(inflight) < window:
                with ps.cv:
                    off = ps.pending.popleft() if ps.pending else None
                    if off is not None:
                        ps.inflight += 1
                if off is None:
                    break
                length = min(chunk, total - off)
                payload = {"object_id": oid.binary(), "offset": off,
                           "length": length, "timeout": 0.0, "oob": True}
                if trace_ctx is not None:
                    # every chunk dispatch joins the trace, not just the
                    # discovery probe (the docs promise chunk fetches
                    # ride the context; ~70B per 8MiB chunk frame)
                    payload["_trace_ctx"] = trace_ctx
                used: List[int] = []
                try:
                    fut = st.conn.call_async(
                        "fetch_object_chunk", payload,
                        buffer_sink=self._make_sink(
                            mv[off:off + length], used))
                except Exception:
                    fail("error", popped=off)
                    return
                inflight.append((off, fut, time.monotonic(), used))
            if not inflight:
                with ps.cv:
                    if ps.done >= total or \
                            not (ps.pending or ps.inflight):
                        return
                    if not ps.pending:
                        # a peer still holds in-flight offsets: if it
                        # dies they re-queue — park here instead of
                        # abandoning the transfer to that peer's fate
                        ps.cv.wait(0.05)
                if deadline is not None and time.monotonic() >= deadline:
                    st.outcome = "error"
                    return
                continue
            off, fut, t_sent, used = inflight.popleft()
            if deadline is not None and time.monotonic() >= deadline:
                fail("error", popped=off, popped_fut=fut)
                return
            try:
                res = fut.result(self._chunk_timeout(deadline))
            except Exception:  # transport death, remote error, timeout
                fail("error", popped=off, popped_fut=fut)
                return
            data = res.get("data") if res else None
            if not data:
                # evicted/freed on this source mid-transfer: authoritative
                # for this source only — survivors pick up its ranges
                fail("absent", popped=off, popped_fut=fut)
                return
            _M_CHUNK_RTT.observe((time.monotonic() - t_sent) * 1000.0)
            st.served += 1
            if not used:
                # in-band reply (spilled-object path, legacy server):
                # land it at its offset ourselves
                mv[off:off + len(data)] = data
            with ps.cv:
                ps.done += len(data)
                ps.inflight -= 1
                if ps.done >= total:
                    ps.cv.notify_all()

    def _publish_dest(self, oid, dest, mv, kind):
        """Seal a completed shm create and swap to a pinned read view."""
        if kind != "created":
            return dest, False  # heap fallback: plain buffer
        mv.release()
        try:
            self._store.seal(oid)
        except KeyError:
            pass  # freed between write and seal: serve what we assembled
        res = self._store.get(oid, timeout=5.0)
        if res is None:
            # sealed copy vanished instantly (evicted/freed): the transfer
            # still succeeded — fall back to an unpinned error? No bytes
            # remain; report transient so the caller retries.
            return None, False
        return res[0], True

    def _discard_dest(self, oid, dest, kind) -> None:
        if kind != "created":
            return
        try:
            dest.release()
        except (BufferError, AttributeError):
            pass
        try:
            self._store.abort(oid)
        except Exception:
            pass
