"""Per-process runtime: task submission, object ownership, get/put/wait.

Analog of the reference CoreWorker
(/root/reference/src/ray/core_worker/core_worker.h:261): every driver and
worker embeds one.  It owns

  - the in-process memory store for inlined objects
    (store_provider/memory_store/memory_store.h:43),
  - the shm-store client for large objects (plasma_store_provider.h:88),
  - the ownership table: this process owns the objects its tasks return
    (reference_count.h:61 ownership model — the owner records locations and
    serves gets; no central object table),
  - the lease-based task submitter
    (transport/direct_task_transport.h:57 — lease a worker per scheduling
    key from the raylet, push tasks directly, return when idle), and
  - actor handles with per-actor ordered submission queues
    (transport/direct_actor_task_submitter.h:67 — sequence numbers,
    resubmit on restart).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.exceptions import SchedulingError
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import transfer
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.logging_utils import get_logger
from ray_tpu_torch.runtime.gcs import ALIVE, DEAD, GcsClient, RESTARTING
from ray_tpu_torch.runtime.object_store import SharedMemoryStore

# tracing_helper lives under ray_tpu_torch.util, whose __init__ imports back
# into core_worker (placement_group) — resolved lazily, cached
_trh = None


def _tracing():
    global _trh
    if _trh is None:
        from ray_tpu_torch.util.tracing import tracing_helper
        _trh = tracing_helper
    return _trh

logger = get_logger("core_worker")

_INLINE_MAX = None  # resolved lazily from CONFIG

# hot-path telemetry (docs/observability.md): bound once, attribute
# arithmetic per record, no-ops when RAY_TPU_TORCH_TELEMETRY=0.  _TELEMETRY
# guards the sites with real bookkeeping (the _task_t0 stamp dict),
# so the kill switch removes that cost too.
_TELEMETRY = rtm.enabled()
_M_PUT = rtm.histogram("ray_tpu_put_ms", "ray.put latency (ms)")
_M_GET = rtm.histogram("ray_tpu_get_ms", "per-ref ray.get latency (ms)")
_M_TASK_E2E = rtm.histogram(
    "ray_tpu_task_e2e_ms",
    "task submit -> terminal reply latency at the owner (ms)")
_M_PUSH_BATCH = rtm.histogram(
    "ray_tpu_task_push_batch_size",
    "task specs coalesced per push_tasks frame",
    boundaries=rtm.COUNT_BOUNDARIES)
_M_QUEUE_WAIT = rtm.histogram(
    "ray_tpu_task_queue_wait_ms",
    "task submit -> dispatch-to-worker wait at the owner (ms); the "
    "metric twin of the timeline's SUBMITTED->RUNNING queue_wait slice")
_M_STREAM_ITEMS = rtm.counter(
    "ray_tpu_stream_items_total",
    "streaming-generator items reported to this owner")
_M_STREAM_STALLS = rtm.counter(
    "ray_tpu_stream_backpressure_stalls_total",
    "item reports parked for backpressure (consumer behind producer)")
_M_STREAM_PARKED = rtm.histogram(
    "ray_tpu_stream_parked_report_ms",
    "time an item report spent parked before consumption released it")
_M_FETCH_LOCAL = rtm.counter(
    "ray_tpu_fetch_local_hits_total",
    "borrowed-object fetches served from local shm (prefetch/locality "
    "hits: the bytes were already here)")
_M_FETCH_REMOTE = rtm.counter(
    "ray_tpu_fetch_remote_pulls_total",
    "borrowed-object fetches that had to pull from a remote node")
_M_ACTOR_SUBMITS = rtm.counter(
    "ray_tpu_actor_tasks_submitted_total",
    "classic actor-task submissions from this process; a compiled-DAG "
    "hot loop must NOT move this (the zero-submission contract the "
    "pipeline runner asserts, docs/compiled_dag.md)")


class ObjectRef:
    """Handle to a future object.  Embeds the owner's serving address so any
    borrower can reach the owner directly (ownership-based directory,
    cf. ownership_based_object_directory.h)."""

    __slots__ = ("id", "owner_addr", "_worker", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: Tuple[str, int],
                 worker: Optional["CoreWorker"] = None):
        self.id = object_id
        self.owner_addr = tuple(owner_addr)
        self._worker = worker
        if worker is not None:
            worker._ref_created(object_id)

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def __repr__(self) -> str:
        return f"ObjectRef({self.id.hex()[:16]})"

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __del__(self):
        w = self._worker
        if w is not None:
            w._ref_deleted(self.id)

    def __reduce__(self):
        # crossing process boundaries drops the local refcount hook; the
        # receiver re-binds to its own core worker on use
        return (_rebuild_ref, (self.id.binary(), self.owner_addr))

    def future(self):
        """concurrent.futures-style accessor used by library code."""
        from concurrent.futures import Future
        f: Future = Future()
        def _poll():
            try:
                f.set_result(get_global_worker().get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                f.set_exception(e)
        threading.Thread(target=_poll, daemon=True).start()
        return f


def _views_dropped(worker_ref, oid, n: int) -> None:
    """Finalizer of a fetched value's segment array: the last zero-copy
    view is gone, so its ``n`` pins may go (``_drain_dead_views``)."""
    worker = worker_ref()
    if worker is not None:
        worker._dead_views.append((oid, n))
        worker._drain_dead_views()


def _rebuild_ref(id_bytes: bytes, owner_addr) -> "ObjectRef":
    worker = _global_worker
    return ObjectRef(ObjectID(id_bytes), tuple(owner_addr), worker)


def num_return_slots(num_returns) -> int:
    """Owner-side return slots: "dynamic" and "streaming" reserve one
    (the generator / completion-sentinel slot)."""
    return 1 if num_returns in ("dynamic", "streaming") else num_returns


_STRING_NUM_RETURNS = ("dynamic", "streaming")


def normalize_num_returns(value, *, where: str = "num_returns"):
    """Single validation point for the num_returns modes shared by
    RemoteFunction and ActorMethod: a non-negative int, "dynamic"
    (refs materialize when the whole task finishes), or "streaming"
    (per-yield delivery through a StreamingObjectRefGenerator)."""
    if value in _STRING_NUM_RETURNS:
        return value
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(
            f"{where} must be a non-negative int, \"dynamic\" or "
            f"\"streaming\"; got {value!r}")
    if value < 0:
        raise ValueError(f"{where} must be >= 0; got {value}")
    return value


class ObjectRefGenerator:
    """The value of a ``num_returns="dynamic"`` task: an iterable of the
    refs the task produced, one per yielded item (cf. reference
    ObjectRefGenerator, _raylet.pyx:169)."""

    def __init__(self, refs: List["ObjectRef"]):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self):
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]

    def __repr__(self):
        return f"ObjectRefGenerator({len(self._refs)} refs)"


class _StreamState:
    """Owner-side record of one in-flight ``num_returns="streaming"``
    task (the generator table entry).  Item indexes may arrive in any
    order (reports and the task-level completion ride different
    connections); the consumer always advances strictly by index."""

    __slots__ = ("task_binary", "bp", "cv", "arrived", "consumed", "total",
                 "failed", "parked", "closed", "max_unconsumed", "waiters")

    def __init__(self, task_binary: bytes, bp: int):
        self.task_binary = task_binary
        self.bp = bp                      # backpressure window (<=0: off)
        self.cv = threading.Condition()
        self.arrived: set = set()         # reported, not yet consumed
        self.consumed = 0                 # next index the consumer wants
        self.total: Optional[int] = None  # num_items once complete
        self.failed = False               # terminal error stored in slot 0
        self.closed = False               # consumer dropped the generator
        # event-driven consumers (async __anext__): callbacks fired on
        # the next state change instead of a thread blocking on cv —
        # 1000 concurrent awaited streams cost 0 threads, not 1000
        self.waiters: List = []
        # (index, Deferred, t_parked) item reports parked for
        # backpressure: each resolves when ITS item is consumed, so the
        # producer's unacked window is exactly the unconsumed in-flight
        # count; t_parked feeds the parked-report-time histogram
        self.parked: List[tuple] = []
        self.max_unconsumed = 0           # high-water mark (tests/stats)


class _StreamExhausted:
    """Internal sentinel returned by CoreWorker._stream_next at end of
    stream (StopIteration must not cross executor/coroutine seams)."""


class StreamingObjectRefGenerator:
    """The value of a ``num_returns="streaming"`` task/actor call: each
    ``__next__``/``__anext__`` blocks until the NEXT yielded item has
    been reported by the executing worker and returns its ObjectRef —
    the first item is observable while the task is still running, unlike
    "dynamic" where refs appear only at task completion.  Consuming an
    item acks it to the producer (releasing backpressure credit).

    Not serializable: the stream is owned by the submitting process."""

    def __init__(self, worker: "CoreWorker", state: _StreamState,
                 ref: "ObjectRef"):
        self._worker = worker
        self._state = state
        self._ref = ref

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        out = self._worker._stream_next(self._state, self._ref)
        if out is _StreamExhausted:
            raise StopIteration
        return out

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        """Event-driven await: non-blocking claim attempts with a
        state-change waiter between them — no executor thread parks for
        the wait, so thousands of concurrently-awaited streams coexist
        on one event loop (the serve_disagg 1k-connection harness
        shape; the old executor hop capped concurrency at the thread
        pool size)."""
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            out = self._worker._stream_try_next(self._state, self._ref)
            if out is _StreamExhausted:
                raise StopAsyncIteration
            if out is not None:
                return out
            fut = loop.create_future()

            def _wake(_loop=loop, _fut=fut):
                _loop.call_soon_threadsafe(
                    lambda: _fut.done() or _fut.set_result(None))

            self._worker._stream_add_waiter(self._state, _wake)
            await fut

    def completed(self) -> "ObjectRef":
        """Ref that resolves when the whole generator task finishes:
        to the full ObjectRefGenerator of item refs on success, to the
        task's error on failure (the ``ray.get``-able completion
        sentinel)."""
        return self._ref

    def close(self) -> None:
        """Cancel the stream: parked producer reports are released with
        a cancel verdict (the worker stops iterating the generator) and
        unconsumed item objects are freed."""
        self._worker._close_stream(self._state)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __reduce__(self):
        raise TypeError(
            "StreamingObjectRefGenerator is not serializable; it can "
            "only be consumed by the process that submitted the task")

    def __repr__(self):
        st = self._state
        return (f"StreamingObjectRefGenerator(consumed={st.consumed}, "
                f"total={st.total})")


_global_worker: Optional["CoreWorker"] = None


def get_global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def set_global_worker(worker: Optional["CoreWorker"]) -> None:
    global _global_worker
    _global_worker = worker


_cb_queue: "SimpleQueue" = None
_cb_lock = threading.Lock()


def _dispatch_callback(cb) -> None:
    """Ready callbacks run on one dedicated dispatcher thread, never on
    the thread that called set(): reply-processing paths hold _owned_lock
    when entries become ready, and a callback that blocked (or re-entered
    a CoreWorker API) there would stall every get/put/submit."""
    global _cb_queue
    if _cb_queue is None:
        with _cb_lock:
            if _cb_queue is None:
                from queue import SimpleQueue
                q = SimpleQueue()

                def loop():
                    while True:
                        f = q.get()
                        try:
                            f()
                        except Exception:
                            logger.exception("object ready callback failed")

                threading.Thread(target=loop, daemon=True,
                                 name="ready-callbacks").start()
                _cb_queue = q
    _cb_queue.put(cb)


class _NotifyingEvent:
    """threading.Event + ready callbacks, fired exactly once on set().
    Library code (Serve handles, async bridges) registers callbacks
    instead of polling wait() loops — the reference's task-completion
    callback path in core_worker's TaskManager. Callbacks are invoked on
    a shared dispatcher thread, not the setter's thread."""

    __slots__ = ("_ev", "_cbs", "_lock")

    def __init__(self):
        self._ev = threading.Event()
        self._cbs: List = []
        self._lock = threading.Lock()

    def set(self) -> None:
        with self._lock:
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            _dispatch_callback(cb)

    def add_callback(self, cb) -> bool:
        """Register cb to run on set(); returns False (not registered)
        when already set — caller invokes it directly."""
        with self._lock:
            if self._ev.is_set():
                return False
            self._cbs.append(cb)
            return True

    def clear(self) -> None:
        with self._lock:
            self._ev.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def is_set(self) -> bool:
        return self._ev.is_set()


class _OwnedObject:
    __slots__ = ("state", "data", "error", "locations", "event", "refcount",
                 "task_spec", "dynamic_children", "recovering", "size",
                 "last_lost_node", "recon_attempts", "evac_tried")

    def __init__(self):
        self.state = "pending"       # pending | ready
        self.data: Optional[bytes] = None     # serialized inline payload
        self.error = 0
        self.locations: set = set()  # node_id hex with a shm copy
        self.size = 0                # serialized bytes of a shm copy
        #   (0 = inline or unknown); feeds locality-aware lease hints
        self.event = _NotifyingEvent()
        self.refcount = 0
        # lineage for reconstruction: {"spec","resources","key",
        # "retries_left","strategy","env"} shared across sibling slots
        self.task_spec: Optional[dict] = None
        # sub-object ids of a num_returns="dynamic" task: freed with slot 0
        # unless a deserialized generator bound its own refs to them
        self.dynamic_children: Optional[list] = None
        # a _recover_or_fail thread is resolving this entry: borrowers
        # polling every 10 ms must not spawn redundant ones
        self.recovering = False
        # the last dead node pruned from ``locations``: when lineage is
        # exhausted, ObjectLostError names this node's crash dossier
        # (docs/fault_tolerance.md)
        self.last_lost_node: Optional[str] = None
        # lineage resubmits charged to THIS object, bounded by
        # object_reconstruct_max_attempts on top of the task's own
        # retry budget (a flapping node must converge, not loop)
        self.recon_attempts = 0
        # evac hints already followed by borrower-driven recovery: a
        # stale hint (landing node dropped the copy) must be consulted
        # once, not poll-looped forever by _recover_or_fail
        self.evac_tried: Optional[set] = None


# Pull admission control lives with the data-plane engine now
# (_private/transfer.py); the name stays importable here for callers and
# tests that treat it as part of the core worker's surface.
_PullBudget = transfer.PullBudget


class _Lease:
    __slots__ = ("lease_id", "worker_id", "address", "conn", "key",
                 "granting_addr", "pending", "plock")

    def __init__(self, key, grant, conn):
        self.key = key
        self.lease_id = grant["lease_id"]
        self.worker_id = grant["worker_id"]
        self.address = tuple(grant["address"])
        self.granting_addr = grant.get("granting_addr")  # None == local
        self.conn = conn
        # task_id -> (spec, retries) of every unresolved spec pushed on
        # this lease, in send order.  Resolution pops exactly once, under
        # plock, from whichever arrives first: the worker's streamed
        # task_done push (early, mid-frame) or the batch ack (authoritative
        # backstop); on connection death the leftovers are the unexecuted
        # tail (first entry = the spec that was executing).
        self.pending: Dict[bytes, tuple] = {}
        self.plock = threading.Lock()


class CoreWorker:
    # class-level defaults: the lease loop's queue-wait telemetry reads
    # these dicts, and test doubles that borrow the loop with a minimal
    # __init__ must see an (empty) mapping, not an AttributeError.
    # Real instances shadow them with their own dicts in __init__.
    # _task_t0 feeds the e2e histogram (popped at the terminal reply);
    # _task_tq feeds queue-wait and is popped at FIRST dispatch, so a
    # retry requeued after a worker death is never re-observed with the
    # original submit stamp (that sample would include the first
    # attempt's execution time).
    _task_t0: Dict[bytes, float] = {}
    _task_tq: Dict[bytes, float] = {}

    def _init_submitter_state(self) -> None:
        """Every field the task-submission machinery reads: the lease
        loops (``_enqueue_task``/``_lease_request_loop``/
        ``_lease_worker_loop``), spillback + locality hints
        (``_lease_with_spillback``/``_arg_hints``), and ownership
        bookkeeping.  The scripted-peer harnesses (tests/test_rpc.py,
        tests/test_scripted_peers.py) construct owners that skip
        ``CoreWorker.__init__`` and call THIS instead — a new submitter
        field initialized inline in ``__init__`` silently breaks that
        tier with an AttributeError swallowed on a lease thread, so add
        it here.
        """
        self._owned: Dict[ObjectID, _OwnedObject] = {}
        self._owned_lock = threading.RLock()  # ObjectRef ctor re-enters
        # strong refs to task-argument ObjectRefs, held until the task using
        # them completes (otherwise the owner may free the object before the
        # executing worker fetches it)
        self._arg_refs: Dict[bytes, list] = {}
        # task submission state: per scheduling key a FIFO of pending specs
        # and a set of leased workers that pull from it (cf. reference
        # OnWorkerIdle, direct_task_transport.cc:174 — tasks pipeline onto
        # leased workers; at most one lease request in flight per key,
        # RequestNewWorkerIfNeeded :325)
        self._sched: Dict[str, Dict[str, Any]] = {}
        self._sched_lock = threading.Lock()
        # wakes idle keepalive leases when new work lands on their key
        self._sched_cv = threading.Condition(self._sched_lock)
        # task binary -> remaining OOM-kill retries (separate budget from
        # max_retries; reference task_oom_retries)
        self._oom_retries: Dict[bytes, int] = {}
        self._node_table: Dict[str, Dict] = {}
        self._shutdown = threading.Event()
        # submit-time monotonic stamps: e2e latency + first-dispatch wait
        self._task_t0: Dict[bytes, float] = {}
        self._task_tq: Dict[bytes, float] = {}

    def __init__(self, *, mode: str, gcs_address: Tuple[str, int],
                 raylet_address: Tuple[str, int], store_path: str,
                 node_id: str, job_id: Optional[JobID] = None,
                 worker_id: Optional[WorkerID] = None,
                 session_dir: str = "", host: str = "127.0.0.1"):
        global _INLINE_MAX
        _INLINE_MAX = CONFIG.inline_object_max_bytes
        self.mode = mode  # "driver" | "worker"
        self.worker_id = worker_id or WorkerID.from_random()
        self.job_id = job_id or JobID.from_random()
        self.node_id = node_id
        self.session_dir = session_dir
        self.current_task_id = TaskID.from_random()  # driver root task
        self._put_counter = 0
        self._counter_lock = threading.Lock()

        self._init_submitter_state()
        self._memory_cache: Dict[ObjectID, Any] = {}   # deserialized values
        # insertion order of BORROWED cache entries only — the trim's
        # working set.  Owned entries leave via refcounting, so scanning
        # the whole cache for borrowed victims on every get was O(cache)
        # per call (quadratic across a big wave of gets) for zero
        # evictions.  Entries carry an insertion token matched against
        # _borrowed_tokens at trim time: a removal path (release_borrowed
        # etc.) drops the token, so a stale FIFO entry can never evict a
        # LIVE re-fetched value and release its active pins.
        self._borrowed_cache_order: deque = deque()   # (oid, token)
        self._borrowed_tokens: Dict[ObjectID, int] = {}
        self._borrowed_seq = itertools.count()
        self._pins: Dict[ObjectID, int] = {}   # local shm pins we hold
        self._pins_lock = threading.Lock()
        # of those pins, the ones a fetched value's zero-copy arrays hold
        # (_hold_views): released when the last array dies, never by the
        # owner's free or a cache eviction, which would let the store
        # reuse memory the arrays still read
        self._view_pins: Dict[ObjectID, int] = {}
        self._view_freed: set = set()   # freed by us while views lived
        self._dead_views: deque = deque()   # (oid, pins) to release
        self._owner_conns = transfer.ConnCache()
        self._pull_budget = _PullBudget(CONFIG.pull_memory_cap_bytes)
        # bulk data plane (docs/object_transfer.md): pipelined multi-
        # source shm-direct pulls over the pooled connection cache
        self._puller: Optional[transfer.ObjectPuller] = None

        # streaming-generator table: task binary -> _StreamState for every
        # live num_returns="streaming" submission this process owns
        self._streams: Dict[bytes, _StreamState] = {}
        self._streams_lock = threading.Lock()

        self.store = SharedMemoryStore.attach(store_path)
        # report_generator_item only buffers + notifies (and may resolve
        # a parked Deferred, which just enqueues a reply frame): run it
        # inline on the reader thread — item delivery latency is the
        # time-to-first-token path.  report_object_location is a dict
        # update under _owned_lock.
        self._server = rpc.Server(
            self._handle_rpc, host=host,
            fast_methods=frozenset({"report_generator_item",
                                    "report_object_location"}))
        self.address = self._server.address
        self._puller = transfer.ObjectPuller(
            self.store, self._node_address, self._owner_conn,
            budget=self._pull_budget)

        self.gcs = GcsClient(gcs_address)
        self.raylet_addr = tuple(raylet_address)
        self._raylet = rpc.connect(self.raylet_addr)

        self._fn_cache: Dict[str, Any] = {}
        self._fn_key_by_id: Dict[int, str] = {}  # id(func) -> fn key
        self._fn_id_pins: Dict[int, Any] = {}    # keeps those ids stable

        # actor submission: per-actor ordered pipeline (a single sender
        # thread per actor allocates seqs in submission order and pipelines
        # calls; cf. CoreWorkerDirectActorTaskSubmitter's per-actor queues,
        # direct_actor_task_submitter.h:67).  A fresh connection starts a new
        # caller-stream with seq 0, so the actor-side queue never waits on
        # seqs that died with an old connection.
        self._actor_pipes: Dict[str, "_ActorPipe"] = {}
        self._actor_lock = threading.Lock()

        # job-level default runtime env (prepared descriptor) + prepare cache
        self.job_runtime_env: Optional[dict] = None
        self._runtime_env_cache: Dict[str, Optional[dict]] = {}

        # lineage ledger (reference: TaskManager lineage pinning,
        # task_manager.h:146 + object_recovery_manager.h:41): FIFO of task
        # binaries whose specs are pinned for reconstruction, bounded by
        # lineage_max_bytes; per-task slot sets so arg refs and specs are
        # dropped when the last return object is freed.
        self._lineage_bytes = 0
        self._lineage_order: deque = deque()
        self._lineage_meta: Dict[bytes, dict] = {}
        self._alive_cache: Tuple[float, set] = (0.0, set())

        # deferred remote frees: (node_hex, oid_binary) batched per node
        # every free_objects_period_ms (reference: plasma Delete batching)
        self._free_queue: List[Tuple[str, bytes]] = []
        self._free_cv = threading.Condition()
        self._free_thread = threading.Thread(target=self._free_loop,
                                             daemon=True)
        self._free_thread.start()

        from ray_tpu_torch._private.task_events import TaskEventBuffer
        # only drivers know the true job id; worker-side CoreWorkers get a
        # random one, which must not overwrite the owner's in the task table
        self.events = TaskEventBuffer(
            self.gcs, job_id=self.job_id.hex() if mode == "driver" else "",
            node_id=node_id, worker_id=self.worker_id.hex())

        # runtime telemetry rides the GCS KV: bind this process's flusher
        # and the poll-time pin-count gauge (zero hot-path cost); both
        # are unhooked in shutdown() so this CoreWorker (and everything
        # its caches pin) stays collectable after ray_tpu_torch.shutdown()
        self._pins_gauge_cb = self._pin_count
        rtm.gauge_callback("ray_tpu_shm_pins",
                           "shared-memory pins held by this process",
                           self._pins_gauge_cb)
        rtm.attach(self.gcs.kv_put,
                   ident=f"{mode}-{self.worker_id.hex()[:12]}")
        # cluster event plane + flight recorder (docs/observability.md):
        # lifecycle events batch to the GCS table; the in-memory ring
        # (incl. ring-only task breadcrumbs) is dumped to a per-worker
        # flight file each flush so the raylet can harvest it into a
        # crash dossier after this process dies
        import os
        from ray_tpu_torch._private import cluster_events as cev
        flight = None
        if session_dir and mode == "worker":
            flight = os.path.join(
                session_dir, "logs",
                cev.flight_file_name(self.worker_id.hex()))
        self._events_recorder = cev.configure(
            sink=lambda evs: self.gcs.call(
                "report_cluster_events", {"events": evs}, timeout=5),
            source=mode, node_id=node_id,
            worker_id=self.worker_id.hex(),
            job_id=self.job_id.hex() if mode == "driver" else "",
            flight_path=flight)
        # distributed request tracing (docs/observability.md): bind this
        # process's span buffer; finished spans batch to the GCS span
        # table on the flusher thread, never on the request path
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        self._span_buffer = trh.configure(
            lambda spans: self.gcs.call(
                "report_spans", {"spans": spans}, timeout=5),
            node_id=node_id, worker_id=self.worker_id.hex(),
            source=mode)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        self._shutdown.set()
        # unhook telemetry publishing bound to this worker's GCS client
        # (a newer worker's attach/callback is left untouched)
        rtm.detach(self.gcs.kv_put)
        rtm.remove_gauge_callback("ray_tpu_shm_pins", self._pins_gauge_cb)
        from ray_tpu_torch._private import cluster_events as cev
        cev.detach(self._events_recorder)
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        trh.detach(self._span_buffer)
        try:
            self.events.stop()
        except Exception:
            pass
        with self._sched_lock:
            leases = [l for s in self._sched.values() for l in s["leases"]]
            self._sched.clear()
            self._sched_cv.notify_all()  # abort idle keepalive waits
        for lease in leases:
            self._return_lease(lease)
        self._server.stop()
        with self._actor_lock:
            pipes = list(self._actor_pipes.values())
        for pipe in pipes:
            if pipe.conn is not None:
                pipe.conn.close()
        try:
            self._raylet.close()
        except Exception:
            pass
        try:
            self.gcs.close()
        except Exception:
            pass
        with self._pins_lock:     # no view's pins are released after it
            self.store.close()

    # ------------------------------------------------------- refcounting
    def _ref_created(self, oid: ObjectID) -> None:
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None:
                entry.refcount += 1

    def _ref_deleted(self, oid: ObjectID) -> None:
        if self._shutdown.is_set():
            return
        freed: List[Tuple[ObjectID, set]] = []
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None:
                entry.refcount -= 1
                if entry.refcount <= 0 and entry.state == "ready":
                    self._free_with_children_locked(oid, entry, freed)
        self._complete_frees(freed)

    def _free_with_children_locked(self, oid: ObjectID,
                                   entry: _OwnedObject,
                                   freed: list) -> None:
        self._free_entry_locked(oid, entry, freed)
        for child in entry.dynamic_children or ():
            child_entry = self._owned.get(child)
            if child_entry is not None and child_entry.refcount <= 0:
                # generator never deserialized: nothing else will ever
                # free these
                self._free_entry_locked(child, child_entry, freed)

    def _free_entry_locked(self, oid: ObjectID, entry: _OwnedObject,
                           freed: list) -> None:
        del self._owned[oid]
        self._memory_cache.pop(oid, None)
        freed.append((oid, set(entry.locations)))
        self._lineage_slot_freed_locked(oid)

    def _complete_frees(self, freed: List[Tuple[ObjectID, set]]) -> None:
        if self._shutdown.is_set():
            # the store mapping may already be closed: touching it from a
            # late reply/error path would fault, and the raylet reclaims
            # everything at session teardown anyway
            return
        for foid, locations in freed:
            # pins that live arrays hold stay, so the delete below is
            # refused; the last array's death deletes (_drain_dead_views)
            self._release_pins(foid, freed=True)
            # release the primary copies: local shm directly, remote nodes
            # (and any spilled files) via batched free_objects RPCs
            try:
                self.store.delete(foid)
            except Exception:
                pass
            # every location gets a free RPC — including our own node,
            # whose raylet may hold the copy as a spill file
            if locations:
                with self._free_cv:
                    for node_hex in locations:
                        self._free_queue.append((node_hex, foid.binary()))
                    self._free_cv.notify()

    def _lineage_slot_freed_locked(self, oid: ObjectID) -> None:
        """owned_lock held: drop a task's lineage (spec + pinned arg refs)
        once its last return object is freed."""
        if oid.is_put():
            return
        tb = oid.task_id().binary()
        meta = self._lineage_meta.get(tb)
        if meta is None:
            return
        meta["slots"].discard(oid)
        if any(o in self._owned for o in meta["slots"]):
            return
        self._lineage_meta.pop(tb, None)
        if not meta["evicted"]:
            self._lineage_bytes -= meta["size"]
        self._arg_refs.pop(tb, None)

    def _free_loop(self) -> None:
        period = CONFIG.free_objects_period_ms / 1000.0
        while not self._shutdown.is_set():
            # views whose finalizer met a held pin lock wait at most this
            # loop's second for their release
            self._drain_dead_views()
            with self._free_cv:
                if not self._free_queue:
                    self._free_cv.wait(timeout=1.0)
                batch, self._free_queue = self._free_queue, []
            if not batch:
                continue
            time.sleep(period)  # let more frees accumulate
            with self._free_cv:
                batch += self._free_queue
                self._free_queue = []
            by_node: Dict[str, list] = {}
            for node_hex, ob in batch:
                by_node.setdefault(node_hex, []).append(ob)
            for node_hex, obs in by_node.items():
                # nothing here may escape: one bad node/GCS hiccup must not
                # kill the only consumer of the free queue
                try:
                    addr = self._node_address(node_hex)
                    if addr is None:
                        continue
                    conn = self._owner_conn(addr)
                    conn.call("free_objects", {"object_ids": obs},
                              timeout=5.0)
                except Exception:
                    pass

    def _note_pin(self, oid: ObjectID, pin_out: Optional[list] = None
                  ) -> None:
        with self._pins_lock:
            self._pins[oid] = self._pins.get(oid, 0) + 1
        if pin_out is not None:
            pin_out.append(1)
        self._drain_dead_views()

    def _release_pins(self, oid: ObjectID, freed: bool = False) -> None:
        """Release our pins on ``oid`` but those that live zero-copy
        arrays hold (``_hold_views``); ``freed``: the owner's free, so
        the last array's death deletes the object."""
        with self._pins_lock:
            count = self._pins.pop(oid, 0)
            held = self._view_pins.get(oid, 0)
            if held:
                self._pins[oid] = held
                if freed:
                    self._view_freed.add(oid)
        for _ in range(count - held):
            try:
                self.store.release(oid)
            except Exception:
                break
        self._drain_dead_views()

    def _pin_count(self) -> int:
        """The ``ray_tpu_shm_pins`` gauge: the pins this process holds."""
        self._drain_dead_views()
        return sum(self._pins.values())

    def _hold_views(self, oid: ObjectID, keeper, n: int) -> None:
        """Make ``n`` pins that a fetch took on ``oid`` live as long as
        ``keeper``, the array through which every zero-copy view of the
        fetched value reaches the segment."""
        with self._pins_lock:
            self._view_pins[oid] = self._view_pins.get(oid, 0) + n
        weakref.finalize(keeper, _views_dropped, weakref.ref(self), oid,
                         n).atexit = False

    def _drain_dead_views(self) -> None:
        """Release the pins of values whose last view died
        (``_views_dropped`` queues them), and delete those objects that
        we freed meanwhile.  A finalizer may fire inside a section that
        holds ``_pins_lock`` (a collection during an allocation), so this
        never waits for the lock: whoever next releases it drains."""
        if self._shutdown.is_set() or not self._dead_views:
            return
        if not self._pins_lock.acquire(blocking=False):
            return
        try:
            # shutdown closes the store under this lock
            while self._dead_views and not self._shutdown.is_set():
                oid, n = self._dead_views.popleft()
                held = self._view_pins.pop(oid, 0) - n
                if held > 0:
                    self._view_pins[oid] = held
                count = self._pins.pop(oid, 0) - n
                if count > 0:
                    self._pins[oid] = count
                delete = held <= 0 and oid in self._view_freed
                if held <= 0:
                    self._view_freed.discard(oid)
                try:
                    for _ in range(n):
                        self.store.release(oid)
                    if delete:
                        self.store.delete(oid)
                except Exception:
                    pass
        finally:
            self._pins_lock.release()

    def _release_pins_n(self, oid: ObjectID, n: int) -> None:
        """Release exactly the ``n`` pins the caller itself took — a
        concurrent fetch of the same object may hold live views under
        its own pins, so blanket _release_pins would be unsound here."""
        with self._pins_lock:
            count = self._pins.get(oid, 0)
            take = min(count, n)
            if take <= 0:
                return
            if count - take <= 0:
                self._pins.pop(oid, None)
            else:
                self._pins[oid] = count - take
        for _ in range(take):
            try:
                self.store.release(oid)
            except Exception:
                break
        self._drain_dead_views()

    def release_borrowed(self, oids) -> None:
        """Drop pins + cached values for borrowed objects (a worker calls
        this after finishing the task that resolved them)."""
        for oid in oids:
            with self._owned_lock:
                if oid in self._owned:
                    continue  # owned objects are managed by refcounting
                self._drop_cached(oid)
            self._release_pins(oid)

    # ------------------------------------------------------------- put/get
    def put(self, value: Any) -> ObjectRef:
        _t0 = rtm.now()
        with self._counter_lock:
            self._put_counter += 1
            idx = self._put_counter
        oid = ObjectID.for_put(self.current_task_id, idx)
        head, views = ser.serialize(value)
        size = ser.serialized_size(head, views)
        entry = _OwnedObject()
        entry.state = "ready"
        with self._owned_lock:
            self._owned[oid] = entry
        if size <= _INLINE_MAX:
            entry.data = ser.to_flat_bytes(head, views)
            self._memory_cache[oid] = value
        else:
            self.store_put(oid, head, views)
            entry.locations.add(self.node_id)
            entry.size = size
        entry.event.set()
        _M_PUT.observe_since(_t0)
        return ObjectRef(oid, self.address, self)

    def store_put(self, oid: ObjectID, head, views,
                   error: bool = False) -> None:
        """Write a primary copy into local shm.  Primaries are never
        LRU-evicted (allow_evict=False); on a full store the raylet spills
        LRU objects to disk and the create retries.  If spilling can't make
        room (everything is pinned by readers), the copy is born on disk
        instead of failing — the reference's plasma fallback allocation
        (object_store_fallback_dir)."""
        size = ser.serialized_size(head, views)
        for _ in range(3):
            try:
                self.store.put_serialized(oid, head, views, error=error,
                                          allow_evict=False)
                return
            except FileExistsError:
                return  # immutable: an identical reconstruction beat us
            except exc.ObjectStoreFullError:
                try:
                    reply = self._raylet.call(
                        "request_spill", {"bytes": size},
                        timeout=CONFIG.raylet_rpc_timeout_s)
                    freed = reply.get("freed", 0)
                except (ConnectionError, rpc.RpcError, TimeoutError,
                        OSError):
                    freed = 0
                if freed < size:
                    break  # nothing left to spill: fall back to disk
                time.sleep(0.01)
        self._put_fallback(oid, head, views, error)

    def _put_fallback(self, oid: ObjectID, head, views,
                      error: bool) -> None:
        """Write the primary copy straight into the raylet's spill dir
        (same host, shared filesystem) and register it; fetches stream or
        restore it like any spilled object."""
        import os
        try:
            spill_dir = self._raylet.call(
                "spill_dir", {}, timeout=CONFIG.raylet_rpc_timeout_s)
        except rpc.RemoteError as e:
            if "out of disk" in str(e):
                # shm full AND disk full: degrade with a clear error
                # instead of a hang (reference OutOfDiskError)
                raise exc.OutOfDiskError(str(e)) from None
            raise
        path = os.path.join(spill_dir, oid.hex())
        tmp = f"{path}.tmp{os.getpid()}"
        total = ser.serialized_size(head, views)
        buf = bytearray(total)
        ser.write_into(memoryview(buf), head, views)
        with open(tmp, "wb") as f:
            f.write(buf)
        os.replace(tmp, path)
        self._raylet.call("register_spilled",
                          {"object_id": oid.binary(), "size": total,
                           "meta": 1 if error else 0},
                          timeout=CONFIG.raylet_rpc_timeout_s)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(r, deadline) for r in refs]

    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id
        if oid in self._memory_cache:
            return self._memory_cache[oid]
        _t0 = rtm.now()
        pins: list = []   # shm pins THIS fetch takes (see _note_pin)
        data = self._fetch_serialized(ref, deadline, pins)
        if data is None:
            raise exc.GetTimeoutError(f"get timed out on {ref}")
        if pins:
            import numpy as np
            # the segment seen through an array: every zero-copy view in
            # the value reaches the segment through it, so it lives
            # exactly as long as the last of them (_hold_views)
            data = np.frombuffer(data, np.uint8)
        try:
            # raises stored task errors
            value, holds_views = ser.deserialize_with_viewinfo(data)
        except BaseException:
            # no value materialized, so nothing can hold views: drop the
            # pins this fetch took or every get of a stored error / un-
            # importable payload leaks one pin per attempt
            if pins:
                data = None
                self._release_pins_n(oid, len(pins))
            raise
        if pins and holds_views:
            # the pins outlive the owner's free and any cache eviction
            # while the value's arrays live
            self._hold_views(oid, data, len(pins))
            data = None
        elif pins:
            # self-contained value (no zero-copy views into the
            # segment): drop our pins now instead of carrying them until
            # cache eviction — a consumer draining a long generator
            # stream must not pin every consumed item (the
            # object_store.py:293 leak)
            data = None
            self._release_pins_n(oid, len(pins))
        self._memory_cache[oid] = value
        with self._owned_lock:
            borrowed = oid not in self._owned
        if borrowed:
            tok = next(self._borrowed_seq)
            self._borrowed_tokens[oid] = tok
            self._borrowed_cache_order.append((oid, tok))
            self._maybe_trim_cache()
        _M_GET.observe_since(_t0)
        return value

    def _drop_cached(self, oid: ObjectID) -> None:
        """Remove a cached value AND its borrowed-FIFO claim; every path
        that pops _memory_cache for a possibly-borrowed oid must come
        through here or the FIFO entry goes stale."""
        self._memory_cache.pop(oid, None)
        self._borrowed_tokens.pop(oid, None)

    def _maybe_trim_cache(self, cap: int = 4096) -> None:
        """Bound the borrowed portion of the value cache (owned entries
        are evicted by refcounting; borrowed ones would otherwise
        accumulate in long-lived pooled workers).  O(1) amortized: only
        the borrowed-insertion FIFO is walked, never the whole cache."""
        while len(self._borrowed_cache_order) > cap:
            oid, tok = self._borrowed_cache_order.popleft()
            if self._borrowed_tokens.get(oid) != tok:
                continue  # superseded or released: not ours to evict
            self._borrowed_tokens.pop(oid, None)
            if self._memory_cache.pop(oid, None) is not None:
                self._release_pins(oid)

    def _fetch_serialized(self, ref: ObjectRef,
                          deadline: Optional[float],
                          pin_out: Optional[list] = None
                          ) -> Optional[memoryview]:
        oid = ref.id
        # 1. owned inline
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is not None:
            evac_tried: set = set()
            while True:
                t = self._remaining(deadline)
                if not entry.event.wait(t if t is not None else None):
                    return None
                with self._owned_lock:
                    data = entry.data
                if data is not None:
                    return memoryview(data)
                # owned but stored in shm somewhere
                res = self._fetch_from_locations(oid, entry, deadline,
                                                 pin_out)
                if res is not None:
                    return res
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                # a drained node may have evacuated the copy before
                # dying: consult the GCS hint table before burning a
                # reconstruction (docs/fault_tolerance.md)
                if self._merge_evacuated_locations(oid, entry, evac_tried):
                    continue
                # every live copy is gone: recover via lineage or give up
                # (reference ObjectRecoveryManager::RecoverObject,
                # object_recovery_manager.h:41)
                if not self._try_reconstruct(oid, entry):
                    raise exc.ObjectLostError(
                        f"object {oid.hex()[:16]} lost: all copies are gone "
                        f"and it cannot be reconstructed (put objects and "
                        f"tasks out of retries/reconstruction budget are "
                        f"unrecoverable)"
                        + (f"; last copy died with node "
                           f"{entry.last_lost_node[:12]} — see "
                           f".debug_dossier()" if entry.last_lost_node
                           else ""),
                        dossier_id=entry.last_lost_node)
        # 2. local shm (argument prefetch lands borrowed copies here:
        # the hit counter is the numerator of the prefetch hit ratio)
        res = self.store.get(oid, timeout=0.0)
        if res is not None:
            buf, _ = res
            _M_FETCH_LOCAL.inc()
            self._note_pin(oid, pin_out)
            return buf
        # 3. ask the owner
        return self._fetch_from_owner(ref, deadline, pin_out)

    def _alive_node_ids(self, max_age: float = 1.0) -> set:
        """Node liveness view, refreshed from the GCS at most every
        ``max_age`` seconds.  Empty set means 'unknown' (GCS unreachable
        before the first successful refresh) — callers must not prune on
        an empty view."""
        ts, cached = self._alive_cache
        now = time.monotonic()
        if now - ts <= max_age:
            return cached
        try:
            nodes = self.gcs.call("list_nodes", timeout=5)
        except (ConnectionError, rpc.RpcError, TimeoutError, OSError):
            return cached
        for n in nodes:
            self._node_table[n["node_id"]] = n
        cached = {n["node_id"] for n in nodes if n["alive"]}
        self._alive_cache = (now, cached)
        return cached

    def _prune_dead_locations(self, entry: _OwnedObject) -> set:
        """Drop locations on dead nodes from an owned entry; a dead node's
        copy never comes back (its shm segment died with it)."""
        alive = self._alive_node_ids()
        with self._owned_lock:
            if alive:
                lost = entry.locations - alive
                if lost:
                    # remember who lost the (so far) last copy: if
                    # lineage is later exhausted, ObjectLostError names
                    # this node's dossier
                    entry.last_lost_node = sorted(lost)[0]
                entry.locations &= alive
            return set(entry.locations)

    def _fetch_from_locations(self, oid: ObjectID, entry: _OwnedObject,
                              deadline: Optional[float],
                              pin_out: Optional[list] = None
                              ) -> Optional[memoryview]:
        """Owner-side fetch of an owned shm object: local shm first, then
        one striped pull across every live location at once (including our
        own raylet, which may hold it as a spill file).  Returns None only
        once the object is genuinely unavailable — every location is dead,
        or definitively reports the copy gone, or has been unreachable
        past fetch_fail_timeout_s — so the caller can decide between
        reconstruction and timeout.  A raylet that *answers* "absent"
        drops that location immediately; a raylet that can't be reached
        gets the grace window (its node may just be restarting) instead of
        triggering a duplicate re-execution."""
        grace = time.monotonic() + CONFIG.fetch_fail_timeout_s
        attempt = 0
        while True:
            locations = self._prune_dead_locations(entry)
            if not locations:
                return None
            if self.node_id in locations:
                res = self.store.get(oid, timeout=0.0)
                if res is not None:
                    self._note_pin(oid, pin_out)
                    return res[0]
            out = self._puller.pull(oid, sorted(locations), deadline)
            if out.absent:
                # evicted/never there: those locations are authoritative
                # about themselves — forget them
                with self._owned_lock:
                    entry.locations -= out.absent
            if out.status == "ok":
                self._finish_pull(oid, out, pin_out)
                if out.published:
                    with self._owned_lock:
                        entry.locations.add(self.node_id)
                return out.data if out.published else memoryview(out.data)
            if not out.transient:
                return None  # every remaining location answered "absent"
            now = time.monotonic()
            if now >= grace or (deadline is not None and now >= deadline):
                return None
            attempt += 1
            time.sleep(min(0.05 * attempt, 1.0))

    def _fetch_from_location_set(self, ref: "ObjectRef", locations: set,
                                 deadline: Optional[float],
                                 pin_out: Optional[list] = None
                                 ) -> Optional[memoryview]:
        """Borrower-side striped pull over owner-reported locations."""
        oid = ref.id
        alive = self._alive_node_ids()
        if self.node_id in locations:
            res = self.store.get(oid, timeout=0.0)
            if res is not None:
                self._note_pin(oid, pin_out)
                return res[0]
        # self stays in the source set: our own raylet may hold the copy
        # as a spill file (the engine's pull restores or streams it)
        sources = [nh for nh in sorted(locations)
                   if not alive or nh in alive]
        if not sources:
            return None
        out = self._puller.pull(oid, sources, deadline)
        if out.status != "ok":
            return None
        self._finish_pull(oid, out, pin_out)
        if out.published:
            # tell the owner this node now holds a copy: later pulls can
            # stripe across us, and the final free sweeps our copy too
            self._report_location(ref, out.bytes)
            return out.data
        return memoryview(out.data)

    def _finish_pull(self, oid: ObjectID, out, pin_out) -> None:
        """Shared bookkeeping for a successful remote pull."""
        _M_FETCH_REMOTE.inc()
        if out.published:
            # the engine holds the single store pin for the sealed copy;
            # account it like any local-shm pin this fetch took
            self._note_pin(oid, pin_out)
        if out.bytes >= CONFIG.object_transfer_chunk_bytes \
                and not oid.is_put():
            # put objects have a pseudo task id with no task record:
            # recording against it would fabricate a phantom stub row in
            # the GCS task table / `ray-tpu status`
            # timeline slice per multi-chunk pull (docs/observability.md):
            # rides the producing task's event record
            # no name: the task record keeps the producing task's name
            # the event rides the producing task's record, but the slice
            # belongs to THIS process's row — stamp the puller's ids
            self.events.record(
                oid.task_id().hex(), "PULL",
                dur_ms=round(out.duration_s * 1000.0, 3),
                bytes=out.bytes, nsources=out.nsources,
                object_id=oid.hex()[:16],
                node_id=self.node_id,
                worker_id=self.worker_id.hex())

    def _report_location(self, ref: "ObjectRef", size: int) -> None:
        """Fire-and-forget location update to the owner after a pulled
        copy was published into local shm (the ownership directory's
        OnObjectLocationAdded analog): grows the owner's location set so
        later pulls can stripe across this node."""
        try:
            conn = self._owner_conn(tuple(ref.owner_addr))
            conn.call_async("report_object_location",
                            {"object_id": ref.id.binary(),
                             "node_id": self.node_id, "size": size})
        except Exception:
            pass  # purely an optimization; the owner survives without it

    def _node_address(self, node_hex: str) -> Optional[Tuple[str, int]]:
        node = self._node_table.get(node_hex)
        if node is None:
            for n in self.gcs.call("list_nodes"):
                self._node_table[n["node_id"]] = n
            node = self._node_table.get(node_hex)
        return tuple(node["address"]) if node else None

    def _owner_conn(self, addr: Tuple[str, int]) -> rpc.Connection:
        return self._owner_conns.get(tuple(addr))

    def _fetch_from_owner(self, ref: ObjectRef,
                          deadline: Optional[float],
                          pin_out: Optional[list] = None
                          ) -> Optional[memoryview]:
        while True:
            t = self._remaining(deadline)
            try:
                conn = self._owner_conn(ref.owner_addr)
                res = conn.call("get_object", {
                    "object_id": ref.id.binary(),
                    "timeout": min(t, 2.0) if t is not None else 2.0,
                }, timeout=CONFIG.gcs_rpc_timeout_s)
            except (ConnectionError, rpc.RemoteError, OSError):
                data = self._orphan_borrower_fetch(ref, deadline, pin_out)
                if data is not None:
                    return data
                raise exc.ObjectLostError(
                    f"owner of {ref} unreachable at {ref.owner_addr} and "
                    f"no surviving copy found (evacuation hints + live-"
                    f"node sweep)")
            if res is not None:
                if "data" in res:
                    return memoryview(res["data"])
                # location answer
                data = self._fetch_from_location_set(
                    ref, set(res["locations"]), deadline, pin_out)
                if data is not None:
                    return data
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.01)

    def _orphan_borrower_fetch(self, ref: ObjectRef,
                               deadline: Optional[float],
                               pin_out: Optional[list] = None
                               ) -> Optional[memoryview]:
        """Owner-death fallback for borrowed refs (docs/fault_tolerance.md):
        the bytes may well outlive the owner — a drained node evacuated
        its primaries into survivors (GCS hint table), or the copy sits
        in a surviving node's store while only the owning *process* died
        (sharded train checkpoints put by gang workers outlive the gang
        teardown exactly this way).  Consult the hint table, then sweep
        the live nodes with one striped pull; raylets that answer
        "absent" drop out of the source set inside the engine."""
        oid = ref.id
        nodes: set = set()
        try:
            hints = self.gcs.call("get_evacuated_locations",
                                  {"object_ids": [oid.hex()]}, timeout=5)
            nodes |= set((hints or {}).get(oid.hex(), ()))
        except (ConnectionError, rpc.RpcError, TimeoutError, OSError):
            pass
        nodes |= self._alive_node_ids()
        nodes.discard(self.node_id)   # local shm was already tried
        if not nodes:
            return None
        return self._fetch_from_location_set(ref, nodes, deadline, pin_out)

    def _merge_evacuated_locations(self, oid: ObjectID,
                                   entry: _OwnedObject,
                                   tried: set) -> bool:
        """Grow the entry's location set from the GCS evacuated-object
        table (docs/fault_tolerance.md): a draining node ships its
        primary copies to survivors and registers each landing, so an
        owner whose old locations died finds the copy here instead of
        re-executing lineage.  ``tried`` keeps one fetch attempt from
        looping on a hint whose copy turned out absent.  Returns True
        when a new candidate location was merged."""
        try:
            hints = self.gcs.call("get_evacuated_locations",
                                  {"object_ids": [oid.hex()]}, timeout=5)
        except (ConnectionError, rpc.RpcError, TimeoutError, OSError):
            return False
        nodes = set((hints or {}).get(oid.hex(), ())) - tried
        if not nodes:
            return False
        alive = self._alive_node_ids()
        if alive:
            # liveness-filter BEFORE marking tried: a hint whose target
            # isn't in the (≤1s-stale) alive view yet must stay
            # consultable on the next attempt, not be consumed unseen
            nodes &= alive
        if not nodes:
            return False
        tried |= nodes
        with self._owned_lock:
            entry.locations |= nodes
        logger.info("object %s: following evacuated copy to %s",
                    oid.hex()[:12], sorted(n[:8] for n in nodes))
        return True

    # ------------------------------------------------------- reconstruction
    def _try_reconstruct(self, oid: ObjectID, entry: _OwnedObject) -> bool:
        """All copies of an owned object are gone: resubmit the task that
        produced it from its pinned spec (reference
        TaskManager::ResubmitTask, task_manager.h:146).  Returns True if a
        recovery is in flight (the entry's event will be set again);
        idempotent — concurrent callers piggyback on one resubmission."""
        with self._owned_lock:
            if entry.state == "pending":
                return True  # recovery already in flight
            meta = entry.task_spec
            if meta is None:
                return False
            if meta["retries_left"] <= 0:
                return False
            if entry.recon_attempts >= \
                    CONFIG.object_reconstruct_max_attempts:
                # per-object budget on top of task retries: a flapping
                # node repeatedly losing the same object converges to
                # ObjectLostError instead of resubmitting forever
                logger.warning(
                    "object %s: reconstruction budget exhausted "
                    "(%d attempts)", oid.hex()[:12], entry.recon_attempts)
                return False
            entry.recon_attempts += 1
            meta["retries_left"] -= 1  # shared dict: visible to all slots
            spec = meta["spec"]
            task_id = TaskID(spec["task_id"])
            lmeta = self._lineage_meta.get(task_id.binary())
            # reset every return slot of the task (the resubmission
            # regenerates them all), including adopted dynamic children
            slots = {ObjectID.for_task_return(task_id, i)
                     for i in range(num_return_slots(spec["num_returns"]))}
            if lmeta is not None:
                slots |= lmeta["slots"]
            for sib_oid in slots:
                sib = self._owned.get(sib_oid)
                if sib is None:
                    continue
                sib.task_spec = meta
                sib.state = "pending"
                sib.data = None
                sib.error = 0
                sib.locations.clear()
                sib.event.clear()
                self._memory_cache.pop(sib_oid, None)
        logger.info("reconstructing object %s: resubmitting task %s "
                    "(%d retries left)", oid.hex()[:12],
                    spec.get("name", ""), meta["retries_left"])
        self.events.record(task_id.hex(), "RECONSTRUCTING",
                           name=spec.get("name", ""))
        self._enqueue_task(meta["key"], meta["resources"], spec,
                           meta["retries_left"],
                           strategy=meta.get("strategy"),
                           env=meta.get("env"))
        return True

    def _recover_or_fail(self, oid: ObjectID, entry: _OwnedObject) -> None:
        """Owner-side recovery entry point for borrower-driven gets: either
        kick off reconstruction or resolve the entry to ObjectLostError so
        every waiter (local and remote) gets a clean failure."""
        try:
            # an evacuated copy beats re-execution: merge any hint the
            # draining node registered before reconstructing.  The
            # tried set persists on the entry — borrowers poll every
            # 10 ms, and a stale hint must be followed once, not
            # re-merged on every recovery attempt
            with self._owned_lock:
                if entry.evac_tried is None:
                    entry.evac_tried = set()
                tried = entry.evac_tried
            if self._merge_evacuated_locations(oid, entry, tried):
                return
            if self._try_reconstruct(oid, entry):
                return
            err = exc.ObjectLostError(
                f"object {oid.hex()[:16]} lost: all copies are gone and it "
                f"cannot be reconstructed",
                dossier_id=entry.last_lost_node)
            head, views = ser.serialize(err, error_type=ser.ERROR_OBJECT_LOST)
            data = ser.to_flat_bytes(head, views)
            with self._owned_lock:
                if entry.state == "ready" and entry.data is None \
                        and not entry.locations:
                    entry.data = data
                    entry.error = ser.ERROR_OBJECT_LOST
                    entry.event.set()
        finally:
            with self._owned_lock:
                entry.recovering = False

    def result_is_error(self, ref: ObjectRef) -> bool:
        """Whether a READY owned ref resolved to an error payload —
        without deserializing (the serve trace roots classify a
        completed request's status off the reply the moment its ready
        callback fires)."""
        with self._owned_lock:
            entry = self._owned.get(ref.id)
            return bool(entry is not None and entry.error)

    def add_ready_callback(self, ref: ObjectRef, cb) -> None:
        """Run ``cb()`` once the owned object is ready — immediately when
        it already is (or when the ref isn't owned by this worker, where
        readiness can't be observed locally; callers use this for refs
        they own, e.g. Serve handles watching their replica calls)."""
        with self._owned_lock:
            entry = self._owned.get(ref.id)
        if entry is None or not entry.event.add_callback(cb):
            cb()

    # ------------------------------------------------------------- wait
    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        refs = list(refs)
        if len({r.id for r in refs}) != len(refs):
            # reference parity (worker.py wait): duplicates would also make
            # num_returns unsatisfiable and spin forever
            raise ValueError("wait() requires a list of unique object refs")
        ready: List[ObjectRef] = []
        while True:
            ready = [r for r in refs if self._is_ready(r)]
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        ready_set = {r.id for r in ready[:num_returns]}
        ready_list = [r for r in refs if r.id in ready_set]
        rest = [r for r in refs if r.id not in ready_set]
        return ready_list, rest

    def _is_ready(self, ref: ObjectRef) -> bool:
        if ref.id in self._memory_cache:
            return True
        with self._owned_lock:
            entry = self._owned.get(ref.id)
        if entry is not None:
            return entry.event.is_set()
        if self.store.contains(ref.id):
            return True
        # borrowed & remote: ask owner without blocking
        try:
            conn = self._owner_conn(ref.owner_addr)
            res = conn.call("get_object", {"object_id": ref.id.binary(),
                                           "timeout": 0.0,
                                           "probe": True}, timeout=5.0)
            return res is not None
        except (ConnectionError, rpc.RemoteError, TimeoutError, OSError):
            return False

    # -------------------------------------------------- function registry
    def register_function(self, func) -> str:
        # hot path: every task submission lands here, and cloudpickling the
        # function just to recompute its content hash dominates small-task
        # submit cost.  The id() cache pins each cached function object
        # explicitly — without the pin, a duplicate-hash function could be
        # collected and its id recycled by a different function, which
        # would then silently run the wrong code remotely.
        cached = self._fn_key_by_id.get(id(func))
        if cached is not None:
            return cached
        blob = cloudpickle.dumps(func)
        key = hashlib.sha1(blob).hexdigest()
        full = f"fn:{self.job_id.hex()}:{key}"
        if full not in self._fn_cache:
            self.gcs.kv_put(full, blob, overwrite=False)
            self._fn_cache[full] = func
        # bound the local caches: drivers that build a fresh closure per
        # submission would otherwise pin every one (and whatever arrays it
        # captured) forever.  Dropping them just costs cache hits — the
        # blobs stay exported in GCS KV for the job's lifetime, like the
        # reference's per-job function table.
        if len(self._fn_key_by_id) >= 4096:
            self._fn_key_by_id.clear()
            self._fn_id_pins.clear()
        if len(self._fn_cache) >= 4096:
            self._fn_cache.clear()
        self._fn_key_by_id[id(func)] = full
        self._fn_id_pins[id(func)] = func
        return full

    def load_function(self, key: str):
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self.gcs.kv_get(key)
            if blob is None:
                raise exc.RayTpuError(f"function {key} not found in GCS")
            fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------ task submission
    def submit_task(self, func, args: tuple, kwargs: dict, *,
                    num_returns=1,
                    resources: Optional[Dict[str, float]] = None,
                    max_retries: int = 3,
                    name: str = "",
                    scheduling_key: Optional[str] = None,
                    scheduling_strategy: Optional[dict] = None,
                    runtime_env: Optional[dict] = None,
                    fn_key: Optional[str] = None,
                    language: Optional[str] = None
                    ) -> List[ObjectRef]:
        # cross-language tasks carry a pre-resolved key ("cpp:Name") the
        # target-language worker resolves in its own registry (reference
        # cross_language.py — no function export through the GCS)
        if fn_key is None:
            fn_key = self.register_function(func)
        task_id = TaskID.from_random()
        resources = dict(resources or {})
        runtime_env = runtime_env or self.job_runtime_env
        # scheduling key = resource footprint (not the function): workers are
        # fungible across functions, so leases and the raylet's idle pool are
        # shared by everything with the same shape (cf. reference
        # SchedulingKey in direct_task_transport.h — runtime_env + resources)
        key = scheduling_key or (
            self.job_id.hex()[:8] + "|" +
            ",".join(f"{k}={v}" for k, v in sorted(resources.items())))
        if scheduling_strategy:
            key += "|" + ",".join(
                f"{k}={scheduling_strategy[k]}"
                for k in sorted(scheduling_strategy))
        if runtime_env:
            # workers are env-specific: a different runtime_env must never
            # reuse another env's idle workers (reference SchedulingKey
            # includes the serialized runtime env)
            key += "|env=" + runtime_env["hash"]
        if language:
            # a cpp lease must never reuse (or be reused by) python
            # workers from the same resource-shaped pool
            key += f"|lang={language}"
        arg_blob, live_refs = self._serialize_args(args, kwargs)
        if live_refs:
            self._arg_refs[task_id.binary()] = live_refs
        spec = {
            "task_id": task_id.binary(),
            "fn_key": fn_key,
            "args": arg_blob,
            "num_returns": num_returns,
            "owner_addr": list(self.address),
            "name": name or getattr(func, "__name__", "task"),
        }
        if live_refs:
            # ObjectRef-carrying specs never share a push_tasks frame —
            # see _drain_batch_locked
            spec["_refs"] = True
        if num_returns == "streaming":
            # the owner's config governs the stream it consumes; the
            # worker honors the stamped window, so no env propagation of
            # the flag is needed
            spec["backpressure"] = CONFIG.generator_backpressure_num_objects
            self._register_stream(task_id.binary(), spec["backpressure"])
        trace_ctx = _submit_trace_ctx(spec["name"])
        if trace_ctx:
            # auto span injection (reference _inject_tracing_into_function,
            # tracing_helper.py:324): the submitting span's context rides
            # the spec so worker-side events/spans join the same trace
            spec["trace_ctx"] = trace_ctx
        return_refs = []
        n_slots = num_return_slots(num_returns)
        # lineage stays an in-process dict (never crosses a wire); pickling
        # it per submission doubled small-task submit cost for no benefit.
        # The spec is never mutated after submission (workers get an RPC
        # copy), so sharing one dict across sibling slots is safe; the
        # byte ledger uses the dominant term (args) plus flat overhead.
        lineage = {"spec": spec, "resources": resources, "key": key,
                   "retries_left": max_retries,
                   "strategy": scheduling_strategy, "env": runtime_env}
        lineage_size = len(arg_blob) + 512
        with self._owned_lock:
            slots = set()
            for i in range(n_slots):
                oid = ObjectID.for_task_return(task_id, i)
                entry = _OwnedObject()
                entry.task_spec = lineage
                self._owned[oid] = entry
                slots.add(oid)
                return_refs.append(ObjectRef(oid, self.address, self))
            self._lineage_meta[task_id.binary()] = {
                "size": lineage_size, "slots": slots, "evicted": False}
            self._lineage_order.append(task_id.binary())
            self._lineage_bytes += lineage_size
            self._evict_lineage_locked()
        if _TELEMETRY:
            self._task_t0[task_id.binary()] = rtm.now()
            self._task_tq[task_id.binary()] = self._task_t0[
                task_id.binary()]
        self._enqueue_task(key, resources, spec, max_retries,
                           strategy=scheduling_strategy, env=runtime_env,
                           language=language)
        self.events.record(task_id.hex(), "SUBMITTED", name=spec["name"])
        return return_refs

    def _evict_lineage_locked(self) -> None:
        """owned_lock held: enforce lineage_max_bytes FIFO — evicted tasks'
        objects become unrecoverable (their specs and pinned arg refs are
        dropped), matching the reference's lineage eviction
        (task_manager lineage footprint accounting)."""
        budget = CONFIG.lineage_max_bytes
        # small rotation cap: this runs under _owned_lock on every task
        # submission, so the scan must stay O(1) per call — rotation makes
        # successive calls examine different entries, so progress past a
        # pending head accumulates across submissions instead
        rotations = min(16, len(self._lineage_order))
        while self._lineage_bytes > budget and self._lineage_order:
            tb = self._lineage_order[0]
            meta = self._lineage_meta.get(tb)
            if meta is None or meta["evicted"]:
                self._lineage_order.popleft()
                continue
            # never evict lineage of a task whose outputs are still pending
            # (its spec is also the retry path for worker death) — but
            # rotate past it rather than stopping, so one long-running head
            # task can't pin every completed task behind it over budget
            if any(self._owned[o].state == "pending"
                   for o in meta["slots"] if o in self._owned):
                if rotations <= 0:
                    break
                rotations -= 1
                self._lineage_order.rotate(-1)
                continue
            self._lineage_order.popleft()
            meta["evicted"] = True
            self._lineage_bytes -= meta["size"]
            for o in meta["slots"]:
                e = self._owned.get(o)
                if e is not None:
                    e.task_spec = None
            self._arg_refs.pop(tb, None)

    def _serialize_args(self, args: tuple, kwargs: dict):
        """Pickle args; ObjectRefs become markers resolved executor-side.
        Large plain values are auto-promoted to the store first (cf.
        reference max_direct_call_object_size).  Returns (blob, live_refs):
        the caller must keep ``live_refs`` alive until the task completes so
        the owner doesn't free argument objects mid-flight."""
        promoted_args = []
        live_refs = []
        for a in args:
            if not isinstance(a, ObjectRef):
                blob_size = len(cloudpickle.dumps(a, protocol=5)) \
                    if _maybe_big(a) else 0
                if blob_size > CONFIG.max_direct_call_args_bytes:
                    a = self.put(a)
            if isinstance(a, ObjectRef):
                live_refs.append(a)
            promoted_args.append(a)
        for v in kwargs.values():
            if isinstance(v, ObjectRef):
                live_refs.append(v)
        return cloudpickle.dumps((tuple(promoted_args), kwargs)), live_refs

    def _serialize_args_tracked(self, args, kwargs, task_id: TaskID) -> bytes:
        blob, live_refs = self._serialize_args(args, kwargs)
        if live_refs:
            self._arg_refs[task_id.binary()] = live_refs
        return blob

    def _store_task_error(self, spec, error: BaseException,
                          error_code: int = ser.ERROR_TASK) -> None:
        task_id = TaskID(spec["task_id"])
        self._arg_refs.pop(spec["task_id"], None)
        self._oom_retries.pop(spec["task_id"], None)
        t0 = self._task_t0.pop(spec["task_id"], None)
        self._task_tq.pop(spec["task_id"], None)
        if t0 is not None:
            _M_TASK_E2E.observe_since(t0)
        self.events.record(task_id.hex(), "FAILED", name=spec.get("name", ""),
                           error_type=type(error).__name__)
        head, views = ser.serialize(error, error_type=error_code)
        data = ser.to_flat_bytes(head, views)
        freed: List[Tuple[ObjectID, set]] = []
        with self._owned_lock:
            for i in range(num_return_slots(spec["num_returns"])):
                oid = ObjectID.for_task_return(task_id, i)
                entry = self._owned.get(oid)
                if entry is not None:
                    entry.data = data
                    entry.state = "ready"
                    entry.error = error_code
                    entry.event.set()
                    if entry.refcount <= 0:
                        self._free_entry_locked(oid, entry, freed)
        self._complete_frees(freed)
        if spec.get("num_returns") == "streaming":
            self._stream_finished(spec["task_id"], failed=True)

    # ----- per-key scheduling queue: leased workers pull pending specs -----
    def _sched_state(self, key: str, resources,
                     strategy: Optional[dict] = None,
                     env: Optional[dict] = None,
                     language: Optional[str] = None) -> Dict[str, Any]:
        with self._sched_lock:
            st = self._sched.get(key)
            if st is None:
                st = {"queue": deque(), "leases": [], "requesting": False,
                      "idle": 0,  # leases parked in keepalive
                      "resources": dict(resources), "strategy": strategy,
                      "env": env, "language": language}
                self._sched[key] = st
            return st

    def _enqueue_task(self, key, resources, spec, retries: int,
                      strategy: Optional[dict] = None,
                      env: Optional[dict] = None,
                      language: Optional[str] = None) -> None:
        st = self._sched_state(key, resources, strategy, env, language)
        with self._sched_lock:
            st["queue"].append((spec, retries))
            self._sched_cv.notify_all()
        self._maybe_request_lease(key, st)

    def _maybe_request_lease(self, key: str, st) -> None:
        with self._sched_lock:
            if (st["requesting"] or not st["queue"]
                    or self._shutdown.is_set()
                    or 0 < len(st["queue"]) <= st.get("idle", 0)):
                # the last clause: idle keepalive leases were just
                # notified and can absorb this little work by themselves
                # (if one instead times out, it decrements "idle" and
                # re-checks the queue under this same lock before
                # exiting, so the task cannot be stranded).  A burst
                # deeper than the parked capacity still requests leases —
                # keepalive must not collapse fan-out for parallel
                # workloads.
                return
            st["requesting"] = True
        threading.Thread(target=self._lease_request_loop, args=(key, st),
                         daemon=True).start()

    def _lease_request_loop(self, key: str, st) -> None:
        """At most one in-flight lease request per scheduling key."""
        try:
            while True:
                with self._sched_lock:
                    if not st["queue"] or self._shutdown.is_set():
                        return
                try:
                    grant = self._lease_with_spillback(key, st)
                    # the worker streams per-task task_done pushes over the
                    # lease connection (early results for mid-frame specs);
                    # the box defers binding until the lease exists
                    lease_box: list = []

                    def _on_push(method, payload, _box=lease_box):
                        if method == "task_done" and _box:
                            self._lease_task_done(_box[0], payload)

                    conn = rpc.connect(tuple(grant["address"]),
                                       push_handler=_on_push)
                except SchedulingError as e:
                    # permanent strategy failure (pg removed, bad bundle
                    # index, hard affinity to a dead node): fail the queued
                    # tasks instead of respawning the loop forever
                    self._fail_queued(st, exc.RayTpuError(str(e)))
                    return
                except (ConnectionError, rpc.RpcError, TimeoutError) as e:
                    # resources busy / raylet hiccup: if existing leases are
                    # draining the queue that's fine; otherwise keep trying
                    with self._sched_lock:
                        have_workers = bool(st["leases"])
                        pending = bool(st["queue"])
                    if not pending:
                        return
                    if not have_workers and self._shutdown.is_set():
                        return
                    if not have_workers and isinstance(e, ConnectionError):
                        self._fail_queued(st, exc.RayTpuError(
                            f"raylet unreachable: {e}"))
                        return
                    time.sleep(0.2)
                    continue
                lease = _Lease(key, grant, conn)
                lease_box.append(lease)
                with self._sched_lock:
                    st["leases"].append(lease)
                threading.Thread(target=self._lease_worker_loop,
                                 args=(key, st, lease), daemon=True).start()
        finally:
            with self._sched_lock:
                st["requesting"] = False
            # new tasks may have arrived while we were exiting
            with self._sched_lock:
                need_more = bool(st["queue"]) and not st["leases"]
            if need_more:
                self._maybe_request_lease(key, st)

    def _arg_hints(self, st) -> dict:
        """Argument locations/sizes of the queued tasks this lease will
        serve (head of the key's queue), for locality-aware placement and
        raylet-side prefetch (docs/object_transfer.md).  Only owned,
        ready, shm-resident arguments at least locality_min_arg_bytes
        participate — below that, transfer cost is noise next to lease
        latency, and pending/inline/borrowed arguments have no location
        worth weighing."""
        if not (CONFIG.locality_aware_scheduling
                or CONFIG.object_prefetch_enabled):
            return {}
        with self._sched_lock:
            specs = [spec for spec, _r in itertools.islice(
                st["queue"], 0, 4)]
        locs: Dict[str, float] = {}
        prefetch: List[dict] = []
        seen: set = set()
        for spec in specs:
            for ref in self._arg_refs.get(spec["task_id"], ()):
                if ref.id.binary() in seen:
                    continue
                seen.add(ref.id.binary())
                with self._owned_lock:
                    entry = self._owned.get(ref.id)
                    if (entry is None or entry.state != "ready"
                            or entry.data is not None
                            or entry.size < CONFIG.locality_min_arg_bytes
                            or not entry.locations):
                        continue
                    size = entry.size
                    locations = sorted(entry.locations)
                for nh in locations:
                    locs[nh] = locs.get(nh, 0.0) + size
                prefetch.append({"object_id": ref.id.binary(),
                                 "size": size, "locations": locations,
                                 "owner": list(self.address)})
        if not prefetch:
            return {}
        return {"arg_locs": locs, "prefetch": prefetch}

    def _lease_with_spillback(self, key: str, st) -> dict:
        """Lease locally; follow at most two retry_at redirects (the
        reference's spillback, direct_task_transport.cc retry_at_raylet).
        The grant remembers which raylet granted it so return_worker goes to
        the right node.  A scheduling strategy pins/redirects the lease
        before the default local-first path runs."""
        strategy = st.get("strategy")
        if strategy:
            grant = self._lease_with_strategy(key, st, strategy)
            if grant is not None:
                return grant
            # soft affinity fall-through: default path below
        payload = {"key": key, "resources": st["resources"],
                   "job_id": self.job_id.hex(), "env": st.get("env"),
                   "language": st.get("language")}
        payload.update(self._arg_hints(st))
        target_addr = None  # None -> local raylet
        for hop in range(3):
            if target_addr is None:
                grant = self._raylet.call(
                    "lease_worker", dict(payload, spillback=hop),
                    timeout=CONFIG.worker_lease_timeout_s + 5)
            else:
                conn = rpc.connect(target_addr)
                try:
                    grant = conn.call(
                        "lease_worker", dict(payload, spillback=hop),
                        timeout=CONFIG.worker_lease_timeout_s + 5)
                finally:
                    conn.close()
            if "retry_at" in grant:
                target_addr = tuple(grant["retry_at"])
                continue
            grant["granting_addr"] = target_addr  # None == local
            return grant
        raise rpc.RpcError("spillback loop exceeded")

    def _lease_at(self, addr: Optional[Tuple[str, int]],
                  payload: dict) -> dict:
        """One lease RPC to a specific raylet (no redirects honored)."""
        if addr is None:
            grant = self._raylet.call(
                "lease_worker", payload,
                timeout=CONFIG.worker_lease_timeout_s + 5)
        else:
            conn = rpc.connect(addr)
            try:
                grant = conn.call("lease_worker", payload,
                                  timeout=CONFIG.worker_lease_timeout_s + 5)
            finally:
                conn.close()
        grant["granting_addr"] = None if addr is None else list(addr)
        return grant

    def _lease_with_strategy(self, key: str, st,
                             strategy: dict) -> Optional[dict]:
        """Resolve a scheduling strategy to a pinned lease.

        placement_group -> lease from the bundle's reserved pool on its
        node; node_affinity -> lease from that raylet (soft falls back by
        returning None); spread -> least-loaded feasible node."""
        base = {"key": key, "resources": st["resources"],
                "job_id": self.job_id.hex(), "spillback": 2,
                "env": st.get("env"), "language": st.get("language")}
        # spillback=2 means the strategy's node choice is final — no
        # locality redirect — but the chosen raylet still prefetches
        hints = self._arg_hints(st)
        if hints.get("prefetch"):
            base["prefetch"] = hints["prefetch"]
        kind = strategy.get("type")
        if kind == "placement_group":
            pg_id = strategy["pg_id"]
            idx = int(strategy.get("bundle_index", -1))
            deadline = time.monotonic() + CONFIG.worker_lease_timeout_s
            while True:
                info = self.gcs.call("get_placement_group",
                                     {"pg_id": pg_id}, timeout=10)
                if info is None:
                    raise SchedulingError(
                        f"placement group {pg_id[:8]} removed")
                if info["state"] == "CREATED":
                    break
                if time.monotonic() > deadline:
                    raise rpc.RpcError(
                        f"placement group {pg_id[:8]} not placed in time")
                time.sleep(0.05)
            placement = info["placement"]
            if idx >= len(placement) or idx < -1:
                raise SchedulingError(
                    f"bundle index {idx} out of range for a "
                    f"{len(placement)}-bundle placement group")
            indices = [idx] if idx >= 0 else list(range(len(placement)))
            last_err: Optional[Exception] = None
            for i in indices:
                addr = self._node_address(placement[i])
                if addr is None:
                    continue
                try:
                    return self._lease_at(
                        addr, dict(base, bundle=[pg_id, i]))
                except (rpc.RemoteError, ConnectionError,
                        TimeoutError) as e:
                    last_err = e
            raise rpc.RpcError(
                f"no bundle of pg {pg_id[:8]} could grant a lease: "
                f"{last_err}")
        if kind == "node_affinity":
            addr = self._node_address(strategy["node_id"])
            if addr is None:
                if strategy.get("soft"):
                    return None
                raise SchedulingError(
                    f"node {strategy['node_id'][:8]} not found/alive")
            try:
                return self._lease_at(addr, dict(base))
            except (rpc.RemoteError, ConnectionError, TimeoutError) as e:
                if strategy.get("soft"):
                    return None
                raise rpc.RpcError(
                    f"node affinity lease failed: {e}") from e
        if kind == "spread":
            # pick the alive feasible node with the most available CPU,
            # breaking ties away from the most recently used one
            try:
                nodes = self.gcs.call("list_nodes", timeout=5)
            except (ConnectionError, rpc.RemoteError, TimeoutError):
                return None
            need = dict(st["resources"])
            need.setdefault("CPU", 1.0)
            feasible = [
                n for n in nodes if n["alive"] and
                all(n["available"].get(r, 0) >= v for r, v in need.items())]
            if not feasible:
                return None
            last = st.get("last_spread_node")
            feasible.sort(key=lambda n: (n["node_id"] == last,
                                         -n["available"].get("CPU", 0)))
            for n in feasible:
                addr = tuple(n["address"])
                try:
                    grant = self._lease_at(addr, dict(base))
                    st["last_spread_node"] = n["node_id"]
                    return grant
                except (rpc.RemoteError, ConnectionError, TimeoutError):
                    continue
            return None
        raise SchedulingError(f"unknown scheduling strategy {kind!r}")

    def _fail_queued(self, st, error: BaseException) -> None:
        with self._sched_lock:
            items = list(st["queue"])
            st["queue"].clear()
        for spec, _ in items:
            self._store_task_error(spec, error)

    # task specs in flight per lease connection: overlaps push RTT + spec
    # serialization with worker execution (the worker drains its own FIFO
    # serially, so this changes delivery, not execution concurrency) —
    # reference push-queue pipelining, direct_task_transport.cc:174/213
    _PUSH_WINDOW = 8

    def _drain_batch_locked(self, st, budget: int, batch_max: int) -> list:
        """_sched_lock held: pop up to min(budget, batch_max) specs for
        one push_tasks frame.  A spec with ObjectRef args always travels
        alone: the worker resolves its dependencies before enqueueing it,
        and a batch is only acked once every member has been enqueued —
        so a dependent batched behind its in-frame producer would wait on
        an ack that waits on it (head-of-line deadlock)."""
        batch = []
        limit = min(budget, batch_max)
        while (st["queue"] and not self._shutdown.is_set()
               and len(batch) < limit):
            spec, retries = st["queue"][0]
            if spec.get("_refs") and batch:
                break
            st["queue"].popleft()
            batch.append((spec, retries))
            if spec.get("_refs"):
                break
        return batch

    def _lease_worker_loop(self, key: str, st, lease: _Lease) -> None:
        """Pull tasks from the key's queue and pipeline them to this
        worker: queued specs coalesce into batched ``push_tasks`` frames
        (task_submit_batch_max per frame) that the worker executes in
        order and acks in batch; up to _PUSH_WINDOW unacked specs ride
        the connection across frames.  Mid-frame completions stream back
        early as task_done pushes (resolved via lease.pending), so a
        fast task batched behind a slow one is observable as soon as it
        finishes — batch acks change framing, not completion latency.
        When the queue drains the lease is parked for
        ``lease_keepalive_ms`` before being returned, so back-to-back
        synchronous submissions reuse the warm worker."""
        inflight: deque = deque()   # (batch, future); batch: [(spec, retries)]
        batch_max = max(1, CONFIG.task_submit_batch_max)
        keepalive = max(0.0, CONFIG.lease_keepalive_ms / 1000.0)
        while True:
            while True:
                with lease.plock:
                    budget = self._PUSH_WINDOW - len(lease.pending)
                if budget <= 0:
                    break
                with self._sched_lock:
                    batch = self._drain_batch_locked(st, budget, batch_max)
                if not batch:
                    break
                if _TELEMETRY:
                    _M_PUSH_BATCH.observe(len(batch))
                    t_now = rtm.now()
                    for _spec, _r in batch:
                        t_sub = self._task_tq.pop(_spec["task_id"], None)
                        if t_sub is not None:
                            _M_QUEUE_WAIT.observe((t_now - t_sub) * 1000.0)
                with lease.plock:
                    for spec, retries in batch:
                        lease.pending[spec["task_id"]] = (spec, retries)
                # send failures surface through the future (call_async
                # catches them internally), landing in the dead-worker
                # path below like any mid-task connection loss
                fut = lease.conn.call_async(
                    "push_tasks", {"specs": [s for s, _ in batch]})
                inflight.append((batch, fut))
            if not inflight:
                with self._sched_lock:
                    # closing window: a task may have been enqueued after
                    # our empty-queue read above
                    if st["queue"] and not self._shutdown.is_set():
                        continue
                    if (keepalive <= 0 or self._shutdown.is_set()
                            or lease.conn.closed):
                        st["leases"].remove(lease)
                        break
                    st["idle"] += 1
                    deadline = time.monotonic() + keepalive
                    while not st["queue"] and not self._shutdown.is_set():
                        t = deadline - time.monotonic()
                        if t <= 0:
                            break
                        self._sched_cv.wait(t)
                    st["idle"] -= 1
                    if (st["queue"] and not self._shutdown.is_set()
                            and not lease.conn.closed):
                        continue
                    st["leases"].remove(lease)
                break
            batch, fut = inflight.popleft()
            try:
                reply = fut.result(None)
            except rpc.RemoteError as e:
                # dispatch-level failure of the whole frame (user task
                # errors come back per-spec, not as RemoteError): fail its
                # unresolved specs; the connection is healthy and keeps
                # serving
                for spec, _retries in batch:
                    if self._lease_unresolve(lease, spec) is not None:
                        self._store_task_error(spec, exc.RayTpuError(str(e)))
                continue
            except (ConnectionError, OSError) as e:
                # Worker died mid-flight. It drains its FIFO serially, so
                # of the unresolved specs (send order — task_done pushes
                # already resolved everything that finished) only the
                # FIRST is charged retry/OOM budget; the rest requeue
                # free.  Send order approximates execution order: a ref-
                # carrying spec resolving args slowly can be overtaken in
                # the executor FIFO by a younger ref-free frame — the
                # same approximation the per-push-thread path always made
                # (pipelined pushes rode independent dispatch threads).
                # Drain the connection's push backlog first: a task_done
                # delivered just before the death must resolve its spec,
                # not be charged as a worker crash.
                try:
                    lease.conn.drain_pushes()
                except Exception:
                    pass
                with lease.plock:
                    remaining = list(lease.pending.values())
                    lease.pending.clear()
                oom = (self._lease_was_oom_killed(lease) if remaining
                       else False)
                if remaining:
                    with self._sched_lock:
                        for s, r in reversed(remaining[1:]):
                            st["queue"].appendleft((s, r))
                        # wake parked keepalive leases: _maybe_request_
                        # lease relies on them having been notified when
                        # it declines to open a lease for a short queue
                        self._sched_cv.notify_all()
                    spec, retries = remaining[0]
                    self._retry_or_fail_dead_worker(key, st, spec,
                                                    retries, oom, e,
                                                    lease.worker_id)
                with self._sched_lock:
                    st["leases"].remove(lease)
                try:
                    lease.conn.close()
                except Exception:
                    pass
                self._maybe_request_lease(key, st)
                return
            else:
                self._consume_batch_reply(lease, batch, reply)
        self._return_lease(lease)
        self._maybe_request_lease(key, st)

    def _lease_unresolve(self, lease: _Lease, spec) -> Optional[tuple]:
        """Claim a spec for resolution: pops its pending entry exactly
        once (None when a task_done push already resolved it)."""
        with lease.plock:
            return lease.pending.pop(spec["task_id"], None)

    def _lease_task_done(self, lease: _Lease, payload: dict) -> None:
        """Streamed per-task completion (worker push, ahead of the frame
        ack).  Runs on the lease connection's serial push thread."""
        with lease.plock:
            item = lease.pending.pop(payload["task_id"], None)
        if item is None:
            return
        self._apply_task_result(item[0], payload["res"])

    def _apply_task_result(self, spec, res: dict) -> None:
        err = res.get("err")
        if err is not None:
            self._store_task_error(spec, exc.RayTpuError(err))
        else:
            self._on_task_reply(spec, res["ok"])

    def _consume_batch_reply(self, lease: _Lease, batch: list,
                             reply: dict) -> None:
        """Resolve one acked push_tasks frame: per-spec results in frame
        order, skipping specs a task_done push resolved early."""
        results = reply["results"]
        for (spec, _retries), res in zip(batch, results):
            if self._lease_unresolve(lease, spec) is not None:
                self._apply_task_result(spec, res)
        # a short reply (worker bug) must not strand the tail's owners
        for spec, _retries in batch[len(results):]:
            if self._lease_unresolve(lease, spec) is not None:
                self._store_task_error(spec, exc.RayTpuError(
                    f"worker returned no result for task "
                    f"{spec.get('name', '')}"))

    def _retry_or_fail_dead_worker(self, key, st, spec, retries: int,
                                   oom: bool, e: BaseException,
                                   worker_id: Optional[str] = None
                                   ) -> None:
        """Retry accounting for one task whose worker died mid-flight.
        An OOM kill draws from its own retry budget (task_oom_retries)
        and leaves max_retries untouched — the task didn't fail, the
        node ran dry.  ``worker_id`` (the dead worker) becomes the
        propagated error's ``dossier_id``, so ``.debug_dossier()`` at
        the driver can pull the crash forensics the raylet harvested."""
        if oom:
            left = self._oom_retries.get(spec["task_id"],
                                         CONFIG.task_oom_retries)
            if left > 0:
                self._oom_retries[spec["task_id"]] = left - 1
                logger.info("task %s OOM-killed; retrying (%d OOM "
                            "retries left)", spec["name"], left - 1)
                with self._sched_lock:
                    st["queue"].appendleft((spec, retries))
                    self._sched_cv.notify_all()  # wake parked leases
            else:
                oom_err = exc.OutOfMemoryError(
                    f"task {spec['name']} was OOM-killed "
                    f"{CONFIG.task_oom_retries + 1} times "
                    f"(host memory exhausted)")
                oom_err.dossier_id = worker_id
                self._store_task_error(spec, oom_err,
                                       error_code=ser.ERROR_OOM)
        elif retries > 0:
            logger.info("task %s worker died; retrying (%d left)",
                        spec["name"], retries)

            def _requeue():
                with self._sched_lock:
                    st["queue"].appendleft((spec, retries - 1))
                    self._sched_cv.notify_all()  # wake parked leases
                # a DELAYED requeue lands after the dead lease's
                # teardown already ran its _maybe_request_lease against
                # an empty queue — without this, no lease-request loop
                # exists to consume the spec and it strands forever
                self._maybe_request_lease(key, st)

            delay_ms = CONFIG.task_retry_delay_ms
            if delay_ms > 0:
                # optional backoff before resubmission (a crash-looping
                # task must not spin the lease machinery at full rate);
                # 0 (default) requeues immediately.  Daemon timer: a
                # pending requeue must not block interpreter exit nor
                # fire into a torn-down scheduler after shutdown.
                t = threading.Timer(delay_ms / 1000.0, _requeue)
                t.daemon = True
                t.start()
            else:
                _requeue()
        else:
            self._store_task_error(spec, exc.WorkerCrashedError(
                f"task {spec['name']} worker died: {e}",
                dossier_id=worker_id))

    def _lease_was_oom_killed(self, lease: _Lease) -> bool:
        payload = {"worker_id": lease.worker_id}
        try:
            if lease.granting_addr is None:
                reply = self._raylet.call("was_oom_killed", payload,
                                          timeout=5)
            else:
                conn = rpc.connect(tuple(lease.granting_addr), timeout=5.0)
                try:
                    reply = conn.call("was_oom_killed", payload, timeout=5)
                finally:
                    conn.close()
            return bool(reply.get("oom"))
        except (ConnectionError, rpc.RpcError, TimeoutError, OSError):
            return False

    def _return_lease(self, lease: _Lease) -> None:
        payload = {"lease_id": lease.lease_id,
                   "worker_id": lease.worker_id,
                   "key": lease.key}
        try:
            if lease.granting_addr is None:
                self._raylet.call("return_worker", payload, timeout=10)
            else:
                conn = rpc.connect(tuple(lease.granting_addr))
                try:
                    conn.call("return_worker", payload, timeout=10)
                finally:
                    conn.close()
        except (ConnectionError, rpc.RemoteError, TimeoutError, OSError):
            pass
        try:
            lease.conn.close()
        except Exception:
            pass

    def _on_task_reply(self, spec, reply) -> None:
        task_id = TaskID(spec["task_id"])
        t0 = self._task_t0.pop(spec["task_id"], None)
        self._task_tq.pop(spec["task_id"], None)
        if t0 is not None:
            _M_TASK_E2E.observe_since(t0)
        results = reply["results"]
        freed: List[Tuple[ObjectID, set]] = []
        with self._owned_lock:
            # arg refs stay pinned while the task's lineage is retained:
            # a reconstruction resubmits the same arg blob, so the owner
            # must not free argument objects earlier (reference: lineage
            # pinning keeps dependency refs alive, reference_count.h)
            if spec["task_id"] not in self._lineage_meta:
                self._arg_refs.pop(spec["task_id"], None)
            self._oom_retries.pop(spec["task_id"], None)
            for i, result in enumerate(results):
                oid = ObjectID.for_task_return(task_id, i)
                entry = self._owned.get(oid)
                if entry is None:
                    continue
                if "dynamic" in result:
                    # num_returns="dynamic": adopt ownership of each yielded
                    # object (slots 1..N) and resolve slot 0 to the
                    # generator of their refs
                    refs = self._adopt_dynamic_returns_locked(
                        task_id, entry, result["dynamic"])
                    entry.dynamic_children = [r.id for r in refs]
                    head, views = ser.serialize(ObjectRefGenerator(refs))
                    entry.data = ser.to_flat_bytes(head, views)
                    entry.error = 0
                    self._memory_cache.pop(oid, None)
                elif "streaming" in result:
                    # completion sentinel of a num_returns="streaming"
                    # task: items 1..N were adopted eagerly as their
                    # reports arrived; slot 0 resolves to the full
                    # ObjectRefGenerator (the ``completed()`` value) and
                    # anchors the items' cleanup as dynamic children
                    n = result["streaming"]["num_items"]
                    children = [ObjectID.for_task_return(task_id, j + 1)
                                for j in range(n)]
                    entry.dynamic_children = list(children)
                    refs = [ObjectRef(c, self.address, None)
                            for c in children]
                    head, views = ser.serialize(ObjectRefGenerator(refs))
                    entry.data = ser.to_flat_bytes(head, views)
                    entry.error = 0
                    self._memory_cache.pop(oid, None)
                else:
                    entry.error = result.get("error", 0)
                    if result.get("data") is not None:
                        entry.data = result["data"]
                        self._memory_cache.pop(oid, None)
                    else:
                        entry.locations.add(result["location"])
                        entry.size = int(result.get("size", 0))
                entry.state = "ready"
                entry.event.set()
                # the last user ref may have been dropped while this slot
                # was pending (e.g. mid-reconstruction): free now, or the
                # entry and its unevictable primary copy leak forever
                if entry.refcount <= 0:
                    self._free_with_children_locked(oid, entry, freed)
            # a completion may unblock FIFO lineage eviction that a pending
            # head task was holding up at submit time
            self._evict_lineage_locked()
        self._complete_frees(freed)
        failed = any(r.get("error") for r in results)
        if spec.get("num_returns") == "streaming":
            total = next((r["streaming"]["num_items"] for r in results
                          if "streaming" in r), None)
            self._stream_finished(spec["task_id"], failed=failed,
                                  total=total)
        self.events.record(task_id.hex(), "FAILED" if failed else "FINISHED",
                           name=spec["name"])

    def _adopt_dynamic_returns_locked(self, task_id: TaskID, slot0_entry,
                                      sub_results) -> List[ObjectRef]:
        refs = []
        lmeta = self._lineage_meta.get(task_id.binary())
        for j, sub in enumerate(sub_results):
            sub_oid = ObjectID.for_task_return(task_id, j + 1)
            sub_entry = self._owned.get(sub_oid)
            if sub_entry is None:
                sub_entry = _OwnedObject()
                # re-running the task regenerates every dynamic return
                sub_entry.task_spec = slot0_entry.task_spec
                self._owned[sub_oid] = sub_entry
            if lmeta is not None:
                lmeta["slots"].add(sub_oid)
            sub_entry.error = sub.get("error", 0)
            if sub.get("data") is not None:
                sub_entry.data = sub["data"]
            else:
                sub_entry.locations.add(sub["location"])
                sub_entry.size = int(sub.get("size", 0))
            sub_entry.state = "ready"
            sub_entry.event.set()
            # unbound refs (worker=None): these only exist to be serialized
            # into slot 0 — binding them would register/unregister a local
            # refcount whose drop-to-zero frees the entry before the caller
            # ever deserializes the generator
            refs.append(ObjectRef(sub_oid, self.address, None))
        return refs

    # ------------------------------------------- streaming generators
    # Owner side of num_returns="streaming" (docs/streaming_generators.md):
    # the executing worker reports every yield as a report_generator_item
    # RPC on this worker's server; each item is adopted into the owned
    # table the moment it arrives, the consumer's next() advances a
    # strict index cursor, and backpressure is the withheld report reply
    # (a parked Deferred resolves when ITS item is consumed, so the
    # producer's unacked window equals the unconsumed in-flight count).

    def _register_stream(self, task_binary: bytes, bp: int) -> _StreamState:
        state = _StreamState(task_binary, bp)
        with self._streams_lock:
            self._streams[task_binary] = state
        return state

    def make_streaming_generator(self, ref: "ObjectRef"
                                 ) -> StreamingObjectRefGenerator:
        """Wrap a streaming task's slot-0 ref (its stream was registered
        at submit time) into the consumer-facing generator."""
        with self._streams_lock:
            state = self._streams[ref.id.task_id().binary()]
        return StreamingObjectRefGenerator(self, state, ref)

    def _rpc_report_generator_item(self, p: dict):
        """One yielded item from the executing worker: adopt ownership
        eagerly (data inline or a shm location, exactly like a dynamic
        child) and answer with consumption credit — immediately when the
        backpressure window allows, else a Deferred parked until the
        consumer reaches this item.  Replayed items (a retried worker
        re-yielding an already-consumed prefix) ack immediately."""
        tb = p["task_id"]
        idx = p["index"]
        with self._streams_lock:
            state = self._streams.get(tb)
        if state is None:
            return {"cancel": True}   # consumer dropped the generator
        with state.cv:
            if state.closed:
                # checked BEFORE adoption so a post-close report doesn't
                # recreate entries _close_stream just freed (a racing
                # close still gets them swept at task completion via
                # slot 0's dynamic_children)
                return {"cancel": True}
        task_id = TaskID(tb)
        oid = ObjectID.for_task_return(task_id, idx + 1)
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is None:
                entry = _OwnedObject()
                slot0 = self._owned.get(
                    ObjectID.for_task_return(task_id, 0))
                if slot0 is not None:
                    # re-running the task regenerates every item
                    entry.task_spec = slot0.task_spec
                self._owned[oid] = entry
                lmeta = self._lineage_meta.get(tb)
                if lmeta is not None:
                    lmeta["slots"].add(oid)
            if entry.state != "ready":
                entry.error = p.get("error", 0)
                if p.get("data") is not None:
                    entry.data = p["data"]
                else:
                    entry.locations.add(p["location"])
                    entry.size = int(p.get("size", 0))
                entry.state = "ready"
                entry.event.set()
            elif p.get("location"):
                # replay from a retried worker: the fresh copy's node may
                # differ from the (possibly dead) original — record it so
                # the consumer's fetch finds the live copy instead of
                # burning another reconstruction
                entry.locations.add(p["location"])
        _M_STREAM_ITEMS.inc()
        with state.cv:
            if state.closed:
                return {"cancel": True}
            if idx >= state.consumed:
                state.arrived.add(idx)
            state.max_unconsumed = max(state.max_unconsumed,
                                       len(state.arrived))
            self._stream_wake(state)
            if state.bp > 0 and idx >= state.consumed:
                d = rpc.Deferred()
                state.parked.append((idx, d, rtm.now()))
                _M_STREAM_STALLS.inc()
                return d
            return {"consumed": state.consumed}

    @staticmethod
    def _stream_wake(state: _StreamState) -> None:
        """Wake both consumer styles; call with ``state.cv`` held."""
        state.cv.notify_all()
        if state.waiters:
            waiters, state.waiters = state.waiters, []
            for cb in waiters:
                try:
                    cb()          # only schedules a loop callback
                except Exception:
                    pass

    def _stream_add_waiter(self, state: _StreamState, cb) -> None:
        """Register a one-shot state-change callback for an async
        consumer; fires immediately when progress is already available
        (the caller loops and re-tries the claim)."""
        with state.cv:
            ready = (state.consumed in state.arrived or state.failed
                     or state.closed
                     or (state.total is not None
                         and state.consumed >= state.total))
            if not ready:
                state.waiters.append(cb)
                return
        try:
            cb()
        except Exception:
            pass

    def _stream_try_next(self, state: _StreamState, ref: "ObjectRef"):
        """Non-blocking next(): the next item's ObjectRef,
        _StreamExhausted at end of stream, None when nothing is
        available yet, or raises the stream's terminal error — the
        claim half of _stream_next without the cv wait (async
        consumers interleave it with _stream_add_waiter)."""
        resolve: List = []
        failed = False
        with state.cv:
            idx = state.consumed
            if idx in state.arrived:
                state.arrived.discard(idx)
                state.consumed = idx + 1
                resolve = [(d, t) for i, d, t in state.parked
                           if i < state.consumed]
                state.parked = [p for p in state.parked
                                if p[0] >= state.consumed]
            elif state.total is not None and idx >= state.total:
                return _StreamExhausted
            elif state.failed:
                failed = True
            elif state.closed:
                raise exc.RayTpuError("streaming generator was closed")
            else:
                return None
        for d, t_parked in resolve:
            _M_STREAM_PARKED.observe_since(t_parked)
            d.resolve({"consumed": state.consumed})
        if failed:
            # slot 0 holds the task's error payload: get() raises it
            # (the terminal reply that set ``failed`` also readied it)
            self.get([ref])
            raise exc.RayTpuError(
                "streaming generator task failed")  # unreachable backstop
        oid = ObjectID.for_task_return(TaskID(state.task_binary),
                                       idx + 1)    # item j at slot j+1
        return ObjectRef(oid, self.address, self)

    def _stream_next(self, state: _StreamState, ref: "ObjectRef",
                     timeout: Optional[float] = None):
        """Blocking next(): the ObjectRef of the next item in index
        order, _StreamExhausted at end of stream, or the task's error
        (raised) once the stream failed and every delivered item has
        been consumed.  Consuming resolves parked producer reports."""
        deadline = None if timeout is None else time.monotonic() + timeout
        resolve: List = []
        failed = False
        claimed = -1
        with state.cv:
            while True:
                idx = state.consumed
                if idx in state.arrived:
                    state.arrived.discard(idx)
                    # claim THIS index under the lock: a concurrent
                    # consumer may advance state.consumed again before
                    # we build the ref below
                    claimed = idx
                    state.consumed = idx + 1
                    resolve = [(d, t) for i, d, t in state.parked
                               if i < state.consumed]
                    state.parked = [p for p in state.parked
                                    if p[0] >= state.consumed]
                    break
                if state.total is not None and idx >= state.total:
                    return _StreamExhausted
                if state.failed:
                    failed = True
                    break
                if state.closed:
                    raise exc.RayTpuError(
                        "streaming generator was closed")
                t = self._remaining(deadline)
                if not state.cv.wait(t if t is not None else 5.0) \
                        and deadline is not None \
                        and time.monotonic() >= deadline:
                    raise exc.GetTimeoutError(
                        "timed out waiting for the next generator item")
        for d, t_parked in resolve:
            _M_STREAM_PARKED.observe_since(t_parked)
            d.resolve({"consumed": state.consumed})
        if failed:
            # slot 0 holds the task's error payload: get() raises it
            self.get([ref])
            raise exc.RayTpuError(
                "streaming generator task failed")  # unreachable backstop
        oid = ObjectID.for_task_return(TaskID(state.task_binary),
                                       claimed + 1)  # item j at slot j+1
        return ObjectRef(oid, self.address, self)

    def _stream_finished(self, task_binary: bytes, *, failed: bool,
                         total: Optional[int] = None) -> None:
        """Terminal task outcome reached the owner: wake the consumer.
        A retryable worker death never lands here — the stream stays
        open and the re-executed task replays its items."""
        with self._streams_lock:
            state = self._streams.get(task_binary)
        if state is None:
            return
        resolve: List = []
        with state.cv:
            if failed:
                state.failed = True
            else:
                state.total = total
                # late credit: items past the consumer's cursor can no
                # longer arrive, so nothing is parked for a reason
                resolve = [d for _i, d, _t in state.parked]
                state.parked = []
            self._stream_wake(state)
        for d in resolve:
            d.resolve({"consumed": state.consumed})

    def _close_stream(self, state: _StreamState) -> None:
        """Consumer dropped the generator: cancel parked reports (the
        worker stops iterating), drop the table entry, and free
        arrived-but-unconsumed item objects."""
        with state.cv:
            if state.closed:
                return
            state.closed = True
            parked, state.parked = state.parked, []
            orphans = list(state.arrived)
            state.arrived.clear()
            self._stream_wake(state)
        for _i, d, _t in parked:
            d.resolve({"cancel": True})
        with self._streams_lock:
            self._streams.pop(state.task_binary, None)
        if self._shutdown.is_set():
            return
        task_id = TaskID(state.task_binary)
        freed: List[Tuple[ObjectID, set]] = []
        with self._owned_lock:
            for idx in orphans:
                oid = ObjectID.for_task_return(task_id, idx + 1)
                entry = self._owned.get(oid)
                if entry is not None and entry.refcount <= 0 \
                        and entry.state == "ready":
                    self._free_entry_locked(oid, entry, freed)
        self._complete_frees(freed)

    def prepare_runtime_env(self, raw: Optional[dict]) -> Optional[dict]:
        """Package+upload a raw runtime_env; memoised on the spec plus a
        cheap mtime/size fingerprint of any local paths, so edits to a
        working_dir between submits re-upload instead of serving stale
        code, while unchanged trees skip the zip+upload entirely."""
        if not raw:
            return None
        import json as _json
        from ray_tpu_torch.runtime_env.packaging import tree_fingerprint
        paths = list(raw.get("py_modules") or [])
        if raw.get("working_dir"):
            paths.append(raw["working_dir"])
        cache_key = _json.dumps(
            [dict(raw), [tree_fingerprint(p) for p in paths]],
            sort_keys=True, default=str)
        if cache_key not in self._runtime_env_cache:
            from ray_tpu_torch.runtime_env import prepare_runtime_env as _prep
            self._runtime_env_cache[cache_key] = _prep(raw, self.gcs)
        return self._runtime_env_cache[cache_key]

    # --------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, *, name: Optional[str] = None,
                     namespace: str = "", detached: bool = False,
                     max_restarts: int = 0,
                     max_concurrency: Optional[int] = None,
                     concurrency_groups: Optional[Dict[str, int]] = None,
                     resources: Optional[Dict[str, float]] = None,
                     scheduling_strategy: Optional[dict] = None,
                     runtime_env: Optional[dict] = None,
                     cls_key: Optional[str] = None,
                     language: Optional[str] = None) -> "ActorID":
        actor_id = ActorID.from_random()
        bundle = None
        strategy = None
        if scheduling_strategy:
            if scheduling_strategy.get("type") == "placement_group":
                bundle = [scheduling_strategy["pg_id"],
                          int(scheduling_strategy.get("bundle_index", -1))]
            else:
                # node_affinity / spread: enforced by the GCS scheduler
                strategy = dict(scheduling_strategy)
        # cross-language actors carry a pre-resolved class key the target
        # language's worker resolves in its own registry
        if cls_key is None:
            cls_key = self.register_function(cls)
        creation_spec = cloudpickle.dumps({
            "actor_id": actor_id.binary(),
            "cls_key": cls_key,
            "args": self._serialize_args_tracked(args, kwargs,
                                                 TaskID.from_random()),
            "owner_addr": list(self.address),
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
        })
        self.gcs.call("register_actor", {
            "actor_id": actor_id.hex(),
            "caller_node_id": self.node_id,
            "job_id": self.job_id.hex(),
            "name": name,
            "namespace": namespace,
            "detached": detached,
            "spec": creation_spec,
            "resources": dict(resources or {}),
            "max_restarts": max_restarts,
            "bundle": bundle,
            "strategy": strategy,
            "runtime_env": runtime_env or self.job_runtime_env,
            "language": language,
            # an actor made by an actor dies with it (Ray's owner fate
            # sharing); a detached one outlives its maker
            "owner_actor_id": None if detached
            else getattr(self, "current_actor_id", None),
        }, timeout=CONFIG.actor_creation_timeout_s)
        return actor_id

    def _resolve_actor(self, actor_id_hex: str,
                       timeout: Optional[float] = None) -> Tuple[str, int]:
        deadline = time.monotonic() + (timeout or
                                       CONFIG.actor_creation_timeout_s)
        # adaptive poll: tight at first (creation is ~100 ms on an idle
        # node; a fixed 20 ms tick added a quantization stall on every
        # first call), backing off so 1k pending resolvers don't melt
        # the GCS during mass creation
        delay = 0.003
        while True:
            info = self.gcs.call("get_actor", {"actor_id": actor_id_hex})
            if info is None:
                raise exc.ActorDiedError(f"actor {actor_id_hex[:8]} not found")
            if info["state"] == ALIVE and info["address"]:
                return tuple(info["address"])
            if info["state"] == DEAD:
                raise exc.ActorDiedError(
                    info.get("death_cause") or "actor is dead",
                    dossier_id=info.get("death_worker_id"))
            if time.monotonic() > deadline:
                raise exc.ActorUnavailableError(
                    f"actor {actor_id_hex[:8]} not ready "
                    f"(state={info['state']})")
            time.sleep(delay)
            delay = min(delay * 1.6, 0.05)

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, *,
                          num_returns: int = 1,
                          max_task_retries: int = 0,
                          concurrency_group: Optional[str] = None
                          ) -> List[ObjectRef]:
        num_returns = normalize_num_returns(num_returns)
        _M_ACTOR_SUBMITS.inc()
        task_id = TaskID.from_random()
        aid = actor_id.hex()
        spec = {
            "task_id": task_id.binary(),
            "actor_id": aid,
            "method": method_name,
            "args": self._serialize_args_tracked(args, kwargs, task_id),
            "num_returns": num_returns,
            "owner_addr": list(self.address),
            "name": method_name,
        }
        if concurrency_group:
            spec["group"] = concurrency_group
        if num_returns == "streaming":
            spec["backpressure"] = CONFIG.generator_backpressure_num_objects
            self._register_stream(task_id.binary(), spec["backpressure"])
        trace_ctx = _submit_trace_ctx(method_name)
        if trace_ctx:
            spec["trace_ctx"] = trace_ctx
        refs = []
        with self._owned_lock:
            for i in range(num_return_slots(num_returns)):
                oid = ObjectID.for_task_return(task_id, i)
                self._owned[oid] = _OwnedObject()
                refs.append(ObjectRef(oid, self.address, self))
        with self._actor_lock:
            pipe = self._actor_pipes.get(aid)
            if pipe is None:
                pipe = _ActorPipe(self, aid)
                self._actor_pipes[aid] = pipe
        if _TELEMETRY:
            self._task_t0[task_id.binary()] = rtm.now()
        pipe.enqueue(spec, max_task_retries)
        self.events.record(task_id.hex(), "SUBMITTED", name=method_name,
                           actor_id=aid)
        return refs

    def _store_actor_error(self, spec, error: BaseException) -> None:
        task_id = TaskID(spec["task_id"])
        self._arg_refs.pop(spec["task_id"], None)
        t0 = self._task_t0.pop(spec["task_id"], None)
        self._task_tq.pop(spec["task_id"], None)
        if t0 is not None:
            _M_TASK_E2E.observe_since(t0)
        self.events.record(task_id.hex(), "FAILED", name=spec.get("name", ""),
                           actor_id=spec.get("actor_id", ""),
                           error_type=type(error).__name__)
        head, views = ser.serialize(error, error_type=ser.ERROR_ACTOR_DIED)
        data = ser.to_flat_bytes(head, views)
        freed: List[Tuple[ObjectID, set]] = []
        with self._owned_lock:
            for i in range(num_return_slots(spec["num_returns"])):
                oid = ObjectID.for_task_return(task_id, i)
                entry = self._owned.get(oid)
                if entry is not None:
                    entry.data = data
                    entry.state = "ready"
                    entry.error = ser.ERROR_ACTOR_DIED
                    entry.event.set()
                    if entry.refcount <= 0:
                        self._free_entry_locked(oid, entry, freed)
        self._complete_frees(freed)
        if spec.get("num_returns") == "streaming":
            self._stream_finished(spec["task_id"], failed=True)

    def kill_actor(self, actor_id: ActorID) -> None:
        self.gcs.call("kill_actor", {"actor_id": actor_id.hex()})
        # The GCS marks the actor DEAD before replying, but our pipe may
        # still hold a live connection to the (not-yet-exited) worker —
        # sever it so calls submitted after kill() returns deterministically
        # re-resolve via the GCS and fail with ActorDiedError instead of
        # racing the worker's exit.
        with self._actor_lock:
            pipe = self._actor_pipes.get(actor_id.hex())
        if pipe is not None:
            with pipe.cv:
                conn = pipe.conn
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass

    # ----------------------------------------------------------- rpc server
    def _handle_rpc(self, conn: rpc.Connection, method: str, p: Any) -> Any:
        if method == "get_object":
            return self._rpc_get_object(p or {})
        if method == "report_generator_item":
            return self._rpc_report_generator_item(p or {})
        if method == "report_object_location":
            return self._rpc_report_object_location(p or {})
        if method == "core_worker_stats":
            return self._rpc_core_worker_stats(p or {})
        if method == "profile":
            # drivers flame-sample like any worker (`ray-tpu profile`);
            # "device" requests the gang-capture dict (host stacks +
            # torch.profiler CPU+CUDA trace when on a GPU)
            from ray_tpu_torch._private.profiler import (profile_capture,
                                                   sample_folded)
            p = p or {}
            if "device" in p:
                return profile_capture(float(p.get("duration", 2.0)),
                                       device=bool(p.get("device")))
            return sample_folded(float(p.get("duration", 2.0)))
        if method == "dump_stacks":
            from ray_tpu_torch._private.profiler import dump_stacks, \
                sample_folded
            return {"threads": dump_stacks(),
                    "folded": sample_folded(
                        float((p or {}).get("duration", 0.2)))}
        raise rpc.RpcError(f"core_worker: unknown method {method}")

    def _rpc_core_worker_stats(self, p) -> dict:
        """Owned-object + submission introspection for the state API's
        `list objects` / `memory` views (cf. reference
        CoreWorkerService.GetCoreWorkerStats, core_worker.proto)."""
        objects = []
        with self._owned_lock:
            for oid, entry in self._owned.items():
                objects.append({
                    "object_id": oid.hex(),
                    "state": entry.state,
                    "refcount": entry.refcount,
                    "size": len(entry.data) if entry.data is not None else 0,
                    "inline": entry.data is not None,
                    "locations": sorted(entry.locations),
                })
        with self._sched_lock:
            pending = sum(len(s["queue"]) for s in self._sched.values())
            leases = sum(len(s["leases"]) for s in self._sched.values())
        return {
            "worker_id": self.worker_id.hex(),
            "job_id": self.job_id.hex(),
            "mode": self.mode,
            "address": list(self.address),
            "num_owned_objects": len(objects),
            "objects": objects,
            "pending_tasks": pending,
            "active_leases": leases,
        }

    def _rpc_report_object_location(self, p) -> dict:
        """A borrower (or a raylet prefetch) published a pulled copy of
        an object we own into its node's shm — the ownership directory's
        OnObjectLocationAdded analog.  Growing the location set lets
        later pulls stripe across the new copy and the final free sweep
        it; a report for an unknown/inline object is a no-op."""
        oid = ObjectID(p["object_id"])
        with self._owned_lock:
            entry = self._owned.get(oid)
            if entry is not None and entry.data is None:
                entry.locations.add(p["node_id"])
                if not entry.size and p.get("size"):
                    entry.size = int(p["size"])
        return {"ok": True}

    def _rpc_get_object(self, p) -> Optional[dict]:
        """Owner side of borrower gets: inline data or known locations."""
        oid = ObjectID(p["object_id"])
        timeout = p.get("timeout", 0.0)
        with self._owned_lock:
            entry = self._owned.get(oid)
        if entry is None:
            # maybe it's in our local shm even if not owned
            if self.store.contains(oid):
                res = self.store.get(oid, timeout=0.0)
                if res is not None:
                    buf, _ = res
                    try:
                        return {"data": bytes(buf)}
                    finally:
                        buf.release()
                        self.store.release(oid)
            return None
        if not entry.event.wait(timeout):
            return None
        if p.get("probe"):
            return {"ready": True}
        if entry.data is not None:
            return {"data": entry.data}
        locations = self._prune_dead_locations(entry)
        if not locations:
            # every copy died with its node: recover (or resolve the entry
            # to ObjectLostError) off the RPC thread; the borrower keeps
            # polling and picks up the recomputed value / error. One
            # recovery thread per entry — concurrent borrower polls (every
            # 10 ms each) must not fan out redundant ones.
            with self._owned_lock:
                spawn = not entry.recovering
                entry.recovering = True
            if spawn:
                try:
                    threading.Thread(target=self._recover_or_fail,
                                     args=(oid, entry), daemon=True).start()
                except RuntimeError:  # thread exhaustion: let a later
                    with self._owned_lock:  # borrower poll retry the spawn
                        entry.recovering = False
            return None
        return {"locations": list(locations)}

    # -------------------------------------------------------------- events
    def task_events(self) -> List[dict]:
        return self.events.snapshot()


class _ActorPipe:
    """Ordered, pipelined submission channel to one actor.

    A single sender thread drains the FIFO, assigning sequence numbers in
    submission order and issuing async calls without waiting (pipelining).
    On connection loss: unsent + retryable in-flight tasks are resubmitted in
    order on a fresh stream once the actor is ALIVE again; non-retryable
    in-flight tasks fail (reference semantics: actor tasks are not retried
    unless max_task_retries > 0)."""

    def __init__(self, core: "CoreWorker", actor_id_hex: str):
        self.core = core
        self.aid = actor_id_hex
        self.queue: deque = deque()          # (spec, retries)
        self.inflight: Dict[int, tuple] = {}  # seq -> (spec, retries)
        self.cv = threading.Condition()
        self.conn: Optional[rpc.Connection] = None
        self.next_seq = 0
        self.stream = ""
        self.broken = False
        # sender thread holds a popped spec whose seq isn't assigned yet:
        # the inline fast path must not overtake it (seq = submission
        # order is the actor ordering guarantee)
        self.draining = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def enqueue(self, spec, retries: int) -> None:
        with self.cv:
            if (self.conn is None or self.conn.closed or self.broken
                    or self.queue or self.draining):
                # cold/broken/backed-up pipe: the sender thread plans it
                self.queue.append((spec, retries))
                self.cv.notify()
                return
            # warm idle pipe: assign the seq and send from the caller's
            # thread — skips a sender-thread wake per call.  Wire order
            # may interleave with a concurrent inline sender, but seqs
            # are assigned under cv in submission order and the worker
            # executes by seq, so ordering holds.
            conn, seq, spec = self._assign_locked(spec, retries)
        self._send_assigned(conn, seq, spec)

    def _loop(self) -> None:
        while True:
            with self.cv:
                while not self.queue and not self.broken:
                    self.cv.wait()
                if self.broken:
                    self._handle_break_locked()
                    continue
                spec, retries = self.queue.popleft()
                self.draining += 1
            try:
                try:
                    ok = self._ensure_conn(spec)
                except (ConnectionError, OSError, TimeoutError):
                    # the resolved address can be stale mid-restart (the
                    # GCS may answer ALIVE with the dying worker's
                    # address for a beat): requeue and retry.  This must
                    # NOT escape — an uncaught connect error here kills
                    # the only sender thread and every later call on the
                    # pipe hangs to its get() timeout.
                    with self.cv:
                        self.queue.appendleft((spec, retries))
                    time.sleep(0.2)
                    continue
                if not ok:
                    continue
                with self.cv:
                    conn, seq, spec = self._assign_locked(spec, retries)
            finally:
                with self.cv:
                    self.draining -= 1
            self._send_assigned(conn, seq, spec)

    def _assign_locked(self, spec, retries: int):
        """cv held: stamp the next seq + current stream onto the spec
        and register it in-flight.  Both send paths (inline enqueue and
        the sender thread) MUST come through here — the stream stamp is
        what lets _on_done distinguish a stale-connection failure from a
        live break."""
        seq = self.next_seq
        self.next_seq += 1
        spec = dict(spec, seq=seq, stream=self.stream)
        self.inflight[seq] = (spec, retries)
        return self.conn, seq, spec

    def _send_assigned(self, conn, seq: int, spec) -> None:
        fut = conn.call_async("actor_task", spec)
        fut.add_done_callback(
            lambda f, s=seq, sp=spec: self._on_done(s, sp, f))

    def _ensure_conn(self, spec) -> bool:
        """True when a live connection is bound.  Raises ConnectionError/
        OSError on a transient connect failure (caller retries); returns
        False after failing the pipe's work on a permanent actor error."""
        with self.cv:
            if self.conn is not None and not self.conn.closed:
                return True
        try:
            addr = self.core._resolve_actor(self.aid)
        except exc.RayTpuError as e:
            self.core._store_actor_error(spec, e)
            # fail everything queued: the actor is gone for good
            with self.cv:
                dead = list(self.queue)
                self.queue.clear()
            for sp, _ in dead:
                self.core._store_actor_error(sp, e)
            return False
        conn = rpc.connect(addr)
        with self.cv:
            self.conn = conn
            self.stream = WorkerID.from_random().hex()[:16]
            self.next_seq = 0
        return True

    def _on_done(self, seq: int, spec, fut) -> None:
        try:
            reply = fut.result()
        except (ConnectionError, OSError):
            # connection died; the sender thread re-plans everything that
            # was in flight, so just flag the break — but only if this
            # failure belongs to the CURRENT stream.  An inline send can
            # race break recovery: its call_async lands on the old closed
            # conn after _handle_break_locked already re-planned that
            # stream (including this seq) onto a fresh connection, and
            # re-flagging would tear the healthy replacement down.
            with self.cv:
                if spec.get("stream") == self.stream:
                    self.broken = True
                    self.cv.notify()
            return
        except rpc.RemoteError as e:
            self.core._store_actor_error(spec, exc.RayTpuError(str(e)))
            with self.cv:
                self.inflight.pop(seq, None)
            return
        with self.cv:
            self.inflight.pop(seq, None)
        self.core._on_task_reply(spec, reply)

    def _handle_break_locked(self) -> None:
        """cv held.  Reset the pipe after a connection loss."""
        if self.conn is not None:
            conn, self.conn = self.conn, None
        else:
            conn = None
        inflight = [self.inflight[s] for s in sorted(self.inflight)]
        self.inflight.clear()
        self.broken = False
        requeue = []
        failed = []
        for spec, retries in inflight:
            base = {k: v for k, v in spec.items()
                    if k not in ("seq", "stream")}
            if retries > 0:
                requeue.append((base, retries - 1))
            else:
                failed.append(base)
        self.queue.extendleft(reversed(requeue))
        # release the lock-free work outside: store errors after cv block by
        # stashing on self (simplest: do it inline; _store_actor_error only
        # touches _owned_lock which is never held while calling here)
        for spec in failed:
            self.core._store_actor_error(spec, exc.ActorUnavailableError(
                f"actor {self.aid[:8]} died while this call was in flight"))
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass


def _current_trace_context() -> dict:
    from ray_tpu_torch.util.tracing.tracing_helper import get_trace_context
    return get_trace_context()


def _submit_trace_ctx(name: str) -> Optional[dict]:
    """Trace context to stamp onto a task/actor spec at submission.

    An active context (a serve ingress root, a user ``span()``, an
    executing task's span) propagates as-is.  With NO active context the
    deterministic sampler may open a fresh trace root for this
    submission (docs/observability.md): the unsampled fast path costs
    one random draw + compare; a sampled one records an instant
    ``submit`` root span so the trace has an anchor whose children are
    the worker-side execution spans."""
    trh = _tracing()
    ctx = trh.current_context()
    if ctx:
        return dict(ctx)
    ctx = trh.maybe_sample_root()
    if ctx is not None:
        trh.record_span({
            "trace_id": ctx["trace_id"], "span_id": ctx["span_id"],
            "name": f"submit:{name}", "kind": "submit",
            "start": time.time(), "dur_ms": 0.0, "status": trh.OK,
            "root": True})
    return ctx


def _maybe_big(value: Any) -> bool:
    """Cheap pre-filter before paying for a pickle size check."""
    import numpy as np
    if isinstance(value, np.ndarray):
        return value.nbytes > CONFIG.max_direct_call_args_bytes
    if isinstance(value, (bytes, bytearray, str)):
        return len(value) > CONFIG.max_direct_call_args_bytes
    return isinstance(value, (list, tuple, dict)) and len(value) > 1000
