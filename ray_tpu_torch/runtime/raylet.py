"""Node daemon: worker pool, lease-based local scheduler, object serving.

Analog of the reference raylet
(/root/reference/src/ray/raylet/node_manager.h:144 NodeManager,
worker_pool.h:156 WorkerPool, scheduling/local_task_manager.h:58).  The
worker-lease protocol is the reference's
(NodeManager::HandleRequestWorkerLease node_manager.cc:1883 ->
LocalTaskManager dispatch): a caller leases a worker for a scheduling key,
pushes tasks to it directly (the raylet is off the hot path), and returns the
lease when idle.  Resources are granted at lease time and returned at
lease-return time.

GPU process model (SURVEY.md §7 hard-part 4): a node's GPUs are exposed as a
``GPU`` resource, found without starting CUDA here (``detect_resources``).  A
worker that leases no GPU gets ``CUDA_VISIBLE_DEVICES=""`` and cannot touch
the cards; a worker that leases any GPU count sees the node's cards.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import cluster_events as cev
from ray_tpu_torch._private import host_stats
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import transfer
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.logging_utils import get_logger
from ray_tpu_torch.runtime.gcs import GcsClient
from ray_tpu_torch.runtime.object_store import SharedMemoryStore

# lease-path telemetry (docs/observability.md)
_M_LEASE = rtm.histogram(
    "ray_tpu_lease_grant_ms",
    "lease request queued -> grant latency at this raylet (ms)")
_M_SPAWNS = rtm.counter(
    "ray_tpu_workers_spawned_total", "worker processes spawned")
# data-plane serving + prefetch telemetry (docs/object_transfer.md)
_M_CHUNKS_SERVED = rtm.counter(
    "ray_tpu_chunks_served_total",
    "object chunks served to remote pullers from this node")
_M_CHUNK_BYTES_OUT = rtm.counter(
    "ray_tpu_chunk_bytes_served_total",
    "object bytes served to remote pullers (zero-copy shm slices)")
_M_PREFETCH_REQS = rtm.counter(
    "ray_tpu_prefetch_requests_total",
    "large task arguments a lease request asked this raylet to prefetch")
_M_PREFETCH_HITS = rtm.counter(
    "ray_tpu_prefetch_hits_total",
    "prefetch requests already satisfied by a local copy")
_M_PREFETCH_BYTES = rtm.counter(
    "ray_tpu_prefetch_bytes_total",
    "argument bytes pulled into local shm ahead of task dispatch")
_M_LOCALITY_HITS = rtm.counter(
    "ray_tpu_locality_lease_redirects_total",
    "lease requests redirected to the node holding the most argument "
    "bytes (locality-aware placement)")

logger = get_logger("raylet")


def detect_resources() -> Dict[str, float]:
    resources = {"CPU": float(os.cpu_count() or 1)}
    gpus = CONFIG.gpus_per_host or _detect_gpus()
    if gpus:
        resources["GPU"] = float(gpus)
    resources["memory"] = float(host_stats.virtual_memory().total)
    return resources


def _gpu_ids(n: int) -> List[str]:
    """The ``CUDA_VISIBLE_DEVICES`` entries of this host's ``n`` cards:
    the raylet's own entries when it was started with that many, else
    0..n-1."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = []
    for dev in (visible or "").split(","):
        dev = dev.strip()
        if not dev or dev.startswith("-"):
            break
        ids.append(dev)
    return ids[:n] if len(ids) >= n else [str(i) for i in range(n)]


def _detect_gpus() -> int:
    """This host's GPU count, found without starting CUDA: a CUDA context
    in the raylet, or in the zygote it forks workers from, would poison
    every forked worker.  ``CUDA_VISIBLE_DEVICES`` when it is set (CUDA
    stops at the first invalid entry), else ``nvidia-smi --list-gpus``."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        n = 0
        for dev in visible.split(","):
            dev = dev.strip()
            if not dev or dev.startswith("-"):
                break
            n += 1
        return n
    try:
        out = subprocess.run(["nvidia-smi", "--list-gpus"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode != 0:
        return 0
    return sum(line.startswith("GPU ") for line in out.stdout.splitlines())


# env vars consumed at interpreter start / first import: a zygote fork
# applies env AFTER those were read, so such overrides must exec.  The
# zygote has imported torch: TORCH_ and PYTORCH_ variables configure its
# C++ core, some of them as it loads (TORCH_CPP_LOG_LEVEL,
# TORCH_SHOW_CPP_STACKTRACES), and OMP_ / MKL_ ones are read by the
# OpenMP and MKL runtimes that load with it.  CUDA_VISIBLE_DEVICES is
# NOT here: CUDA reads it when it starts, which the zygote never does,
# so the forked child's env update covers it.
_IMPORT_SENSITIVE_ENV = ("LD_", "PYTHON", "TORCH_", "PYTORCH_", "OMP_",
                         "MKL_", "MALLOC_")


def _env_needs_exec(env_overrides) -> bool:
    return any(k.startswith(_IMPORT_SENSITIVE_ENV)
               for k in (env_overrides or {}))


class ForkedProc:
    """Popen-shaped handle over a zygote-forked worker pid.

    The worker is a direct child of the zygote, which runs with SIGCHLD
    ignored so exits auto-reap (single-fork protocol, worker_zygote.py) —
    there is no exit status for the raylet to collect; returncode is -1
    once the process is gone, which is all the pool logic reads.
    Liveness and signaling go through a pidfd when available: a bare pid
    can be recycled by an unrelated process as soon as the kernel reaps
    it, which would make kill(pid, 0) report a dead worker as alive
    forever."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._pidfd: Optional[int] = None
        try:
            self._pidfd = os.pidfd_open(pid)
        except (OSError, AttributeError):
            pass        # process already gone, or pre-5.3 kernel

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self._pidfd is not None:
            import select
            r, _, _ = select.select([self._pidfd], [], [], 0)
            if not r:
                return None
            os.close(self._pidfd)
            self._pidfd = None
            self.returncode = -1
            return self.returncode
        try:
            os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            self.returncode = -1
            return self.returncode
        except PermissionError:     # pid recycled by another user: dead
            self.returncode = -1
            return self.returncode

    def _signal(self, sig: int) -> None:
        try:
            if self._pidfd is not None:
                signal.pidfd_send_signal(self._pidfd, sig)
            else:
                os.kill(self.pid, sig)
        except (ProcessLookupError, OSError):
            self.returncode = self.returncode or -1

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def __del__(self):
        if self._pidfd is not None:
            try:
                os.close(self._pidfd)
            except OSError:
                pass

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("zygote-worker", timeout)
            time.sleep(0.02)
        return self.returncode


class _PendingProc:
    """Placeholder while the real process is being spawned: alive to
    poll(), inert to signals — a health sweep racing the spawn must
    neither reap nor signal a worker that doesn't exist yet.  Signals
    received during the window are REMEMBERED so the spawner can apply
    them to the real process the moment it exists (a kill during the
    pending window must not leak a live worker)."""

    pid = -1
    returncode = None

    def __init__(self):
        self.terminated = False

    def poll(self):
        return None

    def terminate(self):
        self.terminated = True

    def kill(self):
        self.terminated = True

    def wait(self, timeout=None):
        return None


class WorkerHandle:
    def __init__(self, worker_id: WorkerID,
                 proc: Optional[subprocess.Popen]):
        self.worker_id = worker_id
        self.proc = proc if proc is not None else _PendingProc()
        self.address: Optional[Tuple[str, int]] = None
        self.conn: Optional[rpc.Connection] = None
        self.ready = threading.Event()
        self.lease_id: Optional[str] = None
        self.actor_id: Optional[str] = None
        self.job_id: Optional[str] = None
        self.last_idle = time.monotonic()
        self.started_at = time.monotonic()
        # the cards this worker sees (its CUDA_VISIBLE_DEVICES, fixed at
        # spawn): a lease reuses it only when handed the same cards
        self.cards: Tuple[str, ...] = ()


class Raylet:
    def __init__(self, gcs_address: Tuple[str, int],
                 session_dir: str,
                 node_id: Optional[NodeID] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 host: str = "127.0.0.1",
                 labels: Optional[Dict[str, str]] = None):
        self.node_id = node_id or NodeID.from_random()
        self.session_dir = session_dir
        os.makedirs(session_dir, exist_ok=True)
        # explicit resources override what is detected, key by key (the
        # reference's rule): init(num_cpus=4) on a GPU host still
        # reports its GPUs
        self.resources = {**detect_resources(), **(resources or {})}
        self.available = dict(self.resources)
        self._res_lock = threading.Lock()
        # the share of each card that leases hold, by its
        # CUDA_VISIBLE_DEVICES entry: a GPU lease is handed whole cards,
        # or part of one, and its worker sees only those
        self._gpu_load = {c: 0.0 for c in
                          _gpu_ids(int(self.resources.get("GPU", 0)))}
        self._cpu_percent = host_stats.CpuPercent()

        store_mem = object_store_memory or CONFIG.object_store_memory_bytes
        self.store_path = os.path.join(
            self._pick_store_dir(store_mem),
            f"ray_tpu_torch_store_{os.getpid()}_{self.node_id.hex()[:12]}")
        self.store = SharedMemoryStore.create_segment(self.store_path,
                                                      store_mem)
        if CONFIG.object_store_prefault and store_mem >= (1 << 30):
            # big segments: move first-touch fault cost off the put path
            self.store.prefault_async()

        # prefork zygote: launched eagerly so its heavy import (the
        # torch import and the runtime's, a few seconds) overlaps
        # cluster startup; first worker spawn connects to it
        self._zygote_proc: Optional[subprocess.Popen] = None
        self._zygote_conn: Optional[Any] = None
        self._zygote_lock = threading.Lock()
        self._zygote_sock_path = os.path.join(
            session_dir, f"zygote_{self.node_id.hex()[:12]}.sock")
        if CONFIG.worker_prefork:
            try:
                self._start_zygote()
            except Exception as e:
                logger.warning("zygote start failed (%s); workers will "
                               "exec instead", e)

        self._workers: Dict[str, WorkerHandle] = {}       # worker_id hex ->
        self._idle: Dict[str, deque] = {}                 # sched key -> ids
        self._pending_leases: deque = deque()
        # lease_id -> {"need": resources, "pool": bundle pool key or None,
        #              "cards": the CUDA_VISIBLE_DEVICES entries it holds}
        self._leases: Dict[str, Dict[str, Any]] = {}
        # placement-group bundle pools reserved on this node:
        # "pgid:index" -> remaining resources in the bundle
        self._bundle_pools: Dict[str, Dict[str, float]] = {}
        self._lock = threading.RLock()
        self._stopped = threading.Event()
        # preemption drain (docs/fault_tolerance.md): once set, new
        # leases are refused (redirected to surviving nodes), queued
        # leases are swept, and the drain thread waits out short tasks
        # before evacuating primary object copies to surviving peers
        self._draining = False
        self._drain_reason = ""
        self._drain_deadline = 0.0

        # handlers that only touch in-memory state under short locks (no
        # spawns, no GCS round trips, no disk): dispatched inline on the
        # reader thread by the RPC fast path.  Lease/actor RPCs stay
        # pooled — they block on spawns and dispatch scans.
        # register_worker MUST be fast: lease_worker handlers park pool
        # threads waiting on worker registration, so a registration
        # queued behind a full pool of parked leases would wedge the
        # whole wave until the lease timeout.
        # fetch_object_chunk is fast too: a shm hit is a pin + an enqueued
        # zero-copy reply frame (the spilled/absent path hands itself to
        # the dispatch pool behind a Deferred before doing anything slow),
        # so pipelined pulls are served back-to-back off the reader with
        # their replies coalescing into shared sendmsg batches.
        fast = frozenset({"was_oom_killed", "store_stats", "node_info",
                          "list_workers", "spill_dir", "register_worker",
                          "fetch_object_chunk", "object_pins"})
        self._server = rpc.Server(self._handle, host=host,
                                  on_disconnect=self._conn_closed,
                                  fast_methods=fast)
        self.address = self._server.address

        self.gcs_address = tuple(gcs_address)
        self.labels = dict(labels or {})
        if CONFIG.tpu_slice_name and "slice" not in self.labels:
            # pod-slice identity rides the node labels so placement
            # machinery can treat one slice's hosts as an atomic bundle
            self.labels["slice"] = CONFIG.tpu_slice_name
        self.gcs = GcsClient(gcs_address, push_handler=self._gcs_push,
                             handler=self._handle, connect_retry=True)
        self.gcs.call("register_node", {
            "node_id": self.node_id.hex(),
            "address": list(self.address),
            "store_path": self.store_path,
            "resources": self.resources,
            "labels": self.labels,
        })

        # runtime telemetry: worker-pool gauge polled at flush time, and
        # this raylet's flusher publishing into the GCS KV
        rtm.gauge_callback("ray_tpu_worker_pool_size",
                           "workers registered to this raylet",
                           lambda: len(self._workers))
        rtm.attach(self.gcs.kv_put,
                   ident="raylet-" + self.node_id.hex()[:12])
        # cluster event plane (docs/observability.md): this raylet's
        # lifecycle events (worker spawn/exit, OOM kills, spill traffic)
        # batch to the GCS event table on the recorder's flusher cadence
        self._events_recorder = cev.configure(
            sink=lambda evs: self.gcs.call(
                "report_cluster_events", {"events": evs}, timeout=5),
            source="raylet", node_id=self.node_id.hex())
        # folded stacks sampled just before a hang-timeout kill, keyed
        # by worker id until the dossier harvest consumes them
        self._hang_stacks: Dict[str, Any] = {}

        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()
        self._spiller = threading.Thread(target=self._lease_spillback_loop,
                                         daemon=True)
        self._spiller.start()

        # object spilling (reference: LocalObjectManager,
        # src/ray/raylet/local_object_manager.h:41 + external_storage.py:72):
        # when shm usage crosses object_spill_threshold, LRU sealed unpinned
        # objects move to disk files; fetches restore or stream them back.
        self._spill_dir = os.path.join(
            CONFIG.object_store_fallback_dir or session_dir,
            f"spill_{self.node_id.hex()[:12]}")
        os.makedirs(self._spill_dir, exist_ok=True)
        # spill proper goes through the pluggable storage seam (URI-keyed;
        # mock:// + fault wrappers in tests); fallback-allocated primaries
        # written by clients stay plain local files in _spill_dir
        from ray_tpu_torch._private import storage as _storage
        base = CONFIG.object_spill_uri or self._spill_dir
        self._spill_store, self._spill_key_base = _storage.get_storage(base)
        # one fault seam: the legacy object_spill_fault presets and the
        # numeric knobs both wrap the backend in the same FlakyStorage
        fail_rate = CONFIG.object_spill_failure_rate
        slow_ms = CONFIG.object_spill_slow_ms
        if CONFIG.object_spill_fault == "unstable":
            fail_rate = max(fail_rate, 0.5)  # fail every other write
        elif CONFIG.object_spill_fault == "slow":
            slow_ms = max(slow_ms, 500.0)
        if fail_rate or slow_ms:
            self._spill_store = _storage.FlakyStorage(
                self._spill_store, failure_rate=fail_rate, slow_ms=slow_ms)
        self._fs_store = _storage.FileStorage()
        self._fallback_local: set = set()  # oids whose bytes are local files
        # disk-full protection for spill/fallback writes (reference
        # FileSystemMonitor, src/ray/common/file_system_monitor.h)
        from ray_tpu_torch._private.file_system_monitor import FileSystemMonitor
        self._fs_monitor = FileSystemMonitor(
            self._spill_dir,
            on_over=lambda usage: self._report_event(
                "ERROR", "OUT_OF_DISK",
                f"filesystem {usage:.0%} full: spilling disabled",
                usage=round(usage, 3)))
        self._spilled: Dict[bytes, Tuple[int, int]] = {}  # oid -> (size, meta)
        # frees that couldn't complete yet (object pinned, e.g. mid-spill);
        # retried by the spill loop so a free racing a spill can't leak the
        # resulting file or shm copy
        self._deferred_frees: set = set()
        self._restoring: set = set()  # oids mid restore (file -> shm)
        self._spill_mutex = threading.Lock()
        self._obj_spiller = threading.Thread(target=self._object_spill_loop,
                                             daemon=True)
        self._obj_spiller.start()

        # bulk data plane, raylet side (docs/object_transfer.md): pooled
        # peer connections + a pull engine for argument prefetch.  The
        # prefetch budget shares the process-wide cap semantics with
        # client pulls so a wave of lease requests can't overcommit shm.
        self._conn_cache = transfer.ConnCache()
        # (ts, nodes) list_nodes snapshot (_gcs_nodes): one tuple so
        # concurrent lease handlers read it atomically.  Callers pick
        # their own staleness bound — availability is advisory (a
        # locality-redirect target re-checks feasibility and can spill
        # back), and addresses are stabler still.
        self._nodes_snapshot: Tuple[float, list] = (0.0, [])
        self._prefetch_budget = transfer.PullBudget(
            CONFIG.pull_memory_cap_bytes)
        self._puller = transfer.ObjectPuller(
            self.store, self._peer_address, self._conn_cache.get,
            budget=self._prefetch_budget)
        # oid binary -> (pinned view, expires_at): prefetched arguments
        # stay pinned so eviction/spill can't undo the transfer before
        # the task runs; dropped on free, else reaped after
        # prefetch_pin_ttl_s (lease timed out / task cancelled)
        self._prefetch_pins: Dict[bytes, Tuple[memoryview, float]] = {}
        self._prefetch_inflight: set = set()
        # freed while its prefetch was still pulling: the completion must
        # discard the copy instead of pinning a resurrected object
        self._prefetch_freed: set = set()
        # pins taken by evacuation ingest (subset of _prefetch_pins):
        # unlike plain prefetch replicas, these may be an object's LAST
        # copy (cascading drains) and must re-evacuate if THIS node
        # drains too
        self._evac_keep: set = set()
        self._prefetch_lock = threading.Lock()
        # bounded: a lease storm carrying many large-arg entries queues
        # here instead of spawning a thread per argument (PullBudget
        # bounds the bytes, this bounds the threads)
        self._prefetch_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="arg-prefetch")

        # host-memory monitor + OOM worker-killing policy (reference
        # MemoryMonitor, memory_monitor.h:52 + worker_killing_policy.h)
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        self._oom_kills: Dict[str, float] = {}   # worker_id -> kill time
        self._oom_kill_count = 0
        self._last_oom_kill = 0.0
        self._memory_monitor = MemoryMonitor(self._on_memory_breach)
        if self._memory_monitor.enabled:
            self._mem_thread = threading.Thread(
                target=self._memory_monitor_loop, daemon=True)
            self._mem_thread.start()
        if CONFIG.log_to_driver:
            from ray_tpu_torch._private.log_monitor import LogMonitor

            def job_of(worker_prefix: str):
                with self._lock:
                    for wid, h in self._workers.items():
                        if wid.startswith(worker_prefix):
                            return h.job_id
                return None

            self._log_monitor = LogMonitor(session_dir, self.gcs,
                                           self.node_id.hex(), job_of)
            self._log_monitor.start()
        else:
            self._log_monitor = None

    def _report_event(self, severity: str, label: str, message: str,
                      **fields) -> None:
        """Typed component event via the batched event plane.  Emission
        sites sit on memory-critical paths (OOM kill, spill under
        _spill_mutex) — emit() is a ring append; the recorder's flusher
        pays the GCS round trip off-path."""
        cev.emit(label, message, severity=severity, **fields)

    # --------------------------------------------------------------- serving
    def _handle(self, conn: rpc.Connection, method: str, p: Any) -> Any:
        fn = getattr(self, "_rpc_" + method, None)
        if fn is None:
            raise rpc.RpcError(f"raylet: unknown method {method}")
        return fn(conn, p or {})

    def _gcs_push(self, method: str, payload: Any) -> None:
        if method == "kill_actor_worker":
            self._kill_actor_worker(payload["actor_id"])
        elif method == "pubsub":
            pass

    def _conn_closed(self, conn: rpc.Connection) -> None:
        peer = getattr(conn, "peer", None)
        if isinstance(peer, tuple) and peer and peer[0] == "worker":
            self._on_worker_dead(peer[1], "connection lost")

    # ------------------------------------------------------------- heartbeat
    def _node_health(self, loop_lag_ms: float) -> Dict[str, Any]:
        """Health snapshot piggybacked on heartbeats (cpu/mem/store
        occupancy, heartbeat-loop lag, worker-pool size): feeds the
        GCS NODE_UNHEALTHY threshold and the `ray-tpu status` health
        table (docs/observability.md)."""
        health: Dict[str, Any] = {
            "loop_lag_ms": round(loop_lag_ms, 1),
            "workers": len(self._workers),
            "oom_kills": self._oom_kill_count,
        }
        try:
            vm = host_stats.virtual_memory()
            health["mem_frac"] = round(vm.percent / 100.0, 4)
            health["cpu_frac"] = round(self._cpu_percent() / 100.0, 4)
        except Exception:
            pass
        try:
            st = self.store.stats()
            health["store_frac"] = round(
                st["bytes_in_use"] / max(1, st["capacity"]), 4)
        except Exception:
            pass
        return health

    def _heartbeat_loop(self) -> None:
        period = CONFIG.heartbeat_period_ms / 1000.0
        beats = 0
        t_sleep = time.monotonic()
        while not self._stopped.wait(period):
            # loop lag = how late this wake fired vs the period —
            # stamped against the moment we went to SLEEP, so it
            # measures thread starvation (overloaded box) only, not
            # the previous iteration's work (a slow GCS heartbeat RPC
            # must not flip every node to NODE_UNHEALTHY)
            now = time.monotonic()
            loop_lag_ms = max(0.0, (now - t_sleep - period) * 1000.0)
            beats += 1
            try:
                with self._res_lock:
                    avail = dict(self.available)
                with self._lock:
                    # aggregate queued lease demand by resource shape so the
                    # autoscaler can binpack it (reference: resource_load_by_shape
                    # carried in heartbeats to GCS for the monitor)
                    shapes: Dict[tuple, int] = {}
                    for req in self._pending_leases:
                        need = dict(req["resources"])
                        need.setdefault("CPU", 1.0)
                        key = tuple(sorted(need.items()))
                        shapes[key] = shapes.get(key, 0) + 1
                    load = [{"shape": dict(k), "count": c}
                            for k, c in shapes.items()]
                    busy = bool(self._leases) or bool(self._bundle_pools)
                if not busy:
                    # a node whose store (or spill dir) still holds live
                    # objects is not idle: terminating it would strand
                    # ObjectRefs on their primary copies
                    try:
                        busy = (self.store.stats()["num_objects"] > 0
                                or bool(self._spilled))
                    except Exception:
                        busy = True
                hb = {"node_id": self.node_id.hex(),
                      "available": avail,
                      "load": load,
                      "busy": busy}
                with self._res_lock:
                    # bundle-pool reconciliation (docs/fault_tolerance
                    # .md): report the reservations we hold so the GCS
                    # can flag ones it no longer places here (pg
                    # removed / rescheduled while we were unreachable)
                    hb["bundles"] = list(self._bundle_pools)
                if self._draining:
                    hb["draining"] = True
                    hb["drain_reason"] = self._drain_reason
                    hb["drain_grace_s"] = max(
                        0.0, self._drain_deadline - time.monotonic())
                # health snapshot every ~1s (or immediately when the
                # loop itself lagged): cheap, and the GCS only edge-
                # triggers events on threshold crossings
                if beats % max(1, int(round(1.0 / period))) == 0 or \
                        loop_lag_ms >= CONFIG.node_unhealthy_lag_ms:
                    hb["health"] = self._node_health(loop_lag_ms)
                reply = self.gcs.call("heartbeat", hb)
                if reply and reply.get("reregister"):
                    # the GCS restarted without our node in its restored
                    # state: introduce ourselves again
                    try:
                        self.gcs.call("register_node", {
                            "node_id": self.node_id.hex(),
                            "address": list(self.address),
                            "store_path": self.store_path,
                            "resources": self.resources,
                            "labels": self.labels,
                        })
                    except (ConnectionError, rpc.RpcError, TimeoutError):
                        pass
                    continue
                if reply and reply.get("dead"):
                    # the GCS declared us dead and restarted our actors
                    # elsewhere; fate-share instead of running split-brain
                    logger.error("GCS declared this node dead; shutting down")
                    threading.Thread(target=self.shutdown,
                                     daemon=True).start()
                    return
                if reply and reply.get("stale_bundles"):
                    # off-thread: the verify round trip must not delay
                    # liveness reporting past the death threshold
                    threading.Thread(
                        target=self._release_stale_bundles,
                        args=(list(reply["stale_bundles"]),),
                        daemon=True).start()
            except (ConnectionError, rpc.RpcError, TimeoutError):
                if self._stopped.is_set():
                    return
                logger.warning("heartbeat to GCS failed")
            finally:
                # re-stamp at the bottom of every iteration (all exit
                # paths incl. continue) so the next wake's lag excludes
                # this iteration's own work
                t_sleep = time.monotonic()

    def _lease_spillback_loop(self) -> None:
        """Dedicated thread: never blocks heartbeats (a slow GCS list_nodes
        here must not delay liveness reporting past the death threshold)."""
        while not self._stopped.wait(1.0):
            try:
                self._lease_spillback_scan()
            except Exception:
                logger.exception("lease spillback scan failed")

    def _lease_spillback_scan(self) -> None:
        """Redirect stale queued leases to nodes that now have capacity.

        When the autoscaler (ray_tpu_torch/autoscaler/) brings a node up, requests
        queued here before it existed would otherwise sit until their lease
        timeout; this is the queued-side half of the reference's spillback
        (cluster_task_manager spilling queued work on cluster view changes).
        """
        with self._lock:
            stale = [r for r in self._pending_leases
                     if r.get("pool") is None and r.get("spillback", 0) < 2
                     and time.monotonic() - r.get("t_queued", 0) > 1.0]
        if not stale:
            return
        # one cluster snapshot per scan, shared across all stale requests
        try:
            nodes = self.gcs.call("list_nodes", timeout=2)
        except (ConnectionError, rpc.RemoteError, TimeoutError):
            return
        remote_nodes = [n for n in nodes
                        if n["node_id"] != self.node_id.hex()
                        and n["alive"] and not n.get("draining")]
        for req in stale:
            need = dict(req["resources"])
            need.setdefault("CPU", 1.0)
            with self._res_lock:
                local_ok = all(self.available.get(r, 0) >= v
                               for r, v in need.items())
            if local_ok:
                continue
            target = None
            for node in remote_nodes:
                if all(node["available"].get(r, 0) >= v
                       for r, v in need.items()):
                    target = tuple(node["address"])
                    break
            if target is None:
                continue
            with self._lock:
                if req not in self._pending_leases:
                    continue  # granted concurrently
                self._pending_leases.remove(req)
                req["out"]["grant"] = {"retry_at": list(target)}
                req["event"].set()

    # --------------------------------------------------------- object spill
    def _object_spill_loop(self) -> None:
        while not self._stopped.wait(0.2):
            try:
                self._reap_prefetch_pins()
                self._retry_deferred_frees()
                self._object_spill_scan()
            except Exception:
                logger.exception("object spill scan failed")

    def _object_spill_scan(self) -> int:
        """High-water spill: keep shm usage below object_spill_threshold by
        moving LRU sealed unpinned objects to disk (hysteresis: spill down
        to 90% of the threshold so the loop doesn't thrash at the line)."""
        st = self.store.stats()
        hi = CONFIG.object_spill_threshold * st["capacity"]
        if st["bytes_in_use"] <= hi:
            return 0
        return self._spill_bytes(st["bytes_in_use"] - int(hi * 0.9))

    def _spill_path(self, oid) -> str:
        return os.path.join(self._spill_dir, oid.hex())

    def _spill_loc(self, oid):
        """-> (storage, key) holding this object's spilled bytes."""
        with self._lock:
            fb = oid.binary() in self._fallback_local
        if fb:
            return self._fs_store, self._spill_path(oid)
        return self._spill_store, f"{self._spill_key_base}/{oid.hex()}"

    def _spill_bytes(self, needed: int) -> int:
        """Spill LRU-first until ``needed`` bytes left shm (or no victims)."""
        with self._spill_mutex:
            objs = [o for o in self.store.list_objects() if o[3] == 0]
            objs.sort(key=lambda t: t[2])  # oldest lru_tick first
            freed = 0
            for oid, size, _tick, _pins in objs:
                if freed >= needed:
                    break
                if self._spill_one(oid, size):
                    freed += size
            return freed

    def _spill_one(self, oid, size: int) -> bool:
        if not CONFIG.object_spill_uri and self._fs_monitor.over_capacity():
            return False  # disk full: keep the shm copy, fail gracefully
        with self._lock:
            if oid.binary() in self._deferred_frees:
                return False  # being freed: spilling it would leak the file
        res = self.store.get(oid, timeout=0.0)
        if res is None:
            return False
        buf, meta = res
        sstore, skey = self._spill_loc(oid)
        try:
            # pass the shm memoryview straight through: FileStorage
            # streams it to disk without a heap copy (spilling fires
            # exactly when memory is tight)
            try:
                sstore.write_bytes(skey, buf)
            except OSError as e:
                # flaky/full spill target: keep the shm copy, the next
                # scan retries (reference spill IO error path)
                logger.warning("spill write of %s failed: %s",
                               oid.hex()[:12], e)
                self._report_event("WARNING", "SPILL_WRITE_FAILED",
                                   f"spill of {oid.hex()[:12]} failed: {e}")
                return False
        finally:
            buf.release()
            self.store.release(oid)
        # record before delete: a fetch racing the handoff finds the object
        # in at least one of the two places (both is harmless — immutable)
        with self._lock:
            self._spilled[oid.binary()] = (size, meta)
        if not self.store.delete(oid):
            # pinned between release and delete: keep it in shm
            with self._lock:
                self._spilled.pop(oid.binary(), None)
            sstore.delete(skey)
            return False
        logger.debug("spilled %s (%d bytes)", oid.hex()[:12], size)
        cev.emit(cev.OBJECT_SPILL, f"spilled {oid.hex()[:12]}",
                 severity="DEBUG", object_id=oid.hex(), bytes=size)
        return True

    def _fetch_spilled_chunk(self, oid, p):
        """Serve a chunk of a spilled object as (value, on_sent), racing
        safely against a concurrent restore (which removes the file and
        re-creates the shm copy): a None value is authoritative 'absent'
        to owners, so every transient mid-handoff window must be retried,
        never reported — and an exhausted run of flaky storage reads
        raises (the owner maps a transport error to 'transient', never to
        lost)."""
        io_error = None
        for _ in range(3):
            with self._lock:
                rec = self._spilled.get(oid.binary())
            if rec is None:
                # not spilled (anymore): a concurrent restore may have just
                # moved it to shm — block only if one is actually in flight
                # (a plain absent object must answer fast: owners treat it
                # as authoritative for reconstruction)
                with self._lock:
                    restoring = oid.binary() in self._restoring
                res = self.store.get(oid, timeout=2.0 if restoring else 0.0)
                if res is None:
                    return None, None
                return self._chunk_reply(oid, res, p)
            size, meta = rec
            # restore into shm when it fits under the spill threshold
            # (reference LocalObjectManager restore / plasma re-create
            # path) so subsequent local gets are zero-copy again
            st = self.store.stats()
            if st["bytes_in_use"] + size <= \
                    CONFIG.object_spill_threshold * st["capacity"]:
                if self._restore_one(oid, size, meta):
                    # blocking get: a concurrent restorer may not have
                    # sealed yet
                    res = self.store.get(oid, timeout=2.0)
                    if res is not None:
                        return self._chunk_reply(oid, res, p)
                    # "restored concurrently" may actually be a remote
                    # pull's UNSEALED destination create for this very
                    # object (it will seal only after we answer) — fall
                    # through and serve from the spill file, which that
                    # restore-miss left intact.  A true concurrent
                    # restore deleted the file: FileNotFoundError below
                    # re-resolves, keeping the old retry behavior.
            sstore, skey = self._spill_loc(oid)
            try:
                data = sstore.read_bytes(skey, int(p.get("offset", 0)),
                                         int(p.get("length", size)))
                return {"total": size, "meta": meta, "data": data}, None
            except FileNotFoundError:
                continue  # restored (or freed) under us: re-resolve
            except OSError as e:
                io_error = e
                continue  # flaky storage read: retry
        if io_error is not None:
            raise rpc.RpcError(
                f"spill storage read failed for {oid.hex()[:12]}: "
                f"{io_error}")
        return None, None

    def _restore_one(self, oid, size: int, meta: int) -> bool:
        from ray_tpu_torch.exceptions import ObjectStoreFullError
        # Mark restoring BEFORE reading the file: _rpc_free_objects checks
        # _restoring under the same lock, so either it sees us and defers
        # the free (retried until the copy stays gone) or it unlinks first
        # and our read fails — no window where a freed object is re-sealed
        # into shm untracked.
        with self._lock:
            self._restoring.add(oid.binary())
        try:
            sstore, skey = self._spill_loc(oid)
            try:
                data = sstore.read_bytes(skey)
            except FileNotFoundError:
                return False
            except OSError:
                return False  # flaky storage read: fetch path retries
            try:
                buf = self.store.create(oid, size, meta=meta,
                                        allow_evict=False)
            except FileExistsError:
                return True  # restored concurrently
            except (ObjectStoreFullError, OSError):
                return False
            try:
                buf[:len(data)] = data
            finally:
                buf.release()
            self.store.seal(oid)
            with self._lock:
                self._spilled.pop(oid.binary(), None)
                self._fallback_local.discard(oid.binary())
            sstore.delete(skey)
            logger.debug("restored %s (%d bytes)", oid.hex()[:12], size)
            cev.emit(cev.OBJECT_RESTORE, f"restored {oid.hex()[:12]}",
                     severity="DEBUG", object_id=oid.hex(), bytes=size)
            return True
        finally:
            with self._lock:
                self._restoring.discard(oid.binary())

    def _rpc_profile(self, conn, p):
        """Flame-sample this raylet, or forward to one of its workers
        (reference reporter_agent on-demand CPU profiling)."""
        wid = p.get("worker_id")
        duration = float(p.get("duration", 2.0))
        if wid:
            with self._lock:
                h = None
                for w, handle in self._workers.items():
                    if w.startswith(wid):
                        h = handle
                        break
            if h is None or h.conn is None:
                raise rpc.RpcError(f"no live worker matching {wid!r}")
            fwd = {"duration": duration}
            if "device" in p:   # gang/device capture passes through
                fwd["device"] = bool(p.get("device"))
            return h.conn.call("profile", fwd, timeout=duration + 30)
        from ray_tpu_torch._private.profiler import sample_folded
        return sample_folded(duration)

    def _rpc_dump_stacks(self, conn, p):
        """Instant per-thread stacks + a short folded sample of this
        raylet — or, with ``worker_id``/``pid``, forwarded to one of
        its workers (`ray-tpu summary stacks`, docs/observability.md:
        sampling a stalled process without gdb)."""
        wid = p.get("worker_id")
        pid = p.get("pid")
        if wid or pid:
            with self._lock:
                h = None
                for w, handle in self._workers.items():
                    if (wid and w.startswith(wid)) or \
                            (pid and handle.proc.pid == int(pid)):
                        h = handle
                        break
            if h is None or h.conn is None:
                raise rpc.RpcError(
                    f"no live worker matching {wid or pid!r}")
            return h.conn.call("dump_stacks",
                               {"duration": p.get("duration", 0.2)},
                               timeout=30)
        from ray_tpu_torch._private.profiler import dump_stacks, sample_folded
        return {"threads": dump_stacks(),
                "folded": sample_folded(float(p.get("duration", 0.2)))}

    def _rpc_spill_dir(self, conn, p):
        """Clients writing fallback-allocated primaries need the dir."""
        if self._fs_monitor.over_capacity():
            raise rpc.RpcError(
                "out of disk: local filesystem is above "
                f"{CONFIG.local_fs_capacity_threshold:.0%} capacity; "
                "fallback allocation refused")
        return self._spill_dir

    def _rpc_register_spilled(self, conn, p):
        """A client wrote a primary copy straight to the spill dir (plasma
        fallback-allocation analog); track it like any spilled object."""
        from ray_tpu_torch._private.ids import ObjectID
        oid = ObjectID(p["object_id"])
        with self._lock:
            self._fallback_local.add(oid.binary())
            self._spilled[oid.binary()] = (int(p["size"]),
                                           int(p.get("meta", 0)))
        return {"ok": True}

    def _rpc_request_spill(self, conn, p):
        """A client's create failed for lack of space: spill at least
        ``bytes`` synchronously so its retry can succeed."""
        freed = self._spill_bytes(int(p.get("bytes", 0)) or 1)
        return {"freed": freed}

    def _rpc_free_objects(self, conn, p):
        """Owner says these objects' refcounts hit zero: drop the primary
        copies (shm + spill files) on this node."""
        from ray_tpu_torch._private.ids import ObjectID
        for ob in p.get("object_ids", ()):
            oid = ObjectID(ob)
            # a prefetch pin must never turn a free into a deferred retry
            # loop: drop ours first, then delete.  An in-flight prefetch
            # gets a tombstone so its completion discards the copy
            # instead of resurrecting a freed object under a 60 s pin.
            with self._prefetch_lock:
                if bytes(ob) in self._prefetch_inflight:
                    self._prefetch_freed.add(bytes(ob))
            self._release_prefetch_pin(bytes(ob))
            deleted = self.store.delete(oid)
            sstore, skey = self._spill_loc(oid)
            with self._lock:
                rec = self._spilled.pop(oid.binary(), None)
                self._fallback_local.discard(oid.binary())
                restoring = oid.binary() in self._restoring
            if rec is not None:
                sstore.delete(skey)
            if restoring:
                # a concurrent _restore_one may re-seal this object into
                # shm after our delete; defer so the retry loop deletes
                # whatever copy the restore produces
                with self._lock:
                    self._deferred_frees.add(oid.binary())
            elif not deleted and self.store.contains(oid):
                # pinned right now (a reader, or _spill_one mid-handoff):
                # the single free RPC must still win eventually
                with self._lock:
                    self._deferred_frees.add(oid.binary())
        return {"ok": True}

    def _retry_deferred_frees(self) -> None:
        from ray_tpu_torch._private.ids import ObjectID
        with self._lock:
            pending = list(self._deferred_frees)
        for ob in pending:
            oid = ObjectID(ob)
            self.store.delete(oid)
            sstore, skey = self._spill_loc(oid)
            with self._lock:
                rec = self._spilled.pop(ob, None)
                self._fallback_local.discard(ob)
            if rec is not None:
                sstore.delete(skey)
            with self._lock:
                # keep the entry while a restore is in flight: contains()
                # is momentarily False while _restore_one reads the spill
                # file, and dropping the free here would let the restore
                # seal a zero-refcount object into shm permanently
                if not self.store.contains(oid) \
                        and ob not in self._restoring:
                    self._deferred_frees.discard(ob)

    # --------------------------------------------------------- memory / OOM
    def _memory_monitor_loop(self) -> None:
        while not self._stopped.wait(self._memory_monitor.refresh_s):
            try:
                self._memory_monitor.poll_once()
            except Exception:
                logger.exception("memory monitor poll failed")

    def _on_memory_breach(self, usage: float) -> None:
        """Kill one worker per refresh period at most — killing frees
        memory asynchronously, so firing every poll would massacre the
        pool before the first kill lands."""
        now = time.monotonic()
        if now - self._last_oom_kill < self._memory_monitor.refresh_s * 2:
            return
        from ray_tpu_torch._private.memory_monitor import pick_oom_victim
        with self._lock:
            view = [(wid, h.actor_id is not None, h.started_at,
                     h.lease_id is not None)
                    for wid, h in self._workers.items()]
        victim = pick_oom_victim(view)
        if victim is None:
            logger.warning("memory usage %.2f over threshold but no "
                           "killable worker", usage)
            return
        with self._lock:
            # re-check under the lock: a victim that exited on its own
            # since the snapshot must not be charged as an OOM kill (its
            # owner would silently retry a crash on the OOM budget)
            if victim not in self._workers:
                return
            self._last_oom_kill = now
            self._oom_kills[victim] = now
            self._oom_kill_count += 1
            # bound the ledger; owners query within seconds of the kill
            if len(self._oom_kills) > 1024:
                for k in sorted(self._oom_kills,
                                key=self._oom_kills.get)[:512]:
                    del self._oom_kills[k]
        logger.warning("memory usage %.2f >= %.2f: OOM-killing worker %s "
                       "(retriable-LIFO policy)", usage,
                       self._memory_monitor.threshold, victim[:8])
        self._report_event("ERROR", "OOM_KILL",
                           f"host memory {usage:.0%}: killed worker "
                           f"{victim[:8]}", worker_id=victim,
                           usage=round(usage, 3))
        self._kill_worker(victim, f"OOM-killed (host memory {usage:.0%})",
                          force=True)

    def _rpc_die(self, conn, p):
        """Chaos seam (reference NodeKiller, _private/test_utils.py:1301):
        hard-exit the raylet as if the node vanished.  Workers fate-share
        via their raylet connection; graceful=False skips all cleanup."""
        logger.warning("raylet received die request (chaos)")

        def _exit():
            time.sleep(0.05)  # let the RPC reply flush
            os._exit(1)

        threading.Thread(target=_exit, daemon=True).start()
        return {"ok": True}

    # --------------------------------------------------- preemption drain
    def _rpc_drain(self, conn, p):
        """Graceful-preemption drain (spot notice, `ray-tpu drain`):
        emit NODE_PREEMPTING with the grace deadline, stop granting
        leases, let short tasks finish, then evacuate primary object
        copies to surviving nodes over the transfer plane
        (docs/fault_tolerance.md).  Idempotent."""
        raw_grace = p.get("grace_s")
        # explicit 0 means "die ASAP, evacuate now" — `or` would turn
        # it into the 30s default
        grace = CONFIG.drain_grace_s if raw_grace is None \
            else float(raw_grace)
        reason = p.get("reason", "drain requested")
        with self._lock:
            already = self._draining
            self._draining = True
            self._drain_reason = reason
            new_deadline = time.monotonic() + grace
            if already:
                # a later notice can only SHORTEN the window (a 300s
                # maintenance drain followed by a 5s spot notice must
                # evacuate now); the running drain loop re-reads the
                # deadline every tick
                self._drain_deadline = min(self._drain_deadline,
                                           new_deadline)
            else:
                self._drain_deadline = new_deadline
        if already:
            return {"ok": True, "already": True}
        logger.warning("draining: %s (grace %.0fs)", reason, grace)
        # ring_only: the GCS emits the one canonical NODE_PREEMPTING
        # table event (either RPC path reports there); this copy is a
        # flight-ring breadcrumb for this raylet's dossier
        cev.emit(cev.NODE_PREEMPTING,
                 f"raylet draining: {reason} (grace {grace:.0f}s)",
                 severity="WARNING", ring_only=True,
                 grace_s=grace, reason=reason)
        if not p.get("from_gcs"):
            # direct raylet-RPC drain: reflect it in the GCS node table
            # so placement stops choosing this node immediately (the
            # heartbeat-carried flag is the idempotent backstop)
            try:
                self.gcs.call("report_node_draining",
                              {"node_id": self.node_id.hex(),
                               "grace_s": grace, "reason": reason},
                              timeout=5)
            except (ConnectionError, rpc.RpcError, TimeoutError):
                pass
        threading.Thread(target=self._drain_loop, args=(grace, reason),
                         daemon=True).start()
        return {"ok": True}

    def _drain_loop(self, grace: float, reason: str) -> None:
        """Runs the drain to completion: sweep queued leases, wait out
        in-flight task leases (actors are restarted elsewhere by the
        GCS when the node dies — their leases never drain), evacuate,
        report the ledger.  Best effort end to end: a drain must never
        crash the raylet it is trying to wind down."""
        t0 = time.monotonic()
        try:
            self._sweep_queued_leases()
            # live deadline read: a later, shorter preemption notice
            # shrinks _drain_deadline and this wait must honor it.  The
            # lease wait RESERVES part of the window for evacuation — a
            # task that outlives the grace must not eat the whole
            # budget and leave the primary copies to die with the node.
            evac_reserve = min(10.0, 0.4 * grace)
            while time.monotonic() < self._drain_deadline - evac_reserve:
                with self._lock:
                    busy = [lid for lid in self._leases
                            if not lid.startswith("actor-")]
                if not busy:
                    break
                time.sleep(0.2)
            evacuated = nbytes = failed = 0
            if CONFIG.evacuation_enabled:
                evacuated, nbytes, failed = self._evacuate_objects(
                    self._drain_deadline)
            try:
                self.gcs.call("report_node_drained",
                              {"node_id": self.node_id.hex(),
                               "evacuated": evacuated, "bytes": nbytes,
                               "failed": failed,
                               "duration_s": round(
                                   time.monotonic() - t0, 3)},
                              timeout=10)
            except (ConnectionError, rpc.RpcError, TimeoutError):
                pass
            logger.warning("drain complete: %d objects evacuated "
                           "(%d bytes, %d failed) in %.1fs", evacuated,
                           nbytes, failed, time.monotonic() - t0)
        except Exception:
            logger.exception("drain loop failed")

    def _sweep_queued_leases(self) -> None:
        """Resolve every queued lease request with a redirect to a
        surviving node (or a clean error): a request parked behind this
        node's resources must not sit until its timeout while the node
        is going away.  Redirect rules mirror the lease handler: only
        non-bundle, spillback<2 requests can follow a retry_at — the
        other shapes consume the reply as a final grant."""
        with self._lock:
            stranded = list(self._pending_leases)
            self._pending_leases.clear()
        if not stranded:
            return
        # one cluster snapshot for the whole sweep (the stale-request
        # scan above does the same): N queued leases must not cost N
        # list_nodes round trips on the drain path
        try:
            nodes = self.gcs.call("list_nodes", timeout=5)
        except (ConnectionError, rpc.RemoteError, TimeoutError):
            nodes = []
        candidates = [n for n in nodes
                      if n["node_id"] != self.node_id.hex()
                      and n["alive"] and not n.get("draining")]
        for req in stranded:
            need = dict(req["resources"])
            need.setdefault("CPU", 1.0)
            target = None
            if req.get("pool") is None and req.get("spillback", 0) < 2:
                for node in candidates:
                    if all(node["available"].get(r, 0) >= v
                           for r, v in need.items()):
                        target = tuple(node["address"])
                        break
            if target is not None:
                req["out"]["grant"] = {"retry_at": list(target)}
            else:
                req["out"]["error"] = "node draining (preemption " \
                                      "imminent); no alternative node"
            req["event"].set()

    def _evacuation_targets(self) -> list:
        return [n for n in self._gcs_nodes(0.5)
                if n.get("alive") and not n.get("draining")
                and n["node_id"] != self.node_id.hex()]

    def _evacuate_objects(self, deadline: float) -> Tuple[int, int, int]:
        """Ship every local primary copy (sealed shm objects + spilled
        files) to surviving nodes: the receiving raylet pulls over the
        transfer plane (`ingest_object`), pins the copy for
        evac_pin_ttl_s, and the landing is registered in the GCS
        evacuated-object table so owners find it the moment their old
        location set dies (docs/fault_tolerance.md).  -> (evacuated,
        bytes, failed)."""
        targets = self._evacuation_targets()
        if not targets:
            # distinct label: the canonical NODE_DRAINED (with its
            # ledger) still comes from the GCS at drain completion
            self._report_event("ERROR", "EVACUATION_SKIPPED",
                               "evacuation skipped: no surviving node")
            return 0, 0, 0
        with self._prefetch_lock:
            # plain prefetch pins are borrowed REPLICAS of arguments
            # whose primaries live elsewhere — shipping them would
            # burn the grace window on copies nobody will miss.
            # Evac-ingested pins stay: after a cascading drain they
            # may be an object's last copy.
            skip = set(self._prefetch_pins) - self._evac_keep
        work = []   # (oid, size)
        for oid, size, _tick, _pins in self.store.list_objects():
            if oid.binary() not in skip:
                work.append((oid, size))
        from ray_tpu_torch._private.ids import ObjectID
        with self._lock:
            shm = {o.binary() for o, _s in work}
            for ob, (size, _meta) in self._spilled.items():
                if ob not in shm and ob not in skip:
                    work.append((ObjectID(ob), size))
        if not work:
            return 0, 0, 0
        results = []
        with ThreadPoolExecutor(max_workers=4,
                                thread_name_prefix="evac") as pool:
            # rotated target list per object: the primary target is
            # round-robin, but a refusal (full store, transfer already
            # in flight, transient unreachability) falls over to the
            # remaining survivors instead of abandoning the object
            futs = [pool.submit(
                        self._evacuate_one, oid, size,
                        targets[i % len(targets):] +
                        targets[:i % len(targets)], deadline)
                    for i, (oid, size) in enumerate(work)]
            for f in futs:
                try:
                    results.append(f.result())
                except Exception:
                    results.append(None)
        evacuated = sum(1 for r in results if r is not None)
        nbytes = sum(r for r in results if r is not None)
        return evacuated, nbytes, len(results) - evacuated

    def _evacuate_one(self, oid, size: int, targets: list,
                      deadline: float) -> Optional[int]:
        """Hand one object to the first of ``targets`` that takes it
        (each raylet pulls it from us); returns the evacuated byte
        count (0 is a legitimate success — empty objects evacuate too),
        None when every target failed."""
        with self._lock:
            if oid.binary() in self._deferred_frees:
                return 0    # being freed: nothing to preserve (success)
        landed = None
        for target in targets:
            if time.monotonic() > deadline + 30.0:
                # far past the grace window: stop churning so the
                # NODE_DRAINED report (which operators wait on) isn't
                # delayed by minutes on a large store
                return None
            timeout = max(2.0, deadline - time.monotonic() + 10.0)
            try:
                conn = self._conn_cache.get(tuple(target["address"]))
                reply = conn.call("ingest_object",
                                  {"object_id": oid.binary(),
                                   "source": self.node_id.hex(),
                                   "timeout": timeout},
                                  timeout=timeout + 5.0)
            except (ConnectionError, rpc.RpcError, TimeoutError,
                    OSError) as e:
                logger.warning("evacuation of %s to %s failed: %s",
                               oid.hex()[:12], target["node_id"][:8], e)
                continue
            if reply and reply.get("ok"):
                landed = target
                break
        if landed is None:
            return None
        try:
            self.gcs.call("report_object_evacuated",
                          {"object_id": oid.hex(),
                           "node_id": landed["node_id"]}, timeout=5)
        except (ConnectionError, rpc.RpcError, TimeoutError):
            return None  # unregistered copy is invisible: don't count it
        cev.emit(cev.OBJECT_EVACUATED,
                 f"evacuated {oid.hex()[:12]} -> "
                 f"{landed['node_id'][:8]}", severity="DEBUG",
                 object_id=oid.hex(), bytes=size,
                 target_node_id=landed["node_id"])
        return size

    def _rpc_ingest_object(self, conn, p):
        """Receiving side of evacuation: pull ``object_id`` from the
        draining ``source`` node over the transfer plane, publish it
        into local shm and pin it for evac_pin_ttl_s (released early by
        the owner's free, like a prefetch pin).  Runs pooled — the pull
        blocks on the network."""
        from ray_tpu_torch._private.ids import ObjectID
        ob = bytes(p["object_id"])
        oid = ObjectID(ob)
        if self._draining:
            raise rpc.RpcError("node draining: refusing evacuation")
        with self._lock:
            if ob in self._spilled:
                return {"ok": True, "already": True}
        if self.store.contains(oid):
            return {"ok": True, "already": True}
        with self._prefetch_lock:
            if ob in self._prefetch_inflight:
                # a prefetch is mid-pull for the same object: it will
                # land a local copy anyway — report not-ours so the
                # drainer tries another target for durability
                return {"ok": False, "reason": "transfer in flight"}
            self._prefetch_inflight.add(ob)
        try:
            out = self._puller.pull(
                oid, [p["source"]],
                deadline=time.monotonic() + float(p.get("timeout", 30.0)),
                publish_small=True)
            if out.status != "ok" or not out.published:
                return {"ok": False, "reason": out.status}
            with self._prefetch_lock:
                freed = ob in self._prefetch_freed
                if not freed:
                    self._prefetch_pins[ob] = (
                        out.data,
                        time.monotonic() + CONFIG.evac_pin_ttl_s)
                    self._evac_keep.add(ob)
            if freed:
                # freed while we pulled: discard instead of resurrecting
                out.data.release()
                self.store.release(oid)
                self.store.delete(oid)
                return {"ok": False, "reason": "freed during transfer"}
            return {"ok": True, "bytes": out.bytes}
        finally:
            with self._prefetch_lock:
                self._prefetch_inflight.discard(ob)
                self._prefetch_freed.discard(ob)

    def _rpc_was_oom_killed(self, conn, p):
        """Owners distinguish an OOM kill from a plain crash so the
        OOM-specific retry counter applies (reference task_oom_retries)."""
        with self._lock:
            return {"oom": p.get("worker_id") in self._oom_kills}

    def _reap_loop(self) -> None:
        """Detect dead worker processes (cf. WorkerPool child monitoring).
        The loop must survive anything dispatch raises downstream — a
        dead reaper means dead workers are never detected again."""
        while not self._stopped.wait(0.1):
            try:
                with self._lock:
                    handles = list(self._workers.values())
                for h in handles:
                    if h.proc.poll() is not None:
                        self._on_worker_dead(
                            h.worker_id.hex(),
                            f"exit code {h.proc.returncode}")
                self._trim_idle_workers()
            except Exception:
                logger.exception("worker reap pass failed")

    def _trim_idle_workers(self) -> None:
        max_idle = CONFIG.worker_pool_max_idle
        with self._lock:
            idle_ids = [wid for q in self._idle.values() for wid in q]
            excess = len(idle_ids) - max_idle
            victims = []
            if excess > 0:
                now = time.monotonic()
                for wid in idle_ids:
                    h = self._workers.get(wid)
                    if h and now - h.last_idle > 5.0:
                        victims.append(wid)
                        excess -= 1
                        if excess <= 0:
                            break
        for wid in victims:
            self._kill_worker(wid, "idle trim")

    # ------------------------------------------------------------ worker pool
    def _spawn_worker(self, job_id: Optional[str],
                      env_overrides: Optional[Dict[str, str]] = None,
                      language: Optional[str] = None) -> WorkerHandle:
        _M_SPAWNS.inc()
        worker_id = WorkerID.from_random()
        if language == "cpp":
            return self._spawn_cpp_worker(worker_id, job_id, env_overrides)
        if language not in (None, "", "python"):
            raise ValueError(f"unsupported worker language {language!r}")
        from ray_tpu_torch.runtime.node import package_pythonpath
        env = dict(os.environ)
        env.update(env_overrides or {})
        # system-critical keys win over runtime_env env_vars: the child must
        # always be able to import ray_tpu_torch and see the config blob; a user
        # PYTHONPATH is appended, not substituted
        user_pp = (env_overrides or {}).get("PYTHONPATH")
        env["RAY_TPU_TORCH_SYSTEM_CONFIG"] = CONFIG.overrides_env_blob()
        env["PYTHONPATH"] = package_pythonpath() + (
            os.pathsep + user_pp if user_pp else "")
        # a pip runtime env swaps the interpreter for its venv's python
        # (reference PipProcessor + exec hook): isolation is real — the
        # worker process itself runs inside the env, and the venv's
        # site-packages goes FIRST on PYTHONPATH so pinned versions beat
        # any same-named packages living next to ray_tpu_torch
        python = sys.executable
        container = None
        renv_json = (env_overrides or {}).get("RAY_TPU_TORCH_RUNTIME_ENV")
        if renv_json:
            import json as _json
            renv = _json.loads(renv_json)
            container = renv.get("container")
            pip_reqs = renv.get("pip")
            if pip_reqs:
                from ray_tpu_torch.runtime_env.pip import (ensure_pip_env,
                                                     venv_site_packages)
                python = ensure_pip_env(pip_reqs)
                env["PYTHONPATH"] = venv_site_packages(python) + \
                    os.pathsep + env["PYTHONPATH"]
        log_prefix = os.path.join(self.session_dir, "logs",
                                  f"worker-{worker_id.hex()[:12]}")
        os.makedirs(os.path.dirname(log_prefix), exist_ok=True)
        cmd = [python, "-m", "ray_tpu_torch.runtime.worker_main",
               "--raylet-host", self.address[0],
               "--raylet-port", str(self.address[1]),
               "--worker-id", worker_id.hex(),
               "--store-path", self.store_path,
               "--session-dir", self.session_dir,
               "--gcs-host", self.gcs_address[0],
               "--gcs-port", str(self.gcs_address[1]),
               "--node-id", self.node_id.hex()]
        if container:
            # containerized workers exec inside the image (cannot fork
            # off the host zygote); the builder raises a clean error
            # when no container runtime exists on this host
            from ray_tpu_torch.runtime_env.container import wrap_worker_command
            cmd = wrap_worker_command(container, cmd,
                                      session_dir=self.session_dir,
                                      store_path=self.store_path,
                                      env=env)
        # the handle is registered BEFORE the process exists: a zygote-
        # forked child starts running instantly and can win the race to
        # register_worker against this (possibly starved) thread — a
        # missing handle there rejects the registration and the newborn
        # worker dies (observed at the 1k-actor burst: one lost worker
        # per ~50-wave wedged its whole create wave)
        handle = WorkerHandle(worker_id, None)
        handle.job_id = job_id
        with self._lock:
            self._workers[worker_id.hex()] = handle
        proc = None
        if CONFIG.worker_prefork and container is None and \
                python == sys.executable and \
                not _env_needs_exec(env_overrides):
            # stock interpreter, no import-time-sensitive env overrides:
            # fork off the warm zygote (ms) instead of exec+reimport
            # (seconds: the torch import).  Venv workers need
            # their own interpreter -> exec path below.
            try:
                proc = self._zygote_spawn(
                    ["worker_main"] + cmd[3:], env,
                    log_prefix + ".out", log_prefix + ".err")
            except Exception as e:
                logger.warning("zygote spawn failed (%s); exec fallback",
                               e)
                # ambiguous outcome: the zygote may still complete the
                # fork after our timeout.  A fresh worker id keeps that
                # orphan from colliding with the exec'd worker (its
                # registration for the old id is simply rejected).
                with self._lock:
                    self._workers.pop(worker_id.hex(), None)
                worker_id = WorkerID.from_random()
                cmd[cmd.index("--worker-id") + 1] = worker_id.hex()
                handle = WorkerHandle(worker_id, None)
                handle.job_id = job_id
                with self._lock:
                    self._workers[worker_id.hex()] = handle
        if proc is None:
            out_f = err_f = None
            try:
                out_f = open(log_prefix + ".out", "ab")
                err_f = open(log_prefix + ".err", "ab")
                proc = subprocess.Popen(cmd, env=env, stdout=out_f,
                                        stderr=err_f, cwd=os.getcwd())
            except Exception:
                # any failure (incl. EMFILE on the opens) must unregister
                # the pending handle or it ghosts in _workers forever
                with self._lock:
                    self._workers.pop(worker_id.hex(), None)
                raise
            finally:
                for f in (out_f, err_f):   # the child holds its own dups
                    if f is not None:
                        f.close()
        # the pending->real swap and the terminated-flag check happen
        # under the SAME lock _kill_worker signals under: without it, a
        # kill could read the placeholder, lose the race to this swap
        # (which then reads terminated=False), and mark an orphaned
        # placeholder — leaking a live worker (TOCTOU)
        with self._lock:
            pending = handle.proc
            handle.proc = proc
            terminated = getattr(pending, "terminated", False)
        if terminated:
            # a kill landed while the process was still being spawned:
            # apply it now instead of leaking a live worker
            try:
                proc.terminate()
            except OSError:
                pass
        cev.emit(cev.WORKER_SPAWN,
                 f"worker {worker_id.hex()[:8]} spawned",
                 worker_id=worker_id.hex(), job_id=job_id,
                 proc_pid=proc.pid)
        return handle

    # ---------------------------------------------------------- zygote
    def _start_zygote(self) -> None:
        from ray_tpu_torch.runtime.node import package_pythonpath
        env = dict(os.environ)
        env["RAY_TPU_TORCH_SYSTEM_CONFIG"] = CONFIG.overrides_env_blob()
        env["PYTHONPATH"] = package_pythonpath()
        log_prefix = os.path.join(self.session_dir, "logs",
                                  f"zygote-{self.node_id.hex()[:12]}")
        os.makedirs(os.path.dirname(log_prefix), exist_ok=True)
        out_f = open(log_prefix + ".out", "ab")
        err_f = open(log_prefix + ".err", "ab")
        try:
            self._zygote_proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.runtime.worker_zygote",
                 "--socket", self._zygote_sock_path],
                env=env, stdout=out_f, stderr=err_f, cwd=os.getcwd())
        finally:
            out_f.close()
            err_f.close()

    def _zygote_spawn(self, argv, env, out_path, err_path) -> ForkedProc:
        """Fork a worker off the warm zygote; raises on any failure (the
        caller execs instead)."""
        import socket as socketlib

        from ray_tpu_torch.runtime import worker_zygote as wz
        with self._zygote_lock:
            if self._zygote_proc is None or \
                    self._zygote_proc.poll() is not None:
                self._zygote_conn = None
                self._start_zygote()
            if self._zygote_conn is None:
                deadline = time.monotonic() + \
                    CONFIG.worker_start_timeout_s * 2
                while True:
                    try:
                        s = socketlib.socket(socketlib.AF_UNIX,
                                             socketlib.SOCK_STREAM)
                        s.connect(self._zygote_sock_path)
                        self._zygote_conn = s
                        break
                    except OSError:
                        s.close()
                        if self._zygote_proc.poll() is not None:
                            raise RuntimeError("zygote exited "
                                               f"{self._zygote_proc.returncode}")
                        if time.monotonic() > deadline:
                            raise TimeoutError("zygote not ready")
                        time.sleep(0.1)
            conn = self._zygote_conn
            try:
                wz.send_msg(conn, {"argv": argv, "env": env,
                                   "stdout": out_path, "stderr": err_path,
                                   "cwd": os.getcwd()})
                # A slow reply is NOT a dead zygote: under a mass-create
                # burst on a starved core the single-threaded zygote can
                # queue spawns for a long time, and a premature timeout
                # here cascades badly — the exec fallback pays a full
                # interpreter+torch import AND the orphaned fork later
                # registers under the superseded id.  So wait on
                # readability in ticks, timing out only on zygote DEATH
                # or a hard deadline far beyond the start timeout.
                import select
                deadline = time.monotonic() + \
                    CONFIG.worker_start_timeout_s * 4
                while True:
                    r, _, _ = select.select([conn], [], [], 1.0)
                    if r:
                        # readable: the reply frame is tiny, but a torn
                        # write from a dying zygote must not block this
                        # thread (it holds _zygote_lock) forever
                        conn.settimeout(CONFIG.worker_start_timeout_s)
                        try:
                            reply = wz.recv_msg(conn)
                        finally:
                            conn.settimeout(None)
                        break
                    if self._zygote_proc.poll() is not None:
                        raise OSError("zygote died "
                                      f"{self._zygote_proc.returncode}")
                    if time.monotonic() > deadline:
                        raise OSError("zygote reply deadline exceeded")
            except OSError as e:
                try:
                    conn.close()
                finally:
                    self._zygote_conn = None
                raise RuntimeError(f"zygote connection failed: {e}")
            if not reply or "pid" not in reply:
                self._zygote_conn = None
                raise RuntimeError("zygote gave no pid")
            return ForkedProc(reply["pid"])

    def _pick_store_dir(self, store_mem: int) -> str:
        """tmpfs home for the shm segment (plasma convention): big writes
        never generate disk writeback.  Falls back to the session dir
        when the configured dir is missing or can't fit the segment.
        Also sweeps segments leaked by crashed raylets (name embeds the
        creating pid; tmpfs leaks are RAM leaks)."""
        d = CONFIG.object_store_dir
        # sweep leaked segments FIRST: a crashed raylet's multi-GiB
        # segment is the most likely reason the free-space check would
        # fail, and reclaiming it is the point of the sweep
        try:
            for name in os.listdir(d):
                if not name.startswith("ray_tpu_torch_store_"):
                    continue
                try:
                    # ray_tpu_torch_store_<pid>_<node>: the pid is field 4
                    pid = int(name.split("_")[4])
                    os.kill(pid, 0)
                except (IndexError, ValueError):
                    continue
                except ProcessLookupError:
                    try:
                        os.unlink(os.path.join(d, name))
                    except OSError:
                        pass
                except PermissionError:
                    pass     # pid alive under another user
        except OSError:
            pass
        try:
            st = os.statvfs(d)
            if st.f_bavail * st.f_frsize < store_mem:
                return self.session_dir
        except OSError:
            return self.session_dir
        return d

    def _spawn_cpp_worker(self, worker_id, job_id: Optional[str],
                          env_overrides: Optional[Dict[str, str]]
                          ) -> WorkerHandle:
        """Spawn the native C++ worker runtime (csrc/cpp_worker.cc, the
        reference's cpp/ worker analog) for language=cpp leases.  It
        speaks the same worker protocol, so everything downstream (ready
        wait, lease grant, reaping, kill) is language-blind.  The binary
        is the stock one unless cpp_worker_binary points at a user build
        with more registered functions."""
        binary = CONFIG.cpp_worker_binary
        if not binary:
            from ray_tpu_torch.cross_language import NO_CPP_WORKER
            raise RuntimeError(NO_CPP_WORKER)
        if not os.path.exists(binary):
            raise RuntimeError(
                f"cpp worker binary not found at {binary} — set "
                "cpp_worker_binary to a built worker")
        env = dict(os.environ)
        env.update(env_overrides or {})
        log_prefix = os.path.join(self.session_dir, "logs",
                                  f"cppworker-{worker_id.hex()[:12]}")
        os.makedirs(os.path.dirname(log_prefix), exist_ok=True)
        cmd = [binary,
               "--raylet-host", self.address[0],
               "--raylet-port", str(self.address[1]),
               "--worker-id", worker_id.hex(),
               "--gcs-host", self.gcs_address[0],
               "--gcs-port", str(self.gcs_address[1]),
               "--store-path", self.store_path,
               "--node-id", self.node_id.hex()]
        # flag-override channel the binary understands (cf. Config env
        # resolution): keep the inline threshold consistent across
        # languages when tests/system_config change it — but an explicit
        # per-env user override (env_vars) outranks it, like it would for
        # a Python worker
        env.setdefault("RAY_TPU_TORCH_INLINE_OBJECT_MAX_BYTES",
                       str(CONFIG.inline_object_max_bytes))
        out_f = open(log_prefix + ".out", "ab")
        err_f = open(log_prefix + ".err", "ab")
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=out_f,
                                    stderr=err_f, cwd=os.getcwd())
        finally:
            out_f.close()
            err_f.close()
        handle = WorkerHandle(worker_id, proc)
        handle.job_id = job_id
        with self._lock:
            self._workers[worker_id.hex()] = handle
        cev.emit(cev.WORKER_SPAWN,
                 f"cpp worker {worker_id.hex()[:8]} spawned",
                 worker_id=worker_id.hex(), job_id=job_id,
                 proc_pid=proc.pid, language="cpp")
        return handle

    def _rpc_register_worker(self, conn, p):
        """Workers call home once their RPC server is up.

        Runs inline on the reader (fast method): the bookkeeping is a
        short lock hold, and the pending-lease scan — which can spawn
        workers and block — is kicked to its own thread so the reader
        never stalls."""
        wid = p["worker_id"]
        with self._lock:
            h = self._workers.get(wid)
            if h is None:
                raise rpc.RpcError(f"unknown worker {wid}")
            h.address = tuple(p["address"])
            h.conn = conn
            conn.peer = ("worker", wid)
            h.ready.set()
        threading.Thread(target=self._dispatch_pending,
                         daemon=True).start()
        return {"ok": True}

    def _wait_worker_ready(self, h: WorkerHandle) -> bool:
        return h.ready.wait(CONFIG.worker_start_timeout_s)

    def _on_worker_dead(self, wid: str, reason: str) -> None:
        with self._lock:
            h = self._workers.pop(wid, None)
            if h is None:
                return
            for q in self._idle.values():
                if wid in q:
                    q.remove(wid)
            lease = h.lease_id
            actor_id = h.actor_id
            oom = wid in self._oom_kills
        logger.info("worker %s dead: %s", wid[:8], reason)
        if h.proc.poll() is None:
            try:
                h.proc.terminate()
            except OSError:
                pass
        clean = reason == "idle trim"
        cev.emit(cev.WORKER_EXIT,
                 f"worker {wid[:8]} exited: {reason}",
                 severity="INFO" if clean else "ERROR",
                 worker_id=wid, actor_id=actor_id, job_id=h.job_id,
                 reason=reason, exit_code=h.proc.returncode, oom=oom)
        if not clean and not self._stopped.is_set():
            # forensics off-path: flight ring + log tail + metrics
            # watermarks -> GCS dossier, referenced by the propagated
            # WorkerCrashedError/ActorDiedError (docs/observability.md)
            threading.Thread(
                target=self._harvest_dossier,
                args=(wid, h, reason, actor_id, oom), daemon=True).start()
        if lease is not None:
            self._release_lease_resources(lease)
        if actor_id is not None:
            try:
                self.gcs.call("actor_failed", {"actor_id": actor_id,
                                               "reason": reason,
                                               "worker_id": wid})
            except (ConnectionError, rpc.RpcError):
                pass
        self._dispatch_pending()

    def _harvest_dossier(self, wid: str, h: WorkerHandle, reason: str,
                         actor_id: Optional[str], oom: bool) -> None:
        """Assemble + store one dead worker's crash dossier.  Best
        effort end to end: forensics must never destabilize the raylet."""
        import json as _json

        from ray_tpu_torch._private.log_monitor import tail_file
        try:
            events = cev.read_flight_file(self.session_dir, wid)
            tail_n = CONFIG.dossier_log_tail_bytes
            # python workers log as worker-<wid12>.*, cpp workers as
            # cppworker-<wid12>.* (_spawn_cpp_worker): try both or the
            # whole cpp class harvests an empty tail
            log_tail = {}
            for s in ("err", "out"):
                for kind in ("worker", "cppworker"):
                    path = os.path.join(self.session_dir, "logs",
                                        f"{kind}-{wid[:12]}.{s}")
                    tail = tail_file(path, tail_n)
                    if tail:
                        break
                log_tail[s] = tail
            # the dead process's last flushed metrics snapshots (its
            # flusher ident is "<mode>-<wid12>"); watermark gauges in
            # there are the per-interval peaks right before death
            metrics = {}
            try:
                suffix = "/worker-" + wid[:12]
                keys = [k for k in self.gcs.kv_keys("metrics/")
                        if k.endswith(suffix)]
                for key in keys[:48]:
                    raw = self.gcs.kv_get(key)
                    if not raw:
                        continue
                    try:
                        blob = _json.loads(raw)
                    except ValueError:
                        continue
                    metrics[key.split("/", 2)[1]] = blob.get("values")
            except (ConnectionError, rpc.RpcError, TimeoutError):
                pass
            dossier = {
                "kind": "worker", "worker_id": wid,
                "node_id": self.node_id.hex(),
                "actor_id": actor_id, "job_id": h.job_id,
                "pid": h.proc.pid, "reason": reason,
                "exit_code": h.proc.returncode, "oom": oom,
                "events": events, "log_tail": log_tail,
                "metrics": metrics,
                "stacks": self._hang_stacks.pop(wid, None),
            }
            self.gcs.call("put_dossier",
                          {"dossier_id": wid, "dossier": dossier},
                          timeout=10)
        except Exception:
            logger.debug("dossier harvest for %s failed", wid[:8],
                         exc_info=True)

    def _kill_worker(self, wid: str, reason: str,
                     force: bool = False,
                     sample_stacks: bool = False) -> None:
        if sample_stacks:
            # hang-timeout kill: flame-sample the still-live process
            # first so the dossier shows WHERE it was stuck (satellite:
            # profiler wired into the event plane).  Bounded, and only
            # on paths that already waited out a multi-second timeout.
            with self._lock:
                h0 = self._workers.get(wid)
                conn = h0.conn if h0 is not None else None
            if conn is not None:
                try:
                    self._hang_stacks[wid] = conn.call(
                        "profile", {"duration": 0.3}, timeout=5)
                except Exception:
                    pass
        with self._lock:
            h = self._workers.get(wid)
            if h is None:
                return
            try:
                # force=SIGKILL for OOM kills: a SIGTERM trap (or a long
                # native call) would let the hog survive untracked while
                # the monitor serially kills innocent workers (reference
                # memory monitor kills with SIGKILL for the same reason).
                # The read of handle.proc AND the signal both stay under
                # _lock: signaling a _PendingProc placeholder must be
                # ordered against _spawn_worker's swap — either the swap
                # already installed the real proc (we signal it), or our
                # terminated mark is still on the placeholder when the
                # spawner checks it under this same lock.  Signals are
                # non-blocking, so holding the lock here is cheap.
                if force:
                    h.proc.kill()
                else:
                    h.proc.terminate()
            except OSError:
                pass
        self._on_worker_dead(wid, reason)

    def _kill_actor_worker(self, actor_id: str) -> None:
        with self._lock:
            victims = [wid for wid, h in self._workers.items()
                       if h.actor_id == actor_id]
        for wid in victims:
            self._kill_worker(wid, "actor killed")

    # ---------------------------------------------------------------- leases
    def _try_acquire(self, need: Dict[str, float],
                     pool_key: Optional[str] = None
                     ) -> Optional[Tuple[str, ...]]:
        """Deduct ``need`` from the node pool, or from a reserved
        placement-group bundle pool when ``pool_key`` is given, and hand
        the lease its cards.  Returns the cards (empty for a lease with
        no GPU), or None when ``need`` does not fit."""
        with self._res_lock:
            pool = self.available if pool_key is None \
                else self._bundle_pools.get(pool_key)
            if pool is None:
                return None
            if not all(pool.get(r, 0) >= v for r, v in need.items()):
                return None
            cards = self._take_cards(need.get("GPU", 0))
            if cards is None:
                return None
            for r, v in need.items():
                pool[r] = pool.get(r, 0) - v
            return cards

    def _take_cards(self, gpus: float) -> Optional[Tuple[str, ...]]:
        """Cards for a lease of ``gpus``: that many idle cards, rounded
        up, or for a fraction the fullest card it still fits on.  None
        when the free shares are split too finely.  Under _res_lock."""
        if gpus <= 0:
            return ()
        load = self._gpu_load
        if gpus >= 1:
            idle = [c for c, used in load.items() if used <= 1e-9]
            n = int(-(-gpus // 1))
            if len(idle) < n:
                return None
            cards = tuple(idle[:n])
        else:
            fits = [c for c, used in load.items() if used + gpus <= 1 + 1e-9]
            if not fits:
                return None
            cards = (max(fits, key=lambda c: load[c]),)
        for c in cards:
            load[c] += min(gpus, 1.0)
        return cards

    def _give_back(self, need: Dict[str, float], pool_key: Optional[str],
                   cards: Tuple[str, ...] = ()) -> None:
        with self._res_lock:
            pool = self.available
            if pool_key is not None:
                # if the bundle was dropped meanwhile, resources flow back
                # to the node pool (they were carved out of it originally)
                pool = self._bundle_pools.get(pool_key, self.available)
            for r, v in need.items():
                pool[r] = pool.get(r, 0) + v
            for c in cards:
                self._gpu_load[c] -= min(need.get("GPU", 0), 1.0)

    def _release_lease_resources(self, lease_id: str) -> None:
        with self._lock:
            rec = self._leases.pop(lease_id, None)
        if rec:
            self._give_back(rec["need"], rec.get("pool"), rec["cards"])
        self._dispatch_pending()

    # ------------------------------------------------- placement-group 2PC
    def _rpc_reserve_bundle(self, conn, p):
        """Phase-1/2 of GCS bundle reservation: carve the bundle's resources
        out of the node pool into a dedicated pool (cf. reference
        PlacementGroupResourceManager, placement_group_resource_manager.h)."""
        key = f"{p['pg_id']}:{int(p['index'])}"
        need = dict(p["resources"])
        with self._res_lock:
            if key in self._bundle_pools:
                return {"ok": True}  # idempotent retry
            if not all(self.available.get(r, 0) >= v
                       for r, v in need.items()):
                return {"ok": False, "reason": "insufficient resources"}
            for r, v in need.items():
                self.available[r] = self.available.get(r, 0) - v
            self._bundle_pools[key] = dict(need)
        return {"ok": True}

    def _rpc_return_bundle(self, conn, p):
        """Release a bundle pool; whatever is currently free in the pool
        returns to the node. In-flight leases drain back via _give_back."""
        key = f"{p['pg_id']}:{int(p['index'])}"
        return {"ok": self._drop_bundle_pool(key)}

    def _drop_bundle_pool(self, key: str) -> bool:
        with self._res_lock:
            pool = self._bundle_pools.pop(key, None)
            if pool:
                for r, v in pool.items():
                    self.available[r] = self.available.get(r, 0) + v
        return pool is not None

    def _release_stale_bundles(self, keys: list) -> None:
        """A heartbeat reply flagged bundle pools the GCS no longer
        places on this node (docs/fault_tolerance.md: pg removed or
        rescheduled after a member node died while this raylet was
        unreachable — the stranded-reservation leak).  Each key is
        re-verified against fresh GCS state before release so a
        flag computed just before a re-reservation landed here can't
        drop a live pool."""
        for key in keys:
            pgid, _, idx = key.partition(":")
            try:
                pg = self.gcs.call("get_placement_group",
                                   {"pg_id": pgid}, timeout=5)
            except (ConnectionError, rpc.RpcError, TimeoutError):
                continue    # can't verify: keep the pool, retry next beat
            if pg is not None:
                placement = pg.get("placement") or []
                try:
                    i = int(idx)
                except ValueError:
                    continue
                ours = (i < len(placement)
                        and placement[i] == self.node_id.hex())
                if pg.get("state") != "CREATED" or ours:
                    continue    # mid-placement or (again) ours: keep
            if self._drop_bundle_pool(key):
                logger.warning("released stranded placement bundle %s",
                               key)
                self._report_event(
                    "WARNING", "BUNDLE_RECLAIMED",
                    f"stranded placement bundle {key} released",
                    bundle=key)

    def _rpc_lease_worker(self, conn, p):
        """Grant a worker lease, spill to another node, or queue.

        cf. CoreWorkerDirectTaskSubmitter::RequestNewWorkerIfNeeded
        (direct_task_transport.cc:325) on the client side; local-first with
        spillback like the reference HybridSchedulingPolicy
        (scheduling/policy/hybrid_scheduling_policy.h:48)."""
        need = dict(p.get("resources", {}))
        need.setdefault("CPU", 1.0)
        bundle = p.get("bundle")  # [pg_id_hex, index] -> lease from the pool
        pool_key = f"{bundle[0]}:{int(bundle[1])}" if bundle else None
        spillback = int(p.get("spillback", 0))
        if self._draining:
            # draining (docs/fault_tolerance.md): no new leases — not
            # even bundle leases; the group is about to lose this node
            # and the event plane is already driving its failover.
            # Redirects only where the client follows them: a bundle
            # lease or a strategy-pinned request (spillback==2) treats
            # the reply as a final grant, so those get the clean error.
            if pool_key is None and spillback < 2:
                target = self._find_remote_candidate(need)
                if target is not None:
                    return {"retry_at": list(target)}
            raise rpc.RpcError(
                "node draining (preemption imminent): "
                f"{self._drain_reason}")
        if pool_key is None and spillback == 0 and \
                CONFIG.locality_aware_scheduling and p.get("arg_locs"):
            # locality-aware placement (docs/object_transfer.md): on the
            # first hop only (no redirect ping-pong), prefer the feasible
            # node already holding the most argument bytes.  Decided
            # before the env build below: a redirected lease must not
            # pay a cold pip install on the node it is about to leave.
            target = self._locality_candidate(need, p["arg_locs"])
            if target is not None:
                _M_LOCALITY_HITS.inc()
                return {"retry_at": list(target)}
        # cold pip-env builds run here, on the requester's own RPC thread
        # (its lease call is what's waiting) — never inside
        # _dispatch_pending, which register/reap paths also drive
        renv = p.get("env")
        if renv and renv.get("pip"):
            from ray_tpu_torch.runtime_env.pip import ensure_pip_env
            try:
                ensure_pip_env(renv["pip"])
            except Exception as e:
                raise rpc.RpcError(f"runtime env setup failed: {e}")
        if pool_key is not None:
            with self._res_lock:
                if pool_key not in self._bundle_pools:
                    raise rpc.RpcError(
                        f"bundle {pool_key} not reserved on this node")
        if pool_key is None and spillback < 2:
            with self._res_lock:
                local_ok = all(self.available.get(r, 0) >= v
                               for r, v in need.items())
            if not local_ok:
                target = self._find_remote_candidate(need)
                if target is not None:
                    return {"retry_at": list(target)}
        if CONFIG.object_prefetch_enabled and p.get("prefetch"):
            # serving this lease here: start pulling its missing large
            # arguments NOW, overlapping worker spawn/lease wait below —
            # one pool job per argument, so they also overlap each other
            for e in p["prefetch"]:
                self._prefetch_pool.submit(self._prefetch_one, e)
        fut_holder: Dict[str, Any] = {}
        event = threading.Event()
        req = {"key": p.get("key", ""), "resources": p.get("resources", {}),
               "job_id": p.get("job_id"), "env": p.get("env") or {},
               "language": p.get("language"),
               "pool": pool_key, "spillback": spillback,
               "t_queued": time.monotonic(),
               "event": event, "out": fut_holder}
        with self._lock:
            self._pending_leases.append(req)
        self._dispatch_pending()
        if not event.wait(CONFIG.worker_lease_timeout_s):
            with self._lock:
                still_queued = req in self._pending_leases
                if still_queued:
                    self._pending_leases.remove(req)
            if still_queued:
                cev.emit(cev.LEASE_TIMEOUT,
                         f"lease for {need} timed out after "
                         f"{CONFIG.worker_lease_timeout_s:.0f}s",
                         severity="WARNING", job_id=p.get("job_id"),
                         resources=dict(need))
                raise rpc.RpcError("lease request timed out (resources busy)")
            # dispatch popped it concurrently with our timeout: a grant is
            # imminent — wait briefly for it instead of leaking the lease
            event.wait(5.0)
            with self._lock:
                if "grant" not in fut_holder and "error" not in fut_holder:
                    # mark abandoned under the lock; if dispatch fills the
                    # grant later it will see the flag and return the lease
                    req["abandoned"] = True
                    raise rpc.RpcError("lease grant lost in dispatch race")
        if "error" in fut_holder:
            raise rpc.RpcError(fut_holder["error"])
        return fut_holder["grant"]

    def _find_remote_candidate(self, need: Dict[str, float]):
        """Another alive node whose reported availability covers `need`."""
        try:
            nodes = self.gcs.call("list_nodes", timeout=5)
        except (ConnectionError, rpc.RemoteError, TimeoutError):
            return None
        for node in nodes:
            if node["node_id"] == self.node_id.hex() or not node["alive"] \
                    or node.get("draining"):
                continue
            if all(node["available"].get(r, 0) >= v for r, v in need.items()):
                return tuple(node["address"])
        return None

    def _dispatch_pending(self) -> None:
        """Satisfy queued lease requests, first-fit: a request blocked on an
        exhausted bundle pool must not head-of-line-block node-pool leases
        (and vice versa) since they draw from independent pools."""
        while True:
            if self._draining:
                # a request that slipped into the queue as the drain
                # flag flipped must still get a redirect, not a grant
                self._sweep_queued_leases()
                return
            with self._lock:
                req = None
                rescan = False
                for cand in self._pending_leases:
                    need = dict(cand["resources"])
                    need.setdefault("CPU", 1.0)
                    pool_key = cand.get("pool")
                    if pool_key is not None and not self._pool_exists(
                            pool_key):
                        # the bundle was removed while we queued: fail fast
                        self._pending_leases.remove(cand)
                        cand["out"]["error"] = \
                            f"placement bundle {pool_key} removed"
                        cand["event"].set()
                        rescan = True
                        break  # deque mutated mid-iteration; rescan
                    cards = self._try_acquire(need, pool_key)
                    if cards is not None:
                        req = cand
                        break
                if req is None:
                    if rescan:
                        continue
                    return
                self._pending_leases.remove(req)
                # reuse an idle worker for this key that sees the same
                # cards if possible
                q = self._idle.get(req["key"])
                handle = None
                for wid in list(q or ()):
                    h = self._workers.get(wid)
                    if h is None:
                        q.remove(wid)
                    elif h.cards == cards:
                        q.remove(wid)
                        handle = h
                        break
            if handle is None:
                try:
                    handle = self._spawn_worker(
                        req["job_id"],
                        self._merged_env(cards, req.get("env")),
                        language=req.get("language"))
                    handle.cards = cards
                except Exception as e:
                    # e.g. pip runtime-env build failure: the lease's
                    # resources must return and the requester must hear
                    # a clean error, not a stall
                    logger.error("worker spawn failed: %s", e)
                    self._give_back(need, pool_key, cards)
                    req["out"]["error"] = f"worker spawn failed: {e}"
                    req["event"].set()
                    continue
                if not self._wait_worker_ready(handle):
                    self._give_back(need, pool_key, cards)
                    req["out"]["error"] = "worker failed to start"
                    req["event"].set()
                    continue
            lease_id = WorkerID.from_random().hex()
            _M_LEASE.observe((time.monotonic() - req["t_queued"]) * 1000.0)
            grant = {
                "lease_id": lease_id,
                "worker_id": handle.worker_id.hex(),
                "address": list(handle.address),
            }
            with self._lock:
                self._leases[lease_id] = {"need": need, "pool": pool_key,
                                          "cards": cards}
                handle.lease_id = lease_id
                # stamp at lease assignment, not spawn: the OOM policy's
                # LIFO ranks by progress at risk, and a reused idle worker
                # starts fresh work now
                handle.started_at = time.monotonic()
                handle.job_id = req["job_id"]
                abandoned = req.get("abandoned", False)
                if not abandoned:
                    req["out"]["grant"] = grant
            if abandoned:
                # requester gave up during the dispatch race: recycle
                with self._lock:
                    handle.lease_id = None
                    handle.last_idle = time.monotonic()
                    self._idle.setdefault(req["key"], deque()).append(
                        handle.worker_id.hex())
                self._release_lease_resources(lease_id)
            req["event"].set()

    def _pool_exists(self, pool_key: str) -> bool:
        with self._res_lock:
            return pool_key in self._bundle_pools

    @staticmethod
    def _gpu_env(cards: Tuple[str, ...]) -> Dict[str, str]:
        """A worker sees the cards of its lease and no other: none when
        it leased no GPU (hard-part 4)."""
        return {"CUDA_VISIBLE_DEVICES": ",".join(cards)}

    def _merged_env(self, cards: Tuple[str, ...],
                    runtime_env: Optional[dict]) -> Dict[str, str]:
        """GPU visibility env + runtime_env env_vars + the serialized
        descriptor the worker applies at startup (working_dir/py_modules)."""
        env = self._gpu_env(cards)
        if runtime_env:
            env.update(runtime_env.get("env_vars", {}))
            import json as _json
            env["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(runtime_env)
        return env

    def _rpc_return_worker(self, conn, p):
        lease_id = p["lease_id"]
        wid = p["worker_id"]
        key = p.get("key", "")
        with self._lock:
            h = self._workers.get(wid)
            if h is not None and h.lease_id == lease_id:
                h.lease_id = None
                h.last_idle = time.monotonic()
                self._idle.setdefault(key, deque()).append(wid)
        self._release_lease_resources(lease_id)
        return {"ok": True}

    # ---------------------------------------------------------------- actors
    def _rpc_create_actor(self, conn, p):
        """GCS asks us to host an actor: dedicated worker + creation task."""
        t0 = time.monotonic()
        need = dict(p.get("resources", {}))
        need.setdefault("CPU", 1.0)
        bundle = p.get("bundle")
        pool_key = f"{bundle[0]}:{int(bundle[1])}" if bundle else None
        renv = p.get("runtime_env")
        if renv and renv.get("pip"):
            from ray_tpu_torch.runtime_env.pip import ensure_pip_env
            try:
                ensure_pip_env(renv["pip"])   # cold build before resources
            except Exception as e:
                raise rpc.RpcError(f"runtime env setup failed: {e}")
        cards = self._try_acquire(need, pool_key)
        if cards is None:
            raise rpc.RpcError("resources unavailable for actor")
        try:
            handle = self._spawn_worker(
                None, self._merged_env(cards, p.get("runtime_env")),
                language=p.get("language"))
            handle.cards = cards
        except Exception as e:
            self._give_back(need, pool_key, cards)
            raise rpc.RpcError(f"actor worker spawn failed: {e}")
        t_spawn = time.monotonic()
        if not self._wait_worker_ready(handle):
            self._give_back(need, pool_key, cards)
            raise rpc.RpcError("actor worker failed to start")
        t_ready = time.monotonic()
        lease_id = "actor-" + p["actor_id"]
        with self._lock:
            self._leases[lease_id] = {"need": need, "pool": pool_key,
                                      "cards": cards}
            handle.lease_id = lease_id
            handle.started_at = time.monotonic()
            handle.actor_id = p["actor_id"]
        try:
            handle.conn.call("create_actor", {
                "actor_id": p["actor_id"], "spec": p["spec"]},
                timeout=CONFIG.actor_creation_timeout_s)
        except (rpc.RemoteError, ConnectionError, TimeoutError) as e:
            # a TimeoutError here is a hang-timeout kill: sample the
            # wedged __init__'s stacks into the dossier before killing
            self._kill_worker(handle.worker_id.hex(),
                              f"actor init failed: {e}",
                              sample_stacks=isinstance(e, TimeoutError))
            raise rpc.RpcError(f"actor init failed: {e}")
        logger.info(
            "actor %s hosted: spawn %.0fms ready %.0fms init %.0fms",
            p["actor_id"][:8], (t_spawn - t0) * 1e3,
            (t_ready - t_spawn) * 1e3,
            (time.monotonic() - t_ready) * 1e3)
        return {"ok": True, "address": list(handle.address)}

    # ---------------------------------------------------------------- objects
    def _rpc_fetch_object(self, conn, p):
        """Whole-object fetch: one chunk spanning the object."""
        return self._rpc_fetch_object_chunk(conn, p)

    def _rpc_fetch_object_chunk(self, conn, p):
        """Chunked inter-node transfer: one [offset, offset+length) slice
        per call, so a multi-GB object never occupies a multi-GB RPC frame
        on either side (cf. ObjectManager::Push chunked transfer,
        object_manager.cc:338 / push_manager.h:29).

        Runs inline on the reader thread (fast-method registry): a shm hit
        costs one pin plus an enqueued reply frame.  With ``oob`` the
        reply carries the shm slice itself as a pickle-5 out-of-band
        buffer on a *stable* frame — no ``bytes()`` copy per chunk; the
        pin is held until the write drains to the socket (rpc.py stable
        frames).  The spilled/absent path parks behind a Deferred on the
        dispatch pool so the reader never blocks on disk or restores."""
        from ray_tpu_torch._private.ids import ObjectID
        oid = ObjectID(p["object_id"])
        res = self.store.get(oid, timeout=0.0)
        if res is not None:
            value, on_sent = self._chunk_reply(oid, res, p)
            if on_sent is None:
                return value
            d = rpc.Deferred()
            d.resolve(value, stable=True, on_sent=on_sent)
            return d
        d = rpc.Deferred()

        def run():
            try:
                value, on_sent = self._fetch_spilled_chunk(oid, p)
                d.resolve(value, stable=on_sent is not None,
                          on_sent=on_sent)
            except BaseException as e:  # noqa: BLE001 - crosses the wire
                d.fail(e)

        rpc._dispatch_pool().submit(run)
        return d

    def _chunk_reply(self, oid, res, p):
        """-> (reply value, on_sent or None) for a pinned shm hit."""
        buf, meta = res
        total = len(buf)
        off = int(p.get("offset", 0))
        end = min(off + int(p.get("length", total)), total)
        _M_CHUNKS_SERVED.inc()
        _M_CHUNK_BYTES_OUT.inc(max(0, end - off))
        if not p.get("oob"):
            # legacy/serial callers: copy out and release immediately
            try:
                return ({"total": total, "meta": meta,
                         "data": bytes(buf[off:end])}, None)
            finally:
                buf.release()
                self.store.release(oid)
        piece = buf[off:end]

        def _release(piece=piece, buf=buf, oid=oid):
            # fires exactly once when the frame drains (or is dropped):
            # the only store pin this chunk ever took ends here
            piece.release()
            buf.release()
            self.store.release(oid)

        return ({"total": total, "meta": meta,
                 "data": pickle.PickleBuffer(piece)}, _release)

    def _rpc_object_pins(self, conn, p):
        """Pin counts of sealed local objects (tests + `ray-tpu memory`
        debugging: is a prefetch pin / reader still holding this?)."""
        want = set(p.get("object_ids", ())) if p.get("object_ids") else None
        out = {}
        for oid, _size, _tick, pins in self.store.list_objects():
            if want is None or oid.binary() in want:
                out[oid.hex()] = pins
        return out

    # ------------------------------------------------- argument prefetch
    def _gcs_nodes(self, max_age: float) -> list:
        """list_nodes snapshot at most ``max_age`` seconds old ([] when
        the GCS is unreachable and nothing is cached).  One cache serves
        locality placement and prefetch address resolution — the lease
        path must not pay a GCS round trip per request."""
        ts, nodes = self._nodes_snapshot
        now = time.monotonic()
        if now - ts > max_age:
            try:
                nodes = self.gcs.call("list_nodes", timeout=2)
            except (ConnectionError, rpc.RpcError, TimeoutError):
                return nodes  # stale beats nothing
            self._nodes_snapshot = (now, nodes)
        return nodes

    def _peer_address(self, node_hex: str) -> Optional[Tuple[str, int]]:
        """node hex -> raylet address (prefetch pulls resolve many
        sources per lease wave, so tolerate a 5 s-stale snapshot)."""
        for n in self._gcs_nodes(5.0):
            if n["node_id"] == node_hex and n.get("alive"):
                return tuple(n["address"])
        return None

    def _prefetch_one(self, e: dict) -> None:
        """Pull one lease argument into local shm concurrently with
        worker lease/startup (docs/object_transfer.md: transfer overlaps
        scheduling instead of serializing after it).  Runs on the
        bounded prefetch pool; the lease grant never waits for it."""
        from ray_tpu_torch._private.ids import ObjectID
        ob = bytes(e["object_id"])
        oid = ObjectID(ob)
        _M_PREFETCH_REQS.inc()
        with self._prefetch_lock:
            if ob in self._prefetch_pins or ob in self._prefetch_inflight:
                _M_PREFETCH_HITS.inc()
                return
            self._prefetch_inflight.add(ob)
        try:
            with self._lock:
                spilled_here = ob in self._spilled
            if spilled_here or self.store.contains(oid):
                # already on this node (shm or our spill dir): the
                # task's own fetch restores/pins it on demand
                _M_PREFETCH_HITS.inc()
                return
            sources = [nh for nh in e.get("locations", ())
                       if nh != self.node_id.hex()]
            if not sources:
                return
            out = self._puller.pull(
                oid, sources,
                deadline=time.monotonic() + CONFIG.prefetch_pin_ttl_s,
                publish_small=True)
            if out.status != "ok" or not out.published:
                return
            with self._prefetch_lock:
                freed = ob in self._prefetch_freed
                if not freed:
                    self._prefetch_pins[ob] = (
                        out.data,
                        time.monotonic() + CONFIG.prefetch_pin_ttl_s)
            if freed:
                # freed while we were pulling: discard the resurrected
                # copy instead of pinning bytes nobody can ever use
                out.data.release()
                self.store.release(oid)
                self.store.delete(oid)
                return
            _M_PREFETCH_BYTES.inc(out.bytes)
            owner = e.get("owner")
            if owner:
                # grow the owner's location set: the final free must
                # sweep this copy, and later pulls can stripe off us
                try:
                    conn = self._conn_cache.get(tuple(owner))
                    conn.call_async(
                        "report_object_location",
                        {"object_id": ob,
                         "node_id": self.node_id.hex(),
                         "size": out.bytes})
                except Exception:
                    pass
        except Exception:
            logger.exception("argument prefetch failed for %s",
                             oid.hex()[:12])
        finally:
            with self._prefetch_lock:
                self._prefetch_inflight.discard(ob)
                self._prefetch_freed.discard(ob)

    def _release_prefetch_pin(self, ob: bytes) -> None:
        with self._prefetch_lock:
            rec = self._prefetch_pins.pop(ob, None)
            self._evac_keep.discard(ob)
        if rec is None:
            return
        view, _exp = rec
        try:
            view.release()
        except (BufferError, AttributeError):
            pass
        from ray_tpu_torch._private.ids import ObjectID
        self.store.release(ObjectID(ob))

    def _reap_prefetch_pins(self) -> None:
        """Safety net (spill loop, every 0.2 s): a pin whose lease never
        dispatched — request timed out, task cancelled before dispatch —
        must not keep its bytes unevictable forever."""
        now = time.monotonic()
        with self._prefetch_lock:
            expired = [ob for ob, (_v, exp) in self._prefetch_pins.items()
                       if exp <= now]
        for ob in expired:
            self._release_prefetch_pin(ob)

    def _locality_candidate(self, need: Dict[str, float],
                            arg_locs: Dict[str, float]):
        """The feasible node already holding strictly more argument bytes
        than this one, if any (reference locality-aware lease policy /
        locality_data_provider): its address, else None."""
        local_bytes = float(arg_locs.get(self.node_id.hex(), 0.0))
        best = None
        best_bytes = local_bytes
        nodes = self._gcs_nodes(1.0)
        for node in nodes:
            nh = node["node_id"]
            if nh == self.node_id.hex() or not node.get("alive") \
                    or node.get("draining"):
                continue
            nbytes = float(arg_locs.get(nh, 0.0))
            if nbytes <= best_bytes or \
                    nbytes < CONFIG.locality_min_arg_bytes:
                continue
            if all(node["available"].get(r, 0) >= v
                   for r, v in need.items()):
                best = tuple(node["address"])
                best_bytes = nbytes
        return best

    def _rpc_list_workers(self, conn, p):
        """Registered worker processes on this node (state API fan-out)."""
        with self._lock:
            return [{
                "worker_id": wid,
                "address": list(h.address) if h.address else None,
                "actor_id": h.actor_id,
                "job_id": h.job_id,
                "pid": h.proc.pid,
                "alive": h.proc.poll() is None,
            } for wid, h in self._workers.items()]

    def _rpc_store_stats(self, conn, p):
        return self.store.stats()

    def _rpc_node_info(self, conn, p):
        with self._res_lock:
            return {"node_id": self.node_id.hex(),
                    "resources": dict(self.resources),
                    "available": dict(self.available),
                    "bundles": list(self._bundle_pools),
                    "draining": self._draining,
                    "num_workers": len(self._workers),
                    "oom_kill_count": self._oom_kill_count,
                    "memory_usage": self._memory_monitor.last_usage,
                    "store_path": self.store_path}

    # ------------------------------------------------------------------ stop
    def shutdown(self) -> None:
        self._stopped.set()
        # unhook telemetry publishing bound to this raylet's GCS client
        rtm.detach(self.gcs.kv_put)
        rtm.remove_gauge_callback("ray_tpu_worker_pool_size")
        cev.detach(self._events_recorder)
        if self._log_monitor is not None:
            self._log_monitor.stop()
        with self._lock:
            handles = list(self._workers.values())
            self._workers.clear()
        for h in handles:
            try:
                h.proc.terminate()
            except OSError:
                pass
        for h in handles:
            try:
                h.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                h.proc.kill()
        if self._zygote_conn is not None:
            try:
                self._zygote_conn.close()
            except OSError:
                pass
        if self._zygote_proc is not None:
            self._zygote_proc.terminate()
            try:
                self._zygote_proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self._zygote_proc.kill()
        self._server.stop()
        self._prefetch_pool.shutdown(wait=False)
        self._conn_cache.close()
        with self._prefetch_lock:
            pins = list(self._prefetch_pins)
        for ob in pins:
            self._release_prefetch_pin(ob)
        try:
            self.gcs.close()
        except Exception:
            pass
        self.store.close()
        self.store.unlink()
        import shutil
        shutil.rmtree(self._spill_dir, ignore_errors=True)


def main():  # pragma: no cover - subprocess entry
    import argparse
    import json
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--address-file", default=None)
    parser.add_argument("--labels", default="{}")
    args = parser.parse_args()
    from ray_tpu_torch._private.logging_utils import (enable_stack_dumps,
                                                 setup_component_logging)
    setup_component_logging("raylet", args.session_dir)
    enable_stack_dumps(args.session_dir)
    resources = json.loads(args.resources) or None
    raylet = Raylet((args.gcs_host, args.gcs_port), args.session_dir,
                    resources=resources,
                    object_store_memory=args.object_store_memory or None,
                    labels=json.loads(args.labels) or None)
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": raylet.address[0], "port": raylet.address[1],
                       "node_id": raylet.node_id.hex(),
                       "store_path": raylet.store_path}, f)
        os.replace(tmp, args.address_file)
    logger.info("raylet %s serving at %s", raylet.node_id.hex()[:8],
                raylet.address)
    # the driver stops its raylet with SIGTERM: shut down as on ^C, or
    # the store segment (tmpfs: RAM) stays until a later raylet's sweep
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        raylet.shutdown()


if __name__ == "__main__":
    main()
