"""Cluster event plane + failure flight recorder.

The runtime's *metrics* plane (``runtime_metrics.py``) answers "how fast
is it"; this module answers "what happened" — and, after a death, "why".
Three pieces (docs/observability.md):

* **EventRecorder** — a bounded, lock-cheap per-process recorder of
  typed lifecycle events (node up/down, worker spawn/exit, actor
  restart, lease timeout, object spill/restore, transfer source
  failover, collective rank death, serve replica retire/autoscale).
  ``emit()`` is one dict build + two deque appends; a background
  flusher (same cadence philosophy as the ``runtime_metrics`` flusher:
  periodic, dirty-only, never on the hot path) batches events to the
  GCS and — this is the flight-recorder half — atomically dumps the
  in-memory ring to a per-process *flight file* on disk, so the last N
  events survive the process that recorded them.  ``ring_only=True``
  events (per-task breadcrumbs) stay out of the GCS batch but land in
  the ring/flight file, so a crash dossier shows what the worker was
  doing without the cluster table drowning in per-task noise.

* **GcsClusterEventTable** — the GCS-side aggregation point (the Ray
  paper's GCS-centric design makes the control store the natural home
  for cluster-wide lifecycle state): sharded deques, retention bounded
  by BOTH a max event count (``gcs_max_cluster_events``) and a max
  byte budget (``gcs_events_max_bytes``), queryable with filters
  (node/job/actor/worker/severity/type) via
  ``experimental.state.list_cluster_events()`` / ``ray-tpu events``.

* **Dossiers** — on an abnormal worker exit the raylet harvests the
  worker's flight file, the tail of its logs and its last metrics
  watermarks into a crash dossier stored in the GCS (bounded,
  ``gcs_max_dossiers``); ``RayTaskError``-family exceptions carry a
  ``dossier_id`` and ``.debug_dossier()`` fetches + pretty-prints it
  at the driver.

Kill switch: ``RAY_TPU_TORCH_EVENTS=0`` (or ``CONFIG.events_enabled=False``)
swaps the recorder for a no-op — ``emit()`` returns after one global
read, the flusher never starts, and nothing is written anywhere
(mirrors ``RAY_TPU_TORCH_TELEMETRY``; benchmarks/telemetry_overhead.py
--events holds the on-cost to the same <= 3% bar).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import CONFIG

# ------------------------------------------------------------ event types
# node lifecycle (emitted by the GCS)
NODE_UP = "NODE_UP"
NODE_DEAD = "NODE_DEAD"
NODE_UNHEALTHY = "NODE_UNHEALTHY"
NODE_HEALTHY = "NODE_HEALTHY"
# preemption lifecycle (docs/fault_tolerance.md): a drain request marks
# the node PREEMPTING with a grace deadline; the raylet stops granting
# leases, lets short tasks finish, evacuates primary copies, then
# reports DRAINED with the evacuation ledger
NODE_PREEMPTING = "NODE_PREEMPTING"
NODE_DRAINED = "NODE_DRAINED"
OBJECT_EVACUATED = "OBJECT_EVACUATED"
# worker lifecycle (emitted by the raylet)
WORKER_SPAWN = "WORKER_SPAWN"
WORKER_EXIT = "WORKER_EXIT"
OOM_KILL = "OOM_KILL"
# actor FSM (emitted by the GCS)
ACTOR_RESTARTING = "ACTOR_RESTARTING"
ACTOR_DEAD = "ACTOR_DEAD"
# scheduling
LEASE_TIMEOUT = "LEASE_TIMEOUT"
# object store
OBJECT_SPILL = "OBJECT_SPILL"
OBJECT_RESTORE = "OBJECT_RESTORE"
SPILL_WRITE_FAILED = "SPILL_WRITE_FAILED"
OUT_OF_DISK = "OUT_OF_DISK"
# data planes
TRANSFER_FAILOVER = "TRANSFER_FAILOVER"
COLLECTIVE_RANK_DEATH = "COLLECTIVE_RANK_DEATH"
COLLECTIVE_RING_STALL = "COLLECTIVE_RING_STALL"
# serving
REPLICA_RETIRED = "REPLICA_RETIRED"
AUTOSCALE = "AUTOSCALE"
# SLO-driven pool re-roling (docs/serve_frontdoor.md): the controller
# moves a replica between a <base>-prefill/<base>-decode pair — REROLE
# opens when the donor replica starts draining, REROLE_DONE closes when
# the receiver pool is healthy at its new target and the donor retired
SERVE_REROLE = "SERVE_REROLE"
SERVE_REROLE_DONE = "SERVE_REROLE_DONE"
# training performance plane (emitted by the GCS step-stats table,
# docs/observability.md): a gang rank's step time crossed
# median + k*MAD — the degraded rank names itself (rank/step/phase)
# instead of silently dragging the allreduce
TRAIN_STRAGGLER = "TRAIN_STRAGGLER"
# elastic gang recovery (docs/fault_tolerance.md): the trainer driver
# detected rank/node death (event plane or poll failure), re-formed the
# gang and resumed from the latest reported checkpoint
TRAIN_GANG_RECOVERY = "TRAIN_GANG_RECOVERY"
# RL podracer fleet (docs/rl_podracer.md): a rollout actor's stream
# died (preemption/crash) — the learner keeps stepping on the survivors
# — and the replacement actor finished rendezvous (weights pulled,
# stream re-established).  The recovery auditor pairs them per fleet
# slot into `rl_actor` episodes.
RL_ACTOR_LOST = "RL_ACTOR_LOST"
RL_ACTOR_JOINED = "RL_ACTOR_JOINED"
# flight-recorder breadcrumbs (ring_only by convention)
TASK_RUNNING = "TASK_RUNNING"
TASK_FAILED = "TASK_FAILED"

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def enabled() -> bool:
    """Kill switch: RAY_TPU_TORCH_EVENTS env wins, then the config flag."""
    raw = os.environ.get("RAY_TPU_TORCH_EVENTS")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return CONFIG.events_enabled


class EventRecorder:
    """Per-process event ring + GCS flusher + flight file.

    ``emit()`` never blocks on IO: it appends to the bounded ring (and,
    unless ``ring_only``, to the unflushed batch) under one short lock;
    the flusher thread ships batches and rewrites the flight file."""

    def __init__(self, *, sink: Optional[Callable[[List[dict]], Any]] = None,
                 source: str = "proc", node_id: str = "",
                 worker_id: str = "", job_id: str = "",
                 flight_path: Optional[str] = None):
        self._sink = sink
        self.source = source
        self._defaults = {"node_id": node_id, "worker_id": worker_id,
                          "job_id": job_id, "pid": os.getpid()}
        self._ring: deque = deque(maxlen=max(16, CONFIG.event_ring_size))
        self._unflushed: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flight_path = flight_path
        self._ring_dirty = False

    def emit(self, etype: str, message: str = "", *,
             severity: str = "INFO", ring_only: bool = False,
             **fields: Any) -> None:
        ev = {"ts": time.time(), "type": etype, "severity": severity,
              "source": self.source, "message": message}
        ev.update(self._defaults)
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            self._ring.append(ev)
            self._ring_dirty = True
            if not ring_only and self._sink is not None \
                    and not self._stop.is_set():
                self._unflushed.append(ev)
            start = (self._thread is None
                     and (self._sink is not None or self._flight_path)
                     and not self._stop.is_set())
            if start:
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name="cluster-events-flush")
                self._thread.start()

    def ring_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def flush(self) -> None:
        """One flusher tick: ship the unflushed batch (re-queued on a
        sink failure — the GCS going away must never kill the process)
        and rewrite the flight file if the ring changed."""
        with self._lock:
            batch, self._unflushed = self._unflushed, []
            dirty, self._ring_dirty = self._ring_dirty, False
            ring = list(self._ring) if (dirty and self._flight_path) \
                else None
        if batch and self._sink is not None:
            try:
                self._sink(batch)
            except Exception:
                # sink down (GCS outage): re-queue, but bound the
                # COMBINED backlog — keep only the newest ring's worth,
                # or a long outage grows memory (and the retry payload)
                # by the emission rate for its whole duration
                with self._lock:
                    self._unflushed = (batch + self._unflushed)[
                        -max(16, CONFIG.event_ring_size):]
        if ring is not None:
            self._write_flight(ring)

    def _write_flight(self, ring: List[dict]) -> None:
        """Atomic (tmp+rename) dump of the ring so a SIGKILL mid-write
        can't leave the raylet harvesting a torn file."""
        try:
            tmp = f"{self._flight_path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(ring, f, default=str)
            os.replace(tmp, self._flight_path)
        except OSError:
            pass

    def _flush_loop(self) -> None:
        period = max(0.05, CONFIG.events_flush_interval_ms / 1000.0)
        while not self._stop.wait(period):
            self.flush()
        self.flush()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self.flush()


# -------------------------------------------------- module-level recorder
_recorder: Optional[EventRecorder] = None
_rec_lock = threading.Lock()


def configure(*, sink: Optional[Callable[[List[dict]], Any]],
              source: str, node_id: str = "", worker_id: str = "",
              job_id: str = "",
              flight_path: Optional[str] = None) -> Optional[EventRecorder]:
    """Bind this process's recorder (one per process; a fresh init()
    replaces it).  No-op returning None when the plane is disabled —
    every ``emit()`` then costs one global read."""
    global _recorder
    with _rec_lock:
        old, _recorder = _recorder, None
    if old is not None:
        old.stop()
    # raylint: disable=kill-switch -- configure() runs once per init(), not per emit; emit()'s own guard is one global read
    if not enabled():
        return None
    rec = EventRecorder(sink=sink, source=source, node_id=node_id,
                        worker_id=worker_id, job_id=job_id,
                        flight_path=flight_path)
    with _rec_lock:
        _recorder = rec
    return rec


def detach(rec: Optional[EventRecorder] = None) -> None:
    """Unbind at owner shutdown; with ``rec`` given, only if it is
    still the active recorder (a newer owner's configure survives)."""
    global _recorder
    with _rec_lock:
        if rec is None or _recorder is rec:
            old, _recorder = _recorder, None
        else:
            old = None
    if old is not None:
        old.stop()


def emit(etype: str, message: str = "", *, severity: str = "INFO",
         ring_only: bool = False, **fields: Any) -> None:
    """Record one typed event on this process's recorder (dropped when
    the plane is disabled or the process never configured one)."""
    rec = _recorder
    if rec is not None:
        rec.emit(etype, message, severity=severity, ring_only=ring_only,
                 **fields)


def ring_snapshot() -> List[dict]:
    rec = _recorder
    return rec.ring_snapshot() if rec is not None else []


def flight_file_name(worker_id_hex: str) -> str:
    """Flight-file basename for a worker id — the raylet derives the
    same name to harvest the ring post-mortem."""
    return f"flight-{worker_id_hex[:12]}.json"


def read_flight_file(session_dir: str, worker_id_hex: str) -> List[dict]:
    """Best-effort read of a (possibly dead) worker's flight ring."""
    path = os.path.join(session_dir, "logs",
                        flight_file_name(worker_id_hex))
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, list) else []
    except (OSError, ValueError):
        return []


# ------------------------------------------------------- GCS event table
class GcsClusterEventTable:
    """Sharded, retention-bounded cluster event store.

    Shards keep appends lock-cheap under many concurrent flusher
    batches; retention is bounded twice — per-shard event count derived
    from ``gcs_max_cluster_events`` and a table-wide byte budget
    (``gcs_events_max_bytes``, measured as the JSON size of each
    record) so a chatty cluster can never grow GCS memory without
    bound.  Queries merge shards and sort by timestamp."""

    NSHARDS = 8

    def __init__(self, max_events: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.max_events = max_events or CONFIG.gcs_max_cluster_events
        self.max_bytes = max_bytes or CONFIG.gcs_events_max_bytes
        per = max(4, self.max_events // self.NSHARDS)
        self._shards = [deque() for _ in range(self.NSHARDS)]
        self._locks = [threading.Lock() for _ in range(self.NSHARDS)]
        self._per_shard = per
        self._bytes = 0
        self._bytes_lock = threading.Lock()
        self._counts: Dict[str, int] = {}   # type -> total ever seen
        self._rr = 0

    def _shard_of(self, ev: dict) -> int:
        # round-robin, NOT keyed on node/worker id: a single-node
        # cluster (the common dev topology) would otherwise pile every
        # event into one shard and silently cap retention at
        # max_events/NSHARDS.  Queries merge+sort across shards, so
        # placement carries no meaning — the shards exist only to keep
        # concurrent flusher batches off one lock.
        self._rr = (self._rr + 1) % self.NSHARDS
        return self._rr

    @staticmethod
    def _size_of(ev: dict) -> int:
        try:
            return len(json.dumps(ev, default=str))
        except (TypeError, ValueError):
            return 256

    def put(self, events: List[dict]) -> int:
        """Merge one batch; returns how many old events rotation
        dropped.  Events missing a timestamp are stamped on arrival."""
        dropped = 0
        for ev in events:
            if not isinstance(ev, dict) or not ev.get("type"):
                continue
            ev.setdefault("ts", time.time())
            ev.setdefault("severity", "INFO")
            size = self._size_of(ev)
            i = self._shard_of(ev)
            with self._locks[i]:
                shard = self._shards[i]
                shard.append((ev, size))
                evicted = []
                while len(shard) > self._per_shard:
                    evicted.append(shard.popleft())
                    dropped += 1
            delta = size - sum(s for _e, s in evicted)
            with self._bytes_lock:
                # _counts shares this lock: concurrent batches land on
                # DIFFERENT shards, so a per-shard lock can't order two
                # read-modify-writes of the same type's counter
                self._bytes += delta
                self._counts[ev["type"]] = \
                    self._counts.get(ev["type"], 0) + 1
        # byte budget: evict oldest-first round-robin across shards
        # (outside the per-event loop so one oversized batch settles in
        # one sweep)
        while True:
            with self._bytes_lock:
                if self._bytes <= self.max_bytes:
                    break
            victim = None
            oldest = None
            for i in range(self.NSHARDS):
                with self._locks[i]:
                    if self._shards[i]:
                        ts = self._shards[i][0][0].get("ts", 0)
                        if oldest is None or ts < oldest:
                            oldest, victim = ts, i
            if victim is None:
                break
            with self._locks[victim]:
                if not self._shards[victim]:
                    continue
                _ev, size = self._shards[victim].popleft()
            dropped += 1
            with self._bytes_lock:
                self._bytes -= size
        return dropped

    def list(self, *, node_id: Optional[str] = None,
             job_id: Optional[str] = None,
             actor_id: Optional[str] = None,
             worker_id: Optional[str] = None,
             severity: Optional[str] = None,
             min_severity: Optional[str] = None,
             etype: Optional[str] = None,
             source: Optional[str] = None,
             limit: int = 1000) -> List[dict]:
        out: List[dict] = []
        for i in range(self.NSHARDS):
            with self._locks[i]:
                rows = [ev for ev, _s in self._shards[i]]
            for ev in rows:
                if node_id and not str(ev.get("node_id", "")).startswith(
                        node_id):
                    continue
                if worker_id and not str(ev.get("worker_id", "")
                                         ).startswith(worker_id):
                    continue
                if job_id and not str(ev.get("job_id", "")).startswith(
                        job_id):
                    continue
                if actor_id and not str(ev.get("actor_id", "")
                                        ).startswith(actor_id):
                    continue
                if severity and ev.get("severity") != severity:
                    continue
                if min_severity and _SEV_RANK.get(
                        ev.get("severity", "INFO"), 1) < _SEV_RANK.get(
                        min_severity, 0):
                    continue
                if etype and ev.get("type") != etype:
                    continue
                if source and ev.get("source") != source:
                    continue
                out.append(ev)
        out.sort(key=lambda e: e.get("ts", 0))
        # copy only the returned tail: records are immutable after
        # put(), and an unfiltered query over 20k retained events must
        # not build 20k dict copies to return 200
        return [dict(ev) for ev in out[-max(0, int(limit)):]]

    def counts_by_type(self) -> Dict[str, int]:
        """Total events ever recorded per type (survives rotation —
        the metrics_summary 'top event types' view)."""
        with self._bytes_lock:
            return dict(self._counts)

    def stats(self) -> dict:
        with self._bytes_lock:
            nbytes = self._bytes
        return {"events": sum(len(s) for s in self._shards),
                "bytes": nbytes, "max_events": self.max_events,
                "max_bytes": self.max_bytes}


# ------------------------------------------------------------- dossiers
def fetch_dossier(dossier_id: str, timeout: float = 10.0
                  ) -> Optional[dict]:
    """Driver-side dossier fetch by id (worker id hex for worker
    deaths, node id hex for node deaths) via the connected cluster."""
    from ray_tpu_torch.runtime import core_worker as cw
    worker = cw.get_global_worker()
    if worker is None:
        return None
    return worker.gcs.call("get_dossier", {"dossier_id": dossier_id},
                           timeout=timeout)


def format_dossier(d: dict) -> str:
    """Human-readable crash dossier (``.debug_dossier()`` and
    ``ray-tpu events --dossier``)."""
    if not d:
        return "(no dossier)"
    lines = []
    kind = d.get("kind", "worker")
    ident = d.get("worker_id") or d.get("node_id") or "?"
    lines.append(f"=== crash dossier: {kind} {str(ident)[:16]} ===")
    for key in ("reason", "exit_code", "oom", "node_id", "worker_id",
                "actor_id", "job_id", "pid", "ts"):
        if d.get(key) not in (None, ""):
            val = d[key]
            if key == "ts":
                val = time.strftime("%Y-%m-%d %H:%M:%S",
                                    time.localtime(val))
            lines.append(f"{key:>10}: {val}")
    health = d.get("health")
    if health:
        lines.append(f"{'health':>10}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(health.items())))
    events = d.get("events") or []
    if events:
        lines.append(f"-- last {len(events)} events --")
        for ev in events[-40:]:
            ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
            extra = ev.get("message") or ev.get("name") or ""
            lines.append(f"  {ts} [{ev.get('severity', '?'):7s}] "
                         f"{ev.get('type', ev.get('state', '?')):22s} "
                         f"{extra}")
    metrics = d.get("metrics") or {}
    if metrics:
        lines.append("-- last metrics watermarks --")
        for name, values in sorted(metrics.items()):
            lines.append(f"  {name}: {values}")
    stacks = d.get("stacks")
    if stacks:
        lines.append("-- stacks at kill (folded, top) --")
        from ray_tpu_torch._private.profiler import top_summary
        if isinstance(stacks, dict):
            lines.append(top_summary(stacks))
        else:
            lines.append(str(stacks))
    for stream in ("err", "out"):
        tail = (d.get("log_tail") or {}).get(stream)
        if tail:
            lines.append(f"-- log tail ({stream}) --")
            lines.append(tail.rstrip())
    return "\n".join(lines)
