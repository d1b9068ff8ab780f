"""Task state-transition events: per-worker buffer -> GCS task table.

Analog of the reference's TaskEventBuffer
(/root/reference/src/ray/core_worker/task_event_buffer.h:48): every worker
batches per-task state transitions and periodically flushes them to the GCS
(`TaskInfoGcsService`, gcs_service.proto:635), powering `list tasks`,
`summary`, and the Chrome-trace timeline.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import CONFIG

# Task lifecycle states (cf. reference common.proto TaskStatus).
SUBMITTED = "SUBMITTED"
PENDING_NODE_ASSIGNMENT = "PENDING_NODE_ASSIGNMENT"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
# instant markers (timeline dots, not lifecycle transitions): they never
# update a record's state — a streaming task stays RUNNING while its
# per-yield STREAM_ITEM instants accumulate, a PULL (one inter-node
# object transfer for the task's output, docs/object_transfer.md) rides
# whatever lifecycle state the task is in, a COLLECTIVE (one host-
# collective op on a rank's synthetic ``col-<group>-r<rank>`` record,
# docs/collective.md) never has a lifecycle at all, and a HANDOFF (one
# export/import leg of a disaggregated-serving KV handoff on a
# synthetic ``handoff-<object>`` record, docs/serve_disagg.md) likewise.
# A STEP (one clocked train step with its phase breakdown on a rank's
# synthetic ``step-<run>-r<rank>`` record, docs/observability.md) is
# the training-performance-plane sibling of COLLECTIVE/HANDOFF.
STREAM_ITEM = "STREAM_ITEM"
PULL = "PULL"
COLLECTIVE = "COLLECTIVE"
HANDOFF = "HANDOFF"
STEP = "STEP"
_INSTANT_STATES = frozenset({STREAM_ITEM, PULL, COLLECTIVE, HANDOFF, STEP})

_STATE_RANK = {SUBMITTED: 1, PENDING_NODE_ASSIGNMENT: 2, RUNNING: 3,
               FINISHED: 4, FAILED: 4}

# per-record event-list bound: long streams / chatty spans must not grow
# one task's record without limit (the first and last halves survive)
_EVENTS_PER_TASK_CAP = 512


class TaskEventBuffer:
    """Thread-safe ring buffer of task events with a periodic GCS flusher.

    Records stay available locally (``snapshot()``) even when GCS export is
    disabled (no gcs client, e.g. unit tests driving a bare CoreWorker).
    """

    def __init__(self, gcs=None, *, job_id: str = "", node_id: str = "",
                 worker_id: str = ""):
        self._gcs = gcs
        self._defaults = {"job_id": job_id, "node_id": node_id,
                          "worker_id": worker_id}
        self._buf: deque = deque(maxlen=CONFIG.task_events_buffer_size)
        self._unflushed: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def record(self, task_id: str, state: str, *, name: str = "",
               **extra: Any) -> None:
        if self._stop.is_set():
            return  # stopped: a late event must not restart the flusher
        ev = {"task_id": task_id, "state": state, "name": name,
              "ts": time.time()}
        ev.update(self._defaults)
        ev.update(extra)
        with self._lock:
            self._buf.append(ev)
            if self._gcs is not None:
                self._unflushed.append(ev)
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._flush_loop, daemon=True,
                        name="task-events-flush")
                    self._thread.start()

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._buf)

    def flush(self) -> None:
        with self._lock:
            batch, self._unflushed = self._unflushed, []
        if not batch or self._gcs is None:
            return
        try:
            self._gcs.call("task_events_put", {"events": batch}, timeout=5)
        except Exception:
            # GCS going away must never take a worker down with it; events
            # are best-effort observability data.
            with self._lock:
                if len(self._unflushed) < CONFIG.task_events_buffer_size:
                    self._unflushed = batch + self._unflushed

    def _flush_loop(self) -> None:
        period = CONFIG.task_events_flush_interval_ms / 1000.0
        while not self._stop.wait(period):
            self.flush()

    def stop(self) -> None:
        """Idempotent shutdown: stop the flusher, push the tail batch,
        and JOIN the flush thread — without the join, a final in-flight
        ``flush()`` races this one for the same batch and can re-queue
        events into a buffer nobody will ever drain again."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self.flush()


class GcsTaskTable:
    """GCS-side task table: merges event batches into per-task records.

    Bounded at ``CONFIG.gcs_max_task_events`` tasks; oldest terminal tasks
    are evicted first (cf. reference GcsTaskManager's task-event GC).
    """

    def __init__(self):
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._order: deque = deque()  # task ids in first-seen order
        self._lock = threading.Lock()

    def put_events(self, events: List[dict]) -> int:
        dropped = 0
        with self._lock:
            for ev in events:
                tid = ev["task_id"]
                rec = self._tasks.get(tid)
                if rec is None:
                    rec = {"task_id": tid, "name": ev.get("name", ""),
                           "job_id": ev.get("job_id", ""),
                           "state": "", "events": []}
                    self._tasks[tid] = rec
                    self._order.append(tid)
                for field in ("name", "job_id", "actor_id", "func_or_class",
                              "error_type", "trace_id"):
                    if ev.get(field):
                        rec[field] = ev[field]
                # execution attribution: node/worker come from the executing
                # worker's RUNNING event; the owner's SUBMITTED/FINISHED
                # events carry the *driver's* ids and must not stomp them
                if ev["state"] == RUNNING or "worker_id" not in rec:
                    for field in ("node_id", "worker_id"):
                        if ev.get(field):
                            rec[field] = ev[field]
                # out-of-order delivery: a worker's RUNNING may arrive after
                # the owner's FINISHED (independent flush clocks) — never let
                # a non-terminal state overwrite a terminal one.  Instant
                # markers (STREAM_ITEM) never touch the state at all.
                if ev["state"] not in _INSTANT_STATES:
                    rank = _STATE_RANK.get(ev["state"], 0)
                    if rank >= _STATE_RANK.get(rec["state"], -1):
                        rec["state"] = ev["state"]
                entry = {"state": ev["state"], "ts": ev["ts"]}
                if "index" in ev:   # per-yield stream instants
                    entry["index"] = ev["index"]
                for field in ("dur_ms", "bytes", "nsources", "object_id",
                              "node_id", "worker_id", "op", "algo",
                              "world", "stage", "npages", "step",
                              "phases", "trace_id"):
                    if field in ev:  # per-pull transfer / per-op
                        # collective / KV-handoff / train-step slices
                        # (node/worker = the pulling / participating
                        # process, not a producer task; STEP carries a
                        # per-step trace_id + phase-duration dict)
                        entry[field] = ev[field]
                rec["events"].append(entry)
                rec["events"].sort(key=lambda e: e["ts"])
                if len(rec["events"]) > _EVENTS_PER_TASK_CAP:
                    half = _EVENTS_PER_TASK_CAP // 2
                    rec["events"] = (rec["events"][:half] +
                                     rec["events"][-half:])
                    rec["events_truncated"] = True
                if ev["state"] == SUBMITTED:
                    rec["creation_time"] = ev["ts"]
                elif ev["state"] == RUNNING:
                    rec["start_time"] = ev["ts"]
                elif ev["state"] in (FINISHED, FAILED):
                    rec["end_time"] = ev["ts"]
            # Eviction scans PAST live entries (bounded) instead of
            # stopping at the first one: a long-running task at the head
            # of first-seen order used to re-append itself and break,
            # blocking eviction of every terminal task queued behind it —
            # the table then grew far beyond gcs_max_task_events.
            cap = CONFIG.gcs_max_task_events
            spared = 0
            max_spared = min(len(self._order), 256)
            while len(self._tasks) > cap and self._order:
                victim = self._order.popleft()
                rec = self._tasks.get(victim)
                if rec is None:
                    continue
                # records whose state never left "" carry only instant
                # markers — the synthetic ``handoff-<object>`` /
                # ``col-<group>-r<rank>`` rows.  They have no lifecycle
                # to finish, so they must be evictable like terminal
                # tasks: sparing them let a long-lived serve app grow
                # the table to 2x cap in handoff rows that never die.
                if rec["state"] in (FINISHED, FAILED, "") or \
                        len(self._tasks) > 2 * cap:
                    del self._tasks[victim]
                    dropped += 1
                else:
                    self._order.append(victim)  # still live; rotate past
                    spared += 1
                    if spared >= max_spared:
                        break  # everything scanned is live: give up for now
        return dropped

    def list(self, *, job_id: Optional[str] = None,
             state: Optional[str] = None, name: Optional[str] = None,
             limit: int = 10000) -> List[dict]:
        with self._lock:
            out = []
            for rec in self._tasks.values():
                if job_id and rec.get("job_id") != job_id:
                    continue
                if state and rec.get("state") != state:
                    continue
                if name and rec.get("name") != name:
                    continue
                out.append({k: (list(v) if k == "events" else v)
                            for k, v in rec.items()})
                if len(out) >= limit:
                    break
            return out
