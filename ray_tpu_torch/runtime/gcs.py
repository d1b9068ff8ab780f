"""Global Control Service: the head-node daemon.

Analog of the reference GCS
(/root/reference/src/ray/gcs/gcs_server/gcs_server.cc:121-181 wires the same
module set): node table + health checking (GcsNodeManager/GcsHealthCheckManager),
actor directory + restart FSM (GcsActorManager, gcs_actor_manager.cc:240/1233),
job table (GcsJobManager), internal KV (GcsKVManager — function/config store),
pubsub channels (long-poll in the reference, push-based here since our RPC
connections are duplex), and placement groups.

Storage is pluggable like the reference's RedisStoreClient/InMemoryStoreClient
(store_client/*.h): in-memory dict by default, optional file-snapshot backend
so a restarted GCS replays state (GcsInitData replay analog).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch._private.logging_utils import get_logger

logger = get_logger("gcs")

# Actor FSM states (cf. reference rpc::ActorTableData::ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class GcsServer:
    """All control state for one cluster; serves the RPC surface.

    With ``persist_path`` set, durability is two-tier (reference: every
    table mutation writes through to the store client,
    store_client/redis_store_client.h:28; GcsInitData replays it at
    gcs_server.cc:121-181):

    * a **write-ahead journal** (``<persist_path>.wal``) gets one
      length-prefixed record per mutation, synchronously, before the
      mutating RPC returns — so a SIGKILL directly after an
      acknowledged mutation loses nothing (fsync is opt-in via
      ``gcs_wal_fsync``; without it, records survive process death but
      not host power loss);
    * a **snapshot thread** compacts the full tables into an atomic
      pickle (tmp+rename) every ``gcs_snapshot_interval_s`` while dirty,
      rotating the journal so replay length stays bounded.

    Recovery loads the snapshot (if any), then replays journal records
    with a sequence number newer than the snapshot's.  Records carry
    absolute values (table, key, value-or-tombstone), so re-applying an
    already-compacted record is idempotent.  Task events and the
    component-event ring are deliberately ephemeral."""

    _TOMBSTONE = "__gcs_wal_tombstone__"

    # Handlers that only take self._lock, never block, never WAL and never
    # call back over the connection: the RPC layer runs them inline on the
    # reader thread (rpc.py fast-method registry), skipping the dispatch-
    # pool hop on the control plane's highest-frequency calls (liveness
    # heartbeats, KV reads, actor-resolution polls).
    FAST_METHODS = frozenset({
        "heartbeat", "kv_get", "kv_exists", "kv_keys", "list_nodes",
        "get_actor", "get_placement_group",
    })

    SNAPSHOT_TABLES = ("_nodes", "_actors", "_named_actors", "_jobs",
                      "_kv", "_placement_groups")

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._persist_path = persist_path
        self._dirty = threading.Event()
        # node_id hex -> {address, resources, available, last_heartbeat, alive}
        self._nodes: Dict[str, Dict[str, Any]] = {}
        # actor_id hex -> actor table entry
        self._actors: Dict[str, Dict[str, Any]] = {}
        self._named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name) -> id
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._kv: Dict[str, bytes] = {}
        from ray_tpu_torch._private.task_events import GcsTaskTable
        self._task_table = GcsTaskTable()
        # cluster event plane (docs/observability.md): sharded,
        # retention-bounded table of typed lifecycle events aggregated
        # from every process, plus the bounded crash-dossier store the
        # raylets fill on abnormal worker exits.  Ephemeral (never
        # WALed), like task events and metrics.
        from ray_tpu_torch._private import cluster_events as cev
        self._events_table = cev.GcsClusterEventTable()
        # training performance plane (docs/observability.md): per-run
        # step table aggregating every rank's phase clocks, straggler
        # detection edge-triggering TRAIN_STRAGGLER into the event
        # table, and the goodput-ledger store.  Ephemeral like task
        # events and metrics.
        from ray_tpu_torch._private import step_stats as sst
        self._step_stats = sst.GcsStepStatsTable(emit=self.record_event)
        # distributed request tracing plane (docs/observability.md):
        # trace-indexed span store fed by every process's span-buffer
        # flusher; root spans carrying a dossier_id cross-link the
        # dossier back to the trace.  Ephemeral like events/metrics.
        from ray_tpu_torch.util.tracing import tracing_helper as trh
        self._span_table = trh.GcsSpanTable(
            on_dossier_link=self._link_dossier_trace)
        # metrics-history plane (docs/observability.md): every metrics
        # KV write is additionally folded into a bounded multi-
        # resolution ring per series, and the recovery auditor derives
        # drain/failover/heal episodes from the event stream.
        # Ephemeral like all other observability tables.
        from ray_tpu_torch._private import metrics_history as mh
        self._history = mh.GcsMetricsHistoryTable()
        self._auditor = mh.RecoveryAuditor()
        self._dossiers: Dict[str, dict] = {}
        self._dossier_order: deque = deque()
        # evacuated-object location hints (docs/fault_tolerance.md):
        # oid hex -> (node hex set, ts).  Written by draining raylets as
        # they ship primary copies to survivors; read by owners whose
        # location set emptied, BEFORE lineage reconstruction.  Bounded
        # (dict insertion order IS the eviction order — refreshes
        # reinsert, so the cap always drops the stalest hint) +
        # TTL-swept; ephemeral (an expired hint degrades to
        # reconstruction, never to a wrong answer).
        self._evac: Dict[str, Tuple[set, float]] = {}
        self._placement_groups: Dict[str, Dict[str, Any]] = {}
        # channel -> list of (conn, subscriber key)
        self._subs: Dict[str, List[rpc.Connection]] = {}
        self._node_conns: Dict[str, rpc.Connection] = {}
        self._server = rpc.Server(self._handle, host=host, port=port,
                                  on_disconnect=self._on_disconnect,
                                  fast_methods=self.FAST_METHODS)
        self._stopped = threading.Event()
        self._retry_inflight = threading.Event()
        from ray_tpu_torch._core.scheduler import make_scheduler
        self._cluster_scheduler = make_scheduler(
            spill_threshold=CONFIG.scheduler_spill_threshold)
        self._wal_lock = threading.Lock()
        self._wal_seq = 0
        self._wal_fh = None
        if persist_path:
            self._recover(persist_path)
            if CONFIG.gcs_wal_enabled:
                self._wal_fh = open(persist_path + ".wal", "ab")
        # runtime telemetry: the GCS flushes its own hot-path metrics
        # (RPC dispatch latency etc.) straight into its KV table — no
        # WAL record, metrics are ephemeral monitoring data
        from ray_tpu_torch._private import runtime_metrics as rtm
        rtm.attach(self._metrics_kv_put, ident="gcs")
        self._health_thread = threading.Thread(target=self._health_loop,
                                               daemon=True)
        self._health_thread.start()
        if persist_path:
            self._snap_thread = threading.Thread(target=self._snapshot_loop,
                                                 daemon=True)
            self._snap_thread.start()

    # ------------------------------------------------------------ persistence
    def _mark_dirty(self, *hints) -> None:
        """Mark the snapshot dirty and journal the named entries.

        ``hints`` are ``(table_attr, key)`` pairs identifying what the
        caller just mutated; each becomes one synchronous WAL record of
        the entry's **current** value (``key=None`` journals the whole
        table — used where one RPC fans out over many entries, e.g. a
        job finish killing its actors).  Callers that can't name what
        changed pass nothing and fall back to snapshot-tick durability."""
        if not self._persist_path:
            return
        self._dirty.set()
        if self._wal_fh is None or not hints:
            return
        import pickle
        import struct
        try:
            # self._lock before _wal_lock everywhere: the value read and
            # its sequence number must agree, or replay could finish on a
            # stale value for a key mutated concurrently.  The disk write
            # happens OUTSIDE self._lock so fsync latency never stalls
            # unrelated RPCs; replay sorts records by seq, so two threads
            # landing frames out of file order is harmless.
            with self._lock:
                with self._wal_lock:
                    frames = []
                    for table, key in hints:
                        tbl = getattr(self, table)
                        if key is None:
                            value = dict(tbl)
                        else:
                            value = tbl.get(key, self._TOMBSTONE)
                        self._wal_seq += 1
                        rec = pickle.dumps(
                            (self._wal_seq, table, key, value))
                        frames.append(struct.pack(">I", len(rec)) + rec)
            with self._wal_lock:
                if self._wal_fh is None:
                    return
                self._wal_fh.write(b"".join(frames))
                self._wal_fh.flush()
                if CONFIG.gcs_wal_fsync:
                    os.fsync(self._wal_fh.fileno())
        except Exception:
            logger.exception("GCS WAL append failed (snapshot tick still "
                             "covers this mutation)")

    def _snapshot_loop(self) -> None:
        while not self._stopped.wait(CONFIG.gcs_snapshot_interval_s):
            if not self._dirty.is_set():
                continue
            self._dirty.clear()
            try:
                self._write_snapshot()
            except Exception:
                logger.exception("GCS snapshot write failed")
        # final snapshot on clean stop so nothing since the last tick is lost
        if self._dirty.is_set():
            try:
                self._write_snapshot()
            except Exception:
                pass

    def _wal_old_files(self) -> list:
        """Rotated journal segments on disk, oldest first (the rotation
        seq is embedded in the name)."""
        import glob
        out = []
        for p in glob.glob(self._persist_path + ".wal.old.*"):
            try:
                out.append((int(p.rsplit(".", 1)[1]), p))
            except ValueError:
                continue
        legacy = self._persist_path + ".wal.old"  # pre-unique-name builds
        if os.path.exists(legacy):
            out.append((-1, legacy))
        return [p for _, p in sorted(out)]

    def _write_snapshot(self) -> None:
        import pickle
        with self._lock:
            with self._wal_lock:
                blob = pickle.dumps(
                    {"__v": 2, "wal_seq": self._wal_seq,
                     "tables": {t: getattr(self, t)
                                for t in self.SNAPSHOT_TABLES}})
                # rotate the journal inside the locks: records after the
                # pickle point land in the fresh file and survive the
                # compaction; records before it are covered by the pickle.
                # Rotation uses a UNIQUE name per compaction — if the
                # snapshot write below fails (disk full), earlier rotated
                # segments must survive untouched or their acked records
                # would have no on-disk copy; replay seq-filters overlaps
                if self._wal_fh is not None:
                    self._wal_fh.close()
                    os.replace(self._persist_path + ".wal",
                               f"{self._persist_path}.wal.old."
                               f"{self._wal_seq}")
                    self._wal_fh = open(self._persist_path + ".wal", "ab")
        tmp = f"{self._persist_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._persist_path)
        # only now are all rotated segments (records <= pickled wal_seq)
        # fully covered by a durable snapshot
        for p in self._wal_old_files():
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    @classmethod
    def _read_wal_records(cls, path: str) -> list:
        """Records from one journal file, tolerating a torn final write."""
        import pickle
        import struct
        out = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return out
        off = 0
        while off + 4 <= len(data):
            (n,) = struct.unpack_from(">I", data, off)
            if off + 4 + n > len(data):
                break  # torn tail: the append died mid-record
            try:
                out.append(pickle.loads(data[off + 4:off + 4 + n]))
            except Exception:
                break
            off += 4 + n
        return out

    def _recover(self, path: str) -> None:
        """Snapshot + journal replay (GcsInitData analog).  Runs during
        construction, before the address file is published — no client
        can reach the server yet, so replay is effectively single-
        threaded."""
        import pickle
        base_seq = 0
        loaded = False
        if os.path.exists(path):
            with open(path, "rb") as f:
                state = pickle.load(f)
            if "__v" in state:
                tables, base_seq = state["tables"], state["wal_seq"]
            else:  # v1 flat-dict snapshot from before the WAL existed
                tables = state
            with self._lock:
                for t in self.SNAPSHOT_TABLES:
                    getattr(self, t).update(tables.get(t, {}))
            loaded = True
        # journals are ALWAYS replayed, even with gcs_wal_enabled=False —
        # the flag governs writing; records a previous (WAL-on) incarnation
        # acked must never be dropped just because the operator toggled it.
        # Records apply in seq order (concurrent appenders may land frames
        # out of file order), filtered against the snapshot's seq.
        records = []
        for wal in self._wal_old_files() + [path + ".wal"]:
            records.extend(self._read_wal_records(wal))
        records.sort(key=lambda r: r[0])
        replayed = 0
        for seq, table, key, value in records:
            self._wal_seq = max(self._wal_seq, seq)
            if seq <= base_seq or table not in self.SNAPSHOT_TABLES:
                continue
            tbl = getattr(self, table)
            if key is None:
                tbl.clear()
                tbl.update(value)
            elif value == self._TOMBSTONE:
                tbl.pop(key, None)
            else:
                tbl[key] = value
            replayed += 1
        self._wal_seq = max(self._wal_seq, base_seq)
        if not CONFIG.gcs_wal_enabled and replayed:
            # WAL now off: nothing will rotate these files again, and a
            # future WAL-on incarnation would replay them over a NEWER
            # snapshot, resurrecting later-deleted state.  Fold them into
            # a snapshot right now, then drop them.
            self._write_snapshot()
            try:
                os.remove(path + ".wal")
            except FileNotFoundError:
                pass
        if loaded or replayed:
            self._post_recover(path, replayed)

    def _post_recover(self, path: str, replayed: int) -> None:
        now = time.monotonic()
        with self._lock:
            for node in self._nodes.values():
                # give restored nodes a fresh grace period to heartbeat in;
                # monotonic timestamps from the old process are meaningless
                node["last_heartbeat"] = now
                node["last_busy"] = now
                if node["alive"]:
                    self._cluster_scheduler.update_node(
                        node["node_id"], node["resources"],
                        node["available"], True)
            for a in self._actors.values():
                # in-flight dispatches died with the old process: let the
                # retry machinery re-drive anything not ALIVE/DEAD
                if a.get("state") in (PENDING_CREATION, RESTARTING):
                    a["dispatched"] = False
                    a.pop("retry_delay", None)
        logger.info("GCS state restored from %s (+%d WAL records): "
                    "%d nodes, %d actors, %d jobs, %d kv keys, %d pgs",
                    path, replayed, len(self._nodes), len(self._actors),
                    len(self._jobs), len(self._kv),
                    len(self._placement_groups))
        threading.Thread(target=self._retry_after_reattach,
                         daemon=True).start()

    def _retry_after_reattach(self) -> None:
        """Post-restore retry kick: wait for restored alive nodes to
        re-attach their push connections (first heartbeat) before driving
        pending actors — dispatching into an empty _node_conns would burn
        every restart attempt in milliseconds on 'no connection to node'."""
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                alive = [n["node_id"] for n in self._nodes.values()
                         if n["alive"]]
                if alive and all(nid in self._node_conns for nid in alive):
                    break
            time.sleep(0.05)
        self._retry_pending_actors()

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def stop(self) -> None:
        self._stopped.set()
        from ray_tpu_torch._private import runtime_metrics as rtm
        rtm.detach(self._metrics_kv_put)
        self._server.stop()
        snap = getattr(self, "_snap_thread", None)
        if snap is not None:
            snap.join(timeout=5)  # let the final compaction finish
        with self._wal_lock:
            if self._wal_fh is not None:
                self._wal_fh.close()
                self._wal_fh = None

    # RPCs that change persisted tables → the WAL hints for what they
    # touch; _handle journals + marks dirty after any of them.  Handlers
    # whose fan-out the payload can't name (finish_job kills the job's
    # actors, actor_failed drives the restart FSM) journal from inside
    # the transition instead and are mapped to no hints here.
    # metrics/ keys are ephemeral monitoring data republished every
    # flush interval by every process: journaling them would grow the
    # WAL without bound and pay a per-metric fsync, and even marking
    # the snapshot dirty would make an otherwise-idle cluster rewrite
    # its snapshot continuously — so their mutations skip durability
    _SKIP_DURABILITY = object()

    _MUTATING_RPCS: Dict[str, Any] = {
        "register_node": lambda p: (("_nodes", p["node_id"]),),
        "register_job": lambda p: (("_jobs", p["job_id"]),),
        "finish_job": lambda p: (),
        "kv_put": lambda p: (
            GcsServer._SKIP_DURABILITY
            if p["key"].startswith("metrics/")
            else (("_kv", p["key"]),)),
        "kv_del": lambda p: (
            GcsServer._SKIP_DURABILITY
            if p["key"].startswith("metrics/")
            else (("_kv", p["key"]),)),
        "register_actor": lambda p: (("_actors", p["actor_id"]),
                                     ("_named_actors", None)),
        "actor_ready": lambda p: (("_actors", p["actor_id"]),),
        "actor_failed": lambda p: (),
        "kill_actor": lambda p: (("_actors", p["actor_id"]),
                                 ("_named_actors", None)),
        "create_placement_group": lambda p: (
            ("_placement_groups", p["pg_id"]),),
        # actor deaths from PG removal journal individually via
        # _on_actor_failure's own ("_actors", aid) hint
        "remove_placement_group": lambda p: (
            ("_placement_groups", p["pg_id"]), ("_named_actors", None)),
    }

    def _rpc_profile(self, conn, p):
        """Flame-sample the GCS process itself (reporter_agent analog)."""
        from ray_tpu_torch._private.profiler import sample_folded
        return sample_folded(float((p or {}).get("duration", 2.0)))

    # ------------------------------------------------------ component events
    def _rpc_report_event(self, conn, p):
        """Legacy single-event report (reference event.cc schema:
        severity/label/message/source + custom fields); folded into the
        typed cluster event table — ``label`` becomes the event type."""
        ev = {"ts": p.get("ts") or time.time(),
              "severity": p.get("severity", "INFO"),
              "source": p.get("source", "unknown"),
              "type": p.get("label", "") or "EVENT",
              "message": p.get("message", "")}
        for k, v in (p.get("fields") or {}).items():
            if v is not None:
                ev.setdefault(k, v)
        self._events_table.put([ev])
        self._audit_events([ev])
        self._publish("events", ev)
        return {"ok": True}

    def record_event(self, severity: str, source: str, label: str,
                     message: str, **fields) -> None:
        """In-process emission for the GCS's own transitions.  Honors
        the event-plane kill switch (RAY_TPU_TORCH_EVENTS=0): ambient
        instrumentation goes quiet; explicit client ``report_event``
        calls still land (a user API action, not instrumentation)."""
        from ray_tpu_torch._private import cluster_events as cev
        # raylint: disable=kill-switch -- one explicit control-plane RPC per call; an env read is noise next to the RPC itself, and the kill-switch test flips the env at runtime
        if not cev.enabled():
            return
        self._rpc_report_event(None, {
            "severity": severity, "source": source, "label": label,
            "message": message, "fields": fields})

    def _rpc_report_cluster_events(self, conn, p):
        """Batched typed-event flush from a process's EventRecorder
        (cluster_events.py flusher cadence)."""
        events = p.get("events") or []
        dropped = self._events_table.put(events)
        self._audit_events(events)
        for ev in events:
            self._publish("events", ev)
        return {"dropped": dropped}

    def _audit_events(self, events) -> None:
        """Feed freshly landed events to the recovery auditor (sixth
        plane, metrics_history.py): it derives drain/failover/heal
        episodes and never emits events itself (no recursion)."""
        from ray_tpu_torch._private import metrics_history as mh
        if mh.history_on():
            self._auditor.observe(events)

    def _rpc_list_cluster_events(self, conn, p):
        return self._events_table.list(
            node_id=p.get("node_id"), job_id=p.get("job_id"),
            actor_id=p.get("actor_id"), worker_id=p.get("worker_id"),
            severity=p.get("severity"),
            min_severity=p.get("min_severity"),
            etype=p.get("type"), source=p.get("source"),
            limit=int(p.get("limit", 1000)))

    def _rpc_cluster_event_stats(self, conn, p):
        out = self._events_table.stats()
        out["counts_by_type"] = self._events_table.counts_by_type()
        return out

    def _rpc_list_events(self, conn, p):
        """Legacy shape (dashboard Events page, PARITY tests): typed
        records rendered back as label/message/fields rows."""
        limit = int(p.get("limit", 200)) if p else 200
        sev = (p or {}).get("severity")
        std = ("ts", "type", "severity", "source", "message")
        out = []
        for ev in self._events_table.list(severity=sev, limit=limit):
            out.append({"ts": ev.get("ts"),
                        "severity": ev.get("severity", "INFO"),
                        "source": ev.get("source", ""),
                        "label": ev.get("type", ""),
                        "message": ev.get("message", ""),
                        "fields": {k: v for k, v in ev.items()
                                   if k not in std}})
        return out[-limit:]

    # ------------------------------------------------- training perf plane
    def _rpc_report_step_stats(self, conn, p):
        """Batched per-step reports (and end-of-run goodput ledgers)
        from each rank's step-stats flusher (_private/step_stats.py)."""
        return {"dropped": self._step_stats.put(p.get("reports") or [])}

    def _rpc_list_step_stats(self, conn, p):
        """Run directory + recent per-step cross-rank records.  With
        ``run`` (id or group prefix) includes that run's step rows;
        the run rows carry rank metadata (worker id/address) so
        ``ray-tpu profile --group`` can gang-fan-out."""
        run = p.get("run")
        out = {"runs": self._step_stats.list_runs(
            run=run, limit=int(p.get("limit", 100)))}
        if run:
            out["steps"] = self._step_stats.steps(
                run, limit=int(p.get("steps_limit", 64)))
        out["stats"] = self._step_stats.stats()
        return out

    def _rpc_training_summary(self, conn, p):
        """The goodput-ledger view of one run (latest by default)."""
        return self._step_stats.summary(p.get("run"))

    # ------------------------------------------------------- tracing plane
    def _rpc_report_spans(self, conn, p):
        """Batched span flush from a process's SpanBuffer
        (tracing_helper.py flusher cadence)."""
        return {"dropped": self._span_table.put(p.get("spans") or [])}

    def _rpc_list_traces(self, conn, p):
        return self._span_table.list(
            slo_violations=bool(p.get("slo_violations")),
            route=p.get("route"), status=p.get("status"),
            since=p.get("since"), limit=int(p.get("limit", 100)))

    def _rpc_get_trace(self, conn, p):
        return self._span_table.get(p.get("trace_id") or "")

    def _rpc_trace_stats(self, conn, p):
        return self._span_table.stats()

    # ---------------------------------------------- metrics-history plane
    def _rpc_list_metrics_history(self, conn, p):
        """Windowed points for a series (or all series of a metric):
        parsed payloads oldest-first from the retention rings."""
        p = p or {}
        return self._history.query(
            name=p.get("name"), ident=p.get("ident"),
            since=p.get("since"), resolution=p.get("resolution"),
            limit=int(p.get("limit", 2000)))

    def _rpc_metrics_history_stats(self, conn, p):
        out = self._history.stats()
        if (p or {}).get("series"):
            out["series_index"] = self._history.series()
        return out

    def _rpc_list_recovery_episodes(self, conn, p):
        p = p or {}
        return self._auditor.list(
            kind=p.get("kind"),
            include_open=bool(p.get("include_open", True)),
            limit=int(p.get("limit", 100)))

    def _rpc_recovery_stats(self, conn, p):
        return self._auditor.stats()

    def _rpc_doctor_report(self, conn, p):
        """Cross-plane correlation: one snapshot of all six planes ->
        ranked findings (metrics_history.build_doctor_report).  The
        assembly is a handful of in-process table reads — cheap enough
        for the CLI, the dashboard and the debug bundle to share."""
        from ray_tpu_torch._private import metrics_history as mh
        p = p or {}
        snapshot = {
            "now": time.time(),
            "nodes": self._rpc_list_nodes(None, {}),
            "events": self._events_table.list(
                min_severity="WARNING",
                limit=int(p.get("events_limit", 200))),
            "episodes": self._auditor.list(
                limit=int(p.get("episodes_limit", 100))),
            "recovery_stats": self._auditor.stats(),
            "traces": self._span_table.list(slo_violations=True,
                                            limit=10),
            "dossiers": self._rpc_list_dossiers(None, {}),
            "history_stats": self._history.stats(),
        }
        return mh.build_doctor_report(snapshot)

    def _link_dossier_trace(self, dossier_id: str, trace_id: str) -> None:
        """A root span died carrying a dossier_id: stamp the trace id
        onto the dossier (prefix match like get_dossier) so forensics
        navigate both ways."""
        with self._lock:
            d = self._dossiers.get(dossier_id)
            if d is None and len(dossier_id) >= 8:
                d = next((cand for did, cand in self._dossiers.items()
                          if did.startswith(dossier_id)), None)
            if d is not None:
                d["trace_id"] = trace_id

    # ------------------------------------------------------------- dossiers
    def _rpc_put_dossier(self, conn, p):
        """Store a crash dossier (raylet harvest / GCS node-death
        assembly).  Bounded FIFO: forensic data for recent deaths, not
        an archive."""
        did = p["dossier_id"]
        dossier = dict(p.get("dossier") or {})
        dossier.setdefault("dossier_id", did)
        dossier.setdefault("ts", time.time())
        with self._lock:
            if did not in self._dossiers:
                self._dossier_order.append(did)
            self._dossiers[did] = dossier
            while len(self._dossiers) > CONFIG.gcs_max_dossiers and \
                    len(self._dossier_order) > 1:
                victim = self._dossier_order.popleft()
                if victim == did:   # never evict the one just stored
                    self._dossier_order.append(victim)
                    continue
                self._dossiers.pop(victim, None)
        return {"ok": True}

    def _rpc_get_dossier(self, conn, p):
        """Dossier by id — worker id hex (worker deaths; prefix match
        accepted) or node id hex (node deaths)."""
        want = p.get("dossier_id") or ""
        with self._lock:
            d = self._dossiers.get(want)
            if d is None and len(want) >= 8:
                for did, cand in self._dossiers.items():
                    if did.startswith(want):
                        d = cand
                        break
            return dict(d) if d else None

    def _rpc_list_dossiers(self, conn, p):
        with self._lock:
            return [{"dossier_id": did,
                     "kind": d.get("kind", "worker"),
                     "reason": d.get("reason", ""),
                     "node_id": d.get("node_id", ""),
                     "worker_id": d.get("worker_id", ""),
                     "ts": d.get("ts")}
                    for did, d in self._dossiers.items()]

    def _rpc_dump_stacks(self, conn, p):
        """Instantaneous per-thread stack dump + a short folded-stack
        sample of the GCS process itself (profiler plane)."""
        from ray_tpu_torch._private.profiler import dump_stacks, sample_folded
        return {"threads": dump_stacks(),
                "folded": sample_folded(float((p or {}).get(
                    "duration", 0.2)))}

    # ------------------------------------------------------------------ rpc
    def _handle(self, conn: rpc.Connection, method: str, p: Any) -> Any:
        fn = getattr(self, "_rpc_" + method, None)
        if fn is None:
            raise rpc.RpcError(f"GCS: unknown method {method}")
        out = fn(conn, p or {})
        hints = self._MUTATING_RPCS.get(method)
        if hints is not None:
            h = hints(p or {})
            if h is not self._SKIP_DURABILITY:
                self._mark_dirty(*h)
        return out

    def _on_disconnect(self, conn: rpc.Connection) -> None:
        with self._lock:
            for subs in self._subs.values():
                if conn in subs:
                    subs.remove(conn)
            dead_node = None
            for nid, c in list(self._node_conns.items()):
                if c is conn:
                    dead_node = nid
                    del self._node_conns[nid]
            # driver conn drop -> finish its job
            job_id = getattr(conn, "peer", None)
            if isinstance(job_id, str) and job_id in self._jobs:
                self._finish_job_locked(job_id)
        if dead_node:
            self._mark_node_dead(dead_node)

    # ----------------------------------------------------------------- nodes
    def _rpc_register_node(self, conn, p):
        node_id = p["node_id"]
        with self._lock:
            self._nodes[node_id] = {
                "node_id": node_id,
                "address": tuple(p["address"]),
                "store_path": p.get("store_path"),
                "resources": dict(p.get("resources", {})),
                "available": dict(p.get("resources", {})),
                "labels": dict(p.get("labels", {})),
                "alive": True,
                "last_heartbeat": time.monotonic(),
                "last_busy": time.monotonic(),
                "load": [],
            }
            self._node_conns[node_id] = conn
            conn.peer = ("node", node_id)
            self._cluster_scheduler.update_node(
                node_id, self._nodes[node_id]["resources"],
                self._nodes[node_id]["available"], True)
        self._publish("node", {"node_id": node_id, "state": "ALIVE"})
        self.record_event("INFO", "gcs", "NODE_UP",
                          f"node {node_id[:8]} registered",
                          node_id=node_id,
                          resources=dict(p.get("resources", {})))
        # a new node may unblock pending actors / placement groups
        threading.Thread(target=self._retry_pending_actors,
                         daemon=True).start()
        return {"ok": True}

    def _retry_pending_actors(self) -> None:
        with self._lock:
            # entries holding a retry_delay already have a backoff Timer
            # scheduled (resources-unavailable path) — re-dispatching them
            # here would defeat the backoff and hammer the full node
            pending = [aid for aid, a in self._actors.items()
                       if a["state"] in (PENDING_CREATION, RESTARTING)
                       and not a.get("dispatched")
                       and not a.get("retry_delay")]
            pending_pgs = [pgid for pgid, pg in self._placement_groups.items()
                           if pg["state"] == "PENDING"]
        for aid in pending:
            self._schedule_actor(aid)
        for pgid in pending_pgs:
            self._retry_placement_group(pgid)

    def _retry_placement_group(self, pgid: str) -> None:
        with self._lock:
            pg = self._placement_groups.get(pgid)
        if pg is None or pg["state"] != "PENDING":
            return
        self._try_place_pg(pg)

    # ------------------------------------------------- preemption / drain
    def _mark_node_draining(self, node_id: str, grace_s: float,
                            reason: str) -> bool:
        """Idempotently flag a node PREEMPTING: placement skips it and
        the typed event (with the grace deadline) fires exactly once
        per drain.  Returns False for unknown/dead nodes."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node["alive"]:
                return False
            already = bool(node.get("draining"))
            node["draining"] = True
            deadline = time.time() + grace_s
            if already:
                # a later notice can only shorten the advertised window
                # (and a passed-deadline heartbeat echoing remaining
                # grace 0 must not keep re-extending it)
                deadline = min(node.get("drain_deadline", deadline),
                               deadline)
            node["drain_deadline"] = deadline
        if not already:
            self.record_event(
                "WARNING", "gcs", "NODE_PREEMPTING",
                f"node {node_id[:8]} draining: {reason} "
                f"(grace {grace_s:.0f}s)", node_id=node_id,
                grace_s=grace_s, reason=reason,
                deadline=time.time() + grace_s)
            self._publish("node", {"node_id": node_id,
                                   "state": "DRAINING"})
        return True

    def _rpc_drain_node(self, conn, p):
        """Operator/provider-initiated drain (`ray-tpu drain`, spot
        preemption notice): mark the node draining and forward the
        drain to its raylet, which stops granting leases and evacuates
        primary copies (docs/fault_tolerance.md)."""
        node_id = p["node_id"]
        raw = p.get("grace_s")   # explicit 0 = die ASAP, keep it
        grace = CONFIG.drain_grace_s if raw is None else float(raw)
        reason = p.get("reason", "drain requested")
        if not self._mark_node_draining(node_id, grace, reason):
            return {"ok": False, "reason": "unknown or dead node"}
        with self._lock:
            node_conn = self._node_conns.get(node_id)
        if node_conn is not None:
            try:
                node_conn.call("drain", {"grace_s": grace,
                                         "reason": reason,
                                         "from_gcs": True}, timeout=10)
            except (ConnectionError, rpc.RpcError, TimeoutError) as e:
                return {"ok": True, "forwarded": False,
                        "reason": f"raylet drain forward failed: {e}"}
        return {"ok": True, "forwarded": node_conn is not None}

    def _rpc_report_node_draining(self, conn, p):
        """Raylet-initiated drain (the `drain` RPC hit the raylet
        directly): reflect it in the node table + event plane."""
        raw = p.get("grace_s")
        ok = self._mark_node_draining(
            p["node_id"],
            CONFIG.drain_grace_s if raw is None else float(raw),
            p.get("reason", "drain requested"))
        return {"ok": ok}

    def _rpc_report_node_drained(self, conn, p):
        """Drain completed: the raylet's evacuation ledger becomes the
        NODE_DRAINED event the chaos gate (and operators) assert on."""
        self.record_event(
            "INFO", "gcs", "NODE_DRAINED",
            f"node {p['node_id'][:8]} drained: "
            f"{p.get('evacuated', 0)} objects evacuated "
            f"({p.get('bytes', 0)} bytes, {p.get('failed', 0)} failed)",
            node_id=p["node_id"], evacuated=p.get("evacuated", 0),
            bytes=p.get("bytes", 0), failed=p.get("failed", 0),
            duration_s=p.get("duration_s"))
        return {"ok": True}

    def _rpc_report_object_evacuated(self, conn, p):
        """A draining raylet landed a copy of ``object_id`` on
        ``node_id``; owners consult this table when their location set
        empties (multi-source: every completed evacuation target joins
        the hint, so striped pulls can fan over them immediately)."""
        oid = p["object_id"]
        node = p["node_id"]
        with self._lock:
            rec = self._evac.pop(oid, None)
            nodes = rec[0] if rec is not None else set()
            nodes.add(node)
            # pop + reinsert rotates a refreshed hint to the back of
            # the insertion order, so the cap evicts the stalest entry
            self._evac[oid] = (nodes, time.monotonic())
            while len(self._evac) > CONFIG.gcs_max_evacuated_objects:
                self._evac.pop(next(iter(self._evac)))
        return {"ok": True}

    def _rpc_get_evacuated_locations(self, conn, p):
        """Batch lookup: {oid hex: [node hexes]} for ids with a live
        hint (unknown ids are simply absent from the reply)."""
        out = {}
        now = time.monotonic()
        ttl = CONFIG.gcs_evac_ttl_s
        with self._lock:
            for oid in p.get("object_ids", ()):
                rec = self._evac.get(oid)
                if rec is not None and now - rec[1] <= ttl:
                    out[oid] = sorted(rec[0])
        return out

    def _sweep_evac(self) -> None:
        now = time.monotonic()
        ttl = CONFIG.gcs_evac_ttl_s
        with self._lock:
            dead = [oid for oid, rec in self._evac.items()
                    if now - rec[1] > ttl]
            for oid in dead:
                self._evac.pop(oid, None)

    def _rpc_heartbeat(self, conn, p):
        with self._lock:
            node = self._nodes.get(p["node_id"])
            if node is None:
                return {"ok": False, "reregister": True}
            if not node["alive"]:
                # Death is permanent (reference semantics): a stalled node
                # whose actors were already restarted elsewhere must not be
                # resurrected — tell it to shut down.
                return {"ok": False, "dead": True}
            node["last_heartbeat"] = time.monotonic()
            # after a GCS restart the duplex conns died with the old
            # process: a heartbeat re-attaches this node's push channel
            if self._node_conns.get(p["node_id"]) is not conn:
                self._node_conns[p["node_id"]] = conn
                conn.peer = ("node", p["node_id"])
            node["available"] = dict(p.get("available", node["available"]))
            self._cluster_scheduler.update_node(
                p["node_id"], node["resources"], node["available"], True)
            node["load"] = list(p.get("load", []))
            busy = bool(p.get("busy"))
            if busy or node.get("busy"):
                node["last_busy"] = time.monotonic()
            node["busy"] = busy
            # heartbeat-carried drain flag: the idempotent backstop for
            # a raylet-initiated drain whose report RPC was lost
            hb_draining = bool(p.get("draining"))
            # bundle-pool reconciliation (docs/fault_tolerance.md):
            # the raylet reports the placement-group bundle pools it
            # holds; flag the ones the GCS no longer places on this
            # node (pg removed, or rescheduled elsewhere after a member
            # node died while this raylet was unreachable) so the
            # raylet can release the stranded reservation.  Only the
            # two unambiguous shapes are flagged — a PENDING group
            # mid-placement must keep its fresh reservations.
            stale_bundles = []
            for key in p.get("bundles", ()):
                pgid, _, idx = str(key).partition(":")
                pg = self._placement_groups.get(pgid)
                if pg is None:
                    stale_bundles.append(key)
                    continue
                placement = pg.get("placement")
                if pg.get("state") == "CREATED" and placement is not None:
                    try:
                        i = int(idx)
                    except ValueError:
                        continue
                    if i >= len(placement) or placement[i] != p["node_id"]:
                        stale_bundles.append(key)
            health = p.get("health")
            unhealthy_flip = None
            if health is not None:
                node["health"] = dict(health)
                reasons = self._health_reasons(health)
                was = bool(node.get("unhealthy"))
                now_bad = bool(reasons)
                node["unhealthy"] = now_bad
                node["unhealthy_reasons"] = reasons
                if now_bad != was:
                    unhealthy_flip = (now_bad, reasons, dict(health))
        if unhealthy_flip is not None:
            # edge-triggered: one event per transition, not per beat
            now_bad, reasons, health = unhealthy_flip
            self.record_event(
                "WARNING" if now_bad else "INFO", "gcs",
                "NODE_UNHEALTHY" if now_bad else "NODE_HEALTHY",
                f"node {p['node_id'][:8]} "
                + (f"unhealthy: {', '.join(reasons)}" if now_bad
                   else "recovered"),
                node_id=p["node_id"], **health)
        if hb_draining:
            # outside self._lock: _mark_node_draining takes it itself
            raw = p.get("drain_grace_s")
            self._mark_node_draining(
                p["node_id"],
                CONFIG.drain_grace_s if raw is None else float(raw),
                p.get("drain_reason") or "raylet-initiated drain")
        reply = {"ok": True}
        if stale_bundles:
            reply["stale_bundles"] = stale_bundles
        return reply

    @staticmethod
    def _health_reasons(health: dict) -> List[str]:
        """Threshold check over a raylet health snapshot -> list of
        breach descriptions ([] = healthy)."""
        reasons = []
        mem = health.get("mem_frac")
        if mem is not None and mem >= CONFIG.node_unhealthy_mem_frac:
            reasons.append(f"mem {mem:.0%}")
        store = health.get("store_frac")
        if store is not None and \
                store >= CONFIG.node_unhealthy_store_frac:
            reasons.append(f"store {store:.0%}")
        lag = health.get("loop_lag_ms")
        if lag is not None and lag >= CONFIG.node_unhealthy_lag_ms:
            reasons.append(f"loop lag {lag:.0f}ms")
        return reasons

    def _rpc_list_nodes(self, conn, p):
        now = time.monotonic()
        with self._lock:
            out = []
            for n in self._nodes.values():
                d = dict(n)
                d["idle_s"] = now - n.get("last_busy", now)
                out.append(d)
            return out

    def _prune_stale_metrics(self, now: Optional[float] = None) -> int:
        """Delete RUNTIME metrics/ KV entries whose payload ts is
        stale: the publishing process is gone (or wedged), and its
        frozen last snapshot must not haunt /metrics and list_metrics
        forever.  Only payloads self-marked ``runtime`` are eligible —
        runtime flushers keep-alive their ts even when idle, so
        staleness means death; user metrics (util/metrics.py) flush on
        record only, and an idle live process's once-set gauge must
        not be swept."""
        import json as _json
        from ray_tpu_torch._private.runtime_metrics import METRICS_STALE_AFTER_S
        now = time.time() if now is None else now
        pruned = 0
        with self._lock:
            for key in [k for k in self._kv if k.startswith("metrics/")]:
                try:
                    blob = _json.loads(self._kv[key])
                    ts = blob.get("ts")
                    swept = bool(blob.get("runtime"))
                except (ValueError, TypeError, AttributeError):
                    continue
                if swept and (ts is None
                              or now - ts > METRICS_STALE_AFTER_S):
                    del self._kv[key]
                    pruned += 1
        return pruned

    def _health_loop(self) -> None:
        period = CONFIG.heartbeat_period_ms / 1000.0
        threshold = CONFIG.health_check_failure_threshold
        ticks = 0
        while not self._stopped.wait(period):
            now = time.monotonic()
            dead = []
            with self._lock:
                for nid, node in self._nodes.items():
                    if node["alive"] and \
                            now - node["last_heartbeat"] > period * threshold:
                        dead.append(nid)
                have_pending = any(
                    a["state"] in (PENDING_CREATION, RESTARTING)
                    and not a.get("dispatched")
                    for a in self._actors.values()) or any(
                    pg["state"] == "PENDING"
                    for pg in self._placement_groups.values())
            for nid in dead:
                self._mark_node_dead(nid)
            # dead processes leave their last metrics snapshot behind in
            # the KV; sweep keys whose payload ts went stale (live
            # flushers refresh ts every few intervals) so /metrics and
            # list_metrics don't report frozen gauges forever and KV
            # cardinality stays bounded under worker churn
            if ticks % 50 == 0:
                self._prune_stale_metrics()
                self._sweep_evac()
            # actors/pgs parked with "no feasible node" are otherwise only
            # retried on node registration — also retry as resources free
            # up (freshly reported by heartbeats), else a full-but-draining
            # cluster livelocks pending actors forever.  Off-thread: a
            # create_actor dispatch can block for actor_creation_timeout_s
            # and must not stall dead-node detection.
            ticks += 1
            if have_pending and ticks % 2 == 0 and \
                    not self._retry_inflight.is_set():
                self._retry_inflight.set()

                def _retry_and_clear():
                    try:
                        self._retry_pending_actors()
                    finally:
                        self._retry_inflight.clear()
                threading.Thread(target=_retry_and_clear,
                                 daemon=True).start()

    def _mark_node_dead(self, node_id: str) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if not node or not node["alive"]:
                return
            node["alive"] = False
            self._cluster_scheduler.remove_node(node_id)
            affected = [aid for aid, a in self._actors.items()
                        if a.get("node_id") == node_id
                        and a["state"] in (ALIVE, PENDING_CREATION)]
            broken_pgs = [pg for pg in self._placement_groups.values()
                          if pg.get("placement") and
                          node_id in pg["placement"]]
        logger.warning("node %s marked dead (actors affected: %d)",
                       node_id[:8], len(affected))
        self._mark_dirty(("_nodes", node_id))
        self._publish("node", {"node_id": node_id, "state": "DEAD"})
        self.record_event("ERROR", "gcs", "NODE_DEAD",
                          f"node {node_id[:8]} missed "
                          f"{CONFIG.health_check_failure_threshold} "
                          "heartbeats", node_id=node_id,
                          actors_affected=len(affected))
        # node-death dossier: the raylet can't harvest its own corpse,
        # so the GCS assembles what it already holds — the node's last
        # flushed events, health snapshot and heartbeat age — under the
        # node id, driver-retrievable like any worker dossier
        self._rpc_put_dossier(None, {
            "dossier_id": node_id,
            "dossier": {
                "kind": "node", "node_id": node_id,
                "reason": f"missed "
                          f"{CONFIG.health_check_failure_threshold} "
                          f"heartbeats",
                "health": node.get("health"),
                "last_heartbeat_age_s": round(
                    time.monotonic() - node.get("last_heartbeat", 0), 3),
                "actors_affected": len(affected),
                "events": self._events_table.list(node_id=node_id,
                                                  limit=100),
            }})
        for aid in affected:
            self._on_actor_failure(aid, f"node {node_id[:8]} died")
        # placement groups with a bundle on the dead node go back to PENDING
        # and get fully re-reserved (reference: rescheduling state). Runs on
        # its own thread: the return_bundle/reserve_bundle RPCs must not
        # stall the health loop's detection of other dead nodes.
        if broken_pgs:
            threading.Thread(target=self._reschedule_broken_pgs,
                             args=(broken_pgs, node_id), daemon=True).start()

    def _reschedule_broken_pgs(self, broken_pgs, node_id: str) -> None:
        for pg in broken_pgs:
            with self._lock:
                if self._placement_groups.get(pg["pg_id"]) is not pg:
                    continue   # removed concurrently; must not resurrect
                placement = pg["placement"] or []
                conns = {nid: self._node_conns.get(nid)
                         for nid in placement if nid != node_id}
                pg["state"] = "PENDING"
                pg["placement"] = None
            for i, nid in enumerate(placement):
                node_conn = conns.get(nid)
                if node_conn is None:
                    continue
                try:
                    node_conn.call("return_bundle",
                                   {"pg_id": pg["pg_id"], "index": i},
                                   timeout=10)
                except (ConnectionError, rpc.RpcError, TimeoutError):
                    pass
            self._publish("placement_group",
                          {"pg_id": pg["pg_id"], "state": "PENDING"})
            self._try_place_pg(pg)

    # ----------------------------------------------------------------- jobs
    def _rpc_register_job(self, conn, p):
        job_id = p["job_id"]
        with self._lock:
            if job_id not in self._jobs:
                self._jobs[job_id] = {
                    "job_id": job_id, "state": "RUNNING",
                    "driver_address": tuple(p.get("driver_address") or ()),
                    "start_time": time.time(),
                    "entrypoint": p.get("entrypoint", "")}
            # idempotent re-register (e.g. after a GCS restart) must still
            # bind this connection to the job for disconnect cleanup
            conn.peer = job_id
        return {"ok": True}

    def _rpc_finish_job(self, conn, p):
        with self._lock:
            self._finish_job_locked(p["job_id"])
        return {"ok": True}

    def _finish_job_locked(self, job_id: str) -> None:
        job = self._jobs.get(job_id)
        if job and job["state"] == "RUNNING":
            job["state"] = "FINISHED"
            job["end_time"] = time.time()
            # non-detached actors of the job die with it — and their worker
            # processes must actually be killed so their lease resources free
            doomed = []
            for aid, a in self._actors.items():
                if a.get("job_id") == job_id and not a.get("detached") \
                        and a["state"] != DEAD:
                    a["state"] = DEAD
                    a["death_cause"] = "job finished"
                    node_conn = self._node_conns.get(a.get("node_id") or "")
                    doomed.append((aid, node_conn))
                    if a.get("name"):
                        self._named_actors.pop(
                            (a.get("namespace", ""), a["name"]), None)
            for aid, node_conn in doomed:
                if node_conn is not None:
                    try:
                        node_conn.push("kill_actor_worker", {"actor_id": aid})
                    except ConnectionError:
                        pass
            self._publish("job", {"job_id": job_id, "state": "FINISHED"})
            # per-actor hints keep the WAL record O(affected), not a
            # whole-table pickle under the global lock (_named_actors is
            # a handful of entries — whole-table is fine there)
            self._mark_dirty(("_jobs", job_id),
                             *((("_actors", aid) for aid, _ in doomed)),
                             ("_named_actors", None))

    def _rpc_list_jobs(self, conn, p):
        with self._lock:
            return [dict(j) for j in self._jobs.values()]

    # ----------------------------------------------------------- task events
    def _rpc_task_events_put(self, conn, p):
        """Workers flush TaskEventBuffer batches here (cf. reference
        TaskInfoGcsService.AddTaskEventData, gcs_service.proto:635)."""
        return {"dropped": self._task_table.put_events(p["events"])}

    def _rpc_list_task_events(self, conn, p):
        return self._task_table.list(
            job_id=p.get("job_id"), state=p.get("state"),
            name=p.get("name"), limit=int(p.get("limit", 10000)))

    # ------------------------------------------------------------------- kv
    def _metrics_kv_put(self, key: str, value: bytes) -> None:
        """Runtime-metrics flusher sink: plain KV write, never WALed."""
        with self._lock:
            self._kv[key] = value
        from ray_tpu_torch._private import metrics_history as mh
        if mh.history_on():
            self._history.ingest(key, value)

    def _rpc_kv_put(self, conn, p):
        with self._lock:
            existed = p["key"] in self._kv
            if p.get("overwrite", True) or not existed:
                self._kv[p["key"]] = p["value"]
        # worker metrics flushers arrive over this generic RPC (their
        # sink is a kv_put call): stage them for the history plane too
        # (batched fold — the RPC reply never waits on ring work)
        if p["key"].startswith("metrics/"):
            from ray_tpu_torch._private import metrics_history as mh
            if mh.history_on():
                self._history.ingest(p["key"], p["value"])
        return {"existed": existed}

    def _rpc_kv_get(self, conn, p):
        with self._lock:
            return self._kv.get(p["key"])

    def _rpc_kv_del(self, conn, p):
        with self._lock:
            return {"deleted": self._kv.pop(p["key"], None) is not None}

    def _rpc_kv_keys(self, conn, p):
        prefix = p.get("prefix", "")
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    def _rpc_kv_exists(self, conn, p):
        with self._lock:
            return p["key"] in self._kv

    # --------------------------------------------------------------- pubsub
    def _rpc_subscribe(self, conn, p):
        with self._lock:
            self._subs.setdefault(p["channel"], []).append(conn)
        return {"ok": True}

    def _rpc_publish(self, conn, p):
        self._publish(p["channel"], p["message"])
        return {"ok": True}

    def _publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, []))
        for c in subs:
            try:
                c.push("pubsub", {"channel": channel, "message": message})
            except ConnectionError:
                pass

    # --------------------------------------------------------------- actors
    def _rpc_register_actor(self, conn, p):
        """Register + schedule an actor; cf. GcsActorManager::HandleRegisterActor
        (/root/reference/src/ray/gcs/gcs_server/gcs_actor_manager.cc:240) and
        GcsActorScheduler (gcs_actor_scheduler.h:111)."""
        aid = p["actor_id"]
        with self._lock:
            if aid in self._actors:
                return dict(self._actors[aid])
            name = p.get("name")
            ns = p.get("namespace", "")
            if name and (ns, name) in self._named_actors:
                raise ValueError(f"actor name {name!r} already taken")
            entry = {
                "actor_id": aid,
                "caller_node_id": p.get("caller_node_id"),
                "job_id": p.get("job_id"),
                "name": name,
                "namespace": ns,
                "detached": bool(p.get("detached")),
                "state": PENDING_CREATION,
                "spec": p["spec"],          # opaque creation task spec bytes
                "resources": dict(p.get("resources", {})),
                "max_restarts": int(p.get("max_restarts", 0)),
                "restarts": 0,
                "node_id": None,
                "address": None,
                "death_cause": None,
                "bundle": p.get("bundle"),  # [pg_id_hex, index] or None
                "strategy": p.get("strategy"),  # node_affinity/spread dict
                "language": p.get("language"),  # None/python, or "cpp"
                "runtime_env": p.get("runtime_env"),
                # the actor whose process made this one: it dies with it
                "owner_actor_id": p.get("owner_actor_id"),
            }
            self._actors[aid] = entry
            if name:
                self._named_actors[(ns, name)] = aid
        # dispatch asynchronously: Actor.remote() must return immediately
        # even if __init__ blocks (e.g. on a collective rendezvous with
        # peers created later) — reference semantics: GcsActorManager
        # schedules out-of-band, clients poll actor state.
        threading.Thread(target=self._schedule_actor, args=(aid,),
                         daemon=True).start()
        return {"ok": True}

    def _schedule_actor(self, aid: str) -> None:
        with self._lock:
            entry = self._actors.get(aid)
            if entry is None or entry["state"] == DEAD \
                    or entry.get("dispatched"):
                return
            need = entry["resources"]
            bundle = entry.get("bundle")
            strategy = entry.get("strategy") or {}
            fail_reason = None
            # candidates: [(node_id, bundle_or_None), ...] tried in order
            candidates = []
            if bundle is not None:
                # actor is pinned to a placement-group bundle: it must land
                # on the node holding that reserved bundle
                pg = self._placement_groups.get(bundle[0])
                if pg is None:
                    fail_reason = \
                        f"placement group {bundle[0][:8]} removed"
                elif pg["state"] != "CREATED":
                    logger.info("actor %s pending: placement group pending",
                                aid[:8])
                    entry.pop("retry_delay", None)
                    return
                else:
                    idx = int(bundle[1])
                    placement = pg["placement"]
                    if idx >= len(placement) or idx < -1:
                        fail_reason = (
                            f"bundle index {idx} out of range for "
                            f"{len(placement)}-bundle placement group")
                    else:
                        indices = [idx] if idx >= 0 \
                            else list(range(len(placement)))
                        # an actor asking more than its bundle reserves can
                        # never be placed — fail instead of retrying forever
                        specs = pg["bundles"]
                        fits = [i for i in indices
                                if all(specs[i].get(r, 0) >= v
                                       for r, v in need.items())]
                        if not fits:
                            fail_reason = (
                                f"actor requires {need} but no bundle of "
                                f"placement group {bundle[0][:8]} reserves "
                                "that much")
                        for i in fits:
                            node = self._nodes.get(placement[i])
                            if node is not None and node["alive"]:
                                candidates.append(
                                    (node["node_id"], [bundle[0], i]))
                        if not candidates and fail_reason is None:
                            entry.pop("retry_delay", None)
                            return  # bundle nodes gone; pg will reschedule
            elif strategy.get("type") == "node_affinity":
                node = self._nodes.get(strategy["node_id"])
                if node is not None and node["alive"]:
                    candidates.append((node["node_id"], None))
                elif not strategy.get("soft"):
                    fail_reason = (
                        f"node {strategy['node_id'][:8]} not found/alive "
                        "(hard node affinity)")
                if not candidates and fail_reason is None:
                    # soft affinity falls back to the default policy
                    strategy = {}
            if not candidates and fail_reason is None and bundle is None \
                    and strategy.get("type") != "node_affinity":
                def _fits(node):
                    # milli-unit rounding to match the scheduler's fixed-
                    # point arithmetic (csrc/scheduler.cc) exactly
                    return all(
                        int(round(node["available"].get(r, 0) * 1000))
                        >= int(round(v * 1000)) for r, v in need.items())
                # draining nodes are about to disappear: placing new
                # actors there guarantees an immediate restart
                feasible = [node for node in self._nodes.values()
                            if node["alive"] and not node.get("draining")
                            and _fits(node)]
                spread = strategy.get("type") == "spread"
                if spread:
                    # most-available-CPU first (cf. SpreadSchedulingPolicy)
                    feasible.sort(
                        key=lambda n: -n["available"].get("CPU", 0))
                elif len(feasible) > 1:
                    # rank the primary choice with the native hybrid policy
                    # (csrc/scheduler.cc; cf. hybrid_scheduling_policy.h:48):
                    # pack near the creator until it crosses the spill
                    # threshold; remaining feasible nodes stay as fallbacks
                    best = self._cluster_scheduler.best_node(
                        need, local_id=entry.get("caller_node_id"))
                    if best is not None:
                        feasible.sort(
                            key=lambda n: n["node_id"] != best)
                for node in feasible:
                    candidates.append((node["node_id"], None))
            if fail_reason is None and not candidates:
                # no feasible node now; retried on the next node registration
                # (kept pending even if infeasible against total capacity —
                # the autoscaler scales from pending demand — but say which)
                if not self._cluster_scheduler.feasible_anywhere(need):
                    logger.warning(
                        "actor %s pending: infeasible with current cluster "
                        "total resources (%s); waiting for the cluster to "
                        "grow", aid[:8], need)
                else:
                    logger.info("actor %s pending: no feasible node", aid[:8])
                # hand the entry back to _retry_pending_actors (a stale
                # retry_delay would park it forever: nothing else retries)
                entry.pop("retry_delay", None)
                return
            if fail_reason is None:
                entry["dispatched"] = True
        if fail_reason is not None:
            self._on_actor_failure(aid, fail_reason)
            return
        last_err = None
        for node_id, cand_bundle in candidates:
            with self._lock:
                entry["node_id"] = node_id
                node_conn = self._node_conns.get(node_id)
            if node_conn is None:
                last_err = f"no connection to node {node_id[:8]}"
                continue
            try:
                node_conn.call("create_actor", {
                    "actor_id": aid,
                    "spec": entry["spec"],
                    "resources": entry["resources"],
                    "bundle": cand_bundle,
                    "runtime_env": entry.get("runtime_env"),
                    "language": entry.get("language"),
                }, timeout=CONFIG.actor_creation_timeout_s)
                with self._lock:
                    entry.pop("retry_delay", None)
                    killed_mid_flight = entry["state"] == DEAD
                if killed_mid_flight:
                    # kill_actor raced this dispatch: the kill push found
                    # nothing on the node yet, so the worker+resources it
                    # just acquired would leak without this reap
                    try:
                        node_conn.push("kill_actor_worker",
                                       {"actor_id": aid})
                    except ConnectionError:
                        pass
                return
            except (rpc.RemoteError, ConnectionError, TimeoutError) as e:
                last_err = e
                # only a resource shortfall is worth trying elsewhere; a
                # user __init__ error would just re-raise on every node
                if isinstance(e, rpc.RemoteError) and \
                        "resources unavailable" not in str(e):
                    break
                continue
        if isinstance(last_err, rpc.RemoteError) and \
                "resources unavailable" in str(last_err):
            # candidate node(s) alive but momentarily out of resources
            # (pinned affinity/bundle): park the actor pending and retry
            # with backoff, like the no-feasible-node path, instead of
            # failing it
            logger.info("actor %s pending: %s", aid[:8], last_err)
            with self._lock:
                entry["dispatched"] = False
                entry["node_id"] = None
                delay = entry.get("retry_delay", 0.2)
                entry["retry_delay"] = min(delay * 2, 5.0)
                if strategy.get("type") == "node_affinity" \
                        and strategy.get("soft"):
                    # soft affinity: the pinned node is full — fall back to
                    # the default policy rather than hammering that node
                    entry["strategy"] = None
            timer = threading.Timer(delay, self._schedule_actor, args=(aid,))
            timer.daemon = True
            timer.start()
            return
        reason = repr(last_err) if last_err is not None else "no candidates"
        logger.warning("actor %s creation dispatch failed: %s",
                       aid[:8], reason)
        self._on_actor_failure(aid, f"creation failed: {reason}")

    def _rpc_actor_ready(self, conn, p):
        """Called by the actor's worker once __init__ completed."""
        with self._lock:
            entry = self._actors.get(p["actor_id"])
            if entry is None:
                return {"ok": False}
            dead = entry["state"] == DEAD
            if dead:
                # killed while __init__ ran: reap instead of resurrecting
                node_conn = self._node_conns.get(entry.get("node_id") or "")
            else:
                entry["state"] = ALIVE
                entry["address"] = tuple(p["address"])
                # a successful restart voids the previous crash's
                # dossier reference — the next death names its own
                entry.pop("death_worker_id", None)
        if dead:
            if node_conn is not None:
                try:
                    node_conn.push("kill_actor_worker",
                                   {"actor_id": p["actor_id"]})
                except ConnectionError:
                    pass
            return {"ok": False, "dead": True}
        self._publish("actor", {"actor_id": p["actor_id"], "state": ALIVE,
                                "address": tuple(p["address"])})
        return {"ok": True}

    def _rpc_actor_failed(self, conn, p):
        self._on_actor_failure(p["actor_id"], p.get("reason", "worker died"),
                               worker_id=p.get("worker_id"))
        return {"ok": True}

    def _on_actor_failure(self, aid: str, reason: str,
                          worker_id: Optional[str] = None) -> None:
        """Actor restart FSM; cf. GcsActorManager::OnActorCreationFailed /
        SchedulePendingActors (gcs_actor_manager.cc:1233)."""
        with self._lock:
            entry = self._actors.get(aid)
            if entry is None:
                return
            if worker_id:
                # the worker whose death caused (or followed — a
                # kill_actor marks DEAD before the raylet reports the
                # worker's exit) this transition: the handle that
                # points ActorDiedError.debug_dossier() at the dossier.
                # Overwrite while the actor is live (each failure's
                # worker supersedes the last restart's); once DEAD,
                # first writer wins — a late duplicate report must not
                # repoint an already-propagated reference.
                if entry["state"] != DEAD or \
                        not entry.get("death_worker_id"):
                    entry["death_worker_id"] = worker_id
            if entry["state"] == DEAD:
                return
            if entry["restarts"] < entry["max_restarts"]:
                entry["restarts"] += 1
                entry["state"] = RESTARTING
                entry["address"] = None
                entry["dispatched"] = False
                restart = True
            else:
                entry["state"] = DEAD
                entry["death_cause"] = reason
                restart = False
        # dirty AFTER the state transition: marking first lets the snapshot
        # tick clear the flag and persist the pre-transition tables
        self._mark_dirty(("_actors", aid))
        self._publish("actor", {"actor_id": aid,
                                "state": RESTARTING if restart else DEAD,
                                "reason": reason})
        self.record_event("WARNING" if restart else "ERROR", "gcs",
                          "ACTOR_RESTARTING" if restart else "ACTOR_DEAD",
                          f"actor {aid[:8]}: {reason}", actor_id=aid,
                          worker_id=worker_id)
        if restart:
            logger.info("restarting actor %s (%s)", aid[:8], reason)
            self._schedule_actor(aid)
        else:
            self._reap_owned(aid)

    def _reap_owned(self, owner: str) -> None:
        """An actor is dead for good: the placement groups it made are
        removed (their actors die with them) and the actors it made die,
        down the tree, unless detached (Ray's owner fate sharing;
        gcs_actor_manager.cc OnWorkerDead -> DestroyActor of the owned
        actors).  Without it a trainer's worker leasing a card outlives
        the trial actor Tune kills, and the card is never freed."""
        with self._lock:
            pgs = [pgid for pgid, pg in self._placement_groups.items()
                   if pg.get("owner_actor_id") == owner]
            kids = [aid for aid, a in self._actors.items()
                    if a.get("owner_actor_id") == owner
                    and not a.get("detached") and a["state"] != DEAD]
        for pgid in pgs:
            self._rpc_remove_placement_group(None, {"pg_id": pgid})
            self._mark_dirty(("_placement_groups", pgid),
                             ("_named_actors", None))
        for aid in kids:
            self._rpc_kill_actor(None, {"actor_id": aid},
                                 reason=f"owner {owner[:8]} died")
            self._mark_dirty(("_actors", aid), ("_named_actors", None))

    def _rpc_get_actor(self, conn, p):
        aid = p.get("actor_id")
        with self._lock:
            if aid is None:
                key = (p.get("namespace", ""), p["name"])
                aid = self._named_actors.get(key)
                if aid is None:
                    return None
            entry = self._actors.get(aid)
            return dict(entry, spec=None) if entry else None

    def _rpc_list_actors(self, conn, p):
        with self._lock:
            return [dict(a, spec=None) for a in self._actors.values()]

    def _rpc_kill_actor(self, conn, p, reason: str = "killed via kill_actor"):
        aid = p["actor_id"]
        with self._lock:
            entry = self._actors.get(aid)
            if entry is None:
                return {"ok": False}
            was_dead = entry["state"] == DEAD
            entry["state"] = DEAD
            entry["death_cause"] = reason
            entry["max_restarts"] = 0
            addr = entry.get("address")
            node_conn = self._node_conns.get(entry.get("node_id") or "")
            if entry.get("name"):
                self._named_actors.pop(
                    (entry.get("namespace", ""), entry["name"]), None)
        if node_conn is not None:
            try:
                node_conn.push("kill_actor_worker", {"actor_id": aid})
            except ConnectionError:
                pass
        self._publish("actor", {"actor_id": aid, "state": DEAD,
                                "reason": "killed"})
        if not was_dead:
            self._reap_owned(aid)
        return {"ok": True, "address": addr}

    # ----------------------------------------------------- placement groups
    def _rpc_create_placement_group(self, conn, p):
        """Register a placement group and try to place it now; otherwise it
        stays PENDING and is retried as nodes join (cf. reference
        GcsPlacementGroupManager / GcsPlacementGroupScheduler 2PC)."""
        pgid = p["pg_id"]
        pg = {
            "pg_id": pgid, "state": "PENDING", "bundles": p["bundles"],
            "strategy": p.get("strategy", "PACK"),
            "name": p.get("name", ""), "placement": None,
            "job_id": p.get("job_id"),
            "owner_actor_id": p.get("owner_actor_id"),
        }
        with self._lock:
            existing = self._placement_groups.get(pgid)
            if existing is not None:
                return {"state": existing["state"]}
            self._placement_groups[pgid] = pg
        self._try_place_pg(pg)
        return {"state": pg["state"], "placement": pg["placement"]}

    def _try_place_pg(self, pg) -> bool:
        """Plan a placement, then 2-phase reserve the bundles on the chosen
        raylets (reserve_bundle; rollback with return_bundle on failure)."""
        pgid = pg["pg_id"]
        with self._lock:
            if pg["state"] != "PENDING" or pg.get("placing"):
                return pg["state"] == "CREATED"
            if self._placement_groups.get(pgid) is not pg:
                return False   # removed (or re-registered) concurrently
            nodes = [n for n in self._nodes.values()
                     if n["alive"] and not n.get("draining")]
            placement = self._pack_bundles(pg["bundles"], pg["strategy"],
                                           nodes)
            if placement is None:
                return False
            # single in-flight placer per group: concurrent attempts (client
            # RPC vs node-registration retry) would double-reserve bundles
            pg["placing"] = True
            # optimistic deduction on the GCS view so concurrent planners
            # don't double-book; raylet heartbeats reconcile it afterwards
            for bundle, node_id in zip(pg["bundles"], placement):
                node = self._nodes[node_id]
                for r, v in bundle.items():
                    node["available"][r] = node["available"].get(r, 0) - v
            conns = {nid: self._node_conns.get(nid) for nid in placement}
        try:
            return self._reserve_pg_bundles(pg, placement, conns)
        finally:
            with self._lock:
                pg["placing"] = False
            # after the transition so the snapshot can't persist pre-state
            self._mark_dirty(("_placement_groups", pg["pg_id"]))

    def _reserve_pg_bundles(self, pg, placement, conns) -> bool:
        pgid = pg["pg_id"]
        reserved = []
        failed = False
        for i, (bundle, nid) in enumerate(zip(pg["bundles"], placement)):
            node_conn = conns.get(nid)
            ok = False
            if node_conn is not None:
                try:
                    reply = node_conn.call(
                        "reserve_bundle",
                        {"pg_id": pgid, "index": i, "resources": bundle},
                        timeout=10)
                    ok = bool(reply and reply.get("ok"))
                except (ConnectionError, rpc.RpcError, TimeoutError):
                    ok = False
            if not ok:
                failed = True
                break
            reserved.append((i, nid))
        if failed:
            for i, nid in reserved:
                node_conn = conns.get(nid)
                if node_conn is None:
                    continue
                try:
                    node_conn.call("return_bundle",
                                   {"pg_id": pgid, "index": i}, timeout=10)
                except (ConnectionError, rpc.RpcError, TimeoutError):
                    pass
            with self._lock:  # roll back the optimistic view deduction
                for bundle, node_id in zip(pg["bundles"], placement):
                    node = self._nodes.get(node_id)
                    if node and node["alive"]:
                        for r, v in bundle.items():
                            node["available"][r] = \
                                node["available"].get(r, 0) + v
            return False
        with self._lock:
            if self._placement_groups.get(pgid) is not pg:
                removed_during_placement = True
            else:
                removed_during_placement = False
                pg["state"] = "CREATED"
                pg["placement"] = placement
        if removed_during_placement:
            # remove_placement_group won the race: release what we reserved
            for i, nid in reserved:
                node_conn = conns.get(nid)
                if node_conn is None:
                    continue
                try:
                    node_conn.call("return_bundle",
                                   {"pg_id": pgid, "index": i}, timeout=10)
                except (ConnectionError, rpc.RpcError, TimeoutError):
                    pass
            return False
        self._publish("placement_group", {"pg_id": pgid, "state": "CREATED"})
        # actors parked on this group's bundles can now be scheduled
        with self._lock:
            parked = [aid for aid, a in self._actors.items()
                      if a.get("bundle") and a["bundle"][0] == pgid
                      and a["state"] in (PENDING_CREATION, RESTARTING)
                      and not a.get("dispatched")]
        for aid in parked:
            self._schedule_actor(aid)
        return True

    def _pack_bundles(self, bundles, strategy, nodes) -> Optional[List[str]]:
        """Bin-pack bundles onto nodes. TPU-slice awareness: if any bundle
        names a ``tpu-slice`` resource, candidate nodes are restricted to a
        single slice (node label ``tpu-slice``) so the group is atomic on
        one pod slice (SURVEY.md §2.6)."""
        slice_bundles = any("tpu-slice" in b for b in bundles)
        if slice_bundles:
            slices: Dict[str, List[dict]] = {}
            for n in nodes:
                label = n.get("labels", {}).get("tpu-slice")
                if label:
                    slices.setdefault(label, []).append(n)
            for _, group in sorted(slices.items()):
                placement = self._pack_bundles_on(bundles, strategy, group)
                if placement is not None:
                    return placement
            return None
        return self._pack_bundles_on(bundles, strategy, nodes)

    def _pack_bundles_on(self, bundles, strategy, nodes
                         ) -> Optional[List[str]]:
        avail = {n["node_id"]: dict(n["available"]) for n in nodes}
        order = list(avail.keys())
        placement = []
        for bundle in bundles:
            placed = None
            candidates = order if strategy in ("PACK", "STRICT_PACK") \
                else sorted(order, key=lambda nid: -min(
                    avail[nid].get(r, 0) for r in bundle) if bundle else 0)
            for nid in candidates:
                if all(avail[nid].get(r, 0) >= v for r, v in bundle.items()):
                    placed = nid
                    break
            if placed is None:
                return None
            if strategy == "STRICT_PACK" and placement and \
                    placed != placement[0]:
                return None
            for r, v in bundle.items():
                avail[placed][r] -= v
            placement.append(placed)
        if strategy == "STRICT_SPREAD" and \
                len(set(placement)) != len(placement):
            return None
        return placement

    def _rpc_get_placement_group(self, conn, p):
        with self._lock:
            pg = self._placement_groups.get(p["pg_id"])
            return dict(pg) if pg else None

    def _rpc_list_placement_groups(self, conn, p):
        with self._lock:
            return {pgid: dict(pg)
                    for pgid, pg in self._placement_groups.items()}

    def _rpc_remove_placement_group(self, conn, p):
        pgid = p["pg_id"]
        with self._lock:
            pg = self._placement_groups.pop(pgid, None)
            if pg is None:
                return {"ok": False}
            placement = pg.get("placement") or []
            conns = {nid: self._node_conns.get(nid) for nid in placement}
            # actors living in (or parked on) this group die with it
            # (reference semantics: GcsPlacementGroupManager kills actors
            # of removed groups)
            doomed = [
                (aid, self._node_conns.get(a.get("node_id") or ""))
                for aid, a in self._actors.items()
                if a.get("bundle") and a["bundle"][0] == pgid
                and a["state"] != DEAD]
        for aid, node_conn in doomed:
            if node_conn is not None:
                try:
                    node_conn.push("kill_actor_worker", {"actor_id": aid})
                except ConnectionError:
                    pass
            self._on_actor_failure(aid, "placement group removed")
        for i, nid in enumerate(placement):
            node_conn = conns.get(nid)
            if node_conn is None:
                continue
            try:
                node_conn.call("return_bundle",
                               {"pg_id": pgid, "index": i}, timeout=10)
            except (ConnectionError, rpc.RpcError, TimeoutError):
                pass
        self._publish("placement_group",
                      {"pg_id": pgid, "state": "REMOVED"})
        return {"ok": True}


class GcsClient:
    """Thin client; one duplex connection, also carries pubsub pushes.

    Transport failures trigger transparent reconnects (bounded by the call
    timeout) so clients ride through a GCS restart — the reference's
    gcs_rpc_client reconnection/backoff behavior.  Subscriptions are
    replayed on the fresh connection."""

    def __init__(self, address: Tuple[str, int],
                 push_handler=None, timeout: Optional[float] = None,
                 handler=None, connect_retry: bool = False):
        self._address = tuple(address)
        self._timeout = timeout or CONFIG.gcs_rpc_timeout_s
        self._sub_lock = threading.Lock()
        self._sub_handlers: Dict[str, List] = {}
        self._user_push = push_handler
        self._handler = handler
        self._conn_lock = threading.Lock()
        self._closed = False
        # called with this client after a successful reconnect, so owners
        # of identity state (e.g. the driver's job binding) can restore it
        self.on_reconnect = None
        # ``handler`` serves requests the GCS sends *to us* over this duplex
        # connection (e.g. create_actor dispatched to a raylet).
        # ``connect_retry`` (daemon call sites only — raylet, dashboard,
        # monitor): the FIRST connect retries with bounded backoff,
        # because a freshly spawned daemon races the GCS's accept loop
        # under box load — the address file is published once the
        # socket listens, but a loaded host can starve the acceptor
        # long enough for a connect burst to be refused.  One refused
        # connect must not kill the raylet at spawn (the load-dependent
        # startup-race flake); the window is daemon_connect_retry_s.
        # Interactive clients (init(address=...), the CLI) keep
        # fail-fast semantics: a dead or mistyped address raises
        # immediately.
        if connect_retry:
            self._conn = self._connect_with_retry(handler)
        else:
            self._conn = rpc.connect(self._address,
                                     push_handler=self._on_push,
                                     handler=handler)

    def _connect_with_retry(self, handler) -> rpc.Connection:
        deadline = time.monotonic() + CONFIG.daemon_connect_retry_s
        delay = 0.05
        while True:
            try:
                return rpc.connect(self._address,
                                   push_handler=self._on_push,
                                   handler=handler)
            except ConnectionError:
                # ConnectionError only: a resolver failure (gaierror, a
                # mistyped host) can never heal and must fail fast
                if time.monotonic() >= deadline:
                    raise
                time.sleep(min(delay, max(0.0,
                                          deadline - time.monotonic())))
                delay = min(delay * 2, 1.0)

    def _on_push(self, method: str, payload: Any) -> None:
        if method == "pubsub":
            channel = payload["channel"]
            with self._sub_lock:
                handlers = list(self._sub_handlers.get(channel, []))
            for h in handlers:
                try:
                    h(payload["message"])
                except Exception:
                    logger.exception("pubsub handler error on %s", channel)
        elif self._user_push is not None:
            self._user_push(method, payload)

    def _reconnect(self) -> None:
        with self._conn_lock:
            if self._closed or not self._conn.closed:
                return
            conn = rpc.connect(self._address, push_handler=self._on_push,
                               handler=self._handler)
            with self._sub_lock:
                channels = list(self._sub_handlers)
            for channel in channels:
                conn.call("subscribe", {"channel": channel},
                          timeout=self._timeout)
            self._conn = conn
            logger.info("GCS connection re-established to %s", self._address)
        if self.on_reconnect is not None:
            try:
                self.on_reconnect(self)
            except Exception:
                logger.warning("GCS on_reconnect callback failed",
                               exc_info=True)

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None) -> Any:
        t = timeout or self._timeout
        deadline = None if t is None else time.monotonic() + t
        while True:
            conn = self._conn
            try:
                if conn.closed:
                    raise ConnectionError("GCS connection closed")
                return conn.call(method, payload, timeout=t)
            except (ConnectionError, OSError):
                if self._closed or (deadline is not None
                                    and time.monotonic() >= deadline):
                    raise
                # A send-side OSError can surface as ConnectionError with
                # the conn not yet marked closed (the reader thread closes
                # it asynchronously); close it ourselves so _reconnect
                # actually reconnects instead of no-opping, and so we
                # don't busy-spin on the broken socket. NOTE: retrying
                # re-sends RPCs that may already have been applied
                # server-side — every GCS mutating RPC must stay
                # idempotent (they key on caller-chosen ids, not counters).
                try:
                    conn.close()
                except Exception:
                    pass
                try:
                    self._reconnect()
                except (ConnectionError, OSError, rpc.RpcError,
                        TimeoutError):
                    pass
                if self._conn.closed:
                    time.sleep(0.2)

    def subscribe(self, channel: str, handler) -> None:
        with self._sub_lock:
            self._sub_handlers.setdefault(channel, []).append(handler)
        self.call("subscribe", {"channel": channel})

    # convenience KV API (cf. reference internal_kv)
    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.call("kv_put", {"key": key, "value": value,
                                    "overwrite": overwrite})["existed"]

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.call("kv_get", {"key": key})

    def kv_del(self, key: str) -> bool:
        return self.call("kv_del", {"key": key})["deleted"]

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.call("kv_keys", {"prefix": prefix})

    def kv_exists(self, key: str) -> bool:
        return self.call("kv_exists", {"key": key})

    def close(self) -> None:
        self._closed = True
        self._conn.close()

    @property
    def closed(self) -> bool:
        return self._conn.closed


def main():  # pragma: no cover - spawned as a subprocess
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-dir", default=None)
    parser.add_argument("--address-file", default=None)
    args = parser.parse_args()
    from ray_tpu_torch._private.logging_utils import (enable_stack_dumps,
                                                 setup_component_logging)
    setup_component_logging("gcs_server", args.session_dir)
    enable_stack_dumps(args.session_dir)
    persist = (os.path.join(args.session_dir, "gcs_snapshot.pkl")
               if args.session_dir else None)
    server = GcsServer(args.host, args.port, persist_path=persist)
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": server.address[0],
                       "port": server.address[1]}, f)
        os.replace(tmp, args.address_file)
    logger.info("GCS serving at %s", server.address)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
