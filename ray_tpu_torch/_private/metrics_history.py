"""The sixth observability plane: metrics history + recovery auditing.

The five existing planes answer "what is happening NOW" (metrics
snapshots), "what happened" (typed events + dossiers), "how fast is
training" (step stats), "where did a request go" (traces) and "what
did tasks do" (task events).  None of them answers the two questions a
preemption post-mortem actually starts with: *what did the pool look
like during the outage* and *how long did recovery take* — the first
needs metric values over a window, the second is hand-computed from
event timestamps inside individual tests today.  This module is that
layer, GCS-side like every other table:

* **GcsMetricsHistoryTable** — the metrics sink's KV writes
  (``metrics/{name}/{ident}``) additionally land in a bounded,
  multi-resolution downsampled ring per series (default 1s x 120 /
  10s x 180 / 60s x 120: two minutes fine, half an hour medium, two
  hours coarse).  Within a bucket last-write-wins — the flusher
  snapshots are already cumulative, so keeping the newest payload per
  bucket IS downsampling for counters/histograms and sample-and-hold
  for gauges.  Payloads are stored as raw bytes and parsed only at
  query time: the record path is a ring append, not a JSON parse.
  Count- AND byte-budgeted like the event/span tables.

* **RecoveryAuditor** — folds the typed event stream into first-class
  recovery *episodes*: NODE_PREEMPTING -> NODE_DRAINED (drain latency
  + evacuation ledger), NODE_PREEMPTING/NODE_DEAD ->
  TRAIN_GANG_RECOVERY (time-to-failover + re-executed-step lost
  work), REPLICA_RETIRED -> AUTOSCALE (pool-heal latency), plus
  TRANSFER_FAILOVER counts.  Episodes are classified against the
  ``recovery_slo_*`` targets, published as ``ray_tpu_recovery_*``
  metric families (which the history table then retains — the auditor
  feeds the plane it rides on) and kept in a bounded per-episode table
  whose per-kind counters survive rotation, exactly like the event
  table's ``counts_by_type``.

* **doctor** — ``build_doctor_report`` correlates one snapshot of all
  six planes (node health, recent events, episodes + SLO violations,
  straggler flags, worst-trace exemplars, open dossiers, history
  stats) into ranked findings with evidence lines; the pure-function
  split keeps it unit-testable without a cluster and reusable by the
  CLI (``ray-tpu doctor``), the dashboard (``/api/doctor``) and the
  one-shot ``ray-tpu debug-bundle`` tarball.

Kill switch: ``RAY_TPU_TORCH_METRICS_HISTORY`` env wins, then
``CONFIG.metrics_history_enabled``; hot-path call sites read the
``history_on()`` generation-keyed cache (the tracing ``_flags``
idiom).  Everything here is ephemeral — never WALed, like metrics,
events and traces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private.config import CONFIG


def enabled() -> bool:
    """Kill switch: RAY_TPU_TORCH_METRICS_HISTORY env wins, then the flag."""
    raw = os.environ.get("RAY_TPU_TORCH_METRICS_HISTORY")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return CONFIG.metrics_history_enabled


# enabled() is consulted on every metrics KV write and every event-table
# put reaching the GCS: cache the verdict keyed on the CONFIG override
# generation so the steady state pays a tuple compare, not an env read
# plus a config lock
_flag_cache = (-1, False)


def history_on() -> bool:
    global _flag_cache
    gen = CONFIG.generation()
    cached = _flag_cache
    if cached[0] != gen:
        cached = (gen, enabled())
        _flag_cache = cached
    return cached[1]


def parse_resolutions(spec: str) -> List[Tuple[float, int]]:
    """``"1:120,10:180,60:120"`` -> ``[(1.0, 120), (10.0, 180), ...]``
    (seconds-per-bucket : slots).  Malformed entries are skipped; an
    empty/unusable spec falls back to the declared default so a typo'd
    override degrades to the stock retention, not to no retention."""
    out: List[Tuple[float, int]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            res, slots = part.split(":")
            res_s, nslots = float(res), int(slots)
        except ValueError:
            continue
        if res_s > 0 and nslots > 0:
            out.append((res_s, nslots))
    if not out:
        out = [(1.0, 120), (10.0, 180), (60.0, 120)]
    return sorted(out)


# ------------------------------------------------------- history table
class GcsMetricsHistoryTable:
    """Bounded multi-resolution retention over the metrics KV stream.

    One series per KV key (``metrics/{name}/{ident}``); per series one
    ring per configured resolution, each slot holding the newest raw
    payload whose arrival time fell in that bucket.  The record path is
    O(1) in the common case: each write just replaces the series'
    single **pending** value (last-write-wins for every live bucket at
    once), and the rings are only touched when a write crosses
    ``next_roll`` — the earliest upcoming bucket boundary across the
    rings — at which point the pending value is sealed into every ring
    whose bucket closed.  The live bucket is synthesized from the
    pending value at query time, so readers still see the newest
    sample; the flusher-driven ingest path never pays per-ring work.

    The GCS KV path goes through :meth:`ingest`, which defers even
    that: the write is stamped with its arrival time, appended to a
    lock-free staging deque, and folded in batches of
    ``_INGEST_BATCH`` under a single lock acquisition — so the RPC
    reply never waits on table work, the way span shipping rides the
    tracing flusher thread instead of the submit path.  Readers drain
    the staging queue first (read-your-writes), and bucket assignment
    uses the stamped arrival time, so batching changes *when* the fold
    runs, never *what* it produces.

    Byte accounting charges every stored slot (the same payload may
    occupy one slot in each ring) plus one pending value per series;
    the budget sweep drops the globally oldest stored point first, and
    the series cap evicts the longest-idle series — both mirror the
    event table's oldest-first discipline."""

    # staged writes folded per lock acquisition: big enough to amortize
    # the lock + attribute traffic, small enough that one fold burst
    # (~60us) stays invisible next to an RPC round trip
    _INGEST_BATCH = 64

    def __init__(self, resolutions: Optional[List[Tuple[float, int]]] = None,
                 max_series: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        # binding time: the retention geometry is fixed at construction
        # (one table per GCS lifetime), like the event table's shard cap
        self._resolutions = (resolutions if resolutions is not None
                             else parse_resolutions(
                                 CONFIG.metrics_history_resolutions))
        self._max_series = (CONFIG.gcs_metrics_history_max_series
                            if max_series is None else max_series)
        self._max_bytes = (CONFIG.gcs_metrics_history_max_bytes
                           if max_bytes is None else max_bytes)
        self._lock = threading.Lock()
        # key -> {"name", "ident", "last_ts", "last_raw", "next_roll",
        #         "live": [bucket per ring],
        #         "rings": [deque[(bucket, ts, raw)]]}
        self._series: Dict[str, Dict[str, Any]] = {}
        self._bytes = 0
        self._dropped_points = 0
        self._evicted_series = 0
        # staging queue of (key, raw, arrival_ts) awaiting a batch fold;
        # deque append/popleft are atomic, so ingest() takes no lock
        self._staged: deque = deque()

    @staticmethod
    def _split_key(key: str) -> Tuple[str, str]:
        parts = key.split("/", 2)
        if len(parts) == 3 and parts[0] == "metrics":
            return parts[1], parts[2]
        return key, ""

    def ingest(self, key: str, raw: bytes) -> None:
        """Stage one KV write for folding: stamp its arrival time and
        return immediately; every ``_INGEST_BATCH``-th write folds the
        accumulated batch.  This is the hot-path entry the GCS KV
        handlers call — the RPC reply never waits on ring work."""
        self._staged.append((key, raw, time.time()))
        if len(self._staged) >= self._INGEST_BATCH:
            self.drain()

    def drain(self) -> None:
        """Fold every staged write (arrival-time-stamped, FIFO) into
        the rings.  Called by the batch threshold and by every reader,
        so queries always see writes that preceded them."""
        while True:
            try:
                key, raw, ts = self._staged.popleft()
            except IndexError:
                return
            self.record(key, raw, now=ts)

    def record(self, key: str, raw: bytes, now: Optional[float] = None) \
            -> None:
        """One flusher snapshot for ``key`` landed.  Fast path (no
        bucket boundary crossed since the last write): replace the
        series' pending value — one comparison, no ring work."""
        if not isinstance(raw, (bytes, bytearray)):
            raw = str(raw).encode()
        now = time.time() if now is None else now
        size = len(raw)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                name, ident = self._split_key(key)
                live = [int(now // res) for res, _ in self._resolutions]
                s = {"name": name, "ident": ident, "last_ts": now,
                     "last_raw": raw,
                     "next_roll": min((b + 1) * res for b, (res, _) in
                                      zip(live, self._resolutions)),
                     "live": live,
                     "rings": [deque() for _ in self._resolutions]}
                self._series[key] = s
                self._bytes += size
                while len(self._series) > self._max_series:
                    self._evict_idlest_series_locked()
            else:
                if now >= s["next_roll"]:
                    self._roll_locked(s, now)
                self._bytes += size - len(s["last_raw"])
                s["last_raw"] = raw
                s["last_ts"] = now
            if self._bytes > self._max_bytes:
                while self._bytes > self._max_bytes and self._series:
                    self._drop_oldest_point_locked()

    def _roll_locked(self, s: Dict[str, Any], now: float) -> None:
        """A write crossed a bucket boundary: seal the pending value
        into every ring whose live bucket closed (it was the last write
        of that bucket — last-write-wins), advance the live buckets,
        and recompute the earliest next boundary."""
        raw, ts = s["last_raw"], s["last_ts"]
        size = len(raw)
        live = s["live"]
        next_roll = None
        for i, (res, slots) in enumerate(self._resolutions):
            b = int(now // res)
            if b != live[i]:
                ring = s["rings"][i]
                ring.append((live[i], ts, raw))
                self._bytes += size
                while len(ring) > slots:
                    old = ring.popleft()
                    self._bytes -= len(old[2])
                    self._dropped_points += 1
                live[i] = b
            nr = (live[i] + 1) * res
            if next_roll is None or nr < next_roll:
                next_roll = nr
        s["next_roll"] = next_roll

    def _evict_idlest_series_locked(self) -> None:
        key = min(self._series, key=lambda k: self._series[k]["last_ts"])
        s = self._series.pop(key)
        self._bytes -= len(s["last_raw"])
        self._dropped_points += 1   # the pending value goes with it
        for ring in s["rings"]:
            for _, _, raw in ring:
                self._bytes -= len(raw)
                self._dropped_points += 1
        self._evicted_series += 1

    def _drop_oldest_point_locked(self) -> None:
        """Byte-budget sweep step: drop the globally oldest stored
        point (across all series and rings), oldest-ts-first like the
        event table's budget eviction.  When only pending values remain
        there is no stored point to drop, so the sweep falls back to
        evicting the longest-idle series whole."""
        best_ring, best_ts = None, None
        for s in self._series.values():
            for ring in s["rings"]:
                if ring and (best_ts is None or ring[0][1] < best_ts):
                    best_ring, best_ts = ring, ring[0][1]
        if best_ring is None:
            self._evict_idlest_series_locked()
            return
        old = best_ring.popleft()
        self._bytes -= len(old[2])
        self._dropped_points += 1

    def series(self) -> List[Dict[str, Any]]:
        self.drain()   # read-your-writes over the staging queue
        with self._lock:
            # per-ring counts are sealed points; every series also
            # carries one pending (live-bucket) value on top
            return [{"key": k, "name": s["name"], "ident": s["ident"],
                     "last_ts": s["last_ts"],
                     "points": [len(r) for r in s["rings"]]}
                    for k, s in sorted(self._series.items())]

    def query(self, name: Optional[str] = None,
              ident: Optional[str] = None,
              since: Optional[float] = None,
              resolution: Optional[float] = None,
              limit: int = 2000) -> List[Dict[str, Any]]:
        """Parsed points, oldest first.  ``resolution`` picks the ring
        whose bucket width is closest to the request (finest by
        default); payload JSON is decoded here, at query time, never on
        the record path."""
        self.drain()   # read-your-writes over the staging queue
        with self._lock:
            items = [(k, s) for k, s in self._series.items()
                     if (name is None or s["name"] == name)
                     and (ident is None or s["ident"] == ident)]
            raw_pts: List[Tuple[float, float, str, str, bytes]] = []
            for _k, s in items:
                idx = 0
                if resolution is not None:
                    idx = min(range(len(self._resolutions)),
                              key=lambda i: abs(
                                  self._resolutions[i][0] - resolution))
                res = self._resolutions[idx][0]
                for _bucket, ts, raw in s["rings"][idx]:
                    if since is not None and ts < since:
                        continue
                    raw_pts.append((ts, res, s["name"], s["ident"], raw))
                # the live bucket's value lives as the series' pending
                # slot until the bucket closes — surface it here so
                # readers always see the newest sample
                if since is None or s["last_ts"] >= since:
                    raw_pts.append((s["last_ts"], res, s["name"],
                                    s["ident"], s["last_raw"]))
        raw_pts.sort(key=lambda p: p[0])
        out: List[Dict[str, Any]] = []
        for ts, res, sname, sident, raw in raw_pts[-max(0, limit):]:
            try:
                blob = json.loads(raw)
            except (ValueError, TypeError):
                continue
            out.append({"ts": ts, "res_s": res, "name": sname,
                        "ident": sident,
                        "type": blob.get("type", "gauge"),
                        "values": blob.get("values", {})})
        return out

    def stats(self) -> Dict[str, Any]:
        self.drain()   # read-your-writes over the staging queue
        with self._lock:
            # sealed ring slots plus one pending value per series —
            # every point a query can surface
            points = sum(len(r) for s in self._series.values()
                         for r in s["rings"]) + len(self._series)
            return {"series": len(self._series), "points": points,
                    "bytes": self._bytes,
                    "max_series": self._max_series,
                    "max_bytes": self._max_bytes,
                    "resolutions": [list(r) for r in self._resolutions],
                    "dropped_points": self._dropped_points,
                    "evicted_series": self._evicted_series}


# --------------------------------------------------- recovery auditing
# episode latencies in SECONDS (not the default ms ladder): drains ride
# multi-second grace windows, failovers tens of seconds
RECOVERY_S_BOUNDARIES = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50,
                         100, 250, 600)

_M_DRAIN_S = rtm.histogram(
    "ray_tpu_recovery_drain_s",
    "NODE_PREEMPTING -> NODE_DRAINED latency per drain episode (s).",
    boundaries=RECOVERY_S_BOUNDARIES)
_M_FAILOVER_S = rtm.histogram(
    "ray_tpu_recovery_failover_s",
    "first failure event -> TRAIN_GANG_RECOVERY time-to-failover (s).",
    boundaries=RECOVERY_S_BOUNDARIES)
_M_HEAL_S = rtm.histogram(
    "ray_tpu_recovery_heal_s",
    "REPLICA_RETIRED -> next AUTOSCALE pool-heal latency (s).",
    boundaries=RECOVERY_S_BOUNDARIES)
_M_REROLE_S = rtm.histogram(
    "ray_tpu_recovery_rerole_s",
    "SERVE_REROLE -> SERVE_REROLE_DONE pool re-roling latency (s).",
    boundaries=RECOVERY_S_BOUNDARIES)
_M_RL_ACTOR_S = rtm.histogram(
    "ray_tpu_recovery_rl_actor_s",
    "RL_ACTOR_LOST -> RL_ACTOR_JOINED rollout-actor replacement "
    "latency per fleet slot (s).",
    boundaries=RECOVERY_S_BOUNDARIES)
_M_EPISODES = rtm.counter_family(
    "ray_tpu_recovery_episodes_total",
    "Closed recovery episodes by kind.", tag_keys=("kind",))
_M_SLO_VIOLATIONS = rtm.counter_family(
    "ray_tpu_recovery_slo_violations_total",
    "Closed episodes whose latency exceeded the recovery SLO, by kind.",
    tag_keys=("kind",))
_M_TRANSFER_FAILOVERS = rtm.counter(
    "ray_tpu_recovery_transfer_failovers_total",
    "TRANSFER_FAILOVER events folded by the recovery auditor.")
_M_LOST_STEPS = rtm.counter(
    "ray_tpu_recovery_lost_steps_total",
    "Re-executed training steps (lost work) across failover episodes.")

# episode kinds
DRAIN = "drain"
FAILOVER = "failover"
HEAL = "heal"
REROLE = "rerole"
RL_ACTOR = "rl_actor"

# recovery SLO targets are read per closed episode — rare — but the
# auditor sits on the event-put path, so ride the same generation cache
_slo_cache = (-1, 0.0, 0.0, 0.0, 0.0, 0.0)


def _slos() -> tuple:
    global _slo_cache
    gen = CONFIG.generation()
    cached = _slo_cache
    if cached[0] != gen:
        cached = (gen, CONFIG.recovery_slo_drain_s,
                  CONFIG.recovery_slo_failover_s,
                  CONFIG.recovery_slo_heal_s,
                  CONFIG.recovery_slo_rerole_s,
                  CONFIG.recovery_slo_rl_actor_s)
        _slo_cache = cached
    return cached


class RecoveryAuditor:
    """Folds the typed event stream into recovery episodes.

    ``observe(events)`` runs inside the GCS on every event-table put
    (both the legacy single-event RPC and the batched flusher path),
    AFTER the events land in the table — so episode timestamps are the
    event-plane timestamps the chaos gates previously subtracted by
    hand, and an episode can always be cross-checked against its
    ground-truth events.  The auditor must never emit cluster events
    itself (that would recurse through the put hook); it publishes
    derived values through ``ray_tpu_recovery_*`` instruments and its
    own bounded episode table.

    Episode lifecycle: an *opening* event creates an open episode keyed
    ``(kind, key)``; the matching *closing* event stamps the latency,
    classifies it against the SLO and rotates the episode into the
    bounded store (count + byte budgets; per-kind totals survive
    rotation like the event table's ``counts_by_type``)."""

    def __init__(self, max_episodes: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self._max_episodes = (CONFIG.gcs_max_recovery_episodes
                              if max_episodes is None else max_episodes)
        self._max_bytes = (CONFIG.gcs_recovery_max_bytes
                           if max_bytes is None else max_bytes)
        self._lock = threading.Lock()
        self._open: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._episodes: deque = deque()
        self._bytes = 0
        self._seq = 0
        self._dropped = 0
        self._counts: Dict[str, int] = {}
        self._violations: Dict[str, int] = {}
        self._transfer_failovers = 0
        self._transfer_by_outcome: Dict[str, int] = {}
        self._lost_steps = 0

    # ------------------------------------------------------ ingestion
    def observe(self, events: List[Dict[str, Any]]) -> None:
        for ev in events or []:
            try:
                self._observe_one(ev)
            except Exception:
                # auditing is derived data: a malformed event must never
                # break the event-put path it rides on
                pass

    def _observe_one(self, ev: Dict[str, Any]) -> None:
        etype = ev.get("type")
        if etype == "NODE_PREEMPTING":
            self._on_preempting(ev)
        elif etype == "NODE_DRAINED":
            self._on_drained(ev)
        elif etype == "OBJECT_EVACUATED":
            self._on_evacuated(ev)
        elif etype == "NODE_DEAD":
            self._on_dead(ev)
        elif etype == "TRAIN_GANG_RECOVERY":
            self._on_gang_recovery(ev)
        elif etype == "REPLICA_RETIRED":
            self._on_replica_retired(ev)
        elif etype == "AUTOSCALE":
            self._on_autoscale(ev)
        elif etype == "SERVE_REROLE":
            self._on_rerole(ev)
        elif etype == "SERVE_REROLE_DONE":
            self._on_rerole_done(ev)
        elif etype == "RL_ACTOR_LOST":
            self._on_rl_actor_lost(ev)
        elif etype == "RL_ACTOR_JOINED":
            self._on_rl_actor_joined(ev)
        elif etype == "TRANSFER_FAILOVER":
            with self._lock:
                self._transfer_failovers += 1
                outcome = str(ev.get("outcome", "unknown"))
                self._transfer_by_outcome[outcome] = \
                    self._transfer_by_outcome.get(outcome, 0) + 1
            _M_TRANSFER_FAILOVERS.inc()

    def _open_episode(self, kind: str, key: str, ev: Dict[str, Any],
                      **fields) -> Dict[str, Any]:
        with self._lock:
            ep = self._open.get((kind, key))
            if ep is not None:
                return ep   # idempotent: first opening event anchors
            self._seq += 1
            ep = {"id": f"{kind}-{self._seq}", "kind": kind, "key": key,
                  "opened_ts": ev.get("ts") or time.time(),
                  "open": True, "opening_type": ev.get("type")}
            ep.update(fields)
            self._open[(kind, key)] = ep
            return ep

    def _close_episode(self, kind: str, key: str, ev: Dict[str, Any],
                       slo_s: float, metric, **fields) -> \
            Optional[Dict[str, Any]]:
        with self._lock:
            ep = self._open.pop((kind, key), None)
            if ep is None:
                return None
            ep["closed_ts"] = ev.get("ts") or time.time()
            ep["latency_s"] = round(
                max(0.0, ep["closed_ts"] - ep["opened_ts"]), 6)
            ep["open"] = False
            ep["closing_type"] = ev.get("type")
            ep.update(fields)
            ep["slo_s"] = slo_s
            ep["violation"] = bool(slo_s > 0
                                   and ep["latency_s"] > slo_s)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if ep["violation"]:
                self._violations[kind] = \
                    self._violations.get(kind, 0) + 1
            self._rotate_in_locked(ep)
        metric.observe(ep["latency_s"])
        _M_EPISODES.inc(kind)
        if ep["violation"]:
            _M_SLO_VIOLATIONS.inc(kind)
        return ep

    def _rotate_in_locked(self, ep: Dict[str, Any]) -> None:
        try:
            size = len(json.dumps(ep, default=str))
        except (TypeError, ValueError):
            size = 256
        ep["_size"] = size
        self._episodes.append(ep)
        self._bytes += size
        while len(self._episodes) > self._max_episodes or \
                (self._bytes > self._max_bytes and self._episodes):
            old = self._episodes.popleft()
            self._bytes -= old.get("_size", 256)
            self._dropped += 1

    # ------------------------------------------------- per-event folds
    def _on_preempting(self, ev: Dict[str, Any]) -> None:
        node = ev.get("node_id") or ""
        grace = float(ev.get("grace_s") or 0.0)
        self._open_episode(DRAIN, node, ev, node_id=node, grace_s=grace,
                           reason=ev.get("reason"), evacuated=0,
                           evacuated_bytes=0)
        # a preemption notice is also the earliest failure anchor for a
        # gang riding this node: the graceful chaos leg measures
        # time-to-failover from NODE_PREEMPTING, not NODE_DEAD
        self._open_episode(FAILOVER, node, ev, node_id=node)

    def _on_drained(self, ev: Dict[str, Any]) -> None:
        node = ev.get("node_id") or ""
        slo_drain = _slos()[1]
        with self._lock:
            ep = self._open.get((DRAIN, node))
            grace = float(ep.get("grace_s") or 0.0) if ep else 0.0
        # explicit SLO wins; otherwise the advertised grace window IS
        # the drain budget the raylet promised to finish inside
        slo = slo_drain if slo_drain > 0 else grace
        self._close_episode(
            DRAIN, node, ev, slo, _M_DRAIN_S,
            evacuated=ev.get("evacuated", 0),
            evacuated_bytes=ev.get("bytes", 0),
            failed=ev.get("failed", 0),
            raylet_duration_s=ev.get("duration_s"))

    def _on_evacuated(self, ev: Dict[str, Any]) -> None:
        node = ev.get("node_id") or ""
        with self._lock:
            ep = self._open.get((DRAIN, node))
            if ep is not None:
                ep["evacuated"] = ep.get("evacuated", 0) + 1
                ep["evacuated_bytes"] = (ep.get("evacuated_bytes", 0)
                                         + int(ev.get("bytes") or 0))

    def _on_dead(self, ev: Dict[str, Any]) -> None:
        node = ev.get("node_id") or ""
        # keep the earlier NODE_PREEMPTING anchor if one exists (the
        # graceful path); otherwise the death IS the failure instant
        self._open_episode(FAILOVER, node, ev, node_id=node,
                           actors_affected=ev.get("actors_affected"))
        # a dead node can no longer report NODE_DRAINED: close a
        # dangling drain episode as failed-by-death so it doesn't sit
        # open forever (latency = lifetime of the grace attempt)
        with self._lock:
            dangling = (DRAIN, node) in self._open
        if dangling:
            self._close_episode(DRAIN, node, ev, 0.0, _M_DRAIN_S,
                                outcome="died before drained")

    def _on_gang_recovery(self, ev: Dict[str, Any]) -> None:
        """Close the OLDEST open failover anchor: the recovery event
        carries the experiment, not the node, so the auditor pairs it
        with the longest-outstanding failure — the same convention the
        chaos gate used when subtracting timestamps by hand."""
        with self._lock:
            open_keys = sorted(
                (k for k in self._open if k[0] == FAILOVER),
                key=lambda k: self._open[k]["opened_ts"])
            key = open_keys[0][1] if open_keys else None
        lost = int(ev.get("lost_steps") or 0)
        fields = dict(
            experiment=ev.get("experiment"), attempt=ev.get("attempt"),
            reason=ev.get("reason"), downtime_s=ev.get("downtime_s"),
            resumed_from_checkpoint=ev.get("resumed_from_checkpoint"),
            lost_steps=lost, resume_step=ev.get("resume_step"),
            last_step=ev.get("last_step"))
        if key is None:
            # recovery without an observed failure event (e.g. a worker
            # crash below the node plane): still an episode — anchored
            # on the trainer's own downtime clock when it carried one
            ts = ev.get("ts") or time.time()
            downtime = float(ev.get("downtime_s") or 0.0)
            anchor = {"ts": ts - downtime, "type": "TRAIN_DOWNTIME"}
            self._open_episode(FAILOVER, f"run:{ev.get('experiment')}",
                               anchor)
            key = f"run:{ev.get('experiment')}"
        ep = self._close_episode(FAILOVER, key, ev, _slos()[2],
                                 _M_FAILOVER_S, **fields)
        if ep is not None and lost > 0:
            with self._lock:
                self._lost_steps += lost
            _M_LOST_STEPS.inc(lost)

    def _on_replica_retired(self, ev: Dict[str, Any]) -> None:
        dep = ev.get("deployment") or ""
        self._open_episode(HEAL, dep, ev, deployment=dep,
                           replica=ev.get("replica"),
                           reason=ev.get("reason"), retired=1)
        with self._lock:
            ep = self._open.get((HEAL, dep))
            if ep is not None and ep.get("replica") != ev.get("replica"):
                ep["retired"] = ep.get("retired", 1) + 1

    def _on_autoscale(self, ev: Dict[str, Any]) -> None:
        dep = ev.get("deployment") or ""
        self._close_episode(HEAL, dep, ev, _slos()[3], _M_HEAL_S,
                            old_target=ev.get("old_target"),
                            new_target=ev.get("new_target"),
                            load=ev.get("load"))

    def _on_rerole(self, ev: Dict[str, Any]) -> None:
        # keyed by the pool pair: the controller serializes re-roles per
        # pair (cooldown), so one open episode per pair is the contract
        key = f"{ev.get('src')}->{ev.get('dst')}"
        self._open_episode(REROLE, key, ev, src=ev.get("src"),
                           dst=ev.get("dst"), replica=ev.get("replica"),
                           reason=ev.get("reason"),
                           slo_kind=ev.get("slo_kind"),
                           trace_id=ev.get("trace_id"))

    def _on_rerole_done(self, ev: Dict[str, Any]) -> None:
        key = f"{ev.get('src')}->{ev.get('dst')}"
        self._close_episode(REROLE, key, ev, _slos()[4], _M_REROLE_S,
                            src_replicas=ev.get("src_replicas"),
                            dst_replicas=ev.get("dst_replicas"))

    def _on_rl_actor_lost(self, ev: Dict[str, Any]) -> None:
        # keyed per fleet slot: the executor replaces an actor in its
        # own slot, so LOST(run, slot) pairs with the next JOINED of
        # the same slot
        key = f"{ev.get('run_id')}/{ev.get('slot')}"
        self._open_episode(RL_ACTOR, key, ev, run_id=ev.get("run_id"),
                           slot=ev.get("slot"), reason=ev.get("reason"))

    def _on_rl_actor_joined(self, ev: Dict[str, Any]) -> None:
        key = f"{ev.get('run_id')}/{ev.get('slot')}"
        self._close_episode(RL_ACTOR, key, ev, _slos()[5], _M_RL_ACTOR_S,
                            weight_version=ev.get("weight_version"),
                            weight_pull_ms=ev.get("weight_pull_ms"))

    # ---------------------------------------------------------- views
    def list(self, kind: Optional[str] = None,
             include_open: bool = True,
             limit: int = 100) -> List[Dict[str, Any]]:
        """Episodes, oldest first, open ones (snapshot) at the tail."""
        with self._lock:
            closed = [dict(ep) for ep in self._episodes
                      if kind is None or ep["kind"] == kind]
            opened = [dict(ep) for ep in sorted(
                self._open.values(), key=lambda e: e["opened_ts"])
                if kind is None or ep["kind"] == kind] \
                if include_open else []
        out = closed + opened
        for ep in out:
            ep.pop("_size", None)
        return out[-max(0, limit):]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"episodes": len(self._episodes),
                    "open": len(self._open),
                    "bytes": self._bytes,
                    "max_episodes": self._max_episodes,
                    "max_bytes": self._max_bytes,
                    "dropped": self._dropped,
                    "counts_by_kind": dict(self._counts),
                    "violations_by_kind": dict(self._violations),
                    "transfer_failovers": self._transfer_failovers,
                    "transfer_by_outcome":
                        dict(self._transfer_by_outcome),
                    "lost_steps": self._lost_steps}


# --------------------------------------------------------------- doctor
_SEV_ORDER = {"ERROR": 0, "WARNING": 1, "INFO": 2}


def _finding(severity: str, category: str, summary: str,
             evidence: List[str]) -> Dict[str, Any]:
    return {"severity": severity, "category": category,
            "summary": summary, "evidence": evidence}


def build_doctor_report(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Correlate one cross-plane snapshot into ranked findings.

    ``snapshot`` keys (all optional — the doctor degrades per missing
    plane rather than failing): ``nodes`` (node-table rows), ``events``
    (recent WARNING+ typed events), ``event_stats``, ``episodes`` +
    ``recovery_stats`` (auditor), ``step_stats`` (run rows + table
    stats), ``traces`` (SLO-violating roots), ``dossiers`` (ids or
    summaries), ``history_stats``.  Pure function of the snapshot so
    tests can feed it synthetic planes."""
    findings: List[Dict[str, Any]] = []
    nodes = snapshot.get("nodes") or []
    dead = [n for n in nodes if not n.get("alive", True)]
    draining = [n for n in nodes
                if n.get("alive", True) and n.get("draining")]
    unhealthy = [n for n in nodes
                 if n.get("alive", True) and n.get("unhealthy")]
    if dead:
        findings.append(_finding(
            "ERROR", "nodes", f"{len(dead)} dead node(s)",
            [f"node {n.get('node_id', '?')[:12]} dead"
             f" (dossier: {n.get('node_id', '?')[:12]})" for n in dead]))
    if unhealthy:
        findings.append(_finding(
            "WARNING", "nodes", f"{len(unhealthy)} unhealthy node(s)",
            [f"node {n.get('node_id', '?')[:12]}: "
             f"{', '.join(n.get('unhealthy_reasons') or ['unhealthy'])}"
             for n in unhealthy]))
    if draining:
        findings.append(_finding(
            "WARNING", "nodes", f"{len(draining)} draining node(s)",
            [f"node {n.get('node_id', '?')[:12]} draining"
             for n in draining]))

    episodes = snapshot.get("episodes") or []
    violations = [ep for ep in episodes
                  if ep.get("violation") and not ep.get("open")]
    stuck = [ep for ep in episodes if ep.get("open")]
    if violations:
        findings.append(_finding(
            "WARNING", "recovery",
            f"{len(violations)} recovery episode(s) violated their SLO",
            [f"{ep['kind']} {ep.get('id', '?')} "
             f"({ep.get('key', '?')[:12]}): "
             f"{ep.get('latency_s', 0):.2f}s > slo "
             f"{ep.get('slo_s', 0):.2f}s" for ep in violations]))
    if stuck:
        findings.append(_finding(
            "WARNING", "recovery",
            f"{len(stuck)} recovery episode(s) still open",
            [f"{ep['kind']} {ep.get('id', '?')} "
             f"({ep.get('key', '?')[:12]}) opened by "
             f"{ep.get('opening_type')}" for ep in stuck]))
    closed = [ep for ep in episodes if not ep.get("open")]
    if closed:
        worst = max(closed, key=lambda e: e.get("latency_s") or 0)
        findings.append(_finding(
            "INFO", "recovery",
            f"{len(closed)} recovery episode(s) closed",
            [f"slowest: {worst['kind']} {worst.get('id', '?')} "
             f"({worst.get('key', '?')[:12]}) "
             f"{worst.get('latency_s', 0):.2f}s"
             + (f", {worst.get('lost_steps')} step(s) re-executed"
                if worst.get("lost_steps") else "")]))

    rstats = snapshot.get("recovery_stats") or {}
    if rstats.get("transfer_failovers"):
        findings.append(_finding(
            "INFO", "recovery",
            f"{rstats['transfer_failovers']} transfer failover(s)",
            [f"outcome {k}: {v}" for k, v in sorted(
                (rstats.get("transfer_by_outcome") or {}).items())]))

    events = snapshot.get("events") or []
    by_type: Dict[str, List[dict]] = {}
    for ev in events:
        if _SEV_ORDER.get(ev.get("severity", "INFO"), 2) <= 1:
            by_type.setdefault(ev.get("type", "EVENT"), []).append(ev)
    for etype, evs in sorted(by_type.items(),
                             key=lambda kv: -len(kv[1])):
        errors = [e for e in evs if e.get("severity") == "ERROR"]
        sev = "ERROR" if errors else "WARNING"
        latest = max(evs, key=lambda e: e.get("ts") or 0)
        findings.append(_finding(
            sev, "events", f"{len(evs)} {etype} event(s)",
            [f"latest: {latest.get('message', '')[:120]}"]))

    stragglers = [e for e in events if e.get("type") == "TRAIN_STRAGGLER"]
    if stragglers:
        latest = max(stragglers, key=lambda e: e.get("ts") or 0)
        findings.append(_finding(
            "WARNING", "training",
            f"{len(stragglers)} straggler flag(s) raised",
            [f"latest: {latest.get('message', '')[:120]}"]))

    traces = snapshot.get("traces") or []
    if traces:
        findings.append(_finding(
            "WARNING", "tracing",
            f"{len(traces)} SLO-violating trace(s)",
            [f"trace {t.get('trace_id', '?')[:16]} "
             f"{t.get('route', '?')} {t.get('duration_ms', 0):.0f}ms"
             for t in traces[:5]]))

    dossiers = snapshot.get("dossiers") or []
    if dossiers:
        findings.append(_finding(
            "INFO", "dossiers", f"{len(dossiers)} open dossier(s)",
            [str(d)[:80] if not isinstance(d, dict)
             else f"{d.get('kind', '?')} {d.get('dossier_id', '')[:12]}"
                  f": {str(d.get('reason', ''))[:60]}"
             for d in dossiers[:8]]))

    hstats = snapshot.get("history_stats") or {}
    if hstats:
        findings.append(_finding(
            "INFO", "history",
            f"metrics history: {hstats.get('series', 0)} series, "
            f"{hstats.get('points', 0)} points",
            [f"{hstats.get('bytes', 0)} bytes of "
             f"{hstats.get('max_bytes', 0)} budget; "
             f"{hstats.get('dropped_points', 0)} point(s) aged out"]))

    findings.sort(key=lambda f: _SEV_ORDER.get(f["severity"], 2))
    healthy = not any(f["severity"] != "INFO" for f in findings)
    return {"generated_ts": snapshot.get("now") or time.time(),
            "healthy": healthy,
            "findings": findings,
            "counts": {
                "nodes": len(nodes), "dead_nodes": len(dead),
                "draining_nodes": len(draining),
                "episodes": len(episodes),
                "slo_violations": len(violations),
                "open_episodes": len(stuck)}}


def format_doctor_report(report: Dict[str, Any]) -> str:
    """Operator text for ``ray-tpu doctor`` (the metrics_summary
    rendering idiom: sectioned, aligned, greppable)."""
    lines = ["=== ray-tpu doctor ==="]
    c = report.get("counts", {})
    lines.append(
        f"cluster: {c.get('nodes', 0)} node(s), "
        f"{c.get('dead_nodes', 0)} dead, "
        f"{c.get('draining_nodes', 0)} draining | "
        f"recovery: {c.get('episodes', 0)} episode(s), "
        f"{c.get('slo_violations', 0)} SLO violation(s), "
        f"{c.get('open_episodes', 0)} open")
    lines.append("verdict: " + ("HEALTHY" if report.get("healthy")
                                else "ATTENTION NEEDED"))
    findings = report.get("findings") or []
    if not findings:
        lines.append("no findings.")
    for i, f in enumerate(findings, 1):
        lines.append(f"[{i}] {f['severity']:7s} {f['category']}: "
                     f"{f['summary']}")
        for ev in f.get("evidence", []):
            lines.append(f"      - {ev}")
    return "\n".join(lines)
