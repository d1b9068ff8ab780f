"""State API: `list_*` / `summarize_*` / `memory_summary` / `timeline`.

Analog of Ray's python/ray/experimental/state/api.py (list_tasks
etc.), state_cli.py (`ray list tasks`), _private/state.py:829 (`ray
timeline` Chrome-trace export) and `ray memory` (refcount debugging).

Data sources: the GCS tables (tasks/actors/nodes/jobs/placement groups) and
live fan-out to raylets (`list_workers`) and core workers
(`core_worker_stats`) for objects — mirroring the reference's
StateDataSourceClient (state_manager.py:130).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rpc
from ray_tpu_torch.runtime import core_worker as cw


def _gcs():
    return cw.get_global_worker().gcs


# --------------------------------------------------------------- GCS tables
def list_tasks(*, job_id: Optional[str] = None, state: Optional[str] = None,
               name: Optional[str] = None, limit: int = 10000) -> List[dict]:
    return _gcs().call("list_task_events", {
        "job_id": job_id, "state": state, "name": name, "limit": limit})


def list_actors(*, state: Optional[str] = None,
                limit: int = 10000) -> List[dict]:
    actors = _gcs().call("list_actors")
    if state:
        actors = [a for a in actors if a.get("state") == state]
    return actors[:limit]


def list_nodes(*, limit: int = 10000) -> List[dict]:
    return _gcs().call("list_nodes")[:limit]


def list_jobs(*, limit: int = 10000) -> List[dict]:
    return _gcs().call("list_jobs")[:limit]


def list_placement_groups(*, limit: int = 10000) -> List[dict]:
    return _gcs().call("list_placement_groups")[:limit]


# ----------------------------------------------------------- event plane
def list_cluster_events(*, node_id: Optional[str] = None,
                        job_id: Optional[str] = None,
                        actor_id: Optional[str] = None,
                        worker_id: Optional[str] = None,
                        severity: Optional[str] = None,
                        min_severity: Optional[str] = None,
                        type: Optional[str] = None,  # noqa: A002
                        source: Optional[str] = None,
                        limit: int = 1000) -> List[dict]:
    """Typed lifecycle events from the GCS cluster event table
    (docs/observability.md): node up/down/unhealthy, worker
    spawn/exit, actor restarts, lease timeouts, spill traffic,
    transfer failovers, collective rank deaths, serve replica
    retire/autoscale.  Id filters are prefix matches; ``severity`` is
    exact, ``min_severity`` a floor (DEBUG < INFO < WARNING < ERROR)."""
    return _gcs().call("list_cluster_events", {
        "node_id": node_id, "job_id": job_id, "actor_id": actor_id,
        "worker_id": worker_id, "severity": severity,
        "min_severity": min_severity, "type": type, "source": source,
        "limit": limit})


# ------------------------------------------------ training perf plane
def list_step_stats(run: Optional[str] = None, *, limit: int = 100,
                    steps_limit: int = 64) -> dict:
    """The GCS training step table (docs/observability.md): run
    directory rows (group, world, per-rank metadata, recent cross-rank
    skew) and — with ``run`` given (id or group prefix) — that run's
    per-step per-rank phase records."""
    return _gcs().call("list_step_stats", {
        "run": run, "limit": limit, "steps_limit": steps_limit})


def training_summary(run: Optional[str] = None) -> Optional[dict]:
    """The goodput-ledger view of one training run (latest by
    default): per-rank init/compile/productive/checkpoint/idle time
    buckets, tokens, MFU and goodput fraction, plus a cross-rank
    aggregate (docs/observability.md)."""
    return _gcs().call("training_summary", {"run": run})


def training_summary_text(run: Optional[str] = None) -> str:
    """Operator table for ``ray-tpu summary training``."""
    s = training_summary(run)
    if not s:
        return "(no training runs reported yet)"
    lines = [f"run {s['run']}"
             + (f"  (group {s['group']})" if s.get("group") else "")
             + f"  world={s['world']}  steps={s.get('steps_seen', 0)}"]
    agg = s.get("aggregate")
    if agg:
        lines.append(
            "aggregate: goodput %.1f%%  mfu %.2f%%  %s tokens  "
            "%.0f tokens/s" % (
                100 * agg.get("goodput", 0.0), 100 * agg.get("mfu", 0.0),
                f"{agg.get('tokens', 0):,}",
                agg.get("tokens_per_s", 0.0)))
    ranks = s.get("ranks") or {}
    if ranks:
        lines.append("%-5s %8s %9s %9s %11s %9s %9s %8s %7s" % (
            "RANK", "STEPS", "INIT(ms)", "COMP(ms)", "PROD(ms)",
            "CKPT(ms)", "IDLE(ms)", "GOODPUT", "MFU"))
        for rank, led in sorted(ranks.items(), key=lambda kv: int(kv[0])):
            lines.append("%-5s %8d %9.0f %9.0f %11.0f %9.0f %9.0f "
                         "%7.1f%% %6.2f%%" % (
                             rank, led.get("steps", 0),
                             led.get("init_ms", 0.0),
                             led.get("compile_ms", 0.0),
                             led.get("productive_ms", 0.0),
                             led.get("checkpoint_ms", 0.0),
                             led.get("idle_ms", 0.0),
                             100 * led.get("goodput", 0.0),
                             100 * led.get("mfu", 0.0)))
        # per-phase breakdown off rank 0 (the canonical series)
        led0 = ranks.get(0) or ranks.get("0") or \
            next(iter(ranks.values()))
        phases = led0.get("phase_ms") or {}
        if phases:
            lines.append("rank-0 phase totals: " + "  ".join(
                f"{k}={v:.0f}ms" for k, v in sorted(phases.items())))
    skew = s.get("skew") or []
    if skew:
        worst = max(skew, key=lambda r: r.get("skew_ms", 0.0))
        lines.append(
            "cross-rank skew (last %d analyzed steps): worst +%.1fms "
            "at step %d (median %.1fms)" % (
                len(skew), worst.get("skew_ms", 0.0),
                worst.get("step", 0), worst.get("median_ms", 0.0)))
    return "\n".join(lines)


# ----------------------------------------------------------- tracing plane
def list_traces(*, slo_violations: bool = False,
                route: Optional[str] = None,
                status: Optional[str] = None,
                since: Optional[float] = None,
                limit: int = 100) -> List[dict]:
    """Trace directory rows from the GCS span table
    (docs/observability.md): one row per retained trace — root
    name/route/pool, duration, TTFT/TPOT, SLO verdict, span count,
    dossier cross-link.  ``slo_violations=True`` narrows to requests
    that missed a target; ``route`` is a prefix match."""
    return _gcs().call("list_traces", {
        "slo_violations": slo_violations, "route": route,
        "status": status, "since": since, "limit": limit})


def get_trace(trace_id: str) -> Optional[dict]:
    """One full trace by id (prefix ok): every retained span sorted by
    start time, plus the root's SLO fields."""
    return _gcs().call("get_trace", {"trace_id": trace_id})


def trace_stats() -> dict:
    return _gcs().call("trace_stats", {})


def trace_tree_text(trace: dict) -> str:
    """Render one trace as an indented span tree (``ray-tpu trace``):
    parent/child structure, per-span duration/status, the hop
    decomposition of the request."""
    if not trace:
        return "(no such trace)"
    spans = trace.get("spans") or []
    by_parent: Dict[Optional[str], List[dict]] = {}
    ids = {s.get("span_id") for s in spans}
    for s in spans:
        parent = s.get("parent_id")
        if parent not in ids:
            parent = None     # orphan (parent rotated out): show at root
        by_parent.setdefault(parent, []).append(s)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s.get("start", 0))
    lines = [f"trace {trace.get('trace_id', '?')}  "
             f"({len(spans)} spans"
             + (", truncated" if trace.get("truncated") else "") + ")"]
    root = trace.get("root") or {}
    if root.get("slo_ok") is not None:
        verdict = "OK" if root["slo_ok"] else (
            "VIOLATED " + ",".join(root.get("slo_violated") or []))
        lines.append(
            "slo: %s  ttft=%s ms  tpot=%s ms  tokens=%s" % (
                verdict, root.get("ttft_ms", "-"),
                root.get("tpot_ms", "-"), root.get("num_tokens", "-")))
    if root.get("dossier_id"):
        lines.append(f"crash dossier: {root['dossier_id']}  "
                     f"(ray-tpu events --dossier {root['dossier_id']})")
    t0 = min((s.get("start", 0) for s in spans), default=0)

    def _walk(parent: Optional[str], depth: int) -> None:
        for s in by_parent.get(parent, []):
            status = s.get("status", "ok")
            mark = "" if status == "ok" else \
                f"  !{s.get('error_type') or status}"
            where = (s.get("worker_id") or "")[:8]
            extras = "".join(
                f"  {k}={s[k]}" for k in ("bytes", "npages", "num_tokens",
                                          "index")
                if s.get(k) is not None)
            lines.append(
                "%8.1fms  %s%-28s %8.1fms  [%s]%s%s" % (
                    (s.get("start", 0) - t0) * 1e3, "  " * depth,
                    s.get("name", "?")[:28], s.get("dur_ms", 0.0),
                    where or s.get("source", "?"), extras, mark))
            _walk(s.get("span_id"), depth + 1)

    _walk(None, 0)
    return "\n".join(lines)


def trace_timeline(trace_id: str, path: Optional[str] = None
                   ) -> List[dict]:
    """Perfetto export of ONE trace: its spans as complete slices merged
    with the cluster timeline's slices that carry the same trace id
    (task/queue-wait/STREAM_ITEM/PULL/HANDOFF/STEP events), so the
    request's hops and the subsystems they exercised share one time
    axis.  Load in chrome://tracing or ui.perfetto.dev."""
    trace = get_trace(trace_id)
    if not trace:
        return []
    tid_full = trace["trace_id"]
    events: List[dict] = []
    for s in trace.get("spans") or []:
        args = {k: v for k, v in s.items()
                if k not in ("start", "dur_ms", "name")}
        events.append({
            "name": s.get("name", "?"), "cat": f"span:{s.get('kind')}",
            "ph": "X", "ts": s.get("start", 0) * 1e6,
            "dur": max(1.0, float(s.get("dur_ms", 0.0)) * 1e3),
            "pid": f"trace {tid_full[:8]}",
            "tid": (s.get("source") or "proc") + ":" +
                   (s.get("worker_id") or "")[:8],
            "args": args,
        })
    # merge the subsystem slices stamped with this trace id (PULL /
    # HANDOFF / STEP / task / stream_item rows keep their own pid/tid —
    # the process axis — while the span rows group under the trace pid)
    for ev in timeline():
        if (ev.get("args") or {}).get("trace_id") == tid_full:
            events.append(ev)
    if path:
        with open(path, "w") as f:
            json.dump(events, f)
    return events


def get_dossier(dossier_id: str) -> Optional[dict]:
    """Crash dossier by id — a dead worker's id hex (prefix ok) or a
    dead node's id hex.  Contains the process's flight-recorder event
    ring, log tail and last metrics watermarks (docs/observability.md);
    ``format_dossier`` renders it for terminals."""
    return _gcs().call("get_dossier", {"dossier_id": dossier_id})


def list_dossiers() -> List[dict]:
    return _gcs().call("list_dossiers")


def node_health_table(nodes: List[dict]) -> List[str]:
    """Render the cluster health table off heartbeat-piggybacked
    snapshots — one renderer shared by ``metrics_summary()`` and
    ``ray-tpu status`` ([] when no node has reported health yet)."""
    rows = [n for n in nodes if n.get("health")]
    if not rows:
        return []
    lines = ["%-14s %-10s %6s %6s %6s %9s %s" % (
        "NODE", "STATE", "CPU", "MEM", "STORE", "LAG(ms)", "REASONS")]
    for n in rows:
        h = n["health"]
        state = "DEAD" if not n.get("alive") else (
            "DRAINING" if n.get("draining") else (
                "UNHEALTHY" if n.get("unhealthy") else "OK"))
        lines.append("%-14s %-10s %5.0f%% %5.0f%% %5.0f%% %9.0f %s" % (
            n["node_id"][:12], state,
            100 * h.get("cpu_frac", 0), 100 * h.get("mem_frac", 0),
            100 * h.get("store_frac", 0), h.get("loop_lag_ms", 0),
            ", ".join(n.get("unhealthy_reasons") or [])))
    return lines


# ----------------------------------------------------------------- fan-outs
def _each_raylet(fn):
    out = []
    for node in list_nodes():
        if not node.get("alive"):
            continue
        try:
            conn = rpc.connect(tuple(node["address"]))
        except OSError:
            continue
        try:
            out.append((node, fn(conn)))
        except (rpc.RpcError, ConnectionError, TimeoutError):
            pass
        finally:
            conn.close()
    return out


def list_workers(*, limit: int = 10000) -> List[dict]:
    workers: List[dict] = []
    for node, rows in _each_raylet(
            lambda c: c.call("list_workers", timeout=5)):
        for row in rows:
            row["node_id"] = node["node_id"]
            workers.append(row)
    return workers[:limit]


def _worker_stats() -> List[dict]:
    """core_worker_stats from every live worker + the local driver."""
    stats = []
    me = cw.get_global_worker()
    stats.append(me._rpc_core_worker_stats({}))
    for w in list_workers():
        if not w.get("alive") or not w.get("address"):
            continue
        try:
            conn = rpc.connect(tuple(w["address"]))
        except OSError:
            continue
        try:
            stats.append(conn.call("core_worker_stats", {}, timeout=5))
        except (rpc.RpcError, ConnectionError, TimeoutError):
            pass
        finally:
            conn.close()
    return stats


def list_objects(*, limit: int = 10000) -> List[dict]:
    objects: List[dict] = []
    for st in _worker_stats():
        for obj in st["objects"]:
            obj["owner_worker_id"] = st["worker_id"]
            obj["owner_mode"] = st["mode"]
            objects.append(obj)
    return objects[:limit]


# ---------------------------------------------------------------- summaries
def summarize_tasks(*, job_id: Optional[str] = None) -> Dict[str, Any]:
    summary: Dict[str, Dict[str, int]] = {}
    for t in list_tasks(job_id=job_id):
        per = summary.setdefault(t.get("name") or "<unknown>", {})
        per[t["state"]] = per.get(t["state"], 0) + 1
    return {"cluster": {"summary": summary,
                        "total_tasks": sum(sum(v.values())
                                           for v in summary.values())}}


def summarize_actors() -> Dict[str, Any]:
    summary: Dict[str, Dict[str, int]] = {}
    for a in list_actors():
        key = a.get("class_name") or a.get("name") or "<actor>"
        per = summary.setdefault(key, {})
        per[a["state"]] = per.get(a["state"], 0) + 1
    return {"cluster": {"summary": summary}}


def summarize_objects() -> Dict[str, Any]:
    total = count = inline = 0
    for o in list_objects():
        count += 1
        total += o.get("size", 0)
        inline += int(bool(o.get("inline")))
    return {"cluster": {"total_objects": count, "total_size_bytes": total,
                        "inline_objects": inline}}


def memory_summary() -> str:
    """Human-readable owned-object table (analog of `ray memory`)."""
    objects = list_objects()  # one cluster sweep for both table and totals
    lines = ["%-18s %-10s %-8s %-5s %-10s %s" % (
        "OBJECT_ID", "OWNER", "STATE", "REFS", "SIZE", "LOCATIONS")]
    total = 0
    for o in objects:
        total += o.get("size", 0)
        lines.append("%-18s %-10s %-8s %-5d %-10d %s" % (
            o["object_id"][:16] + "..", o["owner_worker_id"][:8],
            o["state"], o["refcount"], o.get("size", 0),
            ",".join(loc[:8] for loc in o.get("locations", []))))
    lines.append(f"--- {len(objects)} objects, {total} inline bytes ---")
    return "\n".join(lines)


# ----------------------------------------------------------------- timeline
def timeline(path: Optional[str] = None) -> List[dict]:
    """Chrome-trace (catapult) events from the GCS task table.

    Analog of `ray timeline` (Ray's python/ray/_private/
    state.py:829), RPC/stream-aware:

    * each task's RUNNING->FINISHED span is a complete ("X") event on
      its worker's row;
    * the SUBMITTED->RUNNING gap becomes a ``(queued)`` slice in the
      ``queue_wait`` category, so scheduling/lease latency is visible
      next to execution time;
    * streaming generators emit one instant ("i") per reported yield
      (``STREAM_ITEM`` task events), so per-item pacing and
      backpressure pauses show up between the task's start and end;
    * inter-node object pulls of a task's output appear as ``transfer``
      slices (``PULL`` events carrying duration/bytes/source count,
      docs/object_transfer.md) on the pulling process's row;
    * host-collective ops appear as ``collective`` slices
      (``COLLECTIVE`` events carrying op/algorithm/bytes/world size,
      docs/collective.md) on each participating rank's row;
    * disaggregated-serving KV handoffs appear as ``handoff`` slices
      (``HANDOFF`` events carrying stage/bytes/pages,
      docs/serve_disagg.md) on the exporting and importing replicas'
      rows;
    * every event carries the submitting span's ``trace_id`` in its
      args when one was propagated, so user spans (``span(...)``),
      tasks and stream items correlate in Perfetto.

    Load the output in chrome://tracing or ui.perfetto.dev.
    """
    events: List[dict] = []
    for t in list_tasks():
        start = end = None
        items = []
        pulls = []
        cols = []
        handoffs = []
        steps = []
        for ev in t.get("events", []):
            if ev["state"] == "RUNNING":
                start = ev["ts"]
            elif ev["state"] in ("FINISHED", "FAILED"):
                end = ev["ts"]
            elif ev["state"] == "STREAM_ITEM":
                items.append(ev)
            elif ev["state"] == "PULL":
                pulls.append(ev)
            elif ev["state"] == "COLLECTIVE":
                cols.append(ev)
            elif ev["state"] == "HANDOFF":
                handoffs.append(ev)
            elif ev["state"] == "STEP":
                steps.append(ev)
        for ev in steps:
            # one clocked train step (docs/observability.md): rides the
            # rank's synthetic step-<run>-r<rank> record.  The whole
            # step is one slice; its phase breakdown nests as
            # sub-slices stacked in canonical phase order, all stamped
            # with the step's trace_id so gang ranks correlate.
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            t_start = ev["ts"] - dur_s
            pid = ev.get("node_id", t.get("node_id", "node"))[:8]
            tid = ev.get("worker_id", t.get("worker_id", "worker"))[:8]
            args = {"task_id": t["task_id"], "step": ev.get("step")}
            if ev.get("trace_id"):
                args["trace_id"] = ev["trace_id"]
            events.append({
                "name": f"step {ev.get('step', '?')}",
                "cat": "train_step", "ph": "X",
                "ts": t_start * 1e6, "dur": dur_s * 1e6,
                "pid": pid, "tid": tid, "args": dict(args),
            })
            phases = ev.get("phases") or {}
            from ray_tpu_torch._private.step_stats import PHASES
            off = t_start
            ordered = [p for p in PHASES if p in phases] + \
                [p for p in sorted(phases) if p not in PHASES]
            for phase in ordered:
                p_dur = float(phases[phase]) / 1e3
                events.append({
                    "name": phase, "cat": "train_phase", "ph": "X",
                    "ts": off * 1e6, "dur": p_dur * 1e6,
                    "pid": pid, "tid": f"{tid}/phases",
                    "args": dict(args, phase=phase),
                })
                off += p_dur
        for ev in cols:
            # one host-collective op (docs/collective.md): rides the
            # rank's synthetic col-<group>-r<rank> record, which has no
            # lifecycle of its own — the slice stands alone on the
            # participating process's row
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            events.append({
                "name": f"{ev.get('op', 'collective')}"
                        f"[{ev.get('algo', '?')}]"
                        f" ({ev.get('bytes', 0)} B)",
                "cat": "collective",
                "ph": "X",
                "ts": (ev["ts"] - dur_s) * 1e6,
                "dur": dur_s * 1e6,
                "pid": ev.get("node_id", t.get("node_id", "node"))[:8],
                "tid": ev.get("worker_id",
                              t.get("worker_id", "worker"))[:8],
                "args": {"task_id": t["task_id"],
                         "bytes": ev.get("bytes", 0),
                         "op": ev.get("op", ""),
                         "algo": ev.get("algo", ""),
                         "world": ev.get("world", 0)},
            })
        for ev in handoffs:
            # one export/import leg of a disaggregated-serving KV
            # handoff (docs/serve_disagg.md): rides a synthetic
            # ``handoff-<object>`` record with no lifecycle — the slice
            # stands alone on the exporting/importing replica's row
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            events.append({
                "name": f"kv_handoff {ev.get('stage', '?')} "
                        f"({ev.get('bytes', 0)} B)",
                "cat": "handoff",
                "ph": "X",
                "ts": (ev["ts"] - dur_s) * 1e6,
                "dur": dur_s * 1e6,
                "pid": ev.get("node_id", t.get("node_id", "node"))[:8],
                "tid": ev.get("worker_id",
                              t.get("worker_id", "worker"))[:8],
                "args": {"task_id": t["task_id"],
                         "bytes": ev.get("bytes", 0),
                         "stage": ev.get("stage", ""),
                         "npages": ev.get("npages", 0)},
            })
        for ev in pulls:
            # a pull may happen long after the task finished (a borrower
            # fetching the output): its slice stands on its own
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            events.append({
                "name": f"pull {ev.get('object_id', '?')[:12]} "
                        f"({ev.get('bytes', 0)} B)",
                "cat": "transfer",
                "ph": "X",
                "ts": (ev["ts"] - dur_s) * 1e6,
                "dur": dur_s * 1e6,
                # the slice belongs to the PULLING process's row (the
                # event stamps it); older events without the stamp fall
                # back to the producing task's row
                "pid": ev.get("node_id", t.get("node_id", "node"))[:8],
                "tid": ev.get("worker_id",
                              t.get("worker_id", "worker"))[:8],
                "args": {"task_id": t["task_id"],
                         "bytes": ev.get("bytes", 0),
                         "nsources": ev.get("nsources", 0)},
            })
        if start is None:
            continue
        if end is None or end < start:
            end = start
        pid = t.get("node_id", "node")[:8]
        tid = t.get("worker_id", "worker")[:8]
        args = {"task_id": t["task_id"], "state": t["state"]}
        if t.get("trace_id"):
            args["trace_id"] = t["trace_id"]
        queued = t.get("creation_time")
        if queued is not None and queued < start:
            # SUBMITTED -> RUNNING: the owner-side queue + lease wait
            events.append({
                "name": f"{t.get('name', 'task')} (queued)",
                "cat": "queue_wait",
                "ph": "X",
                "ts": queued * 1e6,
                "dur": (start - queued) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": dict(args),
            })
        events.append({
            "name": t.get("name", "task"),
            "cat": "task",
            "ph": "X",
            "ts": start * 1e6,
            "dur": (end - start) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        for ev in items:
            events.append({
                "name": f"{t.get('name', 'task')}[{ev.get('index', '?')}]",
                "cat": "stream_item",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": ev["ts"] * 1e6,
                "pid": pid,
                "tid": tid,
                "args": dict(args, index=ev.get("index")),
            })
    if path:
        with open(path, "w") as f:
            json.dump(events, f)
    return events


# ------------------------------------------------------------------ metrics
def list_metrics(prefix: str = "") -> List[dict]:
    """Cluster-wide metric series from the GCS KV ``metrics/`` namespace
    (user metrics AND the always-on runtime metrics), merged across
    processes.  One row per (metric, tag set): counters carry ``value``
    (summed); gauges carry ``value`` (summed — right for additive
    gauges like pin counts and pool sizes) AND ``max`` (the largest
    single process's reading — the honest aggregate for point-in-time
    or watermark gauges like queue depth); histograms carry
    ``count``/``sum``/``mean`` and bucket-estimated ``p50``/``p95``
    (each quantile reported as the upper bound of the bucket it lands
    in)."""
    gcs = _gcs()
    merged: Dict[tuple, dict] = {}
    for key in gcs.kv_keys("metrics/" + prefix):
        raw = gcs.kv_get(key)
        if not raw:
            continue
        try:
            _, name, _worker = key.split("/", 2)
            data = json.loads(raw)
        except ValueError:
            continue
        for tagjson, val in (data.get("values") or {}).items():
            row = merged.setdefault((name, tagjson), {
                "name": name,
                "type": data.get("type", "untyped"),
                "description": data.get("description", ""),
                "tags": dict(json.loads(tagjson)),
            })
            if isinstance(val, dict):      # histogram wire format
                row.setdefault("buckets", {})
                for le, n in (val.get("buckets") or {}).items():
                    row["buckets"][le] = row["buckets"].get(le, 0) + n
                row["sum"] = row.get("sum", 0.0) + val.get("sum", 0.0)
                row["count"] = row.get("count", 0) + val.get("count", 0)
            else:
                row["value"] = row.get("value", 0.0) + val
                if data.get("type") == "gauge":
                    row["max"] = max(row.get("max", float("-inf")), val)
    out = []
    for row in merged.values():
        if "buckets" in row:
            count = row.get("count", 0)
            row["mean"] = (row.get("sum", 0.0) / count) if count else 0.0
            row["p50"] = _bucket_quantile(row["buckets"], count, 0.5)
            row["p95"] = _bucket_quantile(row["buckets"], count, 0.95)
        out.append(row)
    out.sort(key=lambda r: (r["name"], sorted(r["tags"].items())))
    return out


def _bucket_quantile(buckets: Dict[str, int], count: int,
                     q: float) -> float:
    """Upper-bound estimate of quantile ``q`` from cumulative bucket
    counts; returns ``inf`` when it lands in the overflow bucket."""
    if not count:
        return 0.0
    target = q * count
    cum = 0
    for le in sorted((k for k in buckets if k not in ("+Inf", "inf")),
                     key=float):
        cum += buckets[le]
        if cum >= target:
            return float(le)
    return float("inf")


def metrics_summary() -> str:
    """Operator-facing runtime-telemetry table (``ray-tpu summary
    metrics``): top RPC methods by p50/p95, latency histograms, stream
    stalls, pin counts — telemetry without the dashboard."""
    rows = list_metrics()
    lines: List[str] = []

    # cluster event plane (docs/observability.md): top event types by
    # count plus unhealthy nodes — the single-screen summary covers
    # what happened, not just how fast
    try:
        stats = _gcs().call("cluster_event_stats", {})
        counts = stats.get("counts_by_type") or {}
    except (rpc.RpcError, ConnectionError, TimeoutError):
        stats, counts = {}, {}
    if counts:
        lines.append("== Cluster events ==")
        lines.append("%-34s %10s" % ("TYPE", "COUNT"))
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
        for etype, n in top:
            lines.append("%-34s %10d" % (etype[:34], n))
        lines.append("%-34s %10d  (%d retained, %d B)" % (
            "total", sum(counts.values()), stats.get("events", 0),
            stats.get("bytes", 0)))
        lines.append("")

    try:
        nodes = list_nodes()
    except (rpc.RpcError, ConnectionError, TimeoutError):
        nodes = []
    health_lines = node_health_table(nodes)
    if health_lines:
        lines.append("== Node health ==")
        lines.extend(health_lines)
        lines.append("")

    # object-transfer data plane (docs/object_transfer.md): regressions
    # visible without rerunning benchmarks/object_transfer_perf.py
    byname = {(r["name"], tuple(sorted(r["tags"].items()))): r
              for r in rows}

    def _scalar(name):
        row = byname.get((name, ()))
        return row.get("value", 0.0) if row else 0.0

    pulled = _scalar("ray_tpu_pull_bytes_total")
    rtt = byname.get(("ray_tpu_pull_chunk_rtt_ms", ()))
    local_hits = _scalar("ray_tpu_fetch_local_hits_total")
    remote = _scalar("ray_tpu_fetch_remote_pulls_total")
    pf_reqs = _scalar("ray_tpu_prefetch_requests_total")
    pf_hits = _scalar("ray_tpu_prefetch_hits_total")
    if pulled or remote or pf_reqs:
        lines.append("== Object transfer ==")
        lines.append("%-34s %14s" % ("bytes pulled", f"{pulled:,.0f}"))
        if rtt and rtt.get("count"):
            lines.append("%-34s %9.3g / %.3g ms" % (
                "chunk RTT p50/p95", rtt.get("p50", 0.0),
                rtt.get("p95", 0.0)))
        fetches = local_hits + remote
        if fetches:
            lines.append("%-34s %13.1f%%" % (
                "local-hit ratio (fetches)",
                100.0 * local_hits / fetches))
        if pf_reqs:
            lines.append("%-34s %13.1f%%" % (
                "prefetch hit ratio",
                100.0 * pf_hits / pf_reqs))
        lines.append("")

    # collective data plane (docs/collective.md): wire traffic by
    # codec, bytes the quantized path saved, per-algo op latency, and
    # how much async-op ring time overlapped the caller's compute
    wire_rows = [r for r in rows
                 if r["name"] == "ray_tpu_collective_wire_bytes"]
    saved = _scalar("ray_tpu_collective_bytes_saved_total")
    op_rows = [r for r in rows
               if r["name"] == "ray_tpu_collective_op_ms"
               and r.get("count")]
    if wire_rows or op_rows:
        lines.append("== Collective ==")
        for r in sorted(wire_rows,
                        key=lambda r: r["tags"].get("codec", "")):
            lines.append("%-34s %14s" % (
                f"wire bytes ({r['tags'].get('codec', '?')})",
                f"{r.get('value', 0.0):,.0f}"))
        if saved:
            lines.append("%-34s %14s" % ("bytes saved (quantized)",
                                         f"{saved:,.0f}"))
        for r in sorted(op_rows, key=lambda r: r["tags"].get("op", "")):
            lines.append("%-34s %10d %9.3g %9.3g" % (
                r["tags"].get("op", "?"), r["count"],
                r.get("p50", 0.0), r.get("p95", 0.0)))
        hid = byname.get(("ray_tpu_collective_overlap_hidden_ms", ()))
        if hid and hid.get("count"):
            wait = byname.get(("ray_tpu_collective_overlap_wait_ms", ()))
            lines.append("%-34s %9.3g / %.3g ms" % (
                "overlap hidden/waited p50",
                hid.get("p50", 0.0),
                (wait or {}).get("p50", 0.0)))
        lines.append("")

    # disaggregated serving (docs/serve_disagg.md): handoff movement
    # cost + per-pool latency, visible without the dashboard
    handoff_rows = [r for r in rows
                    if r["name"] in ("ray_tpu_serve_handoff_bytes",
                                     "ray_tpu_serve_handoff_ms")
                    and r.get("count")]
    if handoff_rows:
        lines.append("== Serve KV handoff ==")
        lines.append("%-34s %10s %9s %9s" % ("STAGE", "COUNT", "P50",
                                             "P95"))
        for r in sorted(handoff_rows,
                        key=lambda r: (r["name"],
                                       r["tags"].get("stage", ""))):
            unit = "B" if r["name"].endswith("bytes") else "ms"
            stage = r["tags"].get("stage", "?")
            lines.append("%-34s %10d %9.3g %9.3g" % (
                f"{stage} ({unit})", r["count"], r.get("p50", 0.0),
                r.get("p95", 0.0)))
        lines.append("")

    # training performance plane (docs/observability.md): per-phase
    # step clocks + the goodput ledger, visible without the dashboard
    phase_rows = [r for r in rows
                  if r["name"] == "ray_tpu_train_phase_ms"
                  and r.get("count")]
    step_rows = [r for r in rows if r["name"] == "ray_tpu_train_step_ms"
                 and r.get("count")]
    if phase_rows or step_rows:
        lines.append("== Training steps ==")
        lines.append("%-34s %10s %9s %9s" % ("PHASE", "COUNT", "P50",
                                             "P95"))
        for r in sorted(step_rows,
                        key=lambda r: r["tags"].get("run", "")):
            lines.append("%-34s %10d %9.3g %9.3g" % (
                f"step ({r['tags'].get('run', '?')[:24]})", r["count"],
                r.get("p50", 0.0), r.get("p95", 0.0)))
        for r in sorted(phase_rows,
                        key=lambda r: r["tags"].get("phase", "")):
            lines.append("%-34s %10d %9.3g %9.3g" % (
                r["tags"].get("phase", "?"), r["count"],
                r.get("p50", 0.0), r.get("p95", 0.0)))
        try:
            summary = training_summary()
        except (rpc.RpcError, ConnectionError, TimeoutError):
            summary = None
        agg = (summary or {}).get("aggregate")
        if agg:
            lines.append("latest run %s: goodput %.1f%%  mfu %.2f%%" % (
                (summary or {}).get("run", "?"),
                100 * agg.get("goodput", 0.0),
                100 * agg.get("mfu", 0.0)))
        lines.append("")

    # request tracing plane (docs/observability.md): trace volume, the
    # sampled fraction, and the worst SLO-violating routes with concrete
    # exemplar trace ids — `ray-tpu trace <id>` shows which hop ate the
    # budget
    try:
        tstats = trace_stats()
    except (rpc.RpcError, ConnectionError, TimeoutError):
        tstats = {}
    slo_rows = [r for r in rows
                if r["name"] in ("ray_tpu_serve_slo_good",
                                 "ray_tpu_serve_slo_violation")]
    if tstats.get("traces_seen") or slo_rows:
        lines.append("== Request traces ==")
        total_classified = sum(r.get("value", 0.0) for r in slo_rows
                               if r["tags"].get("slo") == "ttft")
        lines.append("%-34s %10d  (%d retained, %d spans, %d B)" % (
            "traces recorded", tstats.get("traces_seen", 0),
            tstats.get("traces", 0), tstats.get("spans", 0),
            tstats.get("bytes", 0)))
        if total_classified:
            # ingress roots only: counting task-submission traces here
            # would inflate the fraction past the real serve coverage
            lines.append("%-34s %13.1f%%  (%d requests SLO-classified)"
                         % ("sampled fraction",
                            100.0 * min(1.0, tstats.get("ingress_seen", 0)
                                        / total_classified),
                            total_classified))
        for r in sorted(slo_rows, key=lambda r: (
                r["tags"].get("pool", ""), r["tags"].get("slo", ""),
                r["name"])):
            lines.append("%-34s %14g" % (
                "slo %s %s{%s}" % (
                    "good" if r["name"].endswith("good") else "VIOLATION",
                    r["tags"].get("slo", "?"), r["tags"].get("pool", "?")),
                r.get("value", 0.0)))
        violating = sorted(
            ((route, s) for route, s in
             (tstats.get("slo_by_route") or {}).items()
             if s.get("violation")),
            key=lambda kv: -kv[1]["violation"])[:5]
        for route, s in violating:
            ex = (s.get("exemplars") or [{}])[0]
            lines.append("%-34s %6d violations  worst %sms  trace %s" % (
                f"route {route[:26]}", s["violation"],
                ex.get("ttft_ms", "?"),
                (ex.get("trace_id") or "?")[:16]))
        lines.append("")

    rpc_rows = [r for r in rows if r["name"] == "ray_tpu_rpc_dispatch_ms"
                and r.get("count")]
    if rpc_rows:
        rpc_rows.sort(key=lambda r: -r.get("p95", 0.0))
        lines.append("== RPC dispatch latency (ms) ==")
        lines.append("%-28s %10s %9s %9s" % ("METHOD", "COUNT", "P50",
                                             "P95"))
        for r in rpc_rows[:15]:
            lines.append("%-28s %10d %9.3g %9.3g" % (
                r["tags"].get("method", "?")[:28], r["count"],
                r.get("p50", 0.0), r.get("p95", 0.0)))
        lines.append("")

    hist_rows = [r for r in rows if r["type"] == "histogram"
                 and r["name"] != "ray_tpu_rpc_dispatch_ms"
                 and r.get("count")]
    if hist_rows:
        lines.append("== Latency / size distributions ==")
        lines.append("%-36s %10s %9s %9s %9s" % (
            "NAME", "COUNT", "MEAN", "P50", "P95"))
        for r in hist_rows:
            tag = ",".join(f"{k}={v}" for k, v in sorted(
                r["tags"].items()))
            name = r["name"] + (f"{{{tag}}}" if tag else "")
            lines.append("%-36s %10d %9.3g %9.3g %9.3g" % (
                name[:36], r["count"], r.get("mean", 0.0),
                r.get("p50", 0.0), r.get("p95", 0.0)))
        lines.append("")

    scalar_rows = [r for r in rows if r["type"] in ("counter", "gauge")
                   and "value" in r]
    if scalar_rows:
        lines.append("== Counters / gauges ==")
        for r in scalar_rows:
            extra = ""
            if "max" in r and r["max"] != r["value"]:
                extra = "  (max/process %g)" % r["max"]
            lines.append("%-44s %14g%s" % (r["name"][:44], r["value"],
                                           extra))

    return "\n".join(lines) if lines else "(no metrics published yet)"


# ------------------------------------------------------- sixth plane
# metrics history + recovery auditing + doctor (docs/observability.md)
def list_metrics_history(name: Optional[str] = None, *,
                         ident: Optional[str] = None,
                         since: Optional[float] = None,
                         resolution: Optional[float] = None,
                         limit: int = 2000) -> List[dict]:
    """Windowed metric points from the GCS history rings, oldest first
    (``resolution`` picks the ring with the closest bucket width; the
    finest by default).  Each point: ``ts``/``res_s``/``name``/
    ``ident``/``type``/``values`` — the flusher snapshot that closed
    that bucket."""
    return _gcs().call("list_metrics_history", {
        "name": name, "ident": ident, "since": since,
        "resolution": resolution, "limit": limit})


def metrics_history_stats(*, series: bool = False) -> dict:
    return _gcs().call("metrics_history_stats", {"series": series})


def list_recovery_episodes(kind: Optional[str] = None, *,
                           include_open: bool = True,
                           limit: int = 100) -> List[dict]:
    """Recovery episodes the auditor derived from the event plane:
    ``drain`` (NODE_PREEMPTING -> NODE_DRAINED), ``failover`` (first
    failure event -> TRAIN_GANG_RECOVERY) and ``heal``
    (REPLICA_RETIRED -> AUTOSCALE), each with ``latency_s`` and its
    SLO verdict."""
    return _gcs().call("list_recovery_episodes", {
        "kind": kind, "include_open": include_open, "limit": limit})


def recovery_stats() -> dict:
    return _gcs().call("recovery_stats", {})


def doctor_report() -> dict:
    """The cross-plane correlation report (``ray-tpu doctor``): ranked
    findings with evidence lines, assembled GCS-side from one snapshot
    of all six observability planes."""
    return _gcs().call("doctor_report", {})


def doctor_report_text() -> str:
    from ray_tpu_torch._private.metrics_history import format_doctor_report
    return format_doctor_report(doctor_report())


def collect_debug_bundle(path: str) -> Dict[str, Any]:
    """One-shot forensics export (``ray-tpu debug-bundle``): a gzipped
    tarball of every observability plane as JSON — events + dossiers,
    traces, metrics (snapshot AND history window), step stats,
    recovery episodes, the doctor report (json + rendered text) and
    the merged Perfetto timeline.  Returns a manifest of member names
    and sizes so callers (and tests) can assert on the contents."""
    import io
    import tarfile
    import time as _time

    def _collect(fn):
        try:
            return fn()
        except Exception as e:   # a missing plane must not sink the rest
            return {"error": f"{type(e).__name__}: {e}"}

    gcs = _gcs()
    members: Dict[str, Any] = {
        "nodes.json": _collect(list_nodes),
        "events.json": _collect(
            lambda: list_cluster_events(limit=5000)),
        "event_stats.json": _collect(
            lambda: gcs.call("cluster_event_stats", {})),
        "dossiers.json": _collect(
            lambda: [get_dossier(d["dossier_id"]) or d
                     for d in list_dossiers()]),
        "traces.json": _collect(lambda: list_traces(limit=200)),
        "trace_stats.json": _collect(trace_stats),
        "metrics.json": _collect(list_metrics),
        "metrics_history.json": _collect(
            lambda: list_metrics_history(limit=10000)),
        "metrics_history_stats.json": _collect(
            lambda: metrics_history_stats(series=True)),
        "step_stats.json": _collect(lambda: list_step_stats()),
        "training_summary.json": _collect(training_summary),
        "recovery_episodes.json": _collect(
            lambda: list_recovery_episodes(limit=1000)),
        "recovery_stats.json": _collect(recovery_stats),
        "doctor.json": _collect(doctor_report),
        "timeline.json": _collect(timeline),
    }
    from ray_tpu_torch._private.metrics_history import format_doctor_report
    members["doctor.txt"] = _collect(
        lambda: format_doctor_report(members["doctor.json"]))
    manifest = {"generated_ts": _time.time(), "members": {}}
    with tarfile.open(path, "w:gz") as tar:
        for name, payload in members.items():
            if name.endswith(".json"):
                blob = json.dumps(payload, indent=1,
                                  default=str).encode()
            else:
                blob = str(payload).encode()
            info = tarfile.TarInfo("debug-bundle/" + name)
            info.size = len(blob)
            info.mtime = int(_time.time())
            tar.addfile(info, io.BytesIO(blob))
            manifest["members"][name] = len(blob)
    return manifest
