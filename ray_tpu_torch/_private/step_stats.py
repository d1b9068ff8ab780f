"""Training performance plane: per-step phase clock, cross-rank step
aggregation + straggler detection, and the goodput ledger.

The three observability planes that exist (metrics, timeline,
events/dossiers — docs/observability.md) watch the *runtime*; this module
watches the *training job*.  Distributed TPU training lives or dies on
keeping every chip busy every step (Podracer, arXiv:2104.06272): a single
straggling rank or a slow host phase silently taxes the whole gang
through the gradient allreduce, and "why is MFU 0.51 and not 0.55" is
unanswerable without a per-step phase breakdown.  Four pieces:

* **StepClock** — a per-rank, per-step phase timer the train loop drives
  (``bench.py`` timing discipline: phases are cut by explicit fences,
  ``torch.cuda.synchronize`` for device compute).  Every step decomposes
  into ``data_wait / host_dispatch / device_compute / grad_allreduce /
  optimizer / checkpoint`` slices, published three ways: runtime-metrics
  histogram families (``ray_tpu_train_step_ms`` / ``_phase_ms``,
  sub-ms-resolution buckets), STEP timeline slices on a synthetic
  ``step-<run>-r<rank>`` task record (first
  ``step_stats_timeline_steps`` per run, the STREAM_ITEM cap
  discipline) with a shared ``trace_id`` per step, and a batched
  per-step report to the GCS step table.

* **GcsStepStatsTable** — the GCS-side aggregation point (sharded-
  retention philosophy of ``GcsClusterEventTable``: bounded runs x
  bounded steps, ephemeral, never WALed).  When every rank of a step
  has reported, it computes cross-rank skew and **edge-triggers** a
  typed ``TRAIN_STRAGGLER`` event (rank, step, slowest phase, overshoot
  vs ``median + k * MAD``) into the PR 9 event plane — a degraded rank
  names itself instead of just dragging the allreduce.

* **GoodputLedger** — per-run accounting (init/compile time, productive
  step time, checkpoint time, idle/restart gaps, tokens, model FLOPs ->
  MFU and goodput fraction), pushed to the GCS at run end and exposed
  via ``experimental.state.training_summary()`` / ``ray-tpu summary
  training`` / the dashboard Training tab.  ``bench.py`` consumes the
  same ledger so BENCH rows carry ``goodput`` and a phase breakdown
  instead of recomputing MFU by hand.

* **merged_profile_trace** — folds per-rank ``profile`` RPC captures
  (``ray-tpu profile --group``) into one Perfetto-compatible trace
  keyed by rank, correlated with the step slices.

Kill switch: ``RAY_TPU_TORCH_STEP_STATS=0`` (or
``CONFIG.step_stats_enabled=False``) mirrors ``RAY_TPU_TORCH_TELEMETRY`` /
``RAY_TPU_TORCH_EVENTS``: ``step_clock()`` hands back a shared no-op clock, so
an instrumented loop costs one no-op method call per phase and nothing
is recorded anywhere (benchmarks/telemetry_overhead.py --step-stats
holds the on-cost to the same <= 3% bar).
"""

from __future__ import annotations

import os
import statistics
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private import runtime_metrics as rtm

# canonical phase order: timeline sub-slices stack in this order inside a
# step, and the goodput ledger reports totals keyed by these names
PHASES = ("data_wait", "host_dispatch", "device_compute",
          "grad_allreduce", "optimizer", "checkpoint")

# ms-scale steps need sub-ms resolution at the low end (a healthy
# data_wait is tens of microseconds) while checkpoint phases reach tens
# of seconds — same reasoning as the byte-scale handoff buckets
# (serve/llm.py): geometric coverage of the realistic range, anchored
# where the interesting distinctions live.
STEP_PHASE_MS_BOUNDARIES: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
    30000.0)

_M_STEP_MS = rtm.histogram_family(
    "ray_tpu_train_step_ms",
    "end-to-end train-step wall time per run (ms)", tag_key="run",
    boundaries=STEP_PHASE_MS_BOUNDARIES)
_M_PHASE_MS = rtm.histogram_family(
    "ray_tpu_train_phase_ms",
    "train-step phase wall time (ms): data_wait / host_dispatch / "
    "device_compute / grad_allreduce / optimizer / checkpoint",
    tag_key="phase", boundaries=STEP_PHASE_MS_BOUNDARIES)
_C_STEPS = rtm.counter("ray_tpu_train_steps_total",
                       "train steps completed on this process")


def enabled() -> bool:
    """Kill switch: RAY_TPU_TORCH_STEP_STATS env wins, then the config flag."""
    raw = os.environ.get("RAY_TPU_TORCH_STEP_STATS")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return CONFIG.step_stats_enabled


# ------------------------------------------------------------- ledger
class GoodputLedger:
    """Per-run, per-rank time accounting.

    Buckets every second of the run's wall clock: init (before the first
    step), compile (explicitly noted — the first dispatch usually), the
    productive step time (sum of step clocks), checkpoint time spent
    OUTSIDE steps (an in-step checkpoint phase counts inside its step
    and is reported in the phase breakdown either way), and the
    remainder — idle/restart gaps.  With ``tokens`` and model-FLOPs
    context it derives MFU and the goodput fraction."""

    def __init__(self, run_id: str, *, group: str = "", rank: int = 0,
                 world: int = 1, flops_per_token: float = 0.0,
                 peak_flops: float = 0.0):
        self.run_id = run_id
        self.group = group
        self.rank = rank
        self.world = world
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.t_start = time.time()
        self._t0 = rtm.now()
        self.init_ms = 0.0
        self._init_done = False
        self.compile_ms = 0.0
        self.steps = 0
        self.productive_ms = 0.0
        self.checkpoint_outside_ms = 0.0
        self.tokens = 0
        self.phase_ms: Dict[str, float] = {}
        self.finished = False
        self.wall_ms = 0.0

    def note_init_done(self) -> None:
        """Everything before this point was setup (worker spawn, mesh
        build, state init) — called automatically by the first
        ``begin()`` if never called explicitly."""
        if not self._init_done:
            self._init_done = True
            self.init_ms = (rtm.now() - self._t0) * 1000.0

    def note_compile_ms(self, ms: float) -> None:
        self.note_init_done()
        self.compile_ms += ms

    def note_step(self, step_ms: float, phases: Dict[str, float],
                  tokens: int) -> None:
        self.note_init_done()
        self.steps += 1
        self.productive_ms += step_ms
        self.tokens += int(tokens)
        for name, ms in phases.items():
            self.phase_ms[name] = self.phase_ms.get(name, 0.0) + ms

    def note_outside_phase(self, name: str, ms: float) -> None:
        if name == "checkpoint":
            self.checkpoint_outside_ms += ms
        self.phase_ms[name] = self.phase_ms.get(name, 0.0) + ms

    def finish(self) -> dict:
        if not self.finished:
            self.finished = True
            self.wall_ms = (rtm.now() - self._t0) * 1000.0
        return self.summary()

    def summary(self) -> dict:
        wall_ms = self.wall_ms if self.finished \
            else (rtm.now() - self._t0) * 1000.0
        accounted = (self.init_ms + self.compile_ms + self.productive_ms
                     + self.checkpoint_outside_ms)
        idle_ms = max(0.0, wall_ms - accounted)
        prod_s = self.productive_ms / 1000.0
        tokens_per_s = self.tokens / prod_s if prod_s > 0 else 0.0
        mfu = 0.0
        if prod_s > 0 and self.peak_flops > 0:
            mfu = (self.flops_per_token * self.tokens) / prod_s \
                / self.peak_flops
        return {
            "run": self.run_id, "group": self.group, "rank": self.rank,
            "world": self.world, "ts_start": self.t_start,
            "wall_ms": round(wall_ms, 3),
            "init_ms": round(self.init_ms, 3),
            "compile_ms": round(self.compile_ms, 3),
            "productive_ms": round(self.productive_ms, 3),
            "checkpoint_ms": round(
                self.phase_ms.get("checkpoint", 0.0), 3),
            "idle_ms": round(idle_ms, 3),
            "steps": self.steps,
            "tokens": self.tokens,
            "tokens_per_s": round(tokens_per_s, 1),
            "phase_ms": {k: round(v, 3)
                         for k, v in sorted(self.phase_ms.items())},
            "goodput": round(self.productive_ms / wall_ms, 4)
            if wall_ms > 0 else 0.0,
            "mfu": round(mfu, 4),
            "finished": self.finished,
        }


# ---------------------------------------------------------- run context
class _RunContext:
    """One training run on one rank: ledger + reporter + timeline cap.

    The per-step GCS reports buffer here and a small flusher thread
    ships them on ``step_stats_flush_interval_ms`` cadence (the
    metrics/events flusher philosophy: never an RPC on the step path)."""

    def __init__(self, run_id: str, *, group: str = "", rank: int = 0,
                 world: int = 1, flops_per_token: float = 0.0,
                 peak_flops: float = 0.0, tokens_per_step: int = 0,
                 sink: Optional[Callable[[List[dict]], Any]] = None,
                 meta: Optional[dict] = None):
        self.run_id = run_id
        self.group = group
        self.rank = rank
        self.world = world
        self.tokens_per_step = tokens_per_step
        self.ledger = GoodputLedger(
            run_id, group=group, rank=rank, world=world,
            flops_per_token=flops_per_token, peak_flops=peak_flops)
        self._sink = sink
        self._meta = dict(meta or {})
        self._meta_sent = False
        self._buf: List[dict] = []
        self._buf_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.step_no = 0
        self.timeline_steps = 0
        self.clock = StepClock(self)
        self._step_hist = _M_STEP_MS.get(run_id)
        # resolved once per run: CONFIG attribute resolution (lock +
        # env lookup) and the core-worker import are too heavy for the
        # per-step path (benchmarks/telemetry_overhead.py --step-stats)
        self._timeline_cap = CONFIG.step_stats_timeline_steps
        self._events_sink = None
        self._events_resolved = False

    # -- reporting ---------------------------------------------------------
    def _report_step(self, step: int, step_ms: float,
                     phases: Dict[str, float], ts_end: float) -> None:
        if self._sink is None:
            return
        rep = {"run": self.run_id, "group": self.group,
               "rank": self.rank, "world": self.world, "step": step,
               "ts": ts_end, "step_ms": round(step_ms, 3),
               "phases": phases}
        with self._buf_lock:
            if not self._meta_sent:
                rep["meta"] = self._meta
                self._meta_sent = True
            self._buf.append(rep)
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name="step-stats-flush")
                self._thread.start()

    def flush(self) -> None:
        with self._buf_lock:
            batch, self._buf = self._buf, []
        if batch and self._sink is not None:
            try:
                self._sink(batch)
            except Exception:
                # GCS away: re-queue bounded (one table's worth), like
                # the event recorder — a control-plane outage must not
                # grow rank memory by the step rate
                with self._buf_lock:
                    self._buf = (batch + self._buf)[
                        -max(16, CONFIG.gcs_step_stats_max_steps):]

    def _flush_loop(self) -> None:
        period = max(0.05, CONFIG.step_stats_flush_interval_ms / 1000.0)
        while not self._stop.wait(period):
            self.flush()
        self.flush()

    def _push_summary(self, summary: dict) -> None:
        if self._sink is None:
            return
        try:
            self._sink([{"run": self.run_id, "group": self.group,
                         "rank": self.rank, "world": self.world,
                         "summary": summary}])
        except Exception:
            pass

    def close(self) -> dict:
        self.clock._finalize_open_step()
        summary = self.ledger.finish()
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self.flush()
        self._push_summary(summary)
        if self.timeline_steps:
            # the gang's actors are killed right after the driver sees
            # "done": push the STEP timeline events now instead of
            # betting on the task-event flusher's next 500ms tick
            events = (self._events_sink or (None,))[0]
            if events is not None:
                try:
                    events.flush()
                except Exception:
                    pass
        if self.ledger.steps:
            # same race for the train metrics families: a short run's
            # worker can die before its 2s metrics flusher tick
            try:
                rtm.flush_now()
            except Exception:
                pass
        return summary

    # -- timeline ----------------------------------------------------------
    def _record_timeline(self, step: int, step_ms: float,
                         phases: Dict[str, float]) -> None:
        if self.timeline_steps >= self._timeline_cap:
            return
        if not self._events_resolved:
            self._events_resolved = True
            self._events_sink = _events_buffer()
        events, node_id, worker_id = self._events_sink or (None, "", "")
        if events is None:
            return
        self.timeline_steps += 1
        try:
            events.record(
                f"step-{self.run_id}-r{self.rank}", "STEP",
                name=f"train_step:{self.run_id}",
                step=step, dur_ms=round(step_ms, 3),
                phases=phases,
                trace_id=f"step-{self.run_id}:{step}",
                node_id=node_id, worker_id=worker_id)
        except Exception:
            pass


def _events_buffer():
    """The connected process's task-event buffer (timeline sink), or
    (None, ...) standalone — bench.py runs without a cluster."""
    try:
        from ray_tpu_torch.runtime import core_worker as cw
        worker = cw.get_global_worker()
        if worker is None or getattr(worker, "events", None) is None:
            return None, "", ""
        return (worker.events, getattr(worker, "node_id", ""),
                worker.worker_id.hex())
    except Exception:
        return None, "", ""


# ------------------------------------------------------------ step clock
class _PhaseCtx:
    __slots__ = ("_clock", "_name", "_t0")

    def __init__(self, clock: "StepClock", name: str):
        self._clock = clock
        self._name = name

    def __enter__(self):
        self._t0 = rtm.now()
        return self

    def __exit__(self, *exc):
        self._clock.record_phase(self._name,
                                 (rtm.now() - self._t0) * 1000.0)
        return False


class StepClock:
    """Per-step phase timer for one rank's train loop.

    ``begin()`` opens a step (auto-finalizing a still-open previous one,
    so a loop that only calls ``begin()`` + phases still records every
    step); ``phase(name)`` is a context manager cutting one phase;
    ``end(tokens=...)`` closes the step and publishes metrics, the
    timeline slice and the GCS report.  Phase timing relies on the
    caller fencing device work (``torch.cuda.synchronize`` inside the
    ``device_compute`` phase — the bench.py discipline); an unfenced
    dispatch attributes device time to whichever phase next blocks on
    the device queue."""

    def __init__(self, run: _RunContext):
        self._run = run
        self._open = False
        self._t_begin = 0.0
        self._phases: Dict[str, float] = {}

    # -- step lifecycle ----------------------------------------------------
    def begin(self) -> "StepClock":
        self._finalize_open_step()
        self._run.ledger.note_init_done()
        self._open = True
        self._t_begin = rtm.now()
        self._phases = {}
        return self

    def phase(self, name: str) -> _PhaseCtx:
        if not self._open:
            self.begin()
        return _PhaseCtx(self, name)

    def record_phase(self, name: str, ms: float) -> None:
        if self._open:
            self._phases[name] = self._phases.get(name, 0.0) + ms
        else:
            self._run.ledger.note_outside_phase(name, ms)
        _M_PHASE_MS.observe(name, ms)

    def end(self, tokens: Optional[int] = None) -> Optional[float]:
        """Close the step; returns its wall ms (None if no step open)."""
        if not self._open:
            return None
        self._open = False
        step_ms = (rtm.now() - self._t_begin) * 1000.0
        run = self._run
        step = run.step_no
        run.step_no += 1
        n_tokens = run.tokens_per_step if tokens is None else tokens
        run.ledger.note_step(step_ms, self._phases, n_tokens)
        run._step_hist.observe(step_ms)
        _C_STEPS.inc()
        run._record_timeline(step, step_ms, self._phases)
        run._report_step(step, step_ms, self._phases, time.time())
        self._phases = {}
        return step_ms

    def _finalize_open_step(self) -> None:
        if self._open:
            self.end()


class _NoopClock:
    """Shared stub when the plane is disabled: one no-op call per use."""

    class _Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _CTX = _Ctx()

    def begin(self):
        return self

    def phase(self, name: str):
        return self._CTX

    def record_phase(self, name: str, ms: float) -> None:
        pass

    def end(self, tokens: Optional[int] = None):
        return None

    def _finalize_open_step(self) -> None:
        pass


NOOP_CLOCK = _NoopClock()

_runs_lock = threading.Lock()
_runs: Dict[int, _RunContext] = {}       # thread id -> run context


def start_run(run_id: Optional[str] = None, *, group: str = "",
              rank: int = 0, world: int = 1,
              flops_per_token: float = 0.0, peak_flops: float = 0.0,
              tokens_per_step: int = 0,
              sink: Optional[Callable[[List[dict]], Any]] = None,
              meta: Optional[dict] = None) -> Optional[_RunContext]:
    """Open a training-run context on this thread (TrainWorker installs
    one around the user loop; bench.py opens its own).  ``sink`` takes
    report batches (``report_step_stats`` payload); None = local-only
    (the ledger still accumulates).  Returns None when disabled."""
    # raylint: disable=kill-switch -- once per training RUN, not per step; disabled runs get the shared no-op clock
    if not enabled():
        return None
    run = _RunContext(run_id or f"run-{uuid.uuid4().hex[:8]}",
                      group=group, rank=rank, world=world,
                      flops_per_token=flops_per_token,
                      peak_flops=peak_flops,
                      tokens_per_step=tokens_per_step, sink=sink,
                      meta=meta)
    with _runs_lock:
        _runs[threading.get_ident()] = run
    return run


def end_run(run: Optional[_RunContext] = None) -> Optional[dict]:
    """Close the thread's run (or the given one): finalizes the ledger,
    flushes reports, pushes the summary to the GCS.  Returns the
    summary dict (None when no run was active)."""
    with _runs_lock:
        if run is None:
            run = _runs.pop(threading.get_ident(), None)
        else:
            for tid, r in list(_runs.items()):
                if r is run:
                    _runs.pop(tid, None)
    if run is None:
        return None
    return run.close()


def current_run() -> Optional[_RunContext]:
    """The thread's run context, falling back (like air.session) to the
    process's single run so user helper threads resolve it too."""
    with _runs_lock:
        run = _runs.get(threading.get_ident())
        if run is None and len(_runs) == 1:
            run = next(iter(_runs.values()))
        return run


def step_clock():
    """The active run's StepClock (the no-op stub when the plane is
    disabled or no run is open) — the one import a train loop needs:

    >>> clock = step_clock()
    >>> for batch in data:            # doctest: +SKIP
    ...     clock.begin()
    ...     with clock.phase("host_dispatch"):
    ...         state, metrics = step_fn(state, batch)
    ...     with clock.phase("device_compute"):
    ...         torch.cuda.synchronize()
    ...     clock.end(tokens=batch_tokens)
    """
    run = current_run()
    if run is None:
        return NOOP_CLOCK
    return run.clock


def set_model_info(*, flops_per_token: Optional[float] = None,
                   peak_flops: Optional[float] = None,
                   tokens_per_step: Optional[int] = None) -> None:
    """Teach the active run its model arithmetic (from inside the train
    loop — the framework can't derive FLOPs/token generically): with
    these set the goodput ledger reports MFU, not just time buckets."""
    run = current_run()
    if run is None:
        return
    if flops_per_token is not None:
        run.ledger.flops_per_token = float(flops_per_token)
    if peak_flops is not None:
        run.ledger.peak_flops = float(peak_flops)
    if tokens_per_step is not None:
        run.tokens_per_step = int(tokens_per_step)


def record_phase(name: str, ms: float) -> None:
    """Attribute ``ms`` to phase ``name`` of the active step (the hook
    ``sync_gradients`` / ``session.report`` use); outside a step it
    lands in the run ledger's out-of-step totals."""
    run = current_run()
    if run is not None:
        run.clock.record_phase(name, ms)


def _synchronize(out) -> None:
    """Wait for the device work that produced ``out``: a CUDA synchronise
    of every device its tensors (at any depth of lists, tuples and dicts)
    live on.  Host-only outputs need no fence."""
    import torch
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def instrument_step(step_fn: Callable, *,
                    tokens_per_step: Optional[int] = None) -> Callable:
    """Wrap a train step so each call is one clocked step:
    ``begin`` -> dispatch as ``host_dispatch`` -> a CUDA synchronise of
    the output's devices as ``device_compute`` -> ``end``.  The fence
    serializes the device pipeline — use the explicit :func:`step_clock`
    API in throughput-critical loops and fence only where bench.py
    does."""
    def timed(*args, **kwargs):
        clock = step_clock()
        clock.begin()
        with clock.phase("host_dispatch"):
            out = step_fn(*args, **kwargs)
        with clock.phase("device_compute"):
            _synchronize(out)
        clock.end(tokens=tokens_per_step)
        return out

    timed.__name__ = getattr(step_fn, "__name__", "train_step")
    return timed


# ----------------------------------------------------- GCS aggregation
def _median_mad(values: List[float]) -> Tuple[float, float]:
    med = statistics.median(values)
    mad = statistics.median([abs(v - med) for v in values])
    return med, mad


class GcsStepStatsTable:
    """GCS-side per-run step table + straggler detector + ledger store.

    Retention is bounded twice, like the cluster event table: at most
    ``gcs_max_step_runs`` runs (oldest-touched evicted first) each
    keeping the last ``gcs_step_stats_max_steps`` steps.  Ephemeral —
    never WALed, like task events and metrics.

    Straggler detection runs when every rank of a step has reported
    (``world`` from the reports) and the gang has >= 3 ranks — robust
    location/scale (median + k * MAD) needs a majority of honest
    ranks, and a 2-rank gang's median sits exactly between the ranks,
    so neither side can overshoot it meaningfully.  A rank whose step
    time exceeds ``median + straggler_mad_k * MAD`` by at least
    ``straggler_min_ms`` flips to straggling and emits ONE
    ``TRAIN_STRAGGLER`` event naming the phase with the largest
    overshoot vs the phase median; the state edge-triggers — it must
    recover (a clean analyzed step) before it can fire again."""

    def __init__(self, emit: Optional[Callable[..., Any]] = None,
                 max_runs: Optional[int] = None,
                 max_steps: Optional[int] = None):
        self._emit = emit
        self.max_runs = max_runs or CONFIG.gcs_max_step_runs
        self.max_steps = max_steps or CONFIG.gcs_step_stats_max_steps
        self._runs: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self._stragglers_total = 0

    def _run_entry(self, run_id: str, group: str, world: int) -> dict:
        entry = self._runs.get(run_id)
        if entry is None:
            entry = {"run": run_id, "group": group, "world": world,
                     "ranks": {}, "steps": OrderedDict(),
                     "order": deque(), "straggling": {},
                     "summaries": {}, "ts_start": time.time(),
                     "last_ts": time.time(), "nsteps_seen": 0,
                     "skew": deque(maxlen=64)}
            self._runs[run_id] = entry
            while len(self._runs) > self.max_runs:
                self._runs.popitem(last=False)
        entry["group"] = group or entry["group"]
        entry["world"] = max(world, entry["world"])
        self._runs.move_to_end(run_id)
        return entry

    def put(self, reports: List[dict]) -> int:
        """Merge one batch of rank reports; returns steps rotated out.
        A report carrying ``summary`` stores the rank's goodput ledger
        instead of a step."""
        dropped = 0
        analyze: List[Tuple[dict, int]] = []
        with self._lock:
            for rep in reports:
                if not isinstance(rep, dict) or not rep.get("run"):
                    continue
                entry = self._run_entry(rep["run"],
                                        rep.get("group", ""),
                                        int(rep.get("world", 1)))
                entry["last_ts"] = time.time()
                rank = int(rep.get("rank", 0))
                meta = rep.get("meta")
                if meta is not None:
                    entry["ranks"][rank] = dict(meta, rank=rank)
                if "summary" in rep:
                    entry["summaries"][rank] = rep["summary"]
                    continue
                if "step" not in rep:
                    continue
                step = int(rep["step"])
                srec = entry["steps"].get(step)
                if srec is None:
                    srec = entry["steps"][step] = {}
                    entry["order"].append(step)
                    entry["nsteps_seen"] += 1
                    while len(entry["steps"]) > self.max_steps:
                        victim = entry["order"].popleft()
                        entry["steps"].pop(victim, None)
                        dropped += 1
                srec[rank] = {"step_ms": float(rep.get("step_ms", 0.0)),
                              "ts": rep.get("ts"),
                              "phases": dict(rep.get("phases") or {})}
                if len(srec) >= entry["world"] and \
                        not srec.get("_analyzed"):
                    srec["_analyzed"] = True
                    analyze.append((entry, step))
        for entry, step in analyze:
            self._analyze_step(entry, step)
        return dropped

    # -- straggler detection ----------------------------------------------
    def _analyze_step(self, entry: dict, step: int) -> None:
        with self._lock:
            srec = entry["steps"].get(step)
            if srec is None:
                return
            ranks = {r: v for r, v in srec.items()
                     if isinstance(r, int)}
        if len(ranks) < 2:
            return
        totals = {r: v["step_ms"] for r, v in ranks.items()}
        med, mad = _median_mad(list(totals.values()))
        k = CONFIG.straggler_mad_k
        floor = CONFIG.straggler_min_ms
        skew = max(totals.values()) - med
        with self._lock:
            entry["skew"].append({"step": step, "median_ms": round(med, 3),
                                  "max_ms": round(max(totals.values()), 3),
                                  "skew_ms": round(skew, 3)})
        if len(ranks) < 3:
            # a 2-rank gang's median sits exactly between the ranks —
            # skew is recorded, but median+MAD can't name a straggler
            return
        for rank, total in totals.items():
            overshoot = total - (med + k * mad)
            straggling = overshoot >= floor
            with self._lock:
                was = entry["straggling"].get(rank, False)
                entry["straggling"][rank] = straggling
            if straggling and not was:
                phase = self._slowest_phase(ranks, rank)
                self._stragglers_total += 1
                if self._emit is not None:
                    try:
                        self._emit(
                            "WARNING", "step_stats", "TRAIN_STRAGGLER",
                            f"run {entry['run']} rank {rank} straggling "
                            f"at step {step}: {total:.1f}ms vs median "
                            f"{med:.1f}ms (slowest phase: {phase})",
                            run=entry["run"], group=entry["group"],
                            rank=rank, step=step, phase=phase,
                            step_ms=round(total, 3),
                            median_ms=round(med, 3),
                            overshoot_ms=round(total - med, 3),
                            worker_id=(entry["ranks"].get(rank) or {}
                                       ).get("worker_id"),
                            node_id=(entry["ranks"].get(rank) or {}
                                     ).get("node_id"))
                    except Exception:
                        pass

    @staticmethod
    def _slowest_phase(ranks: Dict[int, dict], rank: int) -> str:
        """The phase where ``rank`` overshoots the cross-rank phase
        median the most — the slice that names the bottleneck."""
        mine = ranks[rank].get("phases") or {}
        worst, worst_over = "", float("-inf")
        for name, ms in mine.items():
            peers = [v.get("phases", {}).get(name, 0.0)
                     for r, v in ranks.items() if r != rank]
            med = statistics.median(peers) if peers else 0.0
            over = ms - med
            if over > worst_over:
                worst, worst_over = name, over
        return worst or "step"

    # -- queries -----------------------------------------------------------
    def list_runs(self, run: Optional[str] = None,
                  limit: int = 100) -> List[dict]:
        with self._lock:
            out = []
            for run_id, entry in self._runs.items():
                if run and not (run_id.startswith(run)
                                or entry["group"].startswith(run)):
                    continue
                out.append({
                    "run": run_id, "group": entry["group"],
                    "world": entry["world"],
                    "ranks": {r: dict(m)
                              for r, m in entry["ranks"].items()},
                    "steps_seen": entry["nsteps_seen"],
                    "steps_retained": len(entry["steps"]),
                    "ts_start": entry["ts_start"],
                    "last_ts": entry["last_ts"],
                    "straggling": {r: s for r, s
                                   in entry["straggling"].items() if s},
                    "skew": list(entry["skew"]),
                })
            return out[-max(0, int(limit)):]

    def steps(self, run: str, limit: int = 64) -> List[dict]:
        with self._lock:
            entry = self._runs.get(run)
            if entry is None:
                for rid, e in self._runs.items():
                    if rid.startswith(run) or e["group"].startswith(run):
                        entry = e
                        break
            if entry is None:
                return []
            out = []
            for step in list(entry["order"])[-max(0, int(limit)):]:
                srec = entry["steps"].get(step)
                if srec is None:
                    continue
                out.append({"step": step,
                            "ranks": {r: dict(v) for r, v in srec.items()
                                      if isinstance(r, int)}})
            return out

    def summary(self, run: Optional[str] = None) -> Optional[dict]:
        """The goodput ledger view of one run (latest by default):
        per-rank summaries plus an aggregate."""
        with self._lock:
            entry = None
            if run:
                entry = self._runs.get(run)
                if entry is None:
                    for rid, e in self._runs.items():
                        if rid.startswith(run) \
                                or e["group"].startswith(run):
                            entry = e
                            break
            elif self._runs:
                # latest run with any summary, else latest touched
                for e in reversed(self._runs.values()):
                    if e["summaries"]:
                        entry = e
                        break
                if entry is None:
                    entry = next(reversed(self._runs.values()))
            if entry is None:
                return None
            summaries = {r: dict(s)
                         for r, s in sorted(entry["summaries"].items())}
            out = {"run": entry["run"], "group": entry["group"],
                   "world": entry["world"], "ranks": summaries,
                   "steps_seen": entry["nsteps_seen"],
                   "skew": list(entry["skew"])}
        if summaries:
            vals = list(summaries.values())
            out["aggregate"] = {
                "tokens": sum(s.get("tokens", 0) for s in vals),
                "steps": max(s.get("steps", 0) for s in vals),
                "goodput": round(sum(s.get("goodput", 0.0)
                                     for s in vals) / len(vals), 4),
                "mfu": round(sum(s.get("mfu", 0.0)
                                 for s in vals) / len(vals), 4),
                "tokens_per_s": round(sum(s.get("tokens_per_s", 0.0)
                                          for s in vals), 1),
            }
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"runs": len(self._runs),
                    "steps_retained": sum(len(e["steps"])
                                          for e in self._runs.values()),
                    "stragglers_total": self._stragglers_total,
                    "max_runs": self.max_runs,
                    "max_steps": self.max_steps}


# -------------------------------------------------- profile trace merge
def step_trace_events(task_rows: List[dict],
                      window: Optional[Tuple[float, float]] = None
                      ) -> List[dict]:
    """STEP records from the GCS task table -> chrome-trace slices
    (the ``ray-tpu profile --group`` correlation rows).  ``window``
    (wall-clock start, end) filters to the capture span."""
    events: List[dict] = []
    for t in task_rows:
        for ev in t.get("events") or []:
            if ev.get("state") != "STEP":
                continue
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            t_end = ev.get("ts", 0.0)
            if window and (t_end < window[0] or t_end - dur_s > window[1]):
                continue
            args = {"step": ev.get("step")}
            if ev.get("trace_id"):
                args["trace_id"] = ev["trace_id"]
            args.update({k: v for k, v in (ev.get("phases") or {}).items()})
            events.append({
                "name": f"step {ev.get('step', '?')}",
                "cat": "train_step", "ph": "X",
                "ts": (t_end - dur_s) * 1e6, "dur": dur_s * 1e6,
                "pid": _rank_pid(t.get("task_id", "")),
                "tid": "steps", "args": args,
            })
    return events


def _rank_pid(task_id: str) -> str:
    """``step-<run>-r<rank>`` -> ``rank <rank>`` (the merged profile
    trace keys rows by rank, so step slices land on the rank's row)."""
    if "-r" in task_id:
        tail = task_id.rsplit("-r", 1)[1]
        if tail.isdigit():
            return f"rank {int(tail)}"
    return task_id[:16]


def merged_profile_trace(per_rank: Dict[int, Dict[str, int]],
                         interval_s: float, t_start: float,
                         step_events: Optional[List[dict]] = None
                         ) -> List[dict]:
    """Fold per-rank ``profile`` captures into one Perfetto trace.

    Each rank becomes a ``pid`` row (``rank N``); its folded stacks lay
    out as time-weighted complete slices (count x sampling interval) in
    hotness order from the capture's real start time — sample placement
    WITHIN the window is synthetic (a sampling profile has no
    ordering), but the window bounds are wall-clock, so the rows line
    up against each other and against the STEP slices passed in
    ``step_events`` (state.api timeline shape)."""
    from ray_tpu_torch._private import profiler
    events: List[dict] = []
    for rank in sorted(per_rank):
        counts, leaf_lines = profiler.split_leaf_detail(per_rank[rank])
        t = t_start * 1e6
        for stack, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            dur = n * interval_s * 1e6
            leaf = stack.rsplit(";", 1)[-1]
            args = {"stack": stack.replace(";", "\n"), "samples": n}
            lines = (leaf_lines or {}).get(leaf)
            if lines:
                hot = max(lines.items(), key=lambda kv: kv[1])
                args["top_line"] = hot[0]
            events.append({
                "name": leaf, "cat": "profile", "ph": "X",
                "ts": t, "dur": dur,
                "pid": f"rank {rank}", "tid": "samples",
                "args": args,
            })
            t += dur
    for ev in step_events or []:
        events.append(ev)
    return events
