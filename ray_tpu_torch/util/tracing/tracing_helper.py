"""Distributed request tracing plane (docs/observability.md).

The runtime's fifth observability plane: metrics say how fast, events
say what happened, the timeline shows each subsystem's slices, step
stats clock training — this module follows ONE request across process
boundaries.  A serve request traverses proxy -> router -> prefill
replica -> paged-KV handoff over the transfer plane -> decode replica;
each hop records a span carrying the same ``trace_id``, parent/child
linked, batched off the hot path into the GCS span table, so a p99 TTFT
regression points at a concrete trace whose spans show which hop (queue
wait, prefill, handoff pull, import wait, decode) ate the budget.

Pieces:

* **Context** — a ContextVar dict ``{trace_id, span_id, sampled}``.
  A ContextVar, not a thread-local: async-actor calls interleave on one
  event-loop thread and each asyncio Task must keep its own trace
  identity.  The context rides task specs (``spec["trace_ctx"]``,
  stamped at submission in core_worker.py), streaming-generator report
  RPCs (the reserved ``_trace_ctx`` payload key rpc.py installs around
  dispatch), and transfer-plane pulls.

* **Deterministic sampler** — ``sampled(trace_id)`` hashes the id's
  first 8 hex chars against ``CONFIG.trace_sample_rate``: a pure
  function of the id, so every process reaches the SAME decision with
  no coordination and no sampling flag can desync from its trace.
  Serve ingresses always open a root context (SLO accounting needs
  every request classified); span *recording* follows the sampler.
  Task/actor submissions with no active context draw one 32-bit random
  and only materialize a trace when it clears the rate — the unsampled
  hot-path cost is one ``getrandbits`` + compare.

* **SpanBuffer** — per-process bounded recorder + flusher thread
  (the step-stats/events flusher discipline: never an RPC on the hot
  path; sink failures re-queue bounded to one buffer's worth).
  Bound by ``CoreWorker.__init__`` like the event recorder.

* **GcsSpanTable** — trace-indexed span store, sharded like the event
  table, retention bounded by BOTH ``gcs_max_traces`` and a
  ``gcs_traces_max_bytes`` JSON-size budget plus a per-trace span cap.
  Root spans carry serve SLO fields (ttft/tpot vs targets) and an
  optional crash ``dossier_id`` cross-link (the table annotates the
  dossier with the trace id in return).  Queryable via
  ``experimental.state.list_traces()/get_trace()``, ``ray-tpu trace``/
  ``ray-tpu traces --slo-violations``, dashboard ``/api/traces``.

* **SLO accounting** — ``finish_request()`` classifies a completed
  serve request against ``CONFIG.serve_slo_ttft_ms`` /
  ``serve_slo_tpot_ms``, publishes
  ``ray_tpu_serve_slo_good/violation{pool,slo}`` counters (always, not
  just for sampled requests) and stamps the verdict + exemplar ids on
  the root span.

Kill switch: ``RAY_TPU_TORCH_TRACING=0`` (or ``CONFIG.tracing_enabled=False``)
mirrors RAY_TPU_TORCH_TELEMETRY / RAY_TPU_TORCH_EVENTS — roots/spans degrade to
no-ops after one cached flag read, nothing is buffered or shipped.

User-level ``span()`` predates the plane (reference analog
/root/reference/python/ray/util/tracing/tracing_helper.py) and keeps
its contract: it always records a task-event slice for the timeline
(sampling governs only the span-table copy) and mirrors name,
attributes and error status onto an OpenTelemetry span when
opentelemetry happens to be importable.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

from ray_tpu_torch._private.config import CONFIG

try:  # pragma: no cover - image does not bundle opentelemetry
    from opentelemetry import trace as _otel_trace
    from opentelemetry.trace import Status as _OtelStatus
    from opentelemetry.trace import StatusCode as _OtelStatusCode
    _tracer = _otel_trace.get_tracer("ray_tpu_torch")
except ImportError:
    _otel_trace = None
    _OtelStatus = None
    _OtelStatusCode = None
    _tracer = None

# a ContextVar, not threading.local: async-actor calls interleave on one
# event-loop thread, and each asyncio Task must keep its own trace context
# (a thread-local would let concurrent calls clobber each other's ids)
_ctx_var: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)

# span status values
OK = "ok"
ERROR = "error"
# client walked away (disconnect, early close): neither an SLO success
# nor a service failure — excluded from both counters
CANCELLED = "cancelled"


def enabled() -> bool:
    """Kill switch: RAY_TPU_TORCH_TRACING env wins, then the config flag."""
    raw = os.environ.get("RAY_TPU_TORCH_TRACING")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return CONFIG.tracing_enabled


# enabled() + the sampler threshold are read on every task submission:
# cache them keyed on the CONFIG override generation (the rpc._maybe_fuzz
# idiom) so the hot path pays a tuple compare, not an env read + lock
_flag_cache = (-1, False, 0)


def _flags() -> tuple:
    global _flag_cache
    gen = CONFIG.generation()
    cached = _flag_cache
    if cached[0] != gen:
        rate = min(1.0, max(0.0, CONFIG.trace_sample_rate))
        cached = (gen, enabled(), int(rate * 0x100000000))
        _flag_cache = cached
    return cached


def sampled(trace_id: str) -> bool:
    """Deterministic trace-id-hash sampling decision: a pure function of
    the id and the configured rate, so every process that sees this
    trace reaches the same verdict independently."""
    _gen, on, threshold = _flags()
    if not on:
        return False
    try:
        return int(trace_id[:8], 16) < threshold
    except (ValueError, TypeError):
        return False


# ids come from a Mersenne generator, not uuid4: uuid4 costs ~2us in
# isolation and 5-10us inside the live submit loop (os.urandom syscall +
# object churn), and a sampled task mints 3-4 ids across driver+worker —
# that alone was most of the plane's measured per-task cost.  Trace ids
# are correlation keys, not secrets; 128 random bits from MT are as
# collision-proof as uuid4's.  A module-LOCAL Random reseeded after
# fork, NOT the global generator: workers fork from a warm zygote
# (runtime/worker_zygote.py) with byte-identical RNG state, and without
# the reseed two workers would mint the SAME trace/span ids and merge
# unrelated requests into one trace record.
_id_rng = random.Random()
_rand = _id_rng.getrandbits
if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_id_rng.seed)  # reseeds from urandom


def new_trace_id() -> str:
    return f"{_rand(128):032x}"


def new_span_id() -> str:
    return f"{_rand(64):016x}"


# ------------------------------------------------------------------ context
def get_trace_context() -> Dict[str, Any]:
    """Current trace/span ids, for propagation into submitted tasks."""
    ctx = _ctx_var.get()
    return dict(ctx) if ctx else {}


def current_context() -> Optional[dict]:
    """The raw context dict (no copy) — hot-path read for submitters."""
    return _ctx_var.get()


def propagate_trace_context(ctx: Optional[Dict[str, Any]]) -> None:
    """Install a parent context received with a task."""
    _ctx_var.set(dict(ctx) if ctx else None)


def install(ctx: Optional[dict]):
    """Set the context and return a token for ``uninstall`` (scoped
    installation around a routing/submit section)."""
    return _ctx_var.set(dict(ctx) if ctx else None)


def uninstall(token) -> None:
    _ctx_var.reset(token)


def bind_ctx(ctx: Optional[dict], fn: Callable, *args, **kwargs):
    """Wrap ``fn`` so it runs with ``ctx`` installed — for executor hops
    (``loop.run_in_executor`` does not carry ContextVars), where the
    serve layer moves blocking routing/pull work off the event loop."""
    def _run():
        token = _ctx_var.set(dict(ctx) if ctx else None)
        try:
            return fn(*args, **kwargs)
        finally:
            _ctx_var.reset(token)
    return _run


def maybe_sample_root() -> Optional[dict]:
    """Sampling gate for task/actor submission with no active context
    (core_worker.py): draw one 32-bit random; only when it clears the
    rate does a trace id materialize (its first 8 hex chars ARE the
    draw, so ``sampled()`` re-derives the same verdict anywhere)."""
    _gen, on, threshold = _flags()
    if not on or threshold <= 0:
        return None
    r = _rand(32)
    if r >= threshold:
        return None
    trace_id = f"{r:08x}{_rand(96):024x}"
    return {"trace_id": trace_id, "span_id": new_span_id(),
            "sampled": True}


def ctx_sampled(ctx: Optional[dict]) -> bool:
    """Is this context's trace being recorded?  Trusts the propagated
    flag when present (saves the hash), else re-derives from the id."""
    if not ctx:
        return False
    s = ctx.get("sampled")
    if s is None:
        return sampled(ctx.get("trace_id", ""))
    return bool(s)


# -------------------------------------------------------------------- spans
class Span:
    """One open span: fixed identity at open, attributes at end.

    ``end()`` records into the process's span buffer (no-op when the
    trace is unsampled or the plane is off) — never an RPC."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "start", "_t0", "sampled", "attrs", "_ended")

    def __init__(self, name: str, kind: str = "user", *,
                 ctx: Optional[dict] = None, root: bool = False,
                 attrs: Optional[dict] = None):
        if root or not ctx:
            self.trace_id = (ctx or {}).get("trace_id") or new_trace_id()
            self.parent_id = (ctx or {}).get("span_id")
        else:
            self.trace_id = ctx["trace_id"]
            self.parent_id = ctx.get("span_id")
        self.span_id = new_span_id()
        self.name = name
        self.kind = kind
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.sampled = ctx_sampled(ctx) if ctx else sampled(self.trace_id)
        self.attrs = dict(attrs) if attrs else None
        self._ended = False

    def ctx(self) -> dict:
        """The context children of this span should inherit."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    def set_attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def end(self, status: str = OK, *, dur_ms: Optional[float] = None,
            **fields: Any) -> None:
        """Close and record.  Extra ``fields`` land as top-level span
        fields (root/SLO/dossier stamps); user attributes stay under
        ``attrs``.  Idempotent — a double end records once."""
        if self._ended or not self.sampled:
            self._ended = True
            return
        self._ended = True
        span = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "name": self.name, "kind": self.kind, "start": self.start,
            "dur_ms": round(dur_ms if dur_ms is not None else
                            (time.perf_counter() - self._t0) * 1e3, 3),
            "status": status,
        }
        if self.parent_id:
            span["parent_id"] = self.parent_id
        if self.attrs:
            span["attrs"] = self.attrs
        for k, v in fields.items():
            if v is not None:
                span[k] = v
        record_span(span)


def open_span(name: str, kind: str = "user", *,
              ctx: Optional[dict] = None) -> Optional[Span]:
    """A child span of ``ctx`` (default: the current context) — or None
    when the trace is unsampled, so call sites stay one ``if`` cheap."""
    if ctx is None:
        ctx = _ctx_var.get()
    if not ctx_sampled(ctx):
        return None
    return Span(name, kind, ctx=ctx)


def instant_span(name: str, kind: str, *, ctx: Optional[dict] = None,
                 dur_ms: float = 0.0, **fields: Any) -> None:
    """Marker span recorded after the fact: zero duration by default
    (streaming per-yield items), or backdated by ``dur_ms`` for work
    whose cost was measured out-of-band (handoff export legs)."""
    sp = open_span(name, kind, ctx=ctx)
    if sp is not None:
        if dur_ms:
            sp.start -= dur_ms / 1e3
        sp.end(dur_ms=dur_ms, **fields)


# ------------------------------------------------------- per-process buffer
class SpanBuffer:
    """Bounded per-process span recorder + GCS flusher (the
    cluster-events flusher discipline: record() is one deque append
    under a short lock; the flusher batches to the sink; a sink failure
    re-queues bounded to one buffer's worth)."""

    def __init__(self, sink: Callable[[List[dict]], Any], *,
                 node_id: str = "", worker_id: str = "",
                 source: str = ""):
        self._sink = sink
        self._cap = max(64, CONFIG.trace_buffer_size)
        # stamped onto every span at record time (the EventRecorder
        # defaults idiom): which process/node a hop ran on is exactly
        # what a cross-process trace is for
        self._defaults = {k: v for k, v in
                          (("node_id", node_id), ("worker_id", worker_id),
                           ("source", source)) if v}
        self._unflushed: List[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def record(self, span: dict) -> None:
        for k, v in self._defaults.items():
            span.setdefault(k, v)
        with self._lock:
            if len(self._unflushed) >= self._cap:
                self._dropped += 1
                return
            self._unflushed.append(span)
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name="trace-spans-flush")
                self._thread.start()

    def flush(self) -> None:
        with self._lock:
            batch, self._unflushed = self._unflushed, []
        if not batch:
            return
        try:
            self._sink(batch)
        except Exception:
            with self._lock:
                self._unflushed = (batch + self._unflushed)[-self._cap:]

    def _flush_loop(self) -> None:
        period = max(0.05, CONFIG.trace_flush_interval_ms / 1000.0)
        while not self._stop.wait(period):
            self.flush()
        self.flush()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self.flush()


_buffer: Optional[SpanBuffer] = None
_buf_lock = threading.Lock()


def configure(sink: Optional[Callable[[List[dict]], Any]], *,
              node_id: str = "", worker_id: str = "",
              source: str = "") -> Optional[SpanBuffer]:
    """Bind this process's span buffer (CoreWorker.__init__, mirroring
    cluster_events.configure).  No-op returning None when disabled."""
    global _buffer, _flag_cache
    _flag_cache = (-1, False, 0)   # re-read env/config on rebind
    with _buf_lock:
        old, _buffer = _buffer, None
    if old is not None:
        old.stop()
    # raylint: disable=kill-switch -- configure() runs once per init(); span hot paths read the _flags() generation cache
    if sink is None or not enabled():
        return None
    buf = SpanBuffer(sink, node_id=node_id, worker_id=worker_id,
                     source=source)
    with _buf_lock:
        _buffer = buf
    return buf


def detach(buf: Optional[SpanBuffer] = None) -> None:
    """Unbind at owner shutdown; with ``buf`` given, only if it is still
    the active buffer (a newer owner's configure survives)."""
    global _buffer
    with _buf_lock:
        if buf is None or _buffer is buf:
            old, _buffer = _buffer, None
        else:
            old = None
    if old is not None:
        old.stop()


def record_span(span: dict) -> None:
    """Record one finished span (dropped when no buffer is bound)."""
    buf = _buffer
    if buf is not None:
        buf.record(span)


def flush_now() -> None:
    """Synchronous flush (tests / clean shutdown)."""
    buf = _buffer
    if buf is not None:
        buf.flush()


# -------------------------------------------------- serve ingress + SLO
def _slo_counters():
    # lazy: runtime_metrics import at module load would freeze the
    # kill-switch decision before the driver's env overrides land
    global _SLO_GOOD, _SLO_VIOL
    if _SLO_GOOD is None:
        from ray_tpu_torch._private import runtime_metrics as rtm
        _SLO_GOOD = rtm.counter_family(
            "ray_tpu_serve_slo_good",
            "serve requests that met the SLO dimension",
            tag_keys=("pool", "slo"))
        _SLO_VIOL = rtm.counter_family(
            "ray_tpu_serve_slo_violation",
            "serve requests that violated the SLO dimension",
            tag_keys=("pool", "slo"))
    return _SLO_GOOD, _SLO_VIOL


_SLO_GOOD = None
_SLO_VIOL = None


def serve_ingress_root(name: str, *, route: str = "",
                       attrs: Optional[dict] = None) -> Optional[Span]:
    """Open a request root at a serve ingress (http proxy, deployment /
    disagg handle drivers).  Every request gets a root context (SLO
    accounting classifies all of them); whether its spans are recorded
    follows the deterministic sampler.  Returns None when the plane is
    off — callers guard with one ``if``."""
    _gen, on, _thr = _flags()
    if not on:
        return None
    sp = Span(name, "ingress", attrs=attrs)
    if route:
        sp.set_attr("route", route)
    return sp


def finish_request(root: Optional[Span], *, pool: str, route: str = "",
                   status: str = OK, ttft_s: Optional[float] = None,
                   tpot_s: Optional[float] = None,
                   num_tokens: Optional[int] = None,
                   dossier_id: Optional[str] = None,
                   error_type: Optional[str] = None) -> None:
    """Classify one completed serve request against the TTFT/TPOT
    targets, publish the SLO counters (every request — sampling only
    gates the span-table exemplar), and close the root span with the
    verdict so ``ray-tpu traces --slo-violations`` can point at it."""
    if root is None:
        return
    if not route:
        route = (root.attrs or {}).get("route", "")
    ttft_ms = None if ttft_s is None else ttft_s * 1e3
    tpot_ms = None if tpot_s is None else tpot_s * 1e3
    violated: List[str] = []
    slo_ok = None
    if status == OK:
        # only COMPLETED requests are latency-classified: an errored
        # request that died in 5ms must not count as "SLO good" — it
        # stays visible via status=error, the error counter dimension
        # and list_traces(status="error")
        good, viol = _slo_counters()
        if ttft_ms is not None:
            target = CONFIG.serve_slo_ttft_ms
            if target > 0 and ttft_ms > target:
                violated.append("ttft")
                viol.inc((pool, "ttft"))
            else:
                good.inc((pool, "ttft"))
        if tpot_ms is not None:
            target = CONFIG.serve_slo_tpot_ms
            if target > 0 and tpot_ms > target:
                violated.append("tpot")
                viol.inc((pool, "tpot"))
            else:
                good.inc((pool, "tpot"))
        if ttft_ms is not None or tpot_ms is not None:
            slo_ok = not violated
    elif status == ERROR:
        _good, viol = _slo_counters()
        viol.inc((pool, "error"))
    # CANCELLED: the client walked away — no counter either way, the
    # root still records with its status for list_traces(status=...)
    root.end(
        status, root=True, pool=pool, route=route or None,
        ttft_ms=None if ttft_ms is None else round(ttft_ms, 3),
        tpot_ms=None if tpot_ms is None else round(tpot_ms, 3),
        num_tokens=num_tokens,
        slo_violated=violated or None, slo_ok=slo_ok,
        dossier_id=dossier_id, error_type=error_type)


# ------------------------------------------------------------- user spans
@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict] = None) -> Iterator[None]:
    """Record a named span around a block of worker/driver code.

    Contract (pre-plane, kept): always records a ``span:<name>``
    task-event pair for the timeline and joins/roots the ContextVar
    trace.  Plane addition: when the trace is sampled, the span also
    lands in the span table; when opentelemetry is importable, the
    OTel twin carries the attributes and error status too (not just
    the name)."""
    parent = get_trace_context()
    trace_id = parent.get("trace_id") or new_trace_id()
    span_id = new_span_id()
    is_sampled = (parent.get("sampled") if "sampled" in parent
                  else sampled(trace_id))
    _ctx_var.set({"trace_id": trace_id, "span_id": span_id,
                  "sampled": bool(is_sampled)})
    start = time.time()
    t0 = time.perf_counter()
    otel_cm = _tracer.start_as_current_span(name) if _tracer else None
    otel_span = otel_cm.__enter__() if otel_cm else None
    if otel_span is not None and attributes:
        # mirror user attributes onto the OTel twin (stringify values
        # OTel's attribute model would reject)
        try:
            for k, v in attributes.items():
                otel_span.set_attribute(
                    str(k), v if isinstance(v, (bool, int, float, str))
                    else str(v))
        except Exception:
            pass
    exc_info = (None, None, None)
    try:
        yield
    except BaseException as e:
        # capture only exceptions raised from the span body — sys.exc_info()
        # in the finally would also report an outer in-flight exception when
        # the span runs inside an except handler
        exc_info = (type(e), e, e.__traceback__)
        raise
    finally:
        if otel_span is not None and exc_info[0] is not None:
            # error status + exception event on the OTel side (was:
            # dropped — only the context manager's default handling)
            try:
                otel_span.record_exception(exc_info[1])
                if _OtelStatus is not None:
                    otel_span.set_status(
                        _OtelStatus(_OtelStatusCode.ERROR,
                                    str(exc_info[1])))
            except Exception:
                pass
        if otel_cm:
            otel_cm.__exit__(*exc_info)
        _ctx_var.set(parent or None)
        end = time.time()
        failed = exc_info[0] is not None
        if is_sampled:
            rec = {"trace_id": trace_id, "span_id": span_id,
                   "name": f"span:{name}", "kind": "user",
                   "start": start,
                   "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
                   "status": ERROR if failed else OK}
            if parent.get("span_id"):
                rec["parent_id"] = parent["span_id"]
            if attributes:
                rec["attrs"] = dict(attributes)
            if failed:
                rec["error_type"] = exc_info[0].__name__
            record_span(rec)
        from ray_tpu_torch.runtime import core_worker as cw
        worker = cw._global_worker
        if worker is not None:
            # user attributes go under a single "attrs" key so they can
            # never collide with the record's own fields
            worker.events.record(
                span_id, "RUNNING", name=f"span:{name}", ts=start,
                trace_id=trace_id, attrs=dict(attributes or {}))
            end_state = "FAILED" if failed else "FINISHED"
            worker.events.record(
                span_id, end_state, name=f"span:{name}", ts=end,
                trace_id=trace_id)


# --------------------------------------------------------- GCS span table
class GcsSpanTable:
    """Trace-indexed span store on the GCS.

    Sharded by trace id (a trace's spans must colocate for get_trace);
    retention bounded three ways — trace count (``gcs_max_traces``),
    table-wide JSON byte budget (``gcs_traces_max_bytes``) and a
    per-trace span cap (``gcs_trace_max_spans``, first/last halves
    survive like the task table's event cap).  Root spans index SLO
    verdicts and keep per-route violation counts + worst-TTFT exemplars
    that survive rotation.  ``on_dossier_link`` is called for root
    spans carrying a ``dossier_id`` so the GCS can stamp the trace id
    onto the dossier (the reverse cross-link)."""

    NSHARDS = 8
    _EXEMPLARS = 5

    def __init__(self, max_traces: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 on_dossier_link: Optional[Callable[[str, str], None]]
                 = None):
        self.max_traces = max_traces or CONFIG.gcs_max_traces
        self.max_bytes = max_bytes or CONFIG.gcs_traces_max_bytes
        self.max_spans = CONFIG.gcs_trace_max_spans
        self._on_dossier_link = on_dossier_link
        self._per_shard = max(2, self.max_traces // self.NSHARDS)
        self._bytes_per_shard = max(4096, self.max_bytes // self.NSHARDS)
        self._shards = [dict() for _ in range(self.NSHARDS)]
        self._orders = [deque() for _ in range(self.NSHARDS)]
        self._shard_bytes = [0] * self.NSHARDS
        self._locks = [threading.Lock() for _ in range(self.NSHARDS)]
        self._stats_lock = threading.Lock()
        self._traces_seen = 0
        self._ingress_seen = 0   # serve request roots only
        self._spans_seen = 0
        self._dropped_traces = 0
        # route -> {"good": n, "violation": n, "exemplars": [(ttft, id)]}
        self._slo: Dict[str, dict] = {}

    def _shard_of(self, trace_id: str) -> int:
        try:
            return int(trace_id[:8], 16) % self.NSHARDS
        except (ValueError, TypeError):
            return 0

    @staticmethod
    def _size_of(span: dict) -> int:
        import json
        try:
            return len(json.dumps(span, default=str))
        except (TypeError, ValueError):
            return 256

    def put(self, spans: List[dict]) -> int:
        """Merge one flusher batch; returns traces dropped by
        rotation."""
        dropped = 0
        links: List[tuple] = []
        for span in spans:
            if not isinstance(span, dict):
                continue
            tid = span.get("trace_id")
            if not tid or not span.get("span_id"):
                continue
            size = self._size_of(span)
            i = self._shard_of(tid)
            with self._locks[i]:
                shard, order = self._shards[i], self._orders[i]
                rec = shard.get(tid)
                fresh = rec is None
                if fresh:
                    rec = {"trace_id": tid, "start": span.get("start", 0),
                           "last_ts": 0.0, "spans": [], "nbytes": 0,
                           "root": None}
                    shard[tid] = rec
                    order.append(tid)
                rec["last_ts"] = time.time()
                rec["start"] = min(rec["start"] or span.get("start", 0),
                                   span.get("start", 0))
                rec["spans"].append(span)
                rec["nbytes"] += size
                self._shard_bytes[i] += size
                if span.get("root"):
                    rec["root"] = span
                if len(rec["spans"]) > self.max_spans:
                    half = self.max_spans // 2
                    for victim in rec["spans"][half:-half]:
                        cut = self._size_of(victim)
                        rec["nbytes"] -= cut
                        self._shard_bytes[i] -= cut
                    rec["spans"] = (rec["spans"][:half] +
                                    rec["spans"][-half:])
                    rec["truncated"] = True
                # rotation: count bound then byte budget, oldest first
                evicted = 0
                while (len(shard) > self._per_shard
                       or self._shard_bytes[i] > self._bytes_per_shard) \
                        and len(order) > 1:
                    victim = order.popleft()
                    vrec = shard.pop(victim, None)
                    if vrec is not None:
                        self._shard_bytes[i] -= vrec["nbytes"]
                        evicted += 1
                dropped += evicted
            with self._stats_lock:
                self._spans_seen += 1
                if fresh:
                    self._traces_seen += 1
                self._dropped_traces += evicted
            if span.get("root"):
                # only serve ingress roots feed the SLO route index:
                # task-submission roots (kind "submit") would add one
                # empty slot per unique task name, forever
                if span.get("kind") == "ingress":
                    self._index_root(span)
                    with self._stats_lock:
                        self._ingress_seen += 1
                did = span.get("dossier_id")
                if did and self._on_dossier_link is not None:
                    links.append((did, tid))
        # dossier cross-links outside the shard locks (the GCS callback
        # takes its own table lock)
        for did, tid in links:
            try:
                self._on_dossier_link(did, tid)
            except Exception:
                pass
        return dropped

    _MAX_SLO_ROUTES = 256

    def _index_root(self, span: dict) -> None:
        route = str(span.get("route") or span.get("name") or "?")
        with self._stats_lock:
            if route not in self._slo and \
                    len(self._slo) >= self._MAX_SLO_ROUTES:
                # bounded like the shards: a per-request route pattern
                # must not grow GCS memory without bound
                route = "__other__"
            slot = self._slo.setdefault(
                route, {"good": 0, "violation": 0,
                        "ttft_violation": 0, "tpot_violation": 0,
                        "exemplars": []})
            if span.get("slo_ok") is False:
                slot["violation"] += 1
                # per-dimension counts: the re-roling policy needs to
                # know WHICH budget a route is burning (ttft -> the
                # prefill pool is starved, tpot -> decode is)
                for dim in span.get("slo_violated") or ():
                    k = f"{dim}_violation"
                    if k in slot:
                        slot[k] += 1
            elif span.get("slo_ok") is True:
                slot["good"] += 1
            ttft = span.get("ttft_ms")
            if ttft is not None:
                ex = slot["exemplars"]
                ex.append((float(ttft), span["trace_id"]))
                ex.sort(key=lambda t: -t[0])
                del ex[self._EXEMPLARS:]

    def list(self, *, slo_violations: bool = False,
             route: Optional[str] = None, status: Optional[str] = None,
             since: Optional[float] = None,
             limit: int = 100) -> List[dict]:
        """Trace directory rows (no span bodies), newest first."""
        out = []
        for i in range(self.NSHARDS):
            with self._locks[i]:
                for rec in self._shards[i].values():
                    root = rec.get("root") or {}
                    if slo_violations and root.get("slo_ok") is not False:
                        continue
                    if route and not str(
                            root.get("route") or "").startswith(route):
                        continue
                    if status and root.get("status") != status:
                        continue
                    if since and rec.get("start", 0) < since:
                        continue
                    out.append({
                        "trace_id": rec["trace_id"],
                        "start": rec.get("start"),
                        "nspans": len(rec["spans"]),
                        "name": root.get("name", ""),
                        "route": root.get("route", ""),
                        "pool": root.get("pool", ""),
                        "status": root.get("status", ""),
                        "dur_ms": root.get("dur_ms"),
                        "ttft_ms": root.get("ttft_ms"),
                        "tpot_ms": root.get("tpot_ms"),
                        "slo_ok": root.get("slo_ok"),
                        "slo_violated": root.get("slo_violated"),
                        "dossier_id": root.get("dossier_id"),
                    })
        out.sort(key=lambda r: r.get("start") or 0, reverse=True)
        return out[:max(0, int(limit))]

    def get(self, trace_id: str) -> Optional[dict]:
        """Full trace by id (prefix match accepted), spans sorted by
        start time."""
        if not trace_id:
            return None
        i = self._shard_of(trace_id)
        with self._locks[i]:
            rec = self._shards[i].get(trace_id)
        if rec is None and len(trace_id) >= 6:
            for j in range(self.NSHARDS):
                with self._locks[j]:
                    for tid, cand in self._shards[j].items():
                        if tid.startswith(trace_id):
                            rec = cand
                            break
                if rec is not None:
                    break
        if rec is None:
            return None
        i = self._shard_of(rec["trace_id"])
        with self._locks[i]:
            out = dict(rec)
            out["spans"] = sorted(rec["spans"],
                                  key=lambda s: s.get("start", 0))
        return out

    def stats(self) -> dict:
        retained = sum(len(s) for s in self._shards)
        spans = 0
        for i in range(self.NSHARDS):
            with self._locks[i]:
                spans += sum(len(r["spans"])
                             for r in self._shards[i].values())
        with self._stats_lock:
            slo = {route: {"good": s["good"],
                           "violation": s["violation"],
                           "ttft_violation": s.get("ttft_violation", 0),
                           "tpot_violation": s.get("tpot_violation", 0),
                           "exemplars": [
                               {"ttft_ms": t, "trace_id": tid}
                               for t, tid in s["exemplars"]]}
                   for route, s in self._slo.items()}
            return {"traces": retained, "spans": spans,
                    "bytes": sum(self._shard_bytes),
                    "traces_seen": self._traces_seen,
                    "ingress_seen": self._ingress_seen,
                    "spans_seen": self._spans_seen,
                    "dropped_traces": self._dropped_traces,
                    "max_traces": self.max_traces,
                    "max_bytes": self.max_bytes,
                    "slo_by_route": slo}
