"""Always-on, low-overhead runtime telemetry for the hot paths.

The control-plane fast paths (docs/rpc_fastpath.md) and streaming
generators (docs/streaming_generators.md) made the runtime fast but
opaque: regressions were only visible when someone manually reran
``collect_microbench``.  This module is the counterpart of the
reference's internal stats/metrics layer (``metric_defs.cc`` +
``metrics_agent.py``): every daemon and worker records a fixed set of
counters and latency histograms on its hot loops, and a single
background flusher publishes snapshots to the GCS KV ``metrics/``
namespace — the exact wire format user metrics (util/metrics.py) use,
so ``query_metrics``, the dashboard ``/metrics`` Prometheus endpoint
and ``experimental.state.list_metrics()`` pick runtime metrics up for
free.

Record-path design (the whole point of not reusing util/metrics.py):

* instruments are **preallocated** and bound into module/instance
  attributes by their call sites; the record path is attribute
  arithmetic only — ``Counter.inc`` is ``self.value += n``,
  ``Histogram.observe`` is one ``bisect`` into preallocated bucket
  slots.  No dict lookup, no lock, no tag merging per record.  Under
  the GIL a lost update is possible but rare and harmless for
  monitoring data (the reference's C++ stats make the same relaxed-
  consistency tradeoff).
* timers are coarse monotonic stamps (``time.monotonic``); callers use
  ``observe_since(t0)`` which records milliseconds.
* per-label families (per RPC method, per task function) pay one dict
  hit on ``observe(label, v)``; call sites that can bind the label
  once use ``get(label)`` and keep the plain Histogram.

Kill switch: ``CONFIG.telemetry_enabled`` (env override
``RAY_TPU_TORCH_TELEMETRY=0``).  When off, the instrument getters hand back
shared no-op stubs, so an instrumented code path costs one no-op
method call and the flusher never starts.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG

now = time.monotonic

# default latency boundaries, in milliseconds: sub-100us RPC dispatches
# up to 10 s task executions land in distinct buckets
DEFAULT_MS_BOUNDARIES: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)
# small-integer boundaries for batch/queue-size distributions
COUNT_BOUNDARIES: Tuple[float, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64)


def enabled() -> bool:
    """Kill switch: RAY_TPU_TORCH_TELEMETRY env wins, then the config flag."""
    raw = os.environ.get("RAY_TPU_TORCH_TELEMETRY")
    if raw is not None:
        return raw.strip().lower() not in ("0", "false", "no", "off")
    return CONFIG.telemetry_enabled


class Counter:
    """Monotonic counter; ``inc`` is a bare attribute add (no lock)."""

    __slots__ = ("name", "description", "value")
    kind = "counter"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def _payload(self) -> dict:
        return {"type": "counter", "description": self.description,
                "values": {"{}": self.value}, "ts": time.time()}


class CounterFamily:
    """Per-label-set counters (serve SLO verdicts by pool+dimension).

    The Counter sibling of HistogramFamily: ``inc(labels)`` pays one
    dict hit, where ``labels`` is a tuple matching ``tag_keys`` (or a
    bare string for a single key).  Label sets are bounded
    (``max_labels``) like the histogram family."""

    kind = "counter"

    def __init__(self, name: str, description: str = "", *,
                 tag_keys=("label",), max_labels: int = 256):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self.max_labels = max_labels
        self._items: Dict[tuple, Counter] = {}
        self._lock = threading.Lock()
        self._overflow: Optional[Counter] = None

    def get(self, labels) -> Counter:
        if isinstance(labels, str):
            labels = (labels,)
        labels = tuple(labels)
        c = self._items.get(labels)
        if c is None:
            with self._lock:
                c = self._items.get(labels)
                if c is None:
                    if len(self._items) >= self.max_labels:
                        if self._overflow is None:
                            self._overflow = Counter(self.name,
                                                     self.description)
                            self._items[("__other__",) * len(
                                self.tag_keys)] = self._overflow
                        return self._overflow
                    c = Counter(self.name, self.description)
                    self._items[labels] = c
        return c

    def inc(self, labels, n: float = 1.0) -> None:
        self.get(labels).inc(n)

    def labels(self) -> List[tuple]:
        with self._lock:
            return list(self._items)

    def _payload(self) -> dict:
        with self._lock:
            items = list(self._items.items())
        return {"type": "counter", "description": self.description,
                "values": {json.dumps(dict(zip(self.tag_keys, labels))):
                           c.value for labels, c in items},
                "ts": time.time()}


class Gauge:
    """Point-in-time value.  ``watermark`` gauges track a high-water
    mark via ``set_max`` and are reset to 0 after each flush, so every
    scrape interval reports its own peak (queue depths)."""

    __slots__ = ("name", "description", "value", "watermark")
    kind = "gauge"

    def __init__(self, name: str, description: str = "",
                 watermark: bool = False):
        self.name = name
        self.description = description
        self.value = 0.0
        self.watermark = watermark

    def set(self, v: float) -> None:
        self.value = v

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def _payload(self) -> dict:
        return {"type": "gauge", "description": self.description,
                "values": {"{}": self.value}, "ts": time.time()}


class Histogram:
    """Latency/size distribution over preallocated bucket slots.

    ``observe`` is one C-level bisect plus three attribute adds; the
    final slot is the +Inf overflow bucket.  ``sum``/``count`` ride
    along so the Prometheus exposition can emit ``_sum``/``_count``."""

    __slots__ = ("name", "description", "boundaries", "counts", "sum",
                 "count")
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Iterable[float] = DEFAULT_MS_BOUNDARIES):
        self.name = name
        self.description = description
        self.boundaries = tuple(sorted(boundaries))
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.sum += v
        self.count += 1

    def observe_since(self, t0: float) -> None:
        """Record elapsed milliseconds since monotonic stamp ``t0``."""
        self.observe((now() - t0) * 1000.0)

    def _bucket_dict(self) -> dict:
        out = {}
        for b, c in zip(self.boundaries, self.counts):
            if c:
                out[repr(float(b))] = c
        if self.counts[-1]:
            out["+Inf"] = self.counts[-1]
        return out

    def _value(self) -> dict:
        return {"buckets": self._bucket_dict(), "sum": self.sum,
                "count": self.count}

    def _payload(self) -> dict:
        return {"type": "histogram", "description": self.description,
                "values": {"{}": self._value()}, "ts": time.time()}


class HistogramFamily:
    """Per-label histograms (per RPC method, per task function).

    ``observe(label, v)`` pays one dict hit; ``get(label)`` returns the
    bound Histogram for call sites that can cache it.  Label sets are
    bounded (``max_labels``) so a pathological workload — a fresh
    closure name per task — can't grow the family without bound."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "", *,
                 tag_key: str = "method",
                 boundaries: Iterable[float] = DEFAULT_MS_BOUNDARIES,
                 max_labels: int = 256):
        self.name = name
        self.description = description
        self.tag_key = tag_key
        self.boundaries = tuple(sorted(boundaries))
        self.max_labels = max_labels
        self._items: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._overflow: Optional[Histogram] = None

    def get(self, label: str) -> Histogram:
        h = self._items.get(label)
        if h is None:
            with self._lock:
                h = self._items.get(label)
                if h is None:
                    if len(self._items) >= self.max_labels:
                        if self._overflow is None:
                            self._overflow = Histogram(
                                self.name, self.description,
                                self.boundaries)
                            self._items["__other__"] = self._overflow
                        return self._overflow
                    h = Histogram(self.name, self.description,
                                  self.boundaries)
                    self._items[label] = h
        return h

    def observe(self, label: str, v: float) -> None:
        self.get(label).observe(v)

    def observe_since(self, label: str, t0: float) -> None:
        self.get(label).observe((now() - t0) * 1000.0)

    def labels(self) -> List[str]:
        with self._lock:
            return list(self._items)

    def _payload(self) -> dict:
        with self._lock:
            items = list(self._items.items())
        return {"type": "histogram", "description": self.description,
                "values": {json.dumps({self.tag_key: label}): h._value()
                           for label, h in items},
                "ts": time.time()}


class _Noop:
    """Shared stub handed out when telemetry is disabled: every
    instrument method is a no-op, ``get`` returns itself so bound-label
    call sites stay one no-op call too."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_max(self, v: float) -> None:
        pass

    def observe(self, *a) -> None:
        pass

    def observe_since(self, *a) -> None:
        pass

    def get(self, label: str) -> "_Noop":
        return self

    def labels(self) -> list:
        return []


NOOP = _Noop()

_lock = threading.Lock()
_instruments: Dict[str, Any] = {}
_callbacks: Dict[str, Tuple[str, Callable[[], float]]] = {}
_sink: Optional[Callable[[str, bytes], Any]] = None
_ident = f"proc-{os.getpid()}"
_flusher: Optional[threading.Thread] = None
_flush_wake = threading.Event()


def _register(name: str, factory: Callable[[], Any]):
    # raylint: disable=kill-switch -- binding-time only: instruments resolve once at import; the record path never re-reads the flag
    if not enabled():
        return NOOP
    with _lock:
        inst = _instruments.get(name)
        if inst is None:
            inst = _instruments[name] = factory()
        return inst


def counter(name: str, description: str = ""):
    return _register(name, lambda: Counter(name, description))


def gauge(name: str, description: str = "", *, watermark: bool = False):
    return _register(name,
                     lambda: Gauge(name, description, watermark=watermark))


def histogram(name: str, description: str = "",
              boundaries: Iterable[float] = DEFAULT_MS_BOUNDARIES):
    return _register(name, lambda: Histogram(name, description, boundaries))


def histogram_family(name: str, description: str = "", *,
                     tag_key: str = "method",
                     boundaries: Iterable[float] = DEFAULT_MS_BOUNDARIES):
    return _register(name, lambda: HistogramFamily(
        name, description, tag_key=tag_key, boundaries=boundaries))


def counter_family(name: str, description: str = "", *,
                   tag_keys=("label",)):
    return _register(name, lambda: CounterFamily(
        name, description, tag_keys=tag_keys))


def gauge_callback(name: str, description: str,
                   fn: Callable[[], float]) -> None:
    """Register a gauge polled at flush/snapshot time (pool sizes, pin
    counts): zero hot-path cost, always-current value.  Re-registering
    a name replaces the callback (fresh CoreWorker per init())."""
    # raylint: disable=kill-switch -- binding-time only: callbacks register once per owner, polled by the flusher
    if not enabled():
        return
    with _lock:
        _callbacks[name] = (description, fn)


def remove_gauge_callback(name: str,
                          fn: Optional[Callable[[], float]] = None) -> None:
    """Drop a polled gauge at owner shutdown.  With ``fn`` given, only
    removes the entry if it is still the caller's own registration — a
    newer owner's replacement callback is left alone."""
    with _lock:
        cur = _callbacks.get(name)
        if cur is not None and (fn is None or cur[1] is fn):
            _callbacks.pop(name, None)


def snapshot(reset_watermarks: bool = False) -> Dict[str, dict]:
    """Local process snapshot in the KV wire format (tests, debugging).

    ``reset_watermarks`` is the flusher's contract: watermark gauges
    report per-interval peaks, so only the publishing path may zero
    them — a debugging ``snapshot()`` between flusher ticks must not
    eat the interval's high-water mark."""
    out: Dict[str, dict] = {}
    with _lock:
        insts = list(_instruments.items())
        cbs = list(_callbacks.items())
    for name, inst in insts:
        out[name] = inst._payload()
        if reset_watermarks and isinstance(inst, Gauge) and inst.watermark:
            inst.value = 0.0
    for name, (desc, fn) in cbs:
        try:
            v = float(fn())
        except Exception:
            continue
        out[name] = {"type": "gauge", "description": desc,
                     "values": {"{}": v}, "ts": time.time()}
    return out


def attach(sink: Callable[[str, bytes], Any], ident: str) -> None:
    """Bind this process's flusher to a KV sink (``kv_put``-shaped) and
    identity segment; starts the background flusher on first call.
    Re-attaching (a fresh init() in the same process) replaces both."""
    global _sink, _ident
    _sink = sink
    _ident = ident or _ident
    # a fresh sink means a fresh KV (new cluster): the dirty-skip cache
    # must not suppress the first publication of unchanged metrics
    _last_sent.clear()
    # raylint: disable=kill-switch -- attach() runs once per init(); the flusher it may start ticks on its own clock
    if enabled():
        _ensure_flusher()


def detach(sink: Optional[Callable[[str, bytes], Any]] = None) -> None:
    """Unbind the flusher's sink at owner shutdown so the closed GCS
    client (and everything its bound method pins — caches, sockets) can
    be collected and the flusher stops issuing doomed RPCs.  With
    ``sink`` given, only detaches if it is still the active one — a
    newer owner's attach is left in place."""
    global _sink
    if sink is None or _sink == sink:
        _sink = None


def _ensure_flusher() -> None:
    global _flusher
    if _flusher is not None and _flusher.is_alive():
        return
    with _lock:
        if _flusher is not None and _flusher.is_alive():
            return
        _flusher = threading.Thread(target=_flush_loop, daemon=True,
                                    name="runtime-metrics-flush")
        _flusher.start()


# consumers treat a metrics key whose payload ts is older than this as
# belonging to a dead process (GCS sweeper deletes them)
METRICS_STALE_AFTER_S = 120.0


def _flush_loop() -> None:
    ticks = 0
    while True:
        period = max(0.05, CONFIG.telemetry_flush_interval_ms / 1000.0)
        _flush_wake.wait(period)
        _flush_wake.clear()
        ticks += 1
        # periodically drop the dirty-skip cache so even unchanged
        # metrics refresh their ``ts`` — that freshness is what lets
        # the GCS sweeper distinguish live processes from dead ones.
        # Derived from the staleness bound (>= 3 refreshes inside it)
        # so a user-raised flush interval can't make live processes'
        # idle metrics look stale.
        refresh_every = max(1, int(METRICS_STALE_AFTER_S / (3.0 * period)))
        if ticks % refresh_every == 0:
            _last_sent.clear()
        flush_now()


# last serialized value per metric (ts stripped): unchanged metrics are
# not re-sent, so idle processes cost the GCS ~zero kv traffic and busy
# ones pay one RPC per *changed* metric per interval
_last_sent: Dict[str, bytes] = {}


def flush_now() -> None:
    """Push one snapshot through the sink (flusher tick; tests call it
    directly to avoid waiting out the interval).  Never raises: the
    sink dying (GCS teardown) must not take the process with it.
    Watermark gauges are only reset once every send succeeded — a peak
    that coincided with a sink outage is re-published next tick, not
    silently dropped."""
    sink = _sink
    if sink is None:
        return
    ok = True
    for name, payload in snapshot().items():
        ts = payload.pop("ts", None)
        body = json.dumps(payload).encode()
        if _last_sent.get(name) == body:
            continue
        payload["ts"] = ts
        # self-mark: only runtime payloads get ts keep-alives (the
        # _flush_loop refresh cadence), so only they are eligible for
        # the GCS staleness sweep — user metrics flush on record and
        # an idle live process's once-set gauge must never be swept
        payload["runtime"] = True
        try:
            sink(f"metrics/{name}/{_ident}",
                 json.dumps(payload).encode())
        except Exception:
            ok = False  # sink gone; retry whole snapshot next tick
            break
        _last_sent[name] = body
    if ok:
        _reset_watermarks()


def _reset_watermarks() -> None:
    with _lock:
        for inst in _instruments.values():
            if isinstance(inst, Gauge) and inst.watermark:
                inst.value = 0.0


def _reset_for_tests() -> None:
    """Drop all registered instruments/callbacks (unit-test isolation)."""
    global _sink
    with _lock:
        _instruments.clear()
        _callbacks.clear()
    _sink = None


# ------------------------------------------------------------ exposition
def _fmt_tags(tags: Dict[str, Any]) -> str:
    return ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))


def _hist_lines(lines: List[str], name: str, tags: Dict[str, Any],
                rec: dict) -> None:
    buckets = rec.get("buckets", {}) or {}
    total = int(rec.get("count", 0))
    cum = 0
    for le in sorted((k for k in buckets if k not in ("+Inf", "inf")),
                     key=float):
        cum += int(buckets[le])
        lines.append(
            f"{name}_bucket{{{_fmt_tags(dict(tags, le=repr(float(le))))}}}"
            f" {cum}")
    lines.append(
        f'{name}_bucket{{{_fmt_tags(dict(tags, le="+Inf"))}}} {total}')
    lines.append(f"{name}_count{{{_fmt_tags(tags)}}} {total}")
    lines.append(f"{name}_sum{{{_fmt_tags(tags)}}} {rec.get('sum', 0.0)}")


def prometheus_exposition(entries: Iterable[Tuple[str, str, dict]]) -> str:
    """Render KV metric payloads as conformant Prometheus text.

    ``entries``: (metric name, worker/process ident, payload) triples in
    the shared wire format.  Histograms become cumulative
    ``<name>_bucket{le=...}`` series (always including ``+Inf``) plus
    ``<name>_count``/``<name>_sum`` — the conformant shape Prometheus
    clients expect, instead of raw per-bucket counts tagged ``le`` on
    the bare metric name."""
    lines: List[str] = []
    seen = set()
    for name, worker, data in entries:
        mtype = data.get("type", "untyped")
        if mtype not in ("counter", "gauge", "histogram"):
            mtype = "untyped"
        if name not in seen:
            seen.add(name)
            desc = (data.get("description") or "").replace("\n", " ")
            if desc:
                lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} {mtype}")
        for tagjson, value in (data.get("values") or {}).items():
            try:
                tags = dict(json.loads(tagjson))
            except (ValueError, TypeError):
                tags = {}
            tags["worker"] = worker
            if mtype == "histogram" and isinstance(value, dict):
                _hist_lines(lines, name, tags, value)
            else:
                lines.append(f"{name}{{{_fmt_tags(tags)}}} {value}")
    return "\n".join(lines)
