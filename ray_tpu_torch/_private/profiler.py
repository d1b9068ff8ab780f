"""In-process sampling profiler: folded stacks over a time window.

Analog of the reference's on-demand py-spy CPU profiling of any worker
(/root/reference/python/ray/dashboard/modules/reporter/reporter_agent.py:253
``CpuProfilingManager``) without the external binary: every daemon and
worker answers a ``profile`` RPC by sampling ``sys._current_frames()``
for the requested window and returning flamegraph-ready folded stacks
(``a;b;c count`` lines, collapse format), so ``ray-tpu profile`` can
flame any live process in the cluster.

Frames are keyed ``co_name (file)`` — WITHOUT the line number.  A hot
line shifting by one line between captures (an edit, a different branch
of the same loop) used to split its count across two keys and break
capture-to-capture comparison; line-level detail is preserved
separately for the LEAF frame only (where the samples actually land)
under the reserved ``LEAF_LINES_KEY`` entry, and ``top_summary`` shows
the hottest line as a detail column.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

# reserved entry in a sample_folded() result carrying per-leaf line
# tallies: {leaf_frame: {"lineno": count}}.  Rides the same dict so the
# profile RPC's wire shape stays one JSON-able mapping; every consumer
# goes through split_leaf_detail() first.
LEAF_LINES_KEY = "__leaf_lines__"


def split_leaf_detail(counts: Dict[str, Any]
                      ) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """Split a sample_folded() result into (stack counts, leaf line
    tallies).  Accepts pre-detail captures (no reserved key) and merged
    dicts transparently."""
    if LEAF_LINES_KEY not in counts:
        return counts, {}
    clean = {k: v for k, v in counts.items() if k != LEAF_LINES_KEY}
    detail = counts.get(LEAF_LINES_KEY) or {}
    return clean, detail if isinstance(detail, dict) else {}


def sample_folded(duration_s: float = 2.0,
                  interval_s: float = 0.01,
                  max_depth: int = 60) -> Dict[str, Any]:
    """Sample every thread's stack for ``duration_s``; returns
    {folded_stack: samples} plus the ``LEAF_LINES_KEY`` detail entry.
    Runs inside the target process (the RPC thread doing the sampling
    excludes itself)."""
    me = sys._getframe()  # marker: skip the sampler's own thread
    counts: Dict[str, int] = {}
    leaf_lines: Dict[str, Dict[str, int]] = {}
    end = time.monotonic() + max(0.05, duration_s)
    interval_s = max(0.001, interval_s)
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            f = frame
            stack = []
            leaf_line = None
            skip = False
            while f is not None and len(stack) < max_depth:
                if f is me:
                    skip = True
                    break
                code = f.f_code
                fname = code.co_filename.rsplit("/", 1)[-1]
                if leaf_line is None:
                    leaf_line = f"{fname}:{f.f_lineno}"
                stack.append(f"{code.co_name} ({fname})")
                f = f.f_back
            if skip or not stack:
                continue
            key = ";".join(reversed(stack))
            counts[key] = counts.get(key, 0) + 1
            per = leaf_lines.setdefault(stack[0], {})
            per[leaf_line] = per.get(leaf_line, 0) + 1
        time.sleep(interval_s)
    if counts:
        counts[LEAF_LINES_KEY] = leaf_lines
    return counts


def profile_capture(duration_s: float, *, device: bool = False,
                    out_dir: Optional[str] = None) -> Dict[str, Any]:
    """One profile window: folded host stacks always; with ``device``,
    a ``torch.profiler`` trace with CPU and CUDA activities captured
    over the SAME window and written as ``trace.json`` into the returned
    directory (the trace brackets the host sampling, so gang ranks' host
    and device views line up).  Returns {"folded": counts[, "device_trace": dir,
    "device_error": reason]} — the ``profile`` RPC's gang-fanout shape
    (``ray-tpu profile --group --device``)."""
    if not device:
        return {"folded": sample_folded(duration_s)}
    prof = None
    err = None
    try:
        import torch
        if not torch.cuda.is_available():
            err = ("--device needs a CUDA device; this process has none "
                   "— folded host stacks only (docs/observability.md)")
        else:
            if out_dir is None:   # only once a trace will actually start
                import tempfile
                out_dir = tempfile.mkdtemp(prefix="ray-tpu-devtrace-")
            acts = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[acts.CPU, acts.CUDA])
            prof.start()
    except Exception as e:
        err = f"device trace failed to start: {e!r}"
        prof = None
    counts = sample_folded(duration_s)
    if prof is not None:
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception as e:
            err = f"device trace failed to stop: {e!r}"
            prof = None
    started = prof is not None
    return {"folded": counts,
            "device_trace": out_dir if started else None,
            "device_error": err}


def dump_stacks(max_depth: int = 60) -> Dict[str, str]:
    """One instantaneous stack per live thread, keyed by thread name
    (``dump_stacks`` RPC: a stalled process answers in microseconds,
    no gdb, no sampling window).  The dumping thread excludes itself."""
    import threading
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    out: Dict[str, str] = {}
    for tid, frame in sys._current_frames().items():
        if tid == me:
            continue
        stack = traceback.format_stack(frame)[-max_depth:]
        out[f"{names.get(tid, '?')} ({tid})"] = "".join(stack)
    return out


def stacks_text(threads: Dict[str, str]) -> str:
    """Terminal rendering of a dump_stacks() reply."""
    lines = []
    for name in sorted(threads):
        lines.append(f"--- thread {name} ---")
        lines.append(threads[name].rstrip())
    return "\n".join(lines)


def folded_text(counts: Dict[str, Any]) -> str:
    """Flamegraph collapse format, hottest first."""
    clean, _ = split_leaf_detail(counts)
    return "\n".join(
        f"{stack} {n}" for stack, n in
        sorted(clean.items(), key=lambda kv: -kv[1]))


def merge_folded(dest: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Accumulate one capture into another (gang profile merging),
    keeping the leaf-line detail coherent."""
    clean, detail = split_leaf_detail(src)
    dest_detail = dest.setdefault(LEAF_LINES_KEY, {})
    for stack, n in clean.items():
        dest[stack] = dest.get(stack, 0) + n
    for leaf, lines in detail.items():
        per = dest_detail.setdefault(leaf, {})
        for line, n in lines.items():
            per[line] = per.get(line, 0) + n


def top_summary(counts: Dict[str, Any], limit: int = 20) -> str:
    """Human-readable leaf-frame ranking for terminal output, with the
    hottest source line of each leaf as a detail column (the line
    number lives only here — keys stay line-stable across captures)."""
    clean, detail = split_leaf_detail(counts)
    leaves: Dict[str, int] = {}
    total = 0
    for stack, n in clean.items():
        leaf = stack.rsplit(";", 1)[-1]
        leaves[leaf] = leaves.get(leaf, 0) + n
        total += n
    lines = [f"{total} samples"]
    for leaf, n in sorted(leaves.items(), key=lambda kv: -kv[1])[:limit]:
        where = ""
        per = detail.get(leaf)
        if per:
            line, ln = max(per.items(), key=lambda kv: kv[1])
            where = f"  [{line} {100 * ln / max(1, n):.0f}%]"
        lines.append(f"  {100 * n / max(1, total):5.1f}%  {leaf}{where}")
    return "\n".join(lines)
