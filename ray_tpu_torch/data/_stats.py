"""Per-dataset, per-stage execution statistics (the port's copy of
ray_tpu/data/_stats.py).

Analog of Ray's python/ray/data/_internal/stats.py:161
(``DatasetStats``): every executed stage records its driver-side wall
span plus per-block metadata measured inside the workers — remote wall
time, CPU time, output rows, and output bytes — and ``ds.stats()``
prints the per-stage report users tune against.

Block metadata travels as a second return value of each block task
(``num_returns=2``), so collecting it adds no extra tasks; the tiny
meta objects are resolved lazily the first time ``summary()`` runs.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


def block_meta(block, wall_start: float, cpu_start: float) -> Dict:
    """Worker-side: measure one produced block (called at task end)."""
    from ray_tpu_torch.data.block import BlockAccessor
    acc = BlockAccessor.for_block(block)
    try:
        rows = acc.num_rows()
    except Exception:
        rows = 0
    try:
        nbytes = acc.size_bytes()
    except Exception:
        nbytes = 0
    return {
        "wall_s": time.perf_counter() - wall_start,
        "cpu_s": time.process_time() - cpu_start,
        "rows": rows,
        "bytes": nbytes,
    }


class _StageStats:
    def __init__(self, name: str):
        self.name = name
        self.wall_s = 0.0            # driver-side stage span (submission)
        self.meta_refs: List[Any] = []   # one per output block
        self.block_count = 0
        self._resolved: Optional[List[Dict]] = None

    def _metas(self) -> List[Dict]:
        if self._resolved is None:
            import ray_tpu_torch
            out = []
            for ref in self.meta_refs:
                # per-ref: one lost block's meta (node death mid-chaos)
                # must not discard every other block's measurements
                try:
                    m = ray_tpu_torch.get(ref, timeout=30)
                except Exception:
                    continue
                if m:
                    out.append(m)
            self._resolved = out
        return self._resolved

    def report(self) -> str:
        metas = self._metas()
        n = self.block_count or len(metas)
        head = (f"Stage {self.name}: {n} blocks, "
                f"{self.wall_s:.3f}s driver wall time")
        if not metas:
            return head
        lines = [head]

        def agg(key, label):
            vals = [m.get(key, 0) for m in metas]
            return (f"  * {label}: min={min(vals):.4g} max={max(vals):.4g} "
                    f"mean={sum(vals) / len(vals):.4g} "
                    f"total={sum(vals):.4g}")
        lines.append(agg("wall_s", "remote wall time (s)"))
        lines.append(agg("cpu_s", "remote cpu time (s)"))
        lines.append(agg("rows", "output rows"))
        lines.append(agg("bytes", "output size (bytes)"))
        return "\n".join(lines)


class DatasetStats:
    """Stats ledger of one ExecutionPlan; stages append as they run."""

    def __init__(self, parent: Optional["DatasetStats"] = None):
        self._lock = threading.Lock()
        self.stages: List[_StageStats] = []
        self.parent = parent

    def record_stage(self, name: str, wall_s: float,
                     meta_refs: Optional[List[Any]] = None,
                     block_count: int = 0) -> None:
        st = _StageStats(name)
        st.wall_s = wall_s
        st.meta_refs = list(meta_refs or [])
        st.block_count = block_count or len(st.meta_refs)
        with self._lock:
            self.stages.append(st)

    def summary(self) -> str:
        parts: List[str] = []
        if self.parent is not None:
            parent_text = self.parent.summary()
            if parent_text != "(no stages executed)":
                parts.append(parent_text)
        with self._lock:
            stages = list(self.stages)
        parts.extend(st.report() for st in stages)
        return "\n".join(parts) or "(no stages executed)"

    # datasets (and thus their plans/stats) are shipped to trainer actors
    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
