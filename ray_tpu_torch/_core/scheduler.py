"""ctypes binding for the native cluster scheduler (csrc/scheduler.cc).

Binding layer in the spirit of the reference's _raylet.pyx over
ClusterResourceScheduler (/root/reference/src/ray/raylet/scheduling/
cluster_resource_scheduler.h:45).  Resources cross the ABI as fixed-point
milli-units packed into "name=milli;..." strings.  The library is built
with g++ at first use (``buildcheck.ensure_built``); where it cannot be
built, a pure-Python ClusterScheduler with identical semantics takes over
(same tests run against both).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Dict, Optional

MILLI = 1000


def _pack(resources: Dict[str, float]) -> bytes:
    return ";".join(
        f"{k}={int(round(v * MILLI))}" for k, v in sorted(resources.items())
    ).encode()


def _load_lib():
    from ray_tpu_torch._core.buildcheck import ensure_built
    try:
        lib = ctypes.CDLL(ensure_built("scheduler"))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.sched_create.restype = ctypes.c_void_p
    lib.sched_create.argtypes = [ctypes.c_double, ctypes.c_int]
    lib.sched_destroy.argtypes = [ctypes.c_void_p]
    lib.sched_update_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.sched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sched_num_nodes.restype = ctypes.c_int64
    lib.sched_num_nodes.argtypes = [ctypes.c_void_p]
    lib.sched_best_node.restype = ctypes.c_int
    lib.sched_best_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_int64]
    lib.sched_feasible_anywhere.restype = ctypes.c_int
    lib.sched_feasible_anywhere.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


_lib = None
_lib_loaded = False
_lib_lock = threading.Lock()


def _get_lib():
    """The native library, built and loaded on the first call (None when
    it cannot be built here)."""
    global _lib, _lib_loaded
    with _lib_lock:
        if not _lib_loaded:
            _lib = _load_lib()
            _lib_loaded = True
        return _lib


class NativeClusterScheduler:
    """Hybrid/spread node selection over the native node table."""

    def __init__(self, spill_threshold: float = 0.5, top_k: int = 1):
        if _get_lib() is None:
            raise RuntimeError("the native scheduler library is not built")
        self._h = _lib.sched_create(spill_threshold, top_k)
        self._seed = 0
        self._lock = threading.Lock()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                _lib.sched_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def update_node(self, node_id: str, total: Dict[str, float],
                    available: Dict[str, float], alive: bool = True) -> None:
        _lib.sched_update_node(self._h, node_id.encode(), _pack(total),
                               _pack(available), int(alive))

    def remove_node(self, node_id: str) -> None:
        _lib.sched_remove_node(self._h, node_id.encode())

    def num_nodes(self) -> int:
        return int(_lib.sched_num_nodes(self._h))

    def best_node(self, demand: Dict[str, float],
                  local_id: Optional[str] = None,
                  spread: bool = False) -> Optional[str]:
        out = ctypes.create_string_buffer(256)
        with self._lock:
            seed = self._seed
            self._seed += 1
        ok = _lib.sched_best_node(self._h, _pack(demand),
                                  (local_id or "").encode(), int(spread),
                                  seed, out, len(out))
        return out.value.decode() if ok else None

    def feasible_anywhere(self, demand: Dict[str, float]) -> bool:
        return bool(_lib.sched_feasible_anywhere(self._h, _pack(demand)))


class PyClusterScheduler:
    """Pure-Python fallback with the same semantics (and test suite)."""

    def __init__(self, spill_threshold: float = 0.5, top_k: int = 1):
        self.spill_threshold = spill_threshold
        self.top_k = max(top_k, 1)
        self._nodes: Dict[str, dict] = {}
        self._seed = 0
        self._lock = threading.Lock()

    @staticmethod
    def _milli(res: Dict[str, float]) -> Dict[str, int]:
        return {k: int(round(v * MILLI)) for k, v in res.items()}

    def update_node(self, node_id, total, available, alive=True):
        with self._lock:
            self._nodes[node_id] = {"total": self._milli(total),
                                    "available": self._milli(available),
                                    "alive": alive}

    def remove_node(self, node_id):
        with self._lock:
            self._nodes.pop(node_id, None)

    def num_nodes(self):
        with self._lock:
            return len(self._nodes)

    @staticmethod
    def _feasible(node, demand, against_total):
        cap = node["total"] if against_total else node["available"]
        return all(cap.get(k, 0) >= v for k, v in demand.items() if v > 0)

    @staticmethod
    def _utilization(node, demand):
        worst = 0.0
        for name, tot in node["total"].items():
            if tot <= 0:
                continue
            used = tot - node["available"].get(name, 0) + demand.get(name, 0)
            worst = max(worst, used / tot)
        return worst

    def best_node(self, demand, local_id=None, spread=False):
        demand = self._milli(demand)
        with self._lock:
            nodes = {k: dict(v) for k, v in self._nodes.items()}
            seed = self._seed
            self._seed += 1
        if not spread and local_id and local_id in nodes:
            n = nodes[local_id]
            if n["alive"] and self._feasible(n, demand, False) and \
                    self._utilization(n, demand) <= self.spill_threshold:
                return local_id
        scored = sorted(
            (self._utilization(n, demand), nid)
            for nid, n in nodes.items()
            if n["alive"] and self._feasible(n, demand, False))
        if not scored:
            return None
        k = min(self.top_k, len(scored))
        return scored[seed % k][1]

    def feasible_anywhere(self, demand):
        demand = self._milli(demand)
        with self._lock:
            return any(n["alive"] and self._feasible(n, demand, True)
                       for n in self._nodes.values())


def make_scheduler(spill_threshold: float = 0.5, top_k: int = 1):
    """Native scheduler when the .so builds, Python fallback otherwise."""
    if _get_lib() is not None:
        return NativeClusterScheduler(spill_threshold, top_k)
    return PyClusterScheduler(spill_threshold, top_k)


def native_available() -> bool:
    return _get_lib() is not None
