"""Host memory and CPU readings from ``/proc``.

The port's stand-in for the two ``psutil`` calls the runtime makes
(``virtual_memory`` and ``cpu_percent(interval=None)``): the machines the
port runs on need not have ``psutil``, and Linux exposes both readings in
``/proc/meminfo`` and ``/proc/stat``.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple


class VirtualMemory(NamedTuple):
    total: int        # bytes
    available: int    # bytes
    percent: float    # (total - available) / total * 100, as psutil's


def virtual_memory() -> VirtualMemory:
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            fields[key] = int(rest.split()[0]) * 1024   # kB -> bytes
    total = fields["MemTotal"]
    available = fields.get("MemAvailable", fields.get("MemFree", 0))
    return VirtualMemory(total, available,
                         100.0 * (total - available) / total)


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies over all CPUs since boot."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:]]
    # user nice system idle iowait irq softirq steal [guest guest_nice]:
    # guest time is already counted in user and nice
    ticks = ticks[:8]
    idle = ticks[3] + (ticks[4] if len(ticks) > 4 else 0)
    total = sum(ticks)
    return total - idle, total


class CpuPercent:
    """``psutil.cpu_percent(interval=None)``: the busy share of all CPUs
    since the previous call, in percent (0.0 on the first call)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: Optional[Tuple[int, int]] = None

    def __call__(self) -> float:
        now = _cpu_times()
        with self._lock:
            last, self._last = self._last, now
        if last is None or now[1] <= last[1]:
            return 0.0
        return 100.0 * (now[0] - last[0]) / (now[1] - last[1])
