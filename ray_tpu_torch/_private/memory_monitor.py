"""Host-memory monitor + OOM worker-killing policy.

Analog of the reference MemoryMonitor
(/root/reference/src/ray/common/memory_monitor.h:52 — kernel memory polling
at memory_monitor_refresh_ms) and the retriable-LIFO worker-killing policy
(src/ray/raylet/worker_killing_policy.h:30/60): when host usage crosses
memory_usage_threshold, the raylet kills the worker whose loss costs least
to recover — retriable task workers before actors, newest first — instead
of letting the kernel OOM-killer take out a daemon.

Test/chaos seam: ``memory_monitor_test_usage_path`` (a file holding a float
usage fraction) substitutes for the kernel counters, the analog of the
reference's fault-injecting test doubles.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.host_stats import virtual_memory
from ray_tpu_torch._private.logging_utils import get_logger

logger = get_logger("memory_monitor")


def system_memory_usage_fraction() -> float:
    vm = virtual_memory()
    return (vm.total - vm.available) / vm.total


class MemoryMonitor:
    """Polls a usage source and fires ``on_breach(usage)`` when it crosses
    the configured threshold.  The caller (raylet) owns victim selection
    and re-arm pacing."""

    def __init__(self, on_breach: Callable[[float], None],
                 usage_fn: Optional[Callable[[], float]] = None):
        self.threshold = CONFIG.memory_usage_threshold
        self.refresh_s = CONFIG.memory_monitor_refresh_ms / 1000.0
        self._on_breach = on_breach
        test_path = CONFIG.memory_monitor_test_usage_path
        if usage_fn is not None:
            self._usage_fn = usage_fn
        elif test_path:
            self._usage_fn = lambda: _read_usage_file(test_path)
        else:
            self._usage_fn = system_memory_usage_fraction
        self.last_usage = 0.0
        self._source_warned = False

    @property
    def enabled(self) -> bool:
        return self.refresh_s > 0

    def poll_once(self) -> None:
        try:
            usage = float(self._usage_fn())
            self._source_warned = False
        except Exception:
            if not self._source_warned:
                # once per outage, not per poll: a dead memory source means
                # OOM protection is OFF and must not fail silently
                logger.exception("memory usage source failed; OOM "
                                 "protection inactive until it recovers")
                self._source_warned = True
            return
        self.last_usage = usage
        if usage >= self.threshold:
            self._on_breach(usage)


def _read_usage_file(path: str) -> float:
    try:
        with open(path) as f:
            return float(f.read().strip() or 0.0)
    except (OSError, ValueError):
        return 0.0


def pick_oom_victim(workers) -> Optional[str]:
    """Retriable-LIFO policy (worker_killing_policy.h:60): among active
    workers prefer killing a *task* worker (its work retries via lineage /
    submitter retry) over an actor worker (restart is heavier), and among
    equals the most recently started (least progress lost).  Idle workers
    are skipped — the idle trimmer reclaims those for free.

    ``workers`` is an iterable of (worker_id_hex, is_actor, started_at,
    is_active).  Returns a worker id or None."""
    candidates = [(wid, is_actor, started)
                  for wid, is_actor, started, active in workers if active]
    if not candidates:
        return None
    candidates.sort(key=lambda t: (t[1], -t[2]))  # tasks first, newest first
    return candidates[0][0]
