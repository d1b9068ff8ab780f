"""Local filesystem capacity monitor.

Analog of /root/reference/src/ray/common/file_system_monitor.h
(``FileSystemMonitor``: polls disk usage of the spill/fallback paths and
makes writes fail gracefully above ``local_fs_capacity_threshold``
instead of filling the disk and hanging the node).

Test seam: ``fs_monitor_test_usage_path`` names a file holding a float
usage fraction read instead of the kernel counters — the same shape as
the memory monitor's injection seam.
"""

from __future__ import annotations

import logging
import shutil
import time

from ray_tpu_torch._private.config import CONFIG

logger = logging.getLogger(__name__)


class FileSystemMonitor:
    def __init__(self, path: str,
                 capacity_threshold: float = None,
                 check_interval_s: float = 1.0,
                 on_over=None):
        self.path = path
        self.capacity_threshold = (
            CONFIG.local_fs_capacity_threshold
            if capacity_threshold is None else capacity_threshold)
        self.check_interval_s = check_interval_s
        self.on_over = on_over   # fired once on each not-full->full edge
        self._last_check = 0.0
        self._last_usage = 0.0
        self._warned = False

    def usage_fraction(self) -> float:
        now = time.monotonic()
        if now - self._last_check < self.check_interval_s:
            return self._last_usage
        self._last_check = now
        test_path = CONFIG.fs_monitor_test_usage_path
        if test_path:
            try:
                with open(test_path) as f:
                    self._last_usage = float(f.read().strip())
                return self._last_usage
            except (OSError, ValueError):
                pass
        try:
            du = shutil.disk_usage(self.path)
            self._last_usage = du.used / max(1, du.total)
        except OSError:
            self._last_usage = 0.0
        return self._last_usage

    def over_capacity(self) -> bool:
        usage = self.usage_fraction()
        over = usage >= self.capacity_threshold
        if over and not self._warned:
            self._warned = True
            logger.error(
                "local filesystem holding %s is %.1f%% full "
                "(threshold %.0f%%): object spilling and fallback "
                "allocation are disabled until space frees up",
                self.path, usage * 100, self.capacity_threshold * 100)
            if self.on_over is not None:
                try:
                    self.on_over(usage)
                except Exception:
                    pass
        elif not over:
            self._warned = False
        return over
