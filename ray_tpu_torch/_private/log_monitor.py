"""Per-node log tailer: worker stdout/stderr -> GCS pubsub -> driver.

Analog of /root/reference/python/ray/_private/log_monitor.py (tails the
session log dir and publishes lines over GCS pubsub so drivers can print
them with `ray.init(log_to_driver=True)` semantics).
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Callable, Dict, Optional

LOG_CHANNEL = "worker_logs"
_SCAN_PERIOD_S = 0.5
_MAX_LINES_PER_BATCH = 200


class LogMonitor:
    """Thread tailing `<session>/logs/worker-*.{out,err}`.

    ``job_of`` maps a worker-id prefix to the job currently leasing that
    worker, so each published batch carries a job_id and drivers print only
    their own workers' output (reference routes log lines by job the same
    way).
    """

    def __init__(self, session_dir: str, gcs, node_id: str,
                 job_of: Optional[Callable[[str], Optional[str]]] = None):
        self._log_dir = os.path.join(session_dir, "logs")
        self._gcs = gcs
        self._node_id = node_id
        self._job_of = job_of
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="log-monitor")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(_SCAN_PERIOD_S):
            try:
                self._scan()
            except Exception:
                pass  # never let a log hiccup kill the monitor

    def _scan(self) -> None:
        for path in glob.glob(os.path.join(self._log_dir, "worker-*")):
            base = os.path.basename(path)
            if not (base.endswith(".out") or base.endswith(".err")):
                continue
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            offset = self._offsets.get(path, 0)
            if size <= offset:
                continue
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size - offset)
            # only publish complete lines; carry partials to the next scan
            last_nl = data.rfind(b"\n")
            if last_nl < 0:
                continue
            self._offsets[path] = offset + last_nl + 1
            lines = data[:last_nl].decode("utf-8", "replace").splitlines()
            worker, stream = base[len("worker-"):].rsplit(".", 1)
            job_id = self._job_of(worker) if self._job_of else None
            for i in range(0, len(lines), _MAX_LINES_PER_BATCH):
                try:
                    self._gcs.call("publish", {
                        "channel": LOG_CHANNEL,
                        "message": {
                            "node_id": self._node_id,
                            "worker": worker,
                            "job_id": job_id,
                            "stream": stream,
                            "lines": lines[i:i + _MAX_LINES_PER_BATCH],
                        }})
                except Exception:
                    return  # GCS unreachable; retry next scan


def tail_file(path: str, nbytes: int) -> str:
    """Last ``nbytes`` of a log file, decoded leniently — the crash-
    dossier harvest path (raylet reads a dead worker's stdout/stderr)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - nbytes))
            data = f.read(nbytes)
        return data.decode("utf-8", "replace")
    except OSError:
        return ""


def print_to_driver(message: dict, job_id: Optional[str] = None) -> None:
    """Driver-side subscriber: prefix lines like the reference does.

    ``job_id``: this driver's job — batches tagged with a *different* job are
    dropped (untagged batches print everywhere, e.g. prestarted workers).
    """
    import sys
    msg_job = message.get("job_id")
    if job_id is not None and msg_job is not None and msg_job != job_id:
        return
    out = sys.stderr if message.get("stream") == "err" else sys.stdout
    prefix = f"({message.get('worker', '?')[:8]})"
    for line in message.get("lines", []):
        print(f"{prefix} {line}", file=out)
