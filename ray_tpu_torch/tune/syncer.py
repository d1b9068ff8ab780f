"""Experiment/checkpoint sync between the local staging dir and a storage URI
(the port's copy of ray_tpu/tune/syncer.py).

Analog of Ray's python/ray/tune/syncer.py:185 (``Syncer`` with
``sync_up``/``sync_down``/``sync_period`` throttling) over the pluggable
storage seam (``ray_tpu_torch/_private/storage.py``) instead of pyarrow
filesystems: ``RunConfig(storage_path="mock://...")`` stages the experiment
locally and mirrors it under the URI; ``Tuner.restore(uri)`` downloads the
mirror and resumes.

Uploads mirror the whole experiment directory; experiments here are
checkpoint+JSON sized (the heavy model state lives in orbax shards the
trainer manages), so rsync-style deltas are not worth the bookkeeping.
"""
from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch._private import storage


class Syncer:
    def __init__(self, local_dir: str, remote_uri: str,
                 sync_period: float = 5.0):
        self.local_dir = local_dir
        self.remote_uri = remote_uri
        self.sync_period = sync_period
        self._last_sync = 0.0

    def sync_up(self, force: bool = False) -> bool:
        """Throttled mirror of the experiment dir to the URI; ``force``
        bypasses the period (used at experiment end)."""
        now = time.monotonic()
        if not force and now - self._last_sync < self.sync_period:
            return False
        storage.upload_dir(self.local_dir, self.remote_uri)
        self._last_sync = now
        return True

    def sync_down(self) -> int:
        return storage.download_dir(self.remote_uri, self.local_dir)


def resolve_storage(storage_path: str, name: str,
                    staging_root: str) -> tuple:
    """-> (local experiment dir, remote URI or None). A URI storage_path
    stages locally and syncs; a plain path is used directly. A fresh run
    starts from a clean staging dir — leftovers from a previous same-named
    run would otherwise be mirrored into the new experiment's URI."""
    import os
    import shutil
    if storage.is_uri(storage_path):
        local = os.path.join(staging_root, name)
        shutil.rmtree(local, ignore_errors=True)
        return local, storage.join_uri(storage_path, name)
    return os.path.join(storage_path, name), None
