"""RandomAccessDataset: O(1)-ish distributed point lookups by sort key
(the port's copy of ray_tpu/data/random_access_dataset.py).

Analog of Ray's python/ray/data/random_access_dataset.py: the
dataset is sorted by a key column and repartitioned; a pool of actors each
pins one contiguous span of the sorted data and serves binary-search
lookups.  Blocks travel to the actors as object refs (never through the
driver), and span boundaries come from tiny per-block tasks — the driver
holds only the boundary keys, so dataset size is bounded by the actor
pool's memory, not the driver's.
"""

from __future__ import annotations

import bisect
from typing import Any, List, Optional


class _BlockHolder:
    """Actor: pins one sorted block span, answers key lookups."""

    def __init__(self, block: Any, key: str):
        import numpy as np

        from ray_tpu_torch.data.block import BlockAccessor
        self._rows = list(BlockAccessor.for_block(block).iter_rows())
        self._keys = np.asarray([r[key] for r in self._rows])

    def get(self, key_value) -> Optional[Any]:
        i = bisect.bisect_left(self._keys, key_value)  # type: ignore[arg-type]
        if i < len(self._rows) and self._keys[i] == key_value:
            return self._rows[i]
        return None

    def multiget(self, key_values: List[Any]) -> List[Optional[Any]]:
        return [self.get(k) for k in key_values]

    def num_rows(self) -> int:
        return len(self._rows)


def _span_info(block, key: str):
    """(num_rows, last_key) — runs as a task next to the block."""
    from ray_tpu_torch.data.block import BlockAccessor
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    if n == 0:
        return 0, None
    last = None
    for row in acc.iter_rows():
        last = row[key]
    return n, last


class RandomAccessDataset:
    """Built via ``Dataset.to_random_access_dataset(key, num_workers)``."""

    def __init__(self, ds, key: str, num_workers: int = 2):
        import ray_tpu_torch

        sorted_ds = ds.sort(key).repartition(num_workers).materialize()
        refs = sorted_ds.get_internal_block_refs()
        span_task = ray_tpu_torch.remote(num_cpus=0.5)(_span_info)
        infos = ray_tpu_torch.get([span_task.remote(r, key) for r in refs],
                                  timeout=120)
        self._key = key
        # span i owns keys <= bounds[i] (last span unbounded)
        self._bounds: List[Any] = []
        holder_cls = ray_tpu_torch.remote(num_cpus=0.5)(_BlockHolder)
        self._actors = []
        spans = [(r, last) for r, (n, last) in zip(refs, infos) if n > 0]
        for i, (ref, last) in enumerate(spans):
            if i < len(spans) - 1:
                self._bounds.append(last)
            # the ref resolves to the block inside the actor's __init__ —
            # the block never passes through the driver
            self._actors.append(holder_cls.remote(ref, key))
        if not self._actors:
            raise ValueError("empty dataset")

    def _route(self, key_value) -> int:
        return bisect.bisect_left(self._bounds, key_value)

    def get_async(self, key_value):
        """ObjectRef of the row with key == key_value (None if absent)."""
        return self._actors[self._route(key_value)].get.remote(key_value)

    def multiget(self, key_values: List[Any],
                 timeout: Optional[float] = 60.0) -> List[Optional[Any]]:
        import ray_tpu_torch
        by_actor: dict = {}
        for j, kv in enumerate(key_values):
            by_actor.setdefault(self._route(kv), []).append((j, kv))
        out: List[Optional[Any]] = [None] * len(key_values)
        pending = []
        for idx, items in by_actor.items():
            ref = self._actors[idx].multiget.remote([kv for _, kv in items])
            pending.append((items, ref))
        for items, ref in pending:
            values = ray_tpu_torch.get(ref, timeout=timeout)
            for (j, _), v in zip(items, values):
                out[j] = v
        return out

    def stats(self) -> str:
        import ray_tpu_torch
        counts = ray_tpu_torch.get([a.num_rows.remote() for a in self._actors])
        return (f"RandomAccessDataset: {len(self._actors)} workers, "
                f"{sum(counts)} rows, per-worker {counts}")
