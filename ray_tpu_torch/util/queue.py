"""Distributed FIFO queue backed by an actor.

Analog of /root/reference/python/ray/util/queue.py (Queue, Empty, Full).
"""

from __future__ import annotations

import queue as stdlib_queue
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = stdlib_queue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item: Any, block: bool, timeout: Optional[float]) -> bool:
        try:
            self._q.put(item, block=block, timeout=timeout)
            return True
        except stdlib_queue.Full:
            return False

    def get(self, block: bool, timeout: Optional[float]):
        try:
            return True, self._q.get(block=block, timeout=timeout)
        except stdlib_queue.Empty:
            return False, None

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._q.maxsize > 0 and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    def get_nowait_batch(self, num_items: int):
        if self._q.qsize() < num_items:
            return False, []
        return True, [self._q.get_nowait() for _ in range(num_items)]

    def shutdown(self) -> None:
        pass


class Queue:
    """Cluster-wide FIFO queue; handles are picklable and usable from any
    task or actor."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(maxsize)

    def __reduce__(self):
        return (_rebuild_queue, (self.maxsize, self.actor))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put.remote(item, False, None)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = 0.2 if deadline is None \
                else min(0.2, max(0.0, deadline - time.monotonic()))
            ok = ray_tpu_torch.get(self.actor.put.remote(item, True, chunk))
            if ok:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(False, None))
            if not ok:
                raise Empty
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = 0.2 if deadline is None \
                else min(0.2, max(0.0, deadline - time.monotonic()))
            ok, item = ray_tpu_torch.get(self.actor.get.remote(True, chunk))
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items))
        if not ok:
            raise Empty
        return items

    def shutdown(self) -> None:
        if self.actor is not None:
            ray_tpu_torch.kill(self.actor)
            self.actor = None


def _rebuild_queue(maxsize, actor):
    q = Queue.__new__(Queue)
    q.maxsize = maxsize
    q.actor = actor
    return q
