"""A pool of actors processing a stream of tasks.

Analog of /root/reference/python/ray/util/actor_pool.py (ActorPool).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    """Round-robins work over a fixed set of actor handles.

    >>> pool = ActorPool([Worker.remote() for _ in range(4)])
    >>> list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    """

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._inflight_owner = {}
        self._submit_order_refs = {}
        self._submit_counter = 0
        self._deliver_counter = 0
        self._backlog: List[tuple] = []

    # ------------------------------------------------------------- mapping
    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterable[Any]:
        """Ordered map; yields results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterable[Any]:
        """Unordered map; yields results as they complete (faster when task
        durations vary)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---------------------------------------------------------- scheduling
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        if not self._idle and not self._inflight_owner \
                and not self._backlog:
            raise ValueError("cannot submit to an ActorPool with no actors")
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._inflight_owner[future] = (self._submit_counter, actor)
            self._submit_order_refs[self._submit_counter] = future
            self._submit_counter += 1
        else:
            self._backlog.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._inflight_owner) or bool(self._backlog)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._backlog:
            self.submit(*self._backlog.pop(0))

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order (skipping results already taken
        by :meth:`get_next_unordered`)."""
        if not self.has_next():
            raise StopIteration("no pending results")
        # indices assigned at submit time but absent from the map were
        # consumed by get_next_unordered: skip them
        while self._deliver_counter < self._submit_counter and \
                self._deliver_counter not in self._submit_order_refs:
            self._deliver_counter += 1
        future = self._submit_order_refs.get(self._deliver_counter)
        if future is None:
            # every indexed task was consumed; anything left is parked,
            # which with a non-empty pool implies in-flight futures exist —
            # so this means has_next() lied (defensive)
            raise StopIteration("no pending results")
        value = ray_tpu_torch.get(future, timeout=timeout)
        del self._submit_order_refs[self._deliver_counter]
        self._deliver_counter += 1
        _, actor = self._inflight_owner.pop(future)
        self._return_actor(actor)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Any completed result (completion order)."""
        if not self._inflight_owner:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight_owner),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        future = ready[0]
        i, actor = self._inflight_owner.pop(future)
        del self._submit_order_refs[i]
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    # --------------------------------------------------------------- admin
    def push(self, actor) -> None:
        """Add an idle actor to the pool."""
        self._return_actor(actor)

    def pop_idle(self):
        """Remove and return an idle actor, or None."""
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
