"""@serve.batch — coalesce concurrent calls into one batched invocation.

Analog of Ray's python/ray/serve/batching.py (_BatchQueue).
Replicas are async actors, so concurrent handle_request coroutines each
submit one input and await a per-call future; a batcher thread drains the
queue into calls of the wrapped function with a list of inputs. Plain
threads (threaded actors, driver-side use) block on an event instead.

On TPU replicas this is the continuous-batching seam: the wrapped function
sees a padded batch it can feed to a jitted forward step.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch._private import runtime_metrics as rtm

_M_BATCH = rtm.histogram(
    "ray_tpu_serve_batch_size", "@serve.batch coalesced batch sizes",
    boundaries=rtm.COUNT_BOUNDARIES)

_QUEUE_CREATE_LOCK = threading.Lock()
_QUEUES: dict = {}


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._lock = threading.Condition()
        self._items: List[tuple] = []  # (instance, arg, deliver)
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def submit(self, instance, arg) -> Any:
        """From a plain thread: blocks until the batch result arrives.
        From inside an event loop (async replica / async actor): returns an
        awaitable instead — blocking would starve the very loop whose
        concurrent calls form the batch (the reason the reference's
        _BatchQueue is asyncio-native)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            fut = loop.create_future()

            def deliver(ok: bool, value: Any, _loop=loop, _fut=fut):
                if ok:
                    _loop.call_soon_threadsafe(
                        lambda: None if _fut.done()
                        else _fut.set_result(value))
                else:
                    _loop.call_soon_threadsafe(
                        lambda: None if _fut.done()
                        else _fut.set_exception(value))

            self._enqueue(instance, arg, deliver)
            return fut
        ev = threading.Event()
        out: dict = {}

        def deliver(ok: bool, value: Any):
            out["ok" if ok else "err"] = value
            ev.set()

        self._enqueue(instance, arg, deliver)
        ev.wait()
        if "err" in out:
            raise out["err"]
        return out["ok"]

    def _enqueue(self, instance, arg, deliver) -> None:
        with self._lock:
            self._items.append((instance, arg, deliver))
            self._ensure_thread()
            self._lock.notify()

    def _loop(self):
        while True:
            with self._lock:
                while not self._items:
                    self._lock.wait()
                # wait up to batch_wait_timeout_s for a full batch
                deadline = time.monotonic() + self._wait
                while (len(self._items) < self._max
                       and time.monotonic() < deadline):
                    self._lock.wait(timeout=deadline - time.monotonic())
                batch = self._items[:self._max]
                del self._items[:len(batch)]
            _M_BATCH.observe(len(batch))
            instance = batch[0][0]
            args = [b[1] for b in batch]
            try:
                if instance is not None:
                    results = self._fn(instance, args)
                else:
                    results = self._fn(args)
                if inspect.iscoroutine(results):
                    # reference @serve.batch functions are `async def`;
                    # drive the coroutine to completion on this loop thread
                    results = asyncio.run(results)
                if len(results) != len(args):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for a batch of {len(args)}")
                for (_, _, deliver), r in zip(batch, results):
                    deliver(True, r)
            except Exception as e:  # noqa: BLE001 - delivered to callers
                for _, _, deliver in batch:
                    deliver(False, e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped fn must take a list of inputs and return a
    list of outputs of the same length; concurrent callers each pass one
    input and receive one output."""

    def wrap(fn: Callable):
        params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
        is_method = params and params[0] == "self"
        # Queues hold locks/threads, so they must be created lazily in the
        # executing process — never captured in the pickled closure.
        key = f"__serve_batch_queue_{fn.__name__}"

        if is_method:
            @functools.wraps(fn)
            def method(self, arg):
                # runtime import: locks/threads must never ride the pickle
                from ray_tpu_torch.serve import batching as _b
                with _b._QUEUE_CREATE_LOCK:
                    q = getattr(self, key, None)
                    if q is None:
                        q = _b._BatchQueue(fn, max_batch_size,
                                           batch_wait_timeout_s)
                        setattr(self, key, q)
                return q.submit(self, arg)
            return method

        @functools.wraps(fn)
        def func(arg):
            from ray_tpu_torch.serve import batching as _b
            qkey = (fn.__module__, fn.__qualname__)
            with _b._QUEUE_CREATE_LOCK:
                q = _b._QUEUES.get(qkey)
                if q is None:
                    q = _b._QUEUES[qkey] = _b._BatchQueue(
                        fn, max_batch_size, batch_wait_timeout_s)
            return q.submit(None, arg)
        return func

    if _fn is not None:
        return wrap(_fn)
    return wrap
