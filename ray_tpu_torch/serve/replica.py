"""Replica actor: wraps the user's deployment callable.

Analog of Ray's python/ray/serve/_private/replica.py
(RayServeReplica :250, handle_request :494): tracks in-flight queries for
autoscaling metrics, enforces max_concurrent_queries admission, supports
reconfigure(user_config) and health checks.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict

from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch.util.tracing import tracing_helper as trh

_M_REQ = rtm.histogram_family(
    "ray_tpu_serve_request_ms",
    "serve request latency per deployment (ms); streaming requests are "
    "timed first call -> last yield", tag_key="deployment")
_M_ONGOING = rtm.gauge(
    "ray_tpu_serve_ongoing", "in-flight serve requests on this replica")


class ReplicaActor:
    """Runs as an *async* ray_tpu_torch actor (handle_request is a coroutine, so
    the worker gives this actor an event loop): queries interleave at await
    points up to the actor's max_concurrency, matching the reference
    replica's asyncio execution model (replica.py:250). Sync user callables
    still work — they just occupy the loop for their duration."""

    def __init__(self, serialized_init: bytes, deployment_name: str,
                 replica_tag: str, user_config: Any = None,
                 max_concurrent_queries: int = 8):
        from ray_tpu_torch import cloudpickle
        from concurrent.futures import ThreadPoolExecutor
        cls_or_fn, init_args, init_kwargs = cloudpickle.loads(serialized_init)
        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        self._num_ongoing = 0
        self._num_processed = 0
        self._started = time.time()
        # sync user callables run here so they parallelize up to
        # max_concurrent_queries and never block the loop (metrics/health
        # stay responsive); async callables run on the loop itself
        self._sync_pool = ThreadPoolExecutor(
            max_workers=max_concurrent_queries,
            thread_name_prefix="replica-sync")
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = cls_or_fn
            self._is_function = True
        # method name -> (target, is_async): the two
        # inspect.iscoroutinefunction calls per request cost more than
        # a no-op handler at serving QPS; targets are stable for the
        # replica's lifetime
        self._targets: Dict[str, Any] = {}
        if user_config is not None:
            self.reconfigure(user_config)

    def _resolve_target(self, method_name: str):
        """(target, is_async) for one request, cached per method."""
        key = method_name or "__call__"
        hit = self._targets.get(key)
        if hit is None:
            if self._is_function or key == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            is_async = (inspect.iscoroutinefunction(target)
                        or inspect.iscoroutinefunction(
                            getattr(target, "__call__", None)))
            hit = self._targets[key] = (target, is_async)
        return hit

    # ------------------------------------------------------------- requests
    async def handle_request(self, method_name: str, args: tuple,
                             kwargs: dict) -> Any:
        import functools
        self._num_ongoing += 1
        _M_ONGOING.set(self._num_ongoing)
        _t0 = rtm.now()
        # replica span (docs/observability.md): the actor-call exec span
        # is named after the wrapper (task:handle_request); this one
        # names the ROUTED user method, and its context carries into the
        # user code — so the serve hop reads "<deployment>.<method>" in
        # a trace, and spans the target opens (handoff pull, import
        # wait) nest under it
        sspan = trh.open_span(
            f"serve:{self.deployment_name}.{method_name or '__call__'}",
            "serve")
        token = trh.install(sspan.ctx()) if sspan is not None else None
        try:
            target, is_async = self._resolve_target(method_name)
            if is_async:
                result = await target(*args, **kwargs)
            else:
                loop = asyncio.get_running_loop()
                call = functools.partial(target, *args, **kwargs)
                if sspan is not None:
                    # run_in_executor drops ContextVars; re-bind so the
                    # user code's spans keep the request's trace
                    call = trh.bind_ctx(sspan.ctx(), call)
                result = await loop.run_in_executor(self._sync_pool,
                                                    call)
                if inspect.isawaitable(result):  # e.g. @serve.batch future
                    result = await result
            if sspan is not None:
                sspan.end()
            return result
        except BaseException as e:
            if sspan is not None:
                sspan.end(trh.ERROR, error_type=type(e).__name__)
            raise
        finally:
            if token is not None:
                trh.uninstall(token)
            self._num_ongoing -= 1
            self._num_processed += 1
            _M_ONGOING.set(self._num_ongoing)
            _M_REQ.observe_since(self.deployment_name, _t0)

    async def handle_request_streaming(self, method_name: str, args: tuple,
                                       kwargs: dict):
        """Streaming request path: called with num_returns="streaming"
        (DeploymentHandle.remote_streaming), so every item this
        async generator yields is delivered to the caller as its own
        ObjectRef the moment it is produced — a Serve LLM request
        streams its first token while decode is still running.  The
        user target must return an (async) generator / iterable."""
        self._num_ongoing += 1
        _M_ONGOING.set(self._num_ongoing)
        _t0 = rtm.now()
        # replica span covering the whole stream (first call -> last
        # yield); the user generator's own spans nest under it
        sspan = trh.open_span(
            f"serve:{self.deployment_name}.{method_name or '__call__'}",
            "serve")
        token = trh.install(sspan.ctx()) if sspan is not None else None
        nitems = 0
        try:
            target, _ = self._resolve_target(method_name)
            result = target(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            if hasattr(result, "__aiter__"):
                async for item in result:
                    nitems += 1
                    yield item
            else:
                # sync generator: pull each (possibly blocking) step on
                # the sync pool, matching handle_request's executor
                # offload — a blocking per-item producer must not stall
                # the replica's event loop for the whole stream
                loop = asyncio.get_running_loop()
                it = iter(result)
                sentinel = object()
                while True:
                    item = await loop.run_in_executor(
                        self._sync_pool, next, it, sentinel)
                    if item is sentinel:
                        break
                    nitems += 1
                    yield item
            if sspan is not None:
                sspan.end(num_items=nitems)
        except BaseException as e:
            if sspan is not None:
                sspan.end(trh.ERROR, error_type=type(e).__name__,
                          num_items=nitems)
            raise
        finally:
            if token is not None:
                trh.uninstall(token)
            self._num_ongoing -= 1
            self._num_processed += 1
            _M_ONGOING.set(self._num_ongoing)
            _M_REQ.observe_since(self.deployment_name, _t0)

    # ------------------------------------------------------------- control
    def reconfigure(self, user_config: Any) -> None:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def check_health(self) -> bool:
        if not self._is_function and hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def get_metrics(self) -> Dict[str, Any]:
        """Queue metrics feeding the controller's autoscaling policy
        (cf. reference serve/_private/autoscaling_metrics.py).

        ``load``: the autoscaling signal — the user callable's
        ``autoscale_load()`` when it defines one and returns a number
        (e.g. an LLM decode pool's slot pressure, serve/llm.py),
        otherwise the in-flight request count.  ``node_id`` feeds
        locality-preferring routing (handle.py prefer_node)."""
        load = None
        prefixes = None
        if not self._is_function:
            fn = getattr(self._callable, "autoscale_load", None)
            if fn is not None:
                try:
                    # float() inside the guard: a non-numeric return
                    # must fall back, not fail the health check
                    load = float(fn())
                except Exception:
                    load = None
            # resident prompt-prefix digests (docs/serve_frontdoor.md):
            # the controller republishes them on the get_targets load
            # path so handles can prefix-affinity-route.  Advertised
            # every health-check pass — the set is the replica's CURRENT
            # cache, not a delta
            adv = getattr(self._callable, "advertised_prefixes", None)
            if adv is not None:
                try:
                    prefixes = adv()
                except Exception:
                    prefixes = None
        out = {
            "replica_tag": self.replica_tag,
            "num_ongoing": self._num_ongoing,
            "load": (load if load is not None
                     else float(self._num_ongoing)),
            "node_id": self._node_id(),
            "num_processed": self._num_processed,
            "uptime_s": time.time() - self._started,
        }
        if prefixes:
            out["prefixes"] = prefixes
        return out

    @staticmethod
    def _node_id() -> str:
        try:
            from ray_tpu_torch.runtime.core_worker import get_global_worker
            return get_global_worker().node_id
        except Exception:
            return ""

    async def prepare_for_shutdown(self) -> bool:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self._num_ongoing == 0:
                return True
            await asyncio.sleep(0.05)
        return False
