"""DeploymentHandle: client-side router to a deployment's replicas.

Analog of Ray's python/ray/serve/handle.py (RayServeHandle :78)
+ _private/router.py (Router/ReplicaSet :261/:62, assign_replica :221):
power-of-two-choices over handle-local in-flight counts, with
max_concurrent_queries backpressure; routing tables refresh from the
controller with a version stamp (short-poll analog of LongPollClient).

Per-request hot path (the reference's 1-2 ms overhead bar,
doc/source/serve/performance.md:19-20): no GCS lookups (replica actor
handles are cached), no polling threads (in-flight counts decrement via
owned-object ready callbacks the moment a reply lands), and the periodic
routing-table refresh runs on a background thread so requests never wait
on the controller.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, SERVE_NAMESPACE
from ray_tpu_torch.serve.frontdoor.prefix import PrefixIndex, page_digests
from ray_tpu_torch.util.tracing import tracing_helper as trh

_REFRESH_INTERVAL_S = 1.0


class _SubHandle:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._route(self._method, args, kwargs)

    def remote_streaming(self, *args, **kwargs):
        return self._handle._route_streaming(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._lock = threading.Condition()
        self._version = -1
        self._replicas: List[str] = []
        self._actors: Dict[str, Any] = {}      # replica name -> actor handle
        self._max_concurrent = 8
        self._inflight: Dict[str, int] = {}
        # controller-published per-replica signals (refreshed every
        # poll, including version-unchanged replies): queue-depth load
        # for p2c routing, node ids for locality-preferring routes
        self._loads: Dict[str, float] = {}
        self._nodes: Dict[str, str] = {}
        # prefix-affinity index (docs/serve_frontdoor.md): fed from the
        # controller's load-publish path when replicas advertise
        # resident paged-KV prefix digests; lazily materialized so a
        # handle to a non-LLM deployment pays nothing
        self._prefix_index: Optional[PrefixIndex] = None
        self._prefix_page_size = 0
        self._prefix_advertisers: set = set()
        # replica name -> monotonic deadline: recently-failed replicas
        # the routing table may still list (the controller needs a few
        # health-check passes to retire a death) — skipped until the
        # deadline so retries don't bounce off the same corpse
        self._suspect: Dict[str, float] = {}
        # result (ref / streaming generator) -> replica that produced
        # it, so a consumer seeing an error AFTER submission can
        # suspect-list the right replica (mark_suspect / replica_of)
        self._ref_replica: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._last_refresh = 0.0
        self._controller = None
        self._refreshing = False
        self._worker_cache = None

    # ------------------------------------------------------------ plumbing
    def _get_controller(self):
        if self._controller is None:
            self._controller = ray_tpu_torch.get_actor(
                CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        return self._controller

    def _maybe_refresh_bg(self):
        """Kick a background refresh when the table is stale; requests
        keep routing on the current table meanwhile."""
        now = time.monotonic()
        if now - self._last_refresh < _REFRESH_INTERVAL_S:
            return
        with self._lock:
            if self._refreshing:
                return
            self._refreshing = True
        threading.Thread(target=self._refresh_quiet, daemon=True).start()

    def _refresh_quiet(self):
        try:
            self._refresh(force=True)
        except Exception:
            pass
        finally:
            with self._lock:
                self._refreshing = False

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < _REFRESH_INTERVAL_S:
            return
        self._last_refresh = now
        targets = ray_tpu_torch.get(
            self._get_controller().get_targets.remote(
                self.deployment_name, self._version), timeout=10)
        if targets is None:
            with self._lock:
                self._replicas = []
                self._actors.clear()
            return
        if targets.get("unchanged"):
            # loads ride every reply: they change each health-check
            # pass without bumping the routing version
            with self._lock:
                self._loads.update(targets.get("loads") or {})
            self._feed_prefixes(targets.get("prefixes"))
            return
        self._feed_prefixes(targets.get("prefixes"))
        with self._lock:
            self._version = targets["version"]
            self._replicas = targets["replicas"]
            self._max_concurrent = targets["max_concurrent_queries"]
            self._loads = dict(targets.get("loads") or {})
            self._nodes = dict(targets.get("nodes") or {})
            # suspects for retired tags must not accumulate over
            # autoscaling churn in a long-lived handle
            now = time.monotonic()
            self._suspect = {r: d for r, d in self._suspect.items()
                             if d > now and r in self._loads}
            live = set(self._replicas)
            for r in self._replicas:
                self._inflight.setdefault(r, 0)
            for gone in [r for r in self._actors if r not in live]:
                del self._actors[gone]
            self._lock.notify_all()

    def _feed_prefixes(self, prefixes: Optional[Dict[str, dict]]) -> None:
        """Fold one controller publish of advertised prefix digests
        (replica -> {"page_size", "digests"}) into the affinity index.
        ``None`` means the deployment doesn't advertise (non-LLM, or
        the prefix cache is off) — nothing is built.  Replicas that
        stopped advertising (died, drained, cache wiped on recovery)
        are dropped so their digests can't pin new requests."""
        if prefixes is None:
            return
        idx = self._prefix_index
        if idx is None:
            idx = self._prefix_index = PrefixIndex(
                CONFIG.serve_prefix_index_max)
        for replica, adv in prefixes.items():
            ps = int(adv.get("page_size") or 0)
            if ps:
                self._prefix_page_size = ps
            idx.update(replica, adv.get("digests") or ())
        for replica in self._prefix_advertisers - set(prefixes):
            idx.drop_replica(replica)
        self._prefix_advertisers = set(prefixes)

    def prefix_route(self, prompt) -> Optional[str]:
        """Replica holding the deepest resident prefix of ``prompt``
        (docs/serve_frontdoor.md), or None.  Counts hit/miss/evicted on
        ``ray_tpu_serve_prefix_hit``; a pure no-op (no metric noise)
        until some replica has advertised."""
        idx = self._prefix_index
        ps = self._prefix_page_size
        if idx is None or ps <= 0 or not prompt:
            return None
        chain = page_digests(prompt, ps)
        if not chain:
            return None
        with self._lock:
            live = set(self._replicas)
        return idx.lookup(chain, live)

    def _actor_for(self, replica: str):
        """Cached replica actor handle: one GCS lookup per replica per
        table version, not one per request."""
        actor = self._actors.get(replica)
        if actor is None:
            actor = ray_tpu_torch.get_actor(replica, namespace=SERVE_NAMESPACE)
            with self._lock:
                self._actors[replica] = actor
        return actor

    # ------------------------------------------------------------- routing
    def _load_score(self, r: str) -> float:
        """Effective queue depth: the replica's telemetry-published load
        (covers traffic from OTHER handles and engine-internal queues)
        plus this handle's own in-flight count (covers what we sent
        since the last health-check pass).  Handle-local counts alone
        hotspot a pool under skewed stream lengths — every handle sees
        its own short queue while one replica drowns."""
        return self._inflight.get(r, 0) + self._loads.get(r, 0.0)

    def _pick_replica(self, prefer_node: Optional[str] = None,
                      prefer_replica: Optional[str] = None
                      ) -> Optional[str]:
        """Power-of-two choices on effective queue depth among replicas
        with spare concurrency; ``prefer_node`` narrows to replicas
        colocated with that node first (e.g. the node holding a KV
        handoff's primary copy) and falls back to the whole pool —
        the cross-node loser still gets the object via the transfer
        plane's locality-aware pull, just not for free.

        ``prefer_replica`` is a hard affinity pick (a prefix-index hit:
        THAT replica holds the prompt's resident KV pages) honored
        whenever the replica is routable with spare concurrency —
        affinity beats load balance because a hit skips whole prefill
        pages; a saturated or suspect target falls back to p2c."""
        now = time.monotonic()
        candidates = [r for r in self._replicas
                      if self._inflight.get(r, 0) < self._max_concurrent
                      and self._suspect.get(r, 0.0) <= now]
        if not candidates:
            return None
        if prefer_replica is not None and prefer_replica in candidates:
            return prefer_replica
        if prefer_node:
            colocated = [r for r in candidates
                         if self._nodes.get(r) == prefer_node]
            if colocated:
                candidates = colocated
        if len(candidates) == 1:
            return candidates[0]
        a, b = random.sample(candidates, 2)
        return a if self._load_score(a) <= self._load_score(b) else b

    def _release(self, replica: str) -> None:
        with self._lock:
            self._inflight[replica] = max(
                0, self._inflight.get(replica, 1) - 1)
            self._lock.notify_all()

    def mark_suspect(self, replica: str, ttl_s: float = 10.0) -> None:
        """Skip this replica for ``ttl_s`` (an error surfaced on its
        stream/result AFTER submission succeeded, so the routing loop's
        own submit-failure handling never saw it)."""
        with self._lock:
            self._suspect[replica] = time.monotonic() + ttl_s

    def replica_of(self, result) -> Optional[str]:
        """The replica a _route result (ref / streaming generator) was
        submitted to, for mark_suspect on late-surfacing errors."""
        return self._ref_replica.get(result)

    def _route(self, method: str, args: tuple, kwargs: dict,
               prefer_replica: Optional[str] = None):
        return self._route_impl(
            lambda actor: actor.handle_request.remote(method, args, kwargs),
            prefer_replica=prefer_replica)

    def _route_streaming(self, method: str, args: tuple, kwargs: dict,
                         prefer_node: Optional[str] = None):
        """Streaming variant: submits the replica's
        handle_request_streaming with num_returns="streaming" and
        returns the live StreamingObjectRefGenerator.  The in-flight
        count drops when the whole stream completes (its completion
        sentinel resolves), so a long generation holds its concurrency
        slot for its true duration."""
        return self._route_impl(
            lambda actor: actor.handle_request_streaming.options(
                num_returns="streaming").remote(method, args, kwargs),
            prefer_node=prefer_node)

    def _route_impl(self, submit, prefer_node: Optional[str] = None,
                    prefer_replica: Optional[str] = None):
        """One routing loop for both request shapes: pick a replica
        (power-of-two choices under max_concurrent_queries), call
        ``submit(actor)``, and anchor the in-flight release on the
        result's completion — the reply ref itself, or a streaming
        generator's completion sentinel."""
        if self._replicas:
            self._maybe_refresh_bg()
        else:
            self._refresh()      # cold start: need a table before routing
        deadline = time.monotonic() + 60.0
        while True:
            with self._lock:
                replica = self._pick_replica(prefer_node, prefer_replica)
                if replica is not None:
                    self._inflight[replica] = \
                        self._inflight.get(replica, 0) + 1
            if replica is None:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no replica of {self.deployment_name!r} available "
                        "(backpressure timeout)")
                with self._lock:
                    self._lock.wait(timeout=0.1)
                self._refresh(force=not self._replicas)
                continue
            try:
                actor = self._actor_for(replica)
                out = submit(actor)
            except Exception:
                # replica vanished (scale-down/crash): drop it locally,
                # force-refresh the table, and retry until the deadline.
                # Also suspect-listed: the refreshed table may re-add it
                # until the controller retires the death
                with self._lock:
                    self._inflight[replica] = max(
                        0, self._inflight.get(replica, 1) - 1)
                    if replica in self._replicas:
                        self._replicas.remove(replica)
                    self._actors.pop(replica, None)
                    self._suspect[replica] = time.monotonic() + 10.0
                if time.monotonic() > deadline:
                    raise
                self._refresh(force=True)
                time.sleep(0.05)
                continue
            # in-flight count drops the instant the completion lands —
            # no polling drainer between a reply and the next admission
            anchor = out.completed() if hasattr(out, "completed") else out
            try:
                self._ref_replica[out] = replica
            except TypeError:
                pass
            self._worker().add_ready_callback(
                anchor, lambda r=replica: self._release(r))
            return out

    # ------------------------------------------------------------ user API
    def _open_root(self):
        """Driver-entry trace root (docs/observability.md): opened only
        when no trace is already active (an http-proxy or disagg root
        upstream owns the request), installed for the submit section so
        the replica task joins it.  Returns (root, token, t0)."""
        if trh.current_context() is not None:
            return None, None, 0.0
        root = trh.serve_ingress_root(
            f"handle:{self.deployment_name}", route=self.deployment_name)
        if root is None:
            return None, None, 0.0
        return root, trh.install(root.ctx()), time.perf_counter()

    def _anchor_root(self, root, t0: float, out) -> None:
        """Close the root (+ TTFT SLO accounting) when the request's
        completion anchor resolves — no polling, the same ready
        callback that drops the in-flight count.  A reply that resolved
        to an error payload closes the root as a failure, not a
        (possibly fast) SLO success."""
        anchor = out.completed() if hasattr(out, "completed") else out
        pool = self.deployment_name
        worker = self._worker()

        def _done():
            if worker.result_is_error(anchor):
                trh.finish_request(root, pool=pool, route=pool,
                                   status=trh.ERROR,
                                   error_type="TaskError")
            else:
                trh.finish_request(root, pool=pool, route=pool,
                                   ttft_s=time.perf_counter() - t0)

        worker.add_ready_callback(anchor, _done)

    def remote(self, *args, **kwargs):
        root, token, t0 = self._open_root()
        try:
            out = self._route("__call__", args, kwargs)
        except Exception as e:
            trh.finish_request(root, pool=self.deployment_name,
                               status=trh.ERROR,
                               error_type=type(e).__name__)
            raise
        finally:
            if token is not None:
                trh.uninstall(token)
        if root is not None:
            self._anchor_root(root, t0, out)
        return out

    def remote_streaming(self, *args, **kwargs):
        """Route one request through the replica's streaming path:
        returns a StreamingObjectRefGenerator whose items arrive as the
        deployment's generator produces them (token streaming)."""
        root, token, t0 = self._open_root()
        try:
            out = self._route_streaming("__call__", args, kwargs)
        except Exception as e:
            trh.finish_request(root, pool=self.deployment_name,
                               status=trh.ERROR,
                               error_type=type(e).__name__)
            raise
        finally:
            if token is not None:
                trh.uninstall(token)
        if root is not None:
            # the anchor is stream COMPLETION: the root's dur is total
            # stream latency; TTFT SLO accounting belongs to token-aware
            # drivers (DisaggHandle / the llm stream consumers)
            anchor = out.completed() if hasattr(out, "completed") else out
            worker = self._worker()
            pool = self.deployment_name

            def _done():
                failed = worker.result_is_error(anchor)
                trh.finish_request(
                    root, pool=pool, route=pool,
                    status=trh.ERROR if failed else trh.OK,
                    error_type="TaskError" if failed else None)

            worker.add_ready_callback(anchor, _done)
        return out

    def try_remote(self, *args, **kwargs):
        """One-shot non-blocking route: submit to a replica with spare
        capacity, or return None (cold table, backpressure, vanished
        replica).  Event-loop callers (the HTTP proxy) use this as the
        fast path and fall back to the blocking ``remote`` in an
        executor — so the common case never leaves the loop and the
        congested case never stalls it."""
        if not self._replicas:
            return None
        self._maybe_refresh_bg()
        with self._lock:
            replica = self._pick_replica()
            if replica is None:
                return None
            self._inflight[replica] = self._inflight.get(replica, 0) + 1
        root, token, t0 = self._open_root()
        try:
            actor = self._actor_for(replica)
            ref = actor.handle_request.remote("__call__", args, kwargs)
        except Exception as e:
            # close the root like remote() does — an abandoned root
            # would drop the failed request from SLO accounting
            trh.finish_request(root, pool=self.deployment_name,
                               status=trh.ERROR,
                               error_type=type(e).__name__)
            self._release(replica)
            return None
        finally:
            if token is not None:
                trh.uninstall(token)
        self._worker().add_ready_callback(
            ref, lambda r=replica: self._release(r))
        if root is not None:
            self._anchor_root(root, t0, ref)
        return ref

    def _worker(self):
        w = self._worker_cache
        if w is None:
            from ray_tpu_torch.runtime.core_worker import get_global_worker
            w = self._worker_cache = get_global_worker()
        return w

    def __getattr__(self, name: str) -> _SubHandle:
        if name.startswith("_"):
            raise AttributeError(name)
        return _SubHandle(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name,))

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_name!r})"


async def _aget(worker, ref, timeout: float = 60.0):
    """Awaitable ray_tpu_torch.get: readiness via an owned-object ready
    callback (no polling), then an immediate local get with an executor
    fallback for store-resident results — the http_proxy fast-path
    idiom, reusable by any event-loop router."""
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    def _on_ready():
        loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(None))

    worker.add_ready_callback(ref, _on_ready)
    await asyncio.wait_for(fut, timeout=timeout)
    try:
        return ray_tpu_torch.get(ref, timeout=0.05)
    except ray_tpu_torch.exceptions.GetTimeoutError:
        return await loop.run_in_executor(
            None, lambda: ray_tpu_torch.get(ref, timeout=timeout))


class DisaggHandle:
    """Client-side prefill->decode router for a disaggregated LLM app
    (docs/serve_disagg.md).  One ``stream()`` call:

      1. routes the request to the PREFILL pool (p2c on published
         queue depth) and yields the first token the moment the pool
         samples it — TTFT never waits for the handoff, let alone a
         decode slot;
      2. routes the KV handoff ref to the DECODE pool, preferring a
         replica colocated with the handoff object's primary copy
         (``prefer_node``), and streams the decoded tokens;
      3. re-queues on KVPoolFullError (decode pool momentarily full —
         bounded backoff, possibly landing on another replica) and
         re-prefills on replica death, surfacing a ``{"retry": n}``
         marker mid-stream; already-yielded tokens are not repeated
         (greedy decode reproduces them; sampled decode resumes with a
         fresh suffix).

    A prefill replica dying AFTER its handoff was pulled is invisible:
    the decode stream runs entirely off the imported pages."""

    def __init__(self, prefill_deployment: str, decode_deployment: str,
                 *, max_retries: int = 3,
                 pool_full_timeout_s: float = 30.0):
        self.prefill = DeploymentHandle(prefill_deployment)
        self.decode = DeploymentHandle(decode_deployment)
        self.max_retries = max_retries
        self.pool_full_timeout_s = pool_full_timeout_s

    async def stream(self, request: Dict[str, Any]):
        """Async generator: ``{"token": id}`` per token (first token
        from the prefill pool, the rest from the decode pool), optional
        ``{"retry": n}`` markers, then a summary dict.

        Tracing (docs/observability.md): the whole request is one trace
        — an ingress root here, ``prefill`` / ``decode`` hop spans per
        attempt, the replica-side execution / handoff-pull / import-wait
        spans as their children — closed with TTFT/TPOT SLO accounting.
        A request that dies mid-flight closes its root with the failure
        and the crash ``dossier_id`` when the error carries one, so the
        trace and the flight recorder cross-link.  When an upstream
        ingress already owns the request (the SSE front door installed
        its root on this task's context), no second root opens — the
        hop spans join the upstream trace and the front door closes the
        root with CLIENT-observed SLO latency (one request, one SLO
        verdict)."""
        root = None
        if trh.current_context() is None:
            root = trh.serve_ingress_root(
                f"disagg:{self.decode.deployment_name}",
                route=self.decode.deployment_name)
        t0 = time.perf_counter()
        first_tok = last_tok = None
        emitted = 0                 # tokens already yielded to the client
        retries = 0
        failure: Optional[BaseException] = None
        try:
            while True:
                try:
                    async for kind, val in self._once(request, emitted,
                                                      root):
                        if kind == "token":
                            now = time.perf_counter()
                            if first_tok is None:
                                first_tok = now
                            last_tok = now
                            emitted += 1
                            yield {"token": val}
                        else:
                            yield val
                    return
                except Exception as e:
                    if _is_pool_full(e) or retries >= self.max_retries:
                        raise
                    retries += 1
                    yield {"retry": retries, "error": type(e).__name__}
        except BaseException as e:
            failure = e
            raise
        finally:
            if root is not None:
                tpot_s = None
                if emitted > 1 and first_tok is not None:
                    tpot_s = (last_tok - first_tok) / (emitted - 1)
                if failure is None:
                    status = trh.OK
                elif isinstance(failure, (GeneratorExit,
                                          asyncio.CancelledError)):
                    # the CLIENT walked away mid-stream: not a service
                    # failure — excluded from both SLO counters
                    status = trh.CANCELLED
                else:
                    status = trh.ERROR
                trh.finish_request(
                    root, pool="disagg",
                    route=self.decode.deployment_name,
                    status=status,
                    ttft_s=(first_tok - t0)
                    if first_tok is not None else None,
                    tpot_s=tpot_s, num_tokens=emitted,
                    error_type=(type(failure).__name__
                                if failure is not None else None),
                    dossier_id=getattr(failure, "dossier_id", None))

    async def _once(self, request: Dict[str, Any], skip: int, root=None):
        """One prefill->decode attempt, yielding ("token", id) /
        ("summary", dict).  The first ``skip`` stream positions (tokens
        the client already holds from an earlier attempt) are consumed
        silently — a retry resumes the client's stream, it doesn't
        restart it."""
        worker = self.prefill._worker()
        loop = asyncio.get_running_loop()
        rctx = root.ctx() if root is not None else None
        # client-observed prefill hop: routing + queue wait + replica
        # prefill + reply; the replica-side task:prefill span nests
        # under it, so queue wait is the visible gap between the two
        sp_pref = trh.open_span("prefill", "hop", ctx=rctx)
        pctx = sp_pref.ctx() if sp_pref is not None else rctx
        # prefix-affinity (docs/serve_frontdoor.md): pin the prefill
        # hop to a replica advertising resident KV pages for this
        # prompt's deepest page-aligned prefix — a hit skips whole
        # prefill pages engine-side.  Falls back to p2c on miss or
        # when the pinned replica is saturated/suspect.
        pinned = self.prefill.prefix_route(request.get("prompt") or ())
        if sp_pref is not None and pinned is not None:
            sp_pref.set_attr("prefix_replica", pinned)
        # routing runs in an executor: _route_impl may block (capacity
        # waits, cold-table controller RPC) and this coroutine shares
        # its loop with every other stream (the http_proxy precedent);
        # bind_ctx carries the trace across the executor hop
        pref_ref = await loop.run_in_executor(
            None, trh.bind_ctx(
                pctx, lambda: self.prefill._route(
                    "prefill", (request,), {}, prefer_replica=pinned)))
        try:
            pref = await _aget(worker, pref_ref)
        except Exception as e:
            # the prefill replica died with our call on it: suspect-list
            # it so the outer retry routes around the corpse
            if sp_pref is not None:
                sp_pref.end(trh.ERROR, error_type=type(e).__name__)
            name = self.prefill.replica_of(pref_ref)
            if name:
                self.prefill.mark_suspect(name)
            raise
        if sp_pref is not None:
            sp_pref.end(prompt_len=pref.get("prompt_len"),
                        npages=pref.get("npages"))
        pos = 1                 # stream position incl. the first token
        if pos > skip:
            yield ("token", pref["first_token"])
        if pref.get("done"):
            yield ("summary", {
                "finish_reason": pref["finish_reason"],
                "num_tokens": 1, "prompt_len": pref["prompt_len"],
                "time_to_first_token_s":
                    pref["time_to_first_token_s"]})
            return
        deadline = time.monotonic() + self.pool_full_timeout_s
        backoff = 0.05
        while True:
            # one decode hop span per routed attempt (a pool-full
            # re-queue is a fresh attempt, possibly another replica)
            sp_dec = trh.open_span("decode", "hop", ctx=rctx)
            dctx = sp_dec.ctx() if sp_dec is not None else rctx
            gen = await loop.run_in_executor(
                None, trh.bind_ctx(
                    dctx, lambda: self.decode._route_streaming(
                        "decode", (pref["handoff"], request), {},
                        prefer_node=pref.get("node"))))
            try:
                async for item_ref in gen:
                    item = await _aget(worker, item_ref, timeout=60.0)
                    if "token" in item:
                        pos += 1
                        if pos > skip:
                            yield ("token", item["token"])
                    else:
                        item.setdefault(
                            "time_to_first_token_s",
                            pref["time_to_first_token_s"])
                        yield ("summary", item)
                if sp_dec is not None:
                    sp_dec.end(num_tokens=pos)
                return
            except Exception as e:
                if sp_dec is not None:
                    sp_dec.end(trh.ERROR, error_type=type(e).__name__)
                if not _is_pool_full(e):
                    # a death surfaced mid-stream: the submit succeeded,
                    # so the routing loop never saw it — suspect-list
                    # the replica before the outer retry re-routes
                    name = self.decode.replica_of(gen)
                    if name:
                        self.decode.mark_suspect(name)
                    raise
                if pos > 1 or time.monotonic() > deadline:
                    raise      # mid-stream pool-full can't happen; bail
                # decode pool momentarily full: re-queue the SAME
                # handoff (bounded backoff, p2c may pick another
                # replica) instead of wedging behind the pool
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)

    # -- convenience non-streaming API ---------------------------------
    async def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Aggregate a stream() into one result dict (tokens list +
        summary), the non-streaming client shape."""
        tokens: List[int] = []
        out: Dict[str, Any] = {}
        retries = 0
        async for item in self.stream(request):
            if "token" in item:
                tokens.append(item["token"])
            elif "retry" in item:
                retries = item["retry"]
            else:
                out = dict(item)
        out["tokens"] = tokens
        if retries:
            out["retries"] = retries
        return out

    def __repr__(self):
        return (f"DisaggHandle({self.prefill.deployment_name!r} -> "
                f"{self.decode.deployment_name!r})")


def _is_pool_full(e: BaseException) -> bool:
    """KVPoolFullError, possibly wrapped by the task-error path."""
    if isinstance(e, ray_tpu_torch.exceptions.KVPoolFullError):
        return True
    return "KVPoolFullError" in f"{type(e).__name__}: {e}"
