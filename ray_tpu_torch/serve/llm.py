"""Serve deployment for LLM generation on GPU replicas (the port's copy
of ray_tpu/serve/llm.py).

The north-star serving shape (BASELINE.md: "Serve llama-3-8b"): each
replica owns one LLMEngine on its card (serve/llm_engine.py, continuous
batching over KV-cache slots) and an async ``__call__`` that admits the
request and awaits its completion — concurrent Serve requests interleave
at token granularity inside one replica, and `num_replicas` scales
across cards/hosts like any other deployment.

Reference analog: `python/ray/serve` has no LLM-aware deployment; its
LLM benchmarks drive plain replicas.

What differs from ray_tpu's copy: a replica runs on the card it leased
(``num_gpus``) unless ``device="cpu"`` is passed, and raises without
one; random weights are the port's ``GPT`` in fp32 filled by
``init_weights`` (the engine keeps only its ``cfg.dtype`` copy); a
checkpoint may hold the port's state dict or a JAX parameter tree of
numpy arrays (``models/convert.py`` ``params_from_jax``); a handoff's
``kv`` is a torch tensor, which the int8 wire codec carries through an
fp32 view and restores in its recorded dtype.

Usage::

    from ray_tpu_torch import serve
    app = serve.llm.build_app(preset="gpt-small", num_slots=8)
    handle = serve.run(app)
    out = ray_tpu_torch.get(handle.remote({"prompt": [1, 2, 3],
                                     "max_new_tokens": 16}))
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.serve.deployment import deployment
from ray_tpu_torch.util.tracing import tracing_helper as trh

# Disaggregated-serving telemetry (docs/serve_disagg.md): per-pool
# latency families ("prefill"/"decode" pool labels; "colocated" for a
# classic single-pool replica) + handoff movement cost by stage.
_M_TTFT = rtm.histogram_family(
    "ray_tpu_serve_ttft_ms",
    "LLM time-to-first-token per pool (ms): submit -> first sampled "
    "token on the serving replica", tag_key="pool")
_M_TPOT = rtm.histogram_family(
    "ray_tpu_serve_tpot_ms",
    "LLM inter-token latency per pool (ms/token past the first)",
    tag_key="pool")
_M_HANDOFF_BYTES = rtm.histogram_family(
    "ray_tpu_serve_handoff_bytes",
    "paged-KV handoff object size per stage (export=gather+put, "
    "import=pull+scatter)", tag_key="stage",
    boundaries=(1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20,
                1 << 22, 1 << 24, 1 << 26, 1 << 28))
_M_HANDOFF_MS = rtm.histogram_family(
    "ray_tpu_serve_handoff_ms",
    "paged-KV handoff latency per stage (ms): export_gather (device "
    "gather+fetch), export_put (store publish), import_pull (transfer-"
    "plane fetch), import_admit (upload+remap until decode-ready)",
    tag_key="stage")
_M_HANDOFF_SAVED = rtm.counter(
    "ray_tpu_serve_handoff_saved_bytes",
    "cross-host KV handoff bytes NOT shipped thanks to the int8 wire "
    "codec (raw - encoded, serve_handoff_quantize)")

# one int8 wire-codec block size for both handoff endpoints: encode and
# decode must derive identical segmentation (quant.py wire layout)
_QUANT_BLOCK = 256


def _encode_handoff(h):
    """Swap a PrefillHandoff's raw KV tensor for its int8 wire encoding
    (block-scaled symmetric, collective/quant.py): ~3.9x fewer bytes
    cross the object store + transfer plane per handoff.  The codec
    reads an fp32 view (a bf16 pool included); ``kv_dtype`` records the
    pool's dtype under ray_tpu's names ("bfloat16", "float32")."""
    from ray_tpu_torch.util.collective.quant import get_codec
    raw = h.kv
    h.kv = get_codec("int8", _QUANT_BLOCK).encode(
        raw.detach().to("cpu", torch.float32).numpy())
    h.codec = "int8"
    h.kv_shape = tuple(raw.shape)
    h.kv_dtype = str(raw.dtype).removeprefix("torch.")
    h.raw_nbytes = raw.numel() * raw.element_size()
    return h


def _decode_handoff(h):
    """Inverse of ``_encode_handoff``: restore the raw KV layout, as a
    torch tensor of the recorded dtype, before the decode engine imports
    it (the engine never sees wire bytes)."""
    from ray_tpu_torch.util.collective.quant import get_codec
    nelem = 1
    for dim in h.kv_shape:
        nelem *= int(dim)
    vals = get_codec(h.codec, _QUANT_BLOCK).decode(h.kv, nelem, np.float32)
    h.kv = torch.from_numpy(vals).to(getattr(torch, h.kv_dtype)).reshape(
        h.kv_shape)
    h.codec = None
    return h


def _record_handoff_event(stage: str, object_hex: str, nbytes: int,
                          dur_ms: float, **extra) -> None:
    """HANDOFF timeline slice (docs/observability.md): rides a synthetic
    ``handoff-<object>`` record like collective ops ride ``col-*`` —
    stamped with THIS process's node/worker ids so export and import
    slices land on their own pools' rows in Perfetto."""
    try:
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        w = get_global_worker()
        w.events.record(
            f"handoff-{object_hex[:16]}", "HANDOFF", name="kv_handoff",
            stage=stage, bytes=int(nbytes),
            dur_ms=round(float(dur_ms), 3), node_id=w.node_id,
            worker_id=w.worker_id.hex(), **extra)
    except Exception:
        pass  # observability only; never fails the request path


def _state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``params`` as the port's state dict: kept as it is
    when every value is a tensor, else read as a JAX parameter tree of
    numpy arrays (what ray_tpu's checkpoints hold)."""
    if all(torch.is_tensor(v) for v in params.values()):
        return params
    from ray_tpu_torch.models.convert import params_from_jax
    return params_from_jax(params, cfg)


class LLMServer:
    """Replica class: one engine per replica, admission via async call.

    ``checkpoint``: optional checkpoint directory (``air.Checkpoint``
    dict or torch form) holding ``params``: the port's state dict (what
    a trainer's ``Checkpoint.from_torch`` writes), or a JAX
    parameter tree of numpy arrays as ray_tpu's checkpoints hold it;
    absent means randomly initialized weights from ``seed``
    (shape-correct perf benchmarking without a weights file).

    ``device``: where the engine runs; None means the card this replica
    leased (``num_gpus``), and raises without one.  Pass ``"cpu"`` to
    serve on the CPU (the tests).

    ``role``: ``"colocated"`` (default — one engine prefills AND
    decodes), ``"prefill"`` (serves ``prefill()`` handoff exports only)
    or ``"decode"`` (admits handoffs via ``decode()``, never prefills).
    The split pools of a ``disaggregated=True`` app (docs/
    serve_disagg.md); both split roles force ``paged=True``.
    """

    def __init__(self, preset: str = "tiny", *, num_slots: int = 8,
                 checkpoint: Optional[str] = None,
                 max_prompt_len: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 block_size: int = 32, max_seq_len: Optional[int] = None,
                 warmup_prompt_lens: Optional[list] = None,
                 warmup_burst: int = 0,
                 paged: bool = False, page_size: int = 64,
                 kv_pool_pages: Optional[int] = None,
                 role: str = "colocated",
                 # deliberately SHORTER than DisaggHandle's
                 # pool_full_timeout_s (30s): the replica absorbs brief
                 # page pressure in-process, then the rejection escapes
                 # so the router can try another replica with pool
                 # headroom — equal timeouts would make the re-route
                 # path unreachable
                 import_retry_s: float = 5.0,
                 import_queue_max: Optional[int] = None,
                 prefix_cache_pages: Optional[int] = None,
                 _upstream: Any = None,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models.configs import get_config
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown LLMServer role {role!r}")
        self.role = role
        self.import_retry_s = import_retry_s
        del _upstream   # deploy-ordering anchor only (build_app)
        if role != "colocated":
            paged = True      # handoff is defined on the paged pool
        cfg = get_config(preset, **(config_overrides or {}))
        dev = resolve_device(device)
        params = self._load_params(cfg, checkpoint, seed, dev)
        if prefix_cache_pages is None:
            prefix_cache_pages = CONFIG.serve_prefix_cache_pages
        self.engine = LLMEngine(cfg, params, num_slots=num_slots,
                                max_prompt_len=max_prompt_len,
                                top_k=top_k, top_p=top_p, seed=seed,
                                block_size=block_size,
                                max_seq_len=max_seq_len, paged=paged,
                                page_size=page_size,
                                kv_pool_pages=kv_pool_pages,
                                import_queue_max=import_queue_max,
                                prefix_cache_pages=prefix_cache_pages,
                                device=dev)
        # the engine holds its cfg.dtype copy; the loaded (fp32) one goes
        del params
        # exported handoff objects are owned by THIS replica: freeing
        # the last owner-side ref frees the object, so each ref is
        # pinned for a TTL comfortably beyond any decode retry deadline
        # (expired pins are swept on later prefill calls).  Memory is
        # bounded by in-flight handoffs x TTL — the inherent floor: the
        # object must outlive its pull.
        self._handoff_pins: collections.deque = collections.deque()
        self._handoff_pin_ttl_s = 180.0
        if role == "decode":
            # per-wave host-side remap cost (upload + scatter dispatch)
            self.engine.on_import_admit = (
                lambda ms: _M_HANDOFF_MS.observe("import_admit", ms))
        if warmup_prompt_lens:
            # pay all compiles at replica start, none at request time
            # (warmup_burst additionally compiles the paged engine's
            # saturation-burst fetch shapes — see LLMEngine.warmup)
            self.engine.warmup(prompt_lens=warmup_prompt_lens,
                               burst=warmup_burst)

    @staticmethod
    def _load_params(cfg, checkpoint: Optional[str], seed: int, device):
        """The weights the engine loads: a state dict from the
        checkpoint, or the port's ``GPT`` in ``cfg.param_dtype`` (fp32,
        as ray_tpu inits its leaves) on ``device`` with random weights
        from ``seed``."""
        from ray_tpu_torch.models.convert import init_weights
        from ray_tpu_torch.models.gpt import GPT
        if checkpoint:
            from ray_tpu_torch.air.checkpoint import Checkpoint
            ckpt = Checkpoint.from_directory(checkpoint)
            state = (ckpt.to_torch() if ckpt.has_torch_state()
                     else ckpt.to_dict())
            for key in ("params", "model_params"):
                if key in state:
                    return _state_dict(state[key], cfg)
            raise ValueError(
                f"checkpoint at {checkpoint} has no 'params' entry "
                f"(keys: {sorted(state)})")
        model = GPT(cfg, device=device, dtype=cfg.param_dtype)
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
        return model

    @staticmethod
    async def _chain_first(first, agen):
        yield first
        async for item in agen:
            yield item

    def _observe_latency(self, ttft_s: float, latency_s: float,
                         ntokens: int) -> None:
        _M_TTFT.observe(self.role, ttft_s * 1e3)
        if ntokens > 1:
            _M_TPOT.observe(self.role,
                            (latency_s - ttft_s) * 1e3 / (ntokens - 1))

    async def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        prompt = request["prompt"]
        result = await self.engine.submit(
            prompt,
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"))
        self._observe_latency(result.time_to_first_token_s,
                              result.latency_s, len(result.tokens))
        return {
            "tokens": result.tokens,
            "finish_reason": result.finish_reason,
            "prompt_len": result.prompt_len,
            "time_to_first_token_s": result.time_to_first_token_s,
            "latency_s": result.latency_s,
        }

    # ------------------------------------------ disaggregated pool methods

    async def prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Prefill-pool entrypoint: run slotless paged prefill, export
        the request's KV pages + sampled first token as ONE handoff
        object published via ``ray_tpu_torch.put`` (the pull engine moves
        it to the decode pool zero-copy / multi-source striped), and
        return the ref + routing metadata.  ``done=True`` short-circuits
        requests that finished at their first token — no handoff ships.
        """
        import ray_tpu_torch
        from ray_tpu_torch.runtime.core_worker import get_global_worker

        t0 = time.monotonic()
        h = await self.engine.export_prefill(
            request["prompt"],
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"))
        ttft_s = time.monotonic() - t0
        self._observe_latency(ttft_s, ttft_s, 1)
        if h.finish_reason is not None:
            return {"done": True, "first_token": h.first_token,
                    "finish_reason": h.finish_reason,
                    "prompt_len": h.prompt_len,
                    "time_to_first_token_s": ttft_s}
        # optional int8 wire quantization (docs/serve_frontdoor.md):
        # encode BEFORE the store publish so both the put and the
        # cross-host pull move ~4x fewer bytes; the decode replica
        # restores the raw layout before import
        if CONFIG.serve_handoff_quantize and h.kv is not None:
            h = _encode_handoff(h)
            _M_HANDOFF_SAVED.inc(h.raw_nbytes - h.nbytes)
        t1 = time.monotonic()
        ref = ray_tpu_torch.put(h)
        put_ms = (time.monotonic() - t1) * 1e3
        # handoff-export hop in the request's trace (the actor-call
        # execution span is the parent): gather+fetch+publish cost
        trh.instant_span("handoff_export", "handoff",
                         dur_ms=h.export_ms + put_ms,
                         bytes=h.nbytes, npages=h.npages)
        # the ref pin keeps the object alive (we own it) until the
        # decode pool pulled a copy; expired pins sweep FIFO (also from
        # autoscale_load so an idle replica doesn't retain its last
        # burst's KV objects forever)
        self._sweep_handoff_pins()
        self._handoff_pins.append(
            (time.monotonic() + self._handoff_pin_ttl_s, ref))
        _M_HANDOFF_BYTES.observe("export", h.nbytes)
        _M_HANDOFF_MS.observe("export_gather", h.export_ms)
        _M_HANDOFF_MS.observe("export_put", put_ms)
        _record_handoff_event("export", ref.id.hex(), h.nbytes,
                              h.export_ms + put_ms, npages=h.npages)
        return {"handoff": ref, "first_token": h.first_token,
                "prompt_len": h.prompt_len, "npages": h.npages,
                "nbytes": h.nbytes,
                "node": get_global_worker().node_id,
                "time_to_first_token_s": ttft_s}

    async def decode(self, handoff: Any, request: Dict[str, Any]):
        """Decode-pool entrypoint (async generator, reached via
        ``handle.decode.remote_streaming``): pull the handoff object off
        the transfer plane, admit it straight into a decode slot
        (page-table remap, no prefill), and stream each decoded token,
        then a summary dict.

        Pool-full admission is retried HERE first (in-process: an
        engine re-enqueue costs microseconds) for up to
        ``import_retry_s`` — under saturation most rejections are
        transient page pressure, and bouncing each one back through a
        fresh routed streaming call costs ~1000x more (the re-queue
        storm shows up directly as lost decode tokens/s on a shared
        host).  Only a PERSISTENTLY full pool escapes as
        KVPoolFullError for the router to re-queue elsewhere."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import KVPoolFullError
        from ray_tpu_torch.serve.llm_engine import GenerationResult, \
            PrefillHandoff

        pull_ms = 0.0
        if not isinstance(handoff, PrefillHandoff):
            # an ObjectRef: fetch via the pull engine (multi-source
            # striped, zero-copy landing), off the replica's event loop.
            # The handoff-pull hop span wraps the whole fetch; bind_ctx
            # carries the request's trace onto the executor thread so
            # the transfer engine's own pull span nests under it.
            sp_pull = trh.open_span("handoff_pull", "hop")
            t0 = time.monotonic()
            loop = asyncio.get_running_loop()
            ref = handoff
            handoff = await loop.run_in_executor(
                None, trh.bind_ctx(
                    sp_pull.ctx() if sp_pull is not None else None,
                    lambda: ray_tpu_torch.get(ref, timeout=60.0)))
            pull_ms = (time.monotonic() - t0) * 1e3
            if sp_pull is not None:
                sp_pull.end(bytes=handoff.nbytes, npages=handoff.npages)
            _M_HANDOFF_BYTES.observe("import", handoff.nbytes)
            _M_HANDOFF_MS.observe("import_pull", pull_ms)
            _record_handoff_event("import", ref.id.hex(),
                                  handoff.nbytes, pull_ms,
                                  npages=handoff.npages)
        if getattr(handoff, "codec", None):
            # quantized wire handoff: restore the raw KV array (the
            # engine's import path scatters the pool layout verbatim)
            handoff = _decode_handoff(handoff)
        # import-wait hop: admission into a decode slot (page-table
        # remap, plus any pool-full backoff) — the "import wait" budget
        # line of a traced request
        sp_admit = trh.open_span("import_wait", "hop")
        deadline = time.monotonic() + self.import_retry_s
        backoff = 0.02
        while True:
            agen = self.engine.stream_import(handoff)
            try:
                first = await agen.__anext__()
                if sp_admit is not None:
                    sp_admit.end(npages=handoff.npages)
                break
            except KVPoolFullError:
                if time.monotonic() >= deadline:
                    if sp_admit is not None:
                        sp_admit.end(trh.ERROR,
                                     error_type="KVPoolFullError")
                    raise
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 0.5)
            except StopAsyncIteration:
                if sp_admit is not None:
                    sp_admit.end()
                return
        # TPOT clock starts at admission, AFTER any pool-full wait:
        # queue time must not masquerade as inter-token latency
        start = time.monotonic()
        async for item in self._chain_first(first, agen):
            if isinstance(item, GenerationResult):
                # TTFT belongs to the prefill pool; decode owns TPOT
                if len(item.tokens) > 1:
                    _M_TPOT.observe(self.role,
                                    (time.monotonic() - start) * 1e3
                                    / (len(item.tokens) - 1))
                yield {
                    "finish_reason": item.finish_reason,
                    "num_tokens": len(item.tokens),
                    "prompt_len": handoff.prompt_len,
                    "handoff_pull_ms": round(pull_ms, 3),
                    "latency_s": item.latency_s,
                }
                return
            yield {"token": int(item)}

    async def stream(self, request: Dict[str, Any]):
        """Token-streaming entrypoint: an async generator yielding one
        ``{"token": id}`` dict per generated token as it is decoded,
        then a final summary dict.  Reached via
        ``handle.stream.remote_streaming(request)`` — the Serve handle
        submits the replica's streaming path with
        ``num_returns="streaming"``, so the caller's first item lands
        before decode finishes (time-to-first-token, not
        time-to-last)."""
        from ray_tpu_torch.serve.llm_engine import GenerationResult
        async for item in self.engine.stream(
                request["prompt"],
                max_new_tokens=int(request.get("max_new_tokens", 32)),
                temperature=float(request.get("temperature", 0.0)),
                eos_id=request.get("eos_id")):
            if isinstance(item, GenerationResult):
                self._observe_latency(item.time_to_first_token_s,
                                      item.latency_s, len(item.tokens))
                yield {
                    "finish_reason": item.finish_reason,
                    "num_tokens": len(item.tokens),
                    "prompt_len": item.prompt_len,
                    "time_to_first_token_s": item.time_to_first_token_s,
                    "latency_s": item.latency_s,
                }
            else:
                yield {"token": int(item)}

    def stats(self) -> Dict[str, Any]:
        out = self.engine.stats.snapshot(self.engine.num_slots)
        out["role"] = self.role
        return out

    def advertised_prefixes(self) -> Optional[Dict[str, Any]]:
        """Resident prompt-prefix digests for the replica metrics path
        (docs/serve_frontdoor.md): the controller republishes these on
        get_targets so handles prefix-affinity-route the prefill hop.
        None (advertise nothing) when the engine's prefix cache is
        off."""
        if not getattr(self.engine, "prefix_cache_pages", 0):
            return None
        return {"page_size": self.engine.page_size,
                "digests": self.engine.prefix_digests()}

    def _sweep_handoff_pins(self) -> None:
        now = time.monotonic()
        while self._handoff_pins and self._handoff_pins[0][0] <= now:
            self._handoff_pins.popleft()

    def autoscale_load(self):
        """Per-pool scaling signal read by the replica's get_metrics ->
        controller (serve/controller.py _autoscale).  A decode pool
        scales off DECODE-SLOT PRESSURE (busy slots + admitted handoffs
        waiting for one) — its in-flight request count undercounts
        demand when streams are consumer-paced and overcounts when
        slots turn over faster than clients drain.  A prefill pool
        returns None: every in-flight ``prefill()`` call IS a queued-or-
        running engine prefill (it resolves the instant the handoff
        leaves the engine), so the replica's ongoing-request count
        already equals prefill-queue depth exactly.

        Doubles as the idle-time housekeeping hook (health checks call
        it every couple of seconds): expired handoff pins are swept
        here so a quiet prefill replica releases its last burst's KV
        objects."""
        self._sweep_handoff_pins()
        if self.role == "decode":
            ls = self.engine.load_snapshot()
            return float(ls["busy_slots"] + ls["ready"] + ls["imports"])
        return None


def build_app(preset: str = "tiny", *, num_replicas: int = 1,
              max_concurrent_queries: int = 64, num_gpus: float = 0,
              autoscaling_config: Optional[Dict[str, Any]] = None,
              disaggregated: bool = False,
              prefill_replicas: int = 1,
              prefill_autoscaling: Optional[Dict[str, Any]] = None,
              prefill_server_kwargs: Optional[Dict[str, Any]] = None,
              **server_kwargs):
    """Deployment-bound application for serve.run().

    ``num_gpus``: cards each replica leases; fractions share one card
    (the raylet fits them on the fullest card that has room).  MUST be
    > 0 to serve on the card — a replica with no GPU lease sees
    ``CUDA_VISIBLE_DEVICES=""`` (raylet._gpu_env), and LLMServer with
    ``device=None`` raises there rather than serve on the CPU.  CPU
    tests keep 0 and pass ``device="cpu"``.

    ``autoscaling_config``: queue-depth replica autoscaling (min/max
    replicas, target_num_ongoing_requests_per_replica, up/downscale
    delays — serve/config.py AutoscalingConfig).  Each LLM replica owns
    a full engine, so scaling 1->2 doubles both KV pool and card
    demand; the BASELINE.md north-star pairs this with pod-slice
    autoscaling at the cluster layer.

    ``disaggregated=True`` materializes TWO pools instead of one
    (docs/serve_disagg.md): ``llm-<preset>-prefill`` (prefill_replicas,
    ``prefill_autoscaling``, ``prefill_server_kwargs`` overrides) and
    ``llm-<preset>-decode`` (``num_replicas`` / ``autoscaling_config``
    / ``server_kwargs``), each autoscaled independently off its own
    signal (LLMServer.autoscale_load).  Route through
    ``disagg_handle(preset)`` — the returned app's root is the decode
    pool, with the prefill pool deployed as its dependency."""
    if not disaggregated:
        dep = deployment(
            LLMServer, name=f"llm-{preset}", num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            autoscaling_config=autoscaling_config,
            ray_actor_options={"num_gpus": num_gpus} if num_gpus else None)
        return dep.bind(preset, **server_kwargs)
    actor_opts = {"num_gpus": num_gpus} if num_gpus else None
    pkw = dict(server_kwargs)
    pkw.update(prefill_server_kwargs or {})
    pkw.update(role="prefill", paged=True)
    dkw = dict(server_kwargs)
    dkw.update(role="decode", paged=True)
    prefill_dep = deployment(
        LLMServer, name=f"llm-{preset}-prefill",
        num_replicas=prefill_replicas,
        max_concurrent_queries=max_concurrent_queries,
        autoscaling_config=prefill_autoscaling,
        ray_actor_options=actor_opts)
    decode_dep = deployment(
        LLMServer, name=f"llm-{preset}-decode",
        num_replicas=num_replicas,
        max_concurrent_queries=max_concurrent_queries,
        autoscaling_config=autoscaling_config,
        ray_actor_options=actor_opts)
    # the prefill app rides as a (ignored) init dependency so one
    # serve.run deploys both pools; run it WITHOUT a name override or
    # disagg_handle() won't find the canonical deployment names
    return decode_dep.bind(
        preset, _upstream=prefill_dep.bind(preset, **pkw), **dkw)


def disagg_handle(preset: str = "tiny"):
    """Client-side prefill->decode router for a ``disaggregated=True``
    app deployed by serve.run (serve/handle.py DisaggHandle): streams
    the first token as soon as the prefill pool samples it, then the
    decode pool's tokens; handles KV-pool-full re-queueing and replica-
    death mid-stream retries."""
    from ray_tpu_torch.serve.handle import DisaggHandle
    return DisaggHandle(f"llm-{preset}-prefill", f"llm-{preset}-decode")
