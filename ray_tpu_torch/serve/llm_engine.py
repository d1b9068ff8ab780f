"""Continuous-batching LLM inference engine, paged mode (counterpart of
ray_tpu/serve/llm_engine.py).

The design is the JAX engine's paged mode, run eagerly on one CUDA device:

  - KV lives in a shared page pool, one tensor per layer
    ``[num_pages, kv_heads, page_size, 2*head_dim]`` (K in ``[..., :hd]``,
    V in ``[..., hd:]``, the JAX layout), plus per-row block tables.
    Page 0 is a scratch page: table entries that are 0 point there, and
    padded rows, right-pad positions and stale slots write their garbage
    into it.
  - Prefill is SLOTLESS: a queued prompt is written straight into
    freshly allocated pages and its first token sampled before any decode
    slot frees.  Prompts sharing a power-of-two length bucket run as one
    wave, padded to the next of ``_WAVE_SIZES`` rows.  Prefilled
    requests wait in a ready queue holding their first token; a freeing
    slot installs one by uploading its (token, position, table) row.
  - One block step advances every row ``block_size`` tokens.  Decode
    state (tokens, positions, temperatures, tables) stays on the device
    between blocks; the host uploads only install and redirect rows.
  - One fetch per scheduling quantum, pipelined: block N+1 is dispatched
    before block N's tokens are read.  The block's ``[rows*K]`` tokens go
    to pinned host memory with ``non_blocking=True`` and a CUDA event;
    the host waits on that event only when it processes the quantum.
  - A freed slot keeps stepping junk over its old table until its
    redirect row (table -> scratch page 0) rides the next block.  Pages
    are recycled only through dispatches ordered after that junk on the
    one CUDA stream, so reuse never corrupts a live request.

Not ported yet (ROADMAP.md Queue 1 item 2): the dense slot mode
(``paged=False``), the prompt-prefix page cache, prefill handoffs
(``export_prefill``/``import_prefill``) and token streaming.

The host loop runs on its own thread and passes ``device`` explicitly
to everything it allocates; ``submit`` blocks from a plain thread and
returns an awaitable inside an event loop.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
import time
from typing import Any, Callable, List, Mapping, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.generate import init_decode_cache, sample_logits
from ray_tpu_torch.models.gpt import GPT

# prefill waves are padded to the next of these row counts
_WAVE_SIZES = (1, 2, 4, 8, 16, 32)

_NOT_PORTED = ("is not ported yet: ROADMAP.md Queue 1 item 2 (dense slot "
               "mode, prefix cache, prefill handoffs, streaming)")


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    finish_reason: str                    # "eos" | "length"
    prompt_len: int
    time_to_first_token_s: float
    latency_s: float


@dataclasses.dataclass
class _Request:
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    deliver: Callable[[bool, Any], None]
    on_token: Optional[Callable[[int], None]]
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    delivered: bool = False


class _Slot:
    __slots__ = ("request", "pos", "out", "last_token", "first_token_at",
                 "pages")

    def __init__(self, request: _Request, prompt_len: int, first_token: int,
                 pages: Optional[List[int]] = None):
        self.request = request
        self.pos = prompt_len            # next write position
        self.out = [first_token]
        self.last_token = first_token
        self.first_token_at = time.monotonic()
        self.pages = pages or []         # physical pages owned


class _Prefilled:
    """A request whose prompt K/V already sits in pool pages and whose
    first token is known, waiting for a decode slot."""

    __slots__ = ("slot_state", "table")

    def __init__(self, slot_state: _Slot, table: np.ndarray):
        self.slot_state = slot_state     # reused verbatim at install
        self.table = table               # np.int32 [max_pages]


class EngineStats:
    """Occupancy and throughput counters."""

    def __init__(self):
        # decode steps dispatched (rows-wide), counted at dispatch so the
        # trailing block that only steps junk rows is counted too
        self.steps = 0
        self.step_tokens = 0             # tokens delivered from steps
        self.tokens_generated = 0        # + prefill first tokens
        self.prefills = 0
        self.requests_completed = 0

    def occupancy(self, num_slots: int) -> float:
        """Fraction of step-slots that produced a delivered token."""
        return (self.step_tokens / (self.steps * num_slots)
                if self.steps else 0.0)


class _HostFetch:
    """One device->host copy in flight: pinned memory, ``non_blocking``,
    and an event recorded on the current stream; ``result`` waits on the
    event only."""

    def __init__(self, dev: torch.Tensor):
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))
        else:
            self._host, self._event = dev, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class LLMEngine:
    """Slot-scheduled paged-KV decoder around a GPT-family model.

    ``params_or_model``: the port's ``GPT``, or its state dict (for
    example from ``models.convert.params_from_jax``).  Parameters are
    cast to ``cfg.dtype`` once here, norm scales included, as the JAX
    engine does.  Runs on the card unless ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: TransformerConfig,
                 params_or_model: Union[GPT, Mapping[str, torch.Tensor]], *,
                 num_slots: int = 8, max_prompt_len: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 min_prefill_bucket: int = 16, block_size: int = 32,
                 max_seq_len: Optional[int] = None, paged: bool = True,
                 page_size: int = 64, kv_pool_pages: Optional[int] = None,
                 prefix_cache_pages: int = 0, device=None):
        if not paged:
            raise NotImplementedError(f"paged=False {_NOT_PORTED}")
        if prefix_cache_pages:
            raise NotImplementedError(f"prefix_cache_pages {_NOT_PORTED}")
        self.device = resolve_device(device)
        if max_seq_len is not None:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        self.cfg = cfg
        self.model = self._load_model(params_or_model)
        self.num_slots = num_slots
        self.top_k = top_k
        self.top_p = top_p
        self.max_prompt_len = max_prompt_len or cfg.max_seq_len // 2
        self._min_bucket = min_prefill_bucket
        self.block_size = block_size
        self.page_size = page_size
        self.max_pages = -(-cfg.max_seq_len // page_size)
        # page 0 is the scratch page; the default pool matches the HBM of
        # the dense engine's (num_slots + 1) full-length rows
        self.kv_pool_pages = (kv_pool_pages if kv_pool_pages
                              else 1 + (num_slots + 1) * self.max_pages)
        self.stats = EngineStats()

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._lock = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._free: List[int] = list(range(num_slots))[::-1]
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # +1 scratch row that is never scheduled
        self._rows = num_slots + 1
        self._pools = init_decode_cache(cfg, self.kv_pool_pages, page_size,
                                        device=self.device)
        self._init_state()
        self._free_pages: List[int] = list(
            range(1, self.kv_pool_pages))[::-1]
        self._ready: collections.deque = collections.deque()
        self._stale_slots: set = set()   # evicted, redirect pending

    def _load_model(self, params_or_model) -> GPT:
        """The engine's GPT in ``cfg.dtype`` on the engine's device.  A
        caller's GPT that already is both is shared as it is; any other
        is left untouched, and a new GPT loads a cast copy of its state
        dict, as the JAX engine casts into a new tree.  The caller's
        parameters, ``training`` flag and ``requires_grad`` never
        change."""
        cfg = self.cfg
        if isinstance(params_or_model, GPT):
            model = params_or_model
            if dataclasses.replace(model.cfg,
                                   max_seq_len=cfg.max_seq_len) != cfg:
                raise ValueError("model config differs from the engine's")
            if model.cfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"model rope tables cover {model.cfg.max_seq_len} "
                    f"positions < engine max_seq_len {cfg.max_seq_len}")
            tensors = [*model.parameters(), *model.buffers()]
            if all(t.device == self.device for t in tensors) and all(
                    p.dtype == cfg.dtype for p in model.parameters()):
                return model
            params_or_model = model.state_dict()
        model = GPT(cfg, device=self.device, dtype=cfg.dtype)
        model.load_state_dict(params_or_model)
        model.eval().requires_grad_(False)
        return model

    def _init_state(self) -> None:
        """Decode state on the device: per-row last token, position,
        temperature and block table (zeros -> every page is scratch)."""
        rows, dev = self._rows, self.device
        self._tokens = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._positions = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(rows, dtype=torch.float32, device=dev)
        self._tables = torch.zeros(rows, self.max_pages, dtype=torch.int32,
                                   device=dev)

    # ----------------------------------------------------- device steps

    def _sample(self, logits, temps):
        return sample_logits(logits, temperature=temps, top_k=self.top_k,
                             top_p=self.top_p, generator=self._gen)

    def _prefill(self, packed: torch.Tensor, bucket: int) -> torch.Tensor:
        """One prefill wave.  ``packed`` [wave, bucket + 2 + max_pages]
        int32: right-padded prompt | s_real | temp*1e6 | block table (one
        upload).  Writes the prompts' K/V into their pages and returns
        each row's first token, sampled from its last real position."""
        tokens = packed[:, :bucket]
        s_reals = packed[:, bucket].long()
        temps = packed[:, bucket + 1].float() / 1e6
        tables = packed[:, bucket + 2:]
        b = tokens.shape[0]
        positions = torch.arange(bucket, device=self.device).expand(b, bucket)
        hidden = self.model(tokens, positions, block_tables=tables,
                            kv_pools=self._pools, return_hidden=True)
        # The JAX engine projects every position to [wave, bucket, vocab]
        # fp32 logits and then picks each row's last real one.  Projecting
        # only that position is the same function without the big tensor
        # (8.4 GB at llama3-8b, wave 32 x bucket 512).
        last = hidden[torch.arange(b, device=self.device), s_reals - 1]
        return self._sample(self.model.head(last), temps)

    def _block_step(self) -> torch.Tensor:
        """``block_size`` decode steps over every row; returns the
        [rows * K] tokens, row-major."""
        k_steps = self.block_size
        out = torch.empty(self._rows, k_steps, dtype=torch.int32,
                          device=self.device)
        tokens, positions = self._tokens, self._positions
        for k in range(k_steps):
            logits = self.model(tokens[:, None], positions[:, None],
                                block_tables=self._tables,
                                kv_pools=self._pools)[:, -1]
            tokens = self._sample(logits, self._temps)
            out[:, k] = tokens
            positions = torch.clamp(positions + 1,
                                    max=self.cfg.max_seq_len - 1)
        self._tokens, self._positions = tokens, positions
        return out.reshape(-1)

    # ------------------------------------------------------------- public

    def warmup(self, prompt_lens=(64,)) -> None:
        """Run each prompt bucket once and one decode block, all into the
        scratch page, so the first request pays no kernel build or
        library initialisation.  Eager PyTorch compiles nothing per
        shape, so one wave size per bucket is enough.  Call it before
        submitting requests."""
        with torch.no_grad():
            for bucket in sorted({self._bucket(n) for n in prompt_lens}):
                packed = torch.zeros(1, bucket + 2 + self.max_pages,
                                     dtype=torch.int32, device=self.device)
                packed[:, bucket] = 1
                self._prefill(packed, bucket)
            self._block_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, prompt: List[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None):
        """Enqueue one generation request.

        From inside a running event loop returns an awaitable resolving
        to a GenerationResult; from a plain thread blocks and returns
        the result."""
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt len {len(prompt)} > max_prompt_len "
                             f"{self.max_prompt_len}")
        return self._submit_request(
            lambda deliver: _Request(list(prompt), max_new_tokens,
                                     temperature, eos_id, deliver, on_token),
            self._enqueue)

    def stream(self, *args, **kwargs):
        raise NotImplementedError(f"stream {_NOT_PORTED}")

    def export_prefill(self, *args, **kwargs):
        raise NotImplementedError(f"export_prefill {_NOT_PORTED}")

    def import_prefill(self, *args, **kwargs):
        raise NotImplementedError(f"import_prefill {_NOT_PORTED}")

    def stream_import(self, *args, **kwargs):
        raise NotImplementedError(f"stream_import {_NOT_PORTED}")

    def _submit_request(self, build, enqueue):
        """Build the queue item around a deliver callback, enqueue it,
        and return an awaitable (inside a running event loop) or block
        for the result."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            fut = loop.create_future()

            def deliver(ok, value, _loop=loop, _fut=fut):
                def _set():
                    if _fut.done():
                        return
                    (_fut.set_result if ok else _fut.set_exception)(value)
                _loop.call_soon_threadsafe(_set)

            enqueue(build(deliver))
            return fut
        ev = threading.Event()
        out: dict = {}

        def deliver(ok, value):
            out["ok" if ok else "err"] = value
            ev.set()

        enqueue(build(deliver))
        ev.wait()
        if "err" in out:
            raise out["err"]
        return out["ok"]

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -------------------------------------------------------- engine loop

    def _enqueue(self, req: _Request):
        with self._lock:
            if self._closed:
                raise RuntimeError("engine closed")
            self._pending.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                name="llm-engine",
                                                daemon=True)
                self._thread.start()
            self._lock.notify()

    def _bucket(self, n: int) -> int:
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.cfg.max_seq_len)

    def _wave_chunks(self, items: list):
        """Group (req, payload) pairs by prompt-length bucket and yield
        (bucket, chunk, wave_size) batches."""
        by_bucket: dict = {}
        for item in items:
            by_bucket.setdefault(self._bucket(len(item[0].prompt)),
                                 []).append(item)
        for bucket, group in by_bucket.items():
            for start in range(0, len(group), _WAVE_SIZES[-1]):
                chunk = group[start:start + _WAVE_SIZES[-1]]
                wave = next(w for w in _WAVE_SIZES if w >= len(chunk))
                yield bucket, chunk, wave

    def _safe_on_token(self, req: _Request, token: int):
        try:
            req.on_token(token)
        except Exception:       # user callback; never kills the loop
            pass

    @staticmethod
    def _safe_deliver(req: _Request, ok: bool, value) -> None:
        """Exactly-once, exception-proof completion."""
        if req.delivered:
            return
        req.delivered = True
        try:
            req.deliver(ok, value)
        except Exception:
            pass

    @staticmethod
    def _finish_reason(sl: _Slot, max_seq_len: int) -> Optional[str]:
        req = sl.request
        if req.eos_id is not None and sl.last_token == req.eos_id:
            return "eos"
        if len(sl.out) >= req.max_new_tokens:
            return "length"
        if sl.pos + 1 >= max_seq_len:
            return "length"
        return None

    def _deliver_result(self, sl: _Slot, reason: str) -> None:
        req = sl.request
        now = time.monotonic()
        result = GenerationResult(
            tokens=sl.out, finish_reason=reason,
            prompt_len=sl.pos - len(sl.out) + 1,
            time_to_first_token_s=sl.first_token_at - req.submitted_at,
            latency_s=now - req.submitted_at)
        self.stats.requests_completed += 1
        self._safe_deliver(req, True, result)

    def _maybe_finish(self, i: int) -> bool:
        sl = self._slots[i]
        reason = self._finish_reason(sl, self.cfg.max_seq_len)
        if reason is None:
            return False
        self._slots[i] = None
        self._free.append(i)
        # the freed slot junk-steps its old table until its redirect row
        # rides a block dispatch; pages recycle only through later
        # dispatches on the same stream, so an immediate free is safe
        self._stale_slots.add(i)
        self._free_pages.extend(sl.pages)
        sl.pages = []
        self._deliver_result(sl, reason)
        return True

    def _pages_needed(self, req: _Request) -> int:
        span = min(len(req.prompt) + req.max_new_tokens,
                   self.cfg.max_seq_len)
        return -(-span // self.page_size)

    def _loop(self):
        with torch.no_grad():
            self._loop_paged()

    def _loop_paged(self):
        """Each iteration (1) takes as many queued prompts as the pool
        allows and dispatches their prefill, (2) installs ready requests
        into free slots and dispatches the next block, (3) processes the
        PREVIOUS block's fetch, (4) reads this iteration's prefill first
        tokens.  TTFT is one prefill round trip, independent of slot
        turnover."""
        inflight = None       # (fetch, rows)
        while True:
            with self._lock:
                while (not self._closed and not self._pending
                       and not self._ready
                       and all(s is None for s in self._slots)
                       and inflight is None):
                    self._lock.wait()
                if self._closed:
                    victims = (
                        [s.request for s in self._slots if s is not None]
                        + [pf.slot_state.request for pf in self._ready]
                        + list(self._pending))
                    self._pending.clear()
                    self._ready.clear()
                    for req in victims:
                        self._safe_deliver(
                            req, False, RuntimeError("engine closed"))
                    return
                todo = []
                oversized = []
                while self._pending:
                    need = self._pages_needed(self._pending[0])
                    if need > self.kv_pool_pages - 1:
                        # can never fit: fail it rather than spin forever
                        oversized.append(self._pending.popleft())
                        continue
                    if need > len(self._free_pages):
                        break          # FIFO: no bypass, no starvation
                    req = self._pending.popleft()
                    todo.append((req, [self._free_pages.pop()
                                       for _ in range(need)]))
            for req in oversized:
                self._safe_deliver(req, False, ValueError(
                    f"request needs {self._pages_needed(req)} KV pages; "
                    f"pool holds {self.kv_pool_pages - 1}"))
            try:
                with self._lock:
                    installs = []
                    while self._free and self._ready:
                        installs.append((self._ready.popleft(),
                                         self._free.pop()))
                prefills = self._dispatch_prefill_waves(todo)
                nxt = self._dispatch_block_paged(installs)
                if inflight is not None:
                    self._process_block_paged(inflight)
                self._process_prefill_waves(prefills)
                inflight = nxt
            except Exception as e:   # engine-fatal (OOM, launch failure)
                with self._lock:
                    victims = (
                        [s.request for s in self._slots if s is not None]
                        + [pf.slot_state.request for pf in self._ready]
                        + [r for r, _ in todo]
                        + ([r for _, r in inflight[1]] if inflight else [])
                        + list(self._pending))
                    self._pending.clear()
                    self._ready.clear()
                    self._slots = [None] * self.num_slots
                    self._free = list(range(self.num_slots))[::-1]
                    self._free_pages = list(
                        range(1, self.kv_pool_pages))[::-1]
                    self._stale_slots.clear()
                inflight = None
                # fail the requests first: after a device fault the reset
                # below may raise too, and no submitter may be left waiting
                for req in victims:
                    self._safe_deliver(req, False, e)
                for pool in self._pools:
                    pool.zero_()
                self._init_state()

    def _dispatch_prefill_waves(self, todo: list):
        """Batch queued prompts into (bucket, wave) prefill calls that
        write straight into their reserved pages, and start one fetch of
        all their first tokens.  Returns (fetch, metas) or None."""
        firsts, metas = [], []
        for bucket, chunk, wave in self._wave_chunks(todo):
            packed = np.zeros((wave, bucket + 2 + self.max_pages), np.int32)
            packed[:, bucket] = 1         # pad rows: s_real 1, table -> 0
            for r, (req, pages) in enumerate(chunk):
                packed[r, :len(req.prompt)] = req.prompt
                packed[r, bucket] = len(req.prompt)
                packed[r, bucket + 1] = int(req.temperature * 1e6)
                packed[r, bucket + 2:bucket + 2 + len(pages)] = pages
                metas.append((req, pages,
                              packed[r, bucket + 2:].copy()))
            dev = torch.from_numpy(packed).to(self.device)
            firsts.append(self._prefill(dev, bucket)[:len(chunk)])
            self.stats.prefills += len(chunk)
        if not firsts:
            return None
        return _HostFetch(torch.cat(firsts)), metas

    def _process_prefill_waves(self, prefills) -> None:
        """Requests finish here if one token was all they wanted,
        otherwise they join the ready queue holding their first token."""
        if prefills is None:
            return
        fetch, metas = prefills
        for (req, pages, table), first in zip(metas, fetch.result()):
            self.stats.tokens_generated += 1
            sl = _Slot(req, len(req.prompt), int(first), pages)
            if req.on_token is not None:
                self._safe_on_token(req, int(first))
            reason = self._finish_reason(sl, self.cfg.max_seq_len)
            if reason is not None:
                # never installed, so nothing junk-steps these pages
                self._free_pages.extend(sl.pages)
                sl.pages = []
                self._deliver_result(sl, reason)
            else:
                with self._lock:
                    self._ready.append(_Prefilled(sl, table))

    def _dispatch_block_paged(self, installs: list):
        """Install ready requests into free slots (their last token and
        position are known to the host), attach redirect rows for stale
        slots, and dispatch one decode block.  Returns (fetch, rows) or
        None when no slot is active."""
        admit = []              # one row each: slot | last | pos | temp | table
        for pf, slot in installs:
            sl = pf.slot_state
            self._slots[slot] = sl
            self._stale_slots.discard(slot)   # reuse doubles as redirect
            admit.append(np.concatenate([
                np.array([slot, sl.last_token, sl.pos,
                          int(sl.request.temperature * 1e6)], np.int32),
                pf.table]))
        if all(s is None for s in self._slots):
            return None        # nothing to decode; redirects can wait
        for slot in sorted(self._stale_slots):
            if self._slots[slot] is None:
                # token 0, position 0, zero table -> scratch page
                row = np.zeros(4 + self.max_pages, np.int32)
                row[0] = slot
                admit.append(row)
                self._stale_slots.discard(slot)
        if admit:
            dev = torch.from_numpy(np.stack(admit)).to(self.device)
            slots = dev[:, 0].long()
            self._tokens[slots] = dev[:, 1]
            self._positions[slots] = dev[:, 2]
            self._temps[slots] = dev[:, 3].float() / 1e6
            self._tables[slots] = dev[:, 4:]
        block = self._block_step()
        self.stats.steps += self.block_size
        rows = [(i, s.request) for i, s in enumerate(self._slots)
                if s is not None]
        return _HostFetch(block), rows

    def _process_block_paged(self, quantum) -> None:
        fetch, rows = quantum
        host = fetch.result()              # the ONE fetch this quantum
        k_steps = self.block_size
        block = host.reshape(self._rows, k_steps)
        for i, req in rows:
            sl = self._slots[i]
            if sl is None or sl.request is not req:
                continue      # evicted earlier (or reused): junk row
            for k in range(k_steps):
                tok = int(block[i, k])
                sl.out.append(tok)
                sl.last_token = tok
                sl.pos += 1
                self.stats.step_tokens += 1
                self.stats.tokens_generated += 1
                if sl.request.on_token is not None:
                    self._safe_on_token(sl.request, tok)
                if self._maybe_finish(i):
                    break     # rest of the row is junk past eos
