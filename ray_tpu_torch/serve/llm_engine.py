"""Continuous-batching LLM inference engine (counterpart of
ray_tpu/serve/llm_engine.py), run eagerly on one CUDA device.

Iteration-level scheduling over a fixed grid of ``num_slots`` decode
rows plus one scratch row that is never scheduled:

  - One block step advances every row ``block_size`` tokens.  Decode
    state (tokens, positions, temperatures; block tables in paged mode)
    stays on the device between blocks; the host uploads only admission
    and redirect rows.
  - One fetch per scheduling quantum, pipelined: block N+1 is dispatched
    before block N's tokens are read.  The tokens go to pinned host
    memory with ``non_blocking=True`` and a CUDA event; the host waits
    on that event only when it processes the quantum.
  - No eos logic on the device: rows that finish mid-block generate
    junk the host truncates.

DENSE MODE (``paged=False``, the default, as in the reference): each
layer keeps one cache row of ``max_seq_len`` positions per slot
(``models/generate.py`` ``init_dense_cache``; the model's
``_decode_attend`` writes at per-row positions under a position mask,
so every row sits at its own offset).  Admission runs per wave: prompts
sharing a power-of-two length bucket prefill as one batch into a fresh
cache, and their K/V is inserted into their slots' rows; padded wave
rows write into the scratch row.  Their first tokens are scattered into
the decode state on the device and come back with the block that starts
them, in the same fetch.  A freed slot steps junk until it is reused.

PAGED MODE (``paged=True``):

  - KV lives in a shared page pool, one tensor per layer
    ``[num_pages, kv_heads, page_size, 2*head_dim]`` (K in ``[..., :hd]``,
    V in ``[..., hd:]``, the JAX layout), plus per-row block tables.
    Page 0 is a scratch page: table entries that are 0 point there, and
    padded rows, right-pad positions and stale slots write their garbage
    into it.
  - Prefill is SLOTLESS: a queued prompt is written straight into
    freshly allocated pages and its first token sampled before any
    decode slot frees.  Prefilled requests wait in a ready queue holding
    their first token; a freeing slot installs one by uploading its
    (token, position, table) row.
  - A freed slot keeps stepping junk over its old table until its
    redirect row (table -> scratch page 0) rides the next block.  Pages
    are recycled only through dispatches ordered after that junk on the
    one CUDA stream, so reuse never corrupts a live request.
  - Prompt-prefix cache (``prefix_cache_pages``): the full prompt pages
    of a finished request stay out of the free list, keyed by their
    chained digests (``serve/frontdoor/prefix.py``).  A later prompt
    that starts with them borrows them read-only and prefills only its
    suffix (the model's ``prefix_attend`` path).
  - Prefill handoffs: ``export_prefill`` prefills without a slot and
    gathers the prompt's pages into one host tensor (``PrefillHandoff``);
    ``import_prefill`` on another engine scatters them into its own
    pages and queues the request for decode with its first token known.

The reference runs prefill, the dense decode attention, the suffix
prefill, sampling and the page gathers and scatters as XLA programs,
outside any Pallas kernel, so they are plain PyTorch here.  The paged
decode attention is kernel K4 (``ops/paged_attention.py``).

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
from ray_tpu_torch.exceptions import KVPoolFullError
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.generate import (init_decode_cache,
                                           init_dense_cache, sample_logits)
from ray_tpu_torch.models.gpt import GPT
from ray_tpu_torch.serve.frontdoor.prefix import page_digests

# prefill waves are padded to the next of these row counts
_WAVE_SIZES = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    finish_reason: str                    # "eos" | "length"
    prompt_len: int
    time_to_first_token_s: float
    latency_s: float


@dataclasses.dataclass
class PrefillHandoff:
    """A prefilled request packaged for decode on ANOTHER engine.

    ``kv`` holds the request's prompt pages gathered into one host
    tensor ``[n_pool_leaves, npages, kv_heads, page_size, 2*head_dim]``
    (one pool leaf per layer; K/V fused as the pool stores them), in the
    pool's dtype.  ``import_prefill`` also takes a JAX engine's handoff,
    whose ``kv`` is a numpy array (bfloat16 included).  Only
    ``ceil(prompt_len / page_size)`` pages ship: the first generated
    token's K/V is written by the importer's first decode step.  ``kv``
    is None when the request finished at its first token
    (``finish_reason`` set)."""

    kv: Optional[Any]
    page_size: int
    npages: int
    prompt_len: int
    first_token: int
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    finish_reason: Optional[str] = None   # set: done at first token
    export_ms: float = 0.0                # prefill->gather->fetch wall
    # wire-codec fields, kept for the serving layer: with ``codec`` set,
    # ``kv`` holds the encoded uint8 wire buffer and shape / dtype /
    # raw_nbytes describe the original array; the engine only ever sees
    # the raw layout
    codec: Optional[str] = None
    kv_shape: Optional[tuple] = None
    kv_dtype: Optional[str] = None
    raw_nbytes: int = 0

    @property
    def nbytes(self) -> int:
        return int(self.kv.nbytes) if self.kv is not None else 0


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
    export: bool = False                  # deliver a PrefillHandoff
    # chained page-boundary digests of the prompt, computed at submit
    # when the prefix cache is on
    digests: Optional[List[str]] = None


@dataclasses.dataclass
class _Import:
    """A PrefillHandoff waiting for pool pages.  ``need`` counts the
    pages of the whole generation span; ``kv`` is the handoff's pages as
    a host tensor."""
    handoff: PrefillHandoff
    request: _Request
    need: int
    kv: torch.Tensor


class _Slot:
    __slots__ = ("request", "pos", "out", "last_token", "first_token_at",
                 "pages", "prompt_len", "borrowed", "prefix_entry")

    def __init__(self, request: _Request, prompt_len: int, first_token: int,
                 pages: Optional[List[int]] = None, borrowed: int = 0,
                 prefix_entry=None):
        self.request = request
        self.pos = prompt_len            # next write position
        self.out = [first_token]
        self.last_token = first_token
        self.first_token_at = time.monotonic()
        self.pages = pages or []         # paged mode: physical pages held
        self.prompt_len = prompt_len
        # prefix-cache hit: the first ``borrowed`` pages are shared
        # read-only pages of ``prefix_entry``, released by refcount
        self.borrowed = borrowed
        self.prefix_entry = prefix_entry


class _PrefixEntry:
    """A retained run of full prompt pages, shared read-only across
    hits.  ``chain[i]`` digests the tokens ``pages[:i+1]`` hold."""

    __slots__ = ("pages", "chain", "refs", "last_used")

    def __init__(self, pages: List[int], chain: List[str]):
        self.pages = pages
        self.chain = chain
        self.refs = 0
        self.last_used = 0


class _Prefilled:
    """Paged mode: a request whose prompt K/V already sits in pool pages
    and whose first token is known, waiting for a decode slot."""

    __slots__ = ("slot_state", "table")

    def __init__(self, slot_state: _Slot, table: np.ndarray):
        self.slot_state = slot_state     # reused verbatim at install
        self.table = table               # np.int32 [max_pages]


class EngineStats:
    """Occupancy, throughput, handoff and prefix-cache counters."""

    def __init__(self):
        # decode steps dispatched (rows-wide), counted at dispatch so the
        # trailing block that only steps junk rows is counted too
        self.steps = 0
        self.step_tokens = 0             # tokens delivered from steps
        self.tokens_generated = 0        # + prefill first tokens
        self.prefills = 0
        self.requests_completed = 0
        self.exports = 0                 # prefill handoffs shipped out
        self.imports = 0                 # prefill handoffs admitted
        self.import_rejects = 0          # import queue full
        self.prefix_hits = 0             # prefills served from cached pages
        self.prefix_misses = 0           # cache on but no usable match
        self.prefix_tokens_saved = 0     # prompt tokens not re-prefilled
        self.prefix_evictions = 0        # retained runs evicted

    def occupancy(self, num_slots: int) -> float:
        """Fraction of step-slots that produced a delivered token."""
        return (self.step_tokens / (self.steps * num_slots)
                if self.steps else 0.0)

    def snapshot(self, num_slots: int) -> dict:
        """The counters as a dict, keyed as ray_tpu's engine keys them
        (what a Serve replica's ``stats()`` returns)."""
        return {
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "requests_completed": self.requests_completed,
            "batch_occupancy": round(self.occupancy(num_slots), 4),
            "exports": self.exports,
            "imports": self.imports,
            "import_rejects": self.import_rejects,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefix_evictions": self.prefix_evictions,
        }


class _HostFetch:
    """One device->host copy in flight: pinned memory, ``non_blocking``,
    and an event recorded on the current stream; ``result`` waits on the
    event only and returns the host tensor."""

    def __init__(self, dev: torch.Tensor):
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype,
                                     pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))
        else:
            self._host, self._event = dev, None

    def result(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host


def _host_tensor(kv) -> torch.Tensor:
    """A handoff's pages as a CPU tensor: the port's own, or a JAX
    engine's numpy array (ml_dtypes' bfloat16 read through its bits)."""
    if torch.is_tensor(kv):
        return kv.cpu()
    a = np.array(kv)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class LLMEngine:
    """Slot-scheduled KV-cache decoder around a GPT-family model.

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
                 max_seq_len: Optional[int] = None, paged: bool = False,
                 page_size: int = 64, kv_pool_pages: Optional[int] = None,
                 import_queue_max: Optional[int] = None,
                 prefix_cache_pages: int = 0, device=None):
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
        self.paged = paged
        self.page_size = page_size
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
        # prompt-prefix cache; all mutation happens on the loop thread,
        # _prefix_lock only makes the maps readable from other threads
        # (prefix_digests).  Retained pages are in neither _free_pages
        # nor any slot.
        self._prefix_lock = threading.Lock()
        self._prefix_index: dict = {}    # digest -> (_PrefixEntry, n)
        # deepest digest -> entry, insertion-ordered for LRU
        self._prefix_entries: collections.OrderedDict = \
            collections.OrderedDict()
        self._prefix_pages_used = 0
        self._prefix_seq = 0
        self.prefix_cache_pages = 0
        if paged:
            self.max_pages = -(-cfg.max_seq_len // page_size)
            # page 0 is the scratch page; the default pool matches the
            # HBM of the dense engine's (num_slots + 1) full-length rows
            self.kv_pool_pages = (kv_pool_pages if kv_pool_pages
                                  else 1 + (num_slots + 1) * self.max_pages)
            self._free_pages: List[int] = list(
                range(1, self.kv_pool_pages))[::-1]
            self._ready: collections.deque = collections.deque()
            self._stale_slots: set = set()   # evicted, redirect pending
            self._imports: collections.deque = collections.deque()
            # beyond this many waiting imports, import_prefill raises
            # KVPoolFullError synchronously; None queues without bound
            self.import_queue_max = import_queue_max
            # optional observer of each admitted import's share of its
            # scatter's host wall time (ms)
            self.on_import_admit: Optional[Callable[[float], None]] = None
            # handoff layout: one pool leaf per layer (JAX's _ltot)
            self._ltot = cfg.n_layers
            self._pool_tail = (cfg.n_kv_heads, page_size, 2 * cfg.head_dim)
            # the budget never exceeds the pool minus one working page
            self.prefix_cache_pages = max(
                0, min(int(prefix_cache_pages), self.kv_pool_pages - 2))
        self._cache = self._init_cache()
        self._init_state()

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

    def _init_cache(self) -> List[torch.Tensor]:
        if self.paged:
            return init_decode_cache(self.cfg, self.kv_pool_pages,
                                     self.page_size, device=self.device)
        return init_dense_cache(self.cfg, self._rows, device=self.device)

    def _init_state(self) -> None:
        """Decode state on the device: per-row last token, position,
        temperature and, paged, block table (zeros -> scratch page)."""
        rows, dev = self._rows, self.device
        self._tokens = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._positions = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(rows, dtype=torch.float32, device=dev)
        if self.paged:
            self._tables = torch.zeros(rows, self.max_pages,
                                       dtype=torch.int32, device=dev)

    # ----------------------------------------------------- device steps

    def _sample(self, logits, temps):
        return sample_logits(logits, temperature=temps, top_k=self.top_k,
                             top_p=self.top_p, generator=self._gen)

    def _first_tokens(self, hidden, s_reals, temps) -> torch.Tensor:
        # The JAX engine projects every position to [wave, bucket, vocab]
        # fp32 logits and then picks each row's last real one.  Projecting
        # only that position is the same function without the big tensor
        # (8.4 GB at llama3-8b, wave 32 x bucket 512).
        last = hidden[torch.arange(hidden.shape[0], device=self.device),
                      s_reals - 1]
        return self._sample(self.model.head(last), temps)

    def _prefill_dense(self, packed: torch.Tensor,
                       bucket: int) -> torch.Tensor:
        """One dense admission wave.  ``packed`` [wave, bucket + 3]
        int32: right-padded prompt | s_real | slot | temp*1e6 (one
        upload).  Prefills into a fresh cache of the wave's rows, inserts
        each row's first ``bucket`` positions into its slot's row (pad
        rows carry the scratch row), and returns each row's first token,
        sampled from its last real position.  Keys past a prompt are
        masked by position, so a fresh cache of ``bucket`` positions
        gives what JAX's fresh full-length rows give."""
        tokens = packed[:, :bucket]
        s_reals = packed[:, bucket].long()
        slots = packed[:, bucket + 1].long()
        temps = packed[:, bucket + 2].float() / 1e6
        b = tokens.shape[0]
        fresh = init_dense_cache(self.cfg, b, device=self.device,
                                 seq_len=bucket)
        positions = torch.arange(bucket, device=self.device).expand(b, bucket)
        hidden = self.model(tokens, positions, kv_cache=fresh,
                            return_hidden=True)
        for layer, pre in zip(self._cache, fresh):
            layer[:, slots, :bucket] = pre
        return self._first_tokens(hidden, s_reals, temps)

    def _prefill_paged(self, packed: torch.Tensor, bucket: int,
                       prefix_attend: bool) -> torch.Tensor:
        """One slotless prefill wave.  ``packed`` [wave, bucket + 3 +
        max_pages] int32: right-padded tokens | s_real | temp*1e6 |
        offset | block table (one upload).  Writes the tokens' K/V into
        their pages and returns each row's first token.  With
        ``prefix_attend`` each row's window starts at its offset (a
        page-aligned cached prefix whose borrowed pages lead its table)
        and attends back through the pool."""
        tokens = packed[:, :bucket]
        s_reals = packed[:, bucket].long()
        temps = packed[:, bucket + 1].float() / 1e6
        offsets = packed[:, bucket + 2].long()
        tables = packed[:, bucket + 3:]
        positions = offsets[:, None] + torch.arange(bucket,
                                                    device=self.device)
        hidden = self.model(tokens, positions, block_tables=tables,
                            kv_pools=self._cache, return_hidden=True,
                            prefix_attend=prefix_attend)
        return self._first_tokens(hidden, s_reals, temps)

    def _block_step(self) -> torch.Tensor:
        """``block_size`` decode steps over every row; returns the
        [rows * K] tokens, row-major."""
        kv = (dict(block_tables=self._tables, kv_pools=self._cache)
              if self.paged else dict(kv_cache=self._cache))
        k_steps = self.block_size
        out = torch.empty(self._rows, k_steps, dtype=torch.int32,
                          device=self.device)
        tokens, positions = self._tokens, self._positions
        for k in range(k_steps):
            logits = self.model(tokens[:, None], positions[:, None],
                                **kv)[:, -1]
            tokens = self._sample(logits, self._temps)
            out[:, k] = tokens
            positions = torch.clamp(positions + 1,
                                    max=self.cfg.max_seq_len - 1)
        self._tokens, self._positions = tokens, positions
        return out.reshape(-1)

    # ------------------------------------------------------------- public

    def warmup(self, prompt_lens=(64,), burst: int = 0) -> None:
        """Run each prompt bucket once and one decode block, all into the
        scratch row or page, so the first request pays no kernel build
        or library initialisation.  Eager PyTorch compiles nothing per
        shape, so one wave size per bucket is enough.  Call it before
        submitting requests.

        ``burst`` (paged mode, as in ray_tpu): then push that many
        1-token dummy requests of ``max(prompt_lens)`` tokens through
        the live loop at once.  They count in the stats as any request
        does."""
        with torch.no_grad():
            for bucket in sorted({self._bucket(n) for n in prompt_lens}):
                if self.paged:
                    packed = torch.zeros(1, bucket + 3 + self.max_pages,
                                         dtype=torch.int32,
                                         device=self.device)
                    packed[:, bucket] = 1
                    self._prefill_paged(packed, bucket, False)
                else:
                    packed = torch.zeros(1, bucket + 3, dtype=torch.int32,
                                         device=self.device)
                    packed[:, bucket] = 1
                    packed[:, bucket + 1] = self.num_slots   # scratch row
                    self._prefill_dense(packed, bucket)
            self._block_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if burst and self.paged:
            plen = max(prompt_lens)

            async def _burst():
                futs = [self.submit([7] * plen, max_new_tokens=1)
                        for _ in range(burst)]
                await asyncio.gather(*futs)

            # submit() returns a future only inside a running loop, and
            # asyncio.run() raises inside one (an async serve replica
            # warming up from a coroutine): drive the burst from a
            # helper thread with its own loop there
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                asyncio.run(_burst())
            else:
                out: dict = {}

                def _runner():
                    try:
                        asyncio.run(_burst())
                    except BaseException as e:  # noqa: BLE001
                        out["err"] = e

                t = threading.Thread(target=_runner,
                                     name="llm-warmup-burst")
                t.start()
                t.join()
                if "err" in out:
                    raise out["err"]

    def _check_prompt(self, prompt: List[int]) -> None:
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt len {len(prompt)} > max_prompt_len "
                             f"{self.max_prompt_len}")

    def submit(self, prompt: List[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None):
        """Enqueue one generation request.

        From inside a running event loop returns an awaitable resolving
        to a GenerationResult; from a plain thread blocks and returns
        the result."""
        self._check_prompt(prompt)
        digests = (page_digests(prompt, self.page_size)
                   if self.prefix_cache_pages else None)
        return self._submit_request(
            lambda deliver: _Request(list(prompt), max_new_tokens,
                                     temperature, eos_id, deliver, on_token,
                                     digests=digests),
            self._enqueue)

    async def stream(self, prompt: List[int], *, max_new_tokens: int = 32,
                     temperature: float = 0.0,
                     eos_id: Optional[int] = None):
        """Async-generator submit: yields each generated token id in the
        scheduling quantum it is decoded, then the GenerationResult as
        the last item.  Token callbacks fire on the engine thread and are
        bridged onto the calling event loop; completion is delivered
        after them on the same loop, so the result follows its tokens."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(tok: int) -> None:
            loop.call_soon_threadsafe(q.put_nowait, ("token", int(tok)))

        fut = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_id=eos_id,
                          on_token=on_token)
        fut.add_done_callback(lambda f: q.put_nowait(("done", f)))
        seen = 0
        while True:
            kind, val = await q.get()
            if kind == "token":
                seen += 1
                yield val
                continue
            result = val.result()   # done already; raises engine errors
            # backstop: a token whose bridge lost the race with
            # completion still reaches the consumer, in order
            for tok in result.tokens[seen:]:
                yield int(tok)
            yield result
            return

    # ------------------------------------------- disaggregated handoffs

    def export_prefill(self, prompt: List[int], *,
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       eos_id: Optional[int] = None):
        """Prefill-only submit: run slotless paged prefill, sample the
        first token, then gather the request's pages into one host
        tensor and free them; the request never takes a decode slot
        here.  Resolves to a PrefillHandoff that ``import_prefill`` on
        another engine admits straight into decode.  Loop-aware like
        ``submit``."""
        if not self.paged:
            raise RuntimeError("export_prefill requires paged=True")
        self._check_prompt(prompt)
        digests = (page_digests(prompt, self.page_size)
                   if self.prefix_cache_pages else None)
        return self._submit_request(
            lambda deliver: _Request(list(prompt), max_new_tokens,
                                     temperature, eos_id, deliver, None,
                                     export=True, digests=digests),
            self._enqueue)

    def import_prefill(self, handoff: PrefillHandoff, *,
                       on_token: Optional[Callable[[int], None]] = None):
        """Admit a PrefillHandoff exported elsewhere: allocate pool pages
        for the whole generation span, scatter the shipped prompt K/V
        into them, and queue the request for a decode slot with its
        first token known; no prefill runs here.  Resolves to the
        GenerationResult (``tokens[0]`` is the handoff's first token;
        ``on_token`` fires only for tokens decoded here).

        Admission is FIFO like pending prefills: an import whose pages
        are not free yet waits.  KVPoolFullError is raised synchronously
        only when ``import_queue_max`` is set and the wait queue is
        full."""
        if not self.paged:
            raise RuntimeError("import_prefill requires paged=True")
        h = handoff
        if h.finish_reason is not None:
            raise ValueError("handoff already finished at its first "
                             "token; nothing to decode")
        if h.page_size != self.page_size:
            raise ValueError(f"handoff page_size {h.page_size} != engine "
                             f"page_size {self.page_size}")
        kv = _host_tensor(h.kv)
        if (kv.dim() != 5 or kv.shape[0] != self._ltot
                or kv.shape[1] != h.npages
                or tuple(kv.shape[2:]) != self._pool_tail):
            raise ValueError(
                f"handoff kv shape {tuple(kv.shape)} does not match this "
                f"engine's pool layout [{self._ltot}, {h.npages}, "
                f"{self._pool_tail}]: engines must share the model "
                "config and page_size")
        if h.prompt_len >= self.cfg.max_seq_len:
            raise ValueError(
                f"handoff prompt_len {h.prompt_len} >= this engine's "
                f"max_seq_len {self.cfg.max_seq_len}")
        span = min(h.prompt_len + h.max_new_tokens, self.cfg.max_seq_len)
        need = -(-span // self.page_size)
        if h.npages > need or h.npages > self.max_pages:
            raise ValueError(
                f"handoff ships {h.npages} pages but this engine's "
                f"span allows {min(need, self.max_pages)}")
        if need > self.kv_pool_pages - 1:
            raise ValueError(
                f"handoff needs {need} KV pages; pool holds "
                f"{self.kv_pool_pages - 1}")

        def build(deliver):
            req = _Request([], h.max_new_tokens, h.temperature, h.eos_id,
                           deliver, on_token)
            return _Import(h, req, need, kv)

        def enqueue(imp):
            with self._lock:
                if self._closed:
                    raise RuntimeError("engine closed")
                if (self.import_queue_max is not None
                        and len(self._imports) >= self.import_queue_max):
                    self.stats.import_rejects += 1
                    raise KVPoolFullError(
                        f"import wait queue full ({len(self._imports)} >= "
                        f"{self.import_queue_max}); "
                        f"{len(self._free_pages)} pages free of "
                        f"{self.kv_pool_pages - 1}")
                self._imports.append(imp)
                self._start_loop()

        return self._submit_request(build, enqueue)

    async def stream_import(self, handoff: PrefillHandoff):
        """Async-generator import: yields each token decoded here (not
        the handoff's first token, which the exporting side already
        streamed), then the GenerationResult."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(tok: int) -> None:
            loop.call_soon_threadsafe(q.put_nowait, ("token", int(tok)))

        fut = self.import_prefill(handoff, on_token=on_token)
        fut.add_done_callback(lambda f: q.put_nowait(("done", f)))
        seen = 0
        while True:
            kind, val = await q.get()
            if kind == "token":
                seen += 1
                yield val
                continue
            result = val.result()   # done already; raises engine errors
            # tokens[0] is the handoff's first token; backstop any decoded
            # token whose bridge lost the race with completion
            for tok in result.tokens[1 + seen:]:
                yield int(tok)
            yield result
            return

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

    def load_snapshot(self) -> dict:
        """Queue and occupancy counts feeding per-pool autoscaling
        (serve/replica.py get_metrics -> controller): a prefill pool
        scales off queue depth, a decode pool off slot/ready occupancy."""
        with self._lock:
            return {
                "pending": len(self._pending),
                "imports": len(self._imports) if self.paged else 0,
                "ready": len(self._ready) if self.paged else 0,
                "busy_slots": self.num_slots - len(self._free),
                "free_pages": (len(self._free_pages) if self.paged
                               else 0),
                "pool_pages": self.kv_pool_pages if self.paged else 0,
                "prefix_pages_cached": (self._prefix_pages_used
                                        if self.paged else 0),
                "prefix_entries": (len(self._prefix_entries)
                                   if self.paged else 0),
            }

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -------------------------------------------------------- engine loop

    def _start_loop(self) -> None:
        """Start the loop thread if it is not running (lock held)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="llm-engine", daemon=True)
            self._thread.start()
        self._lock.notify()

    def _enqueue(self, req: _Request):
        with self._lock:
            if self._closed:
                raise RuntimeError("engine closed")
            self._pending.append(req)
            self._start_loop()

    def _bucket(self, n: int) -> int:
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.cfg.max_seq_len)

    def _wave_chunks(self, items: list, length: Callable[[Any], int]):
        """Group items by the bucket of ``length(item)`` tokens and yield
        (bucket, chunk, wave_size) batches."""
        by_bucket: dict = {}
        for item in items:
            by_bucket.setdefault(self._bucket(length(item)), []).append(item)
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
        if self.paged:
            # the freed slot junk-steps its old table until its redirect
            # row rides a block dispatch; pages recycle only through
            # later dispatches on the same stream, so an immediate free
            # is safe.  Junk writes advance past the prompt span, so
            # retained prefix pages are never touched.
            self._stale_slots.add(i)
            self._prefix_release(sl)
        self._deliver_result(sl, reason)
        return True

    def _process_rows(self, block: np.ndarray, rows) -> None:
        """Deliver one block's [rows, K] tokens to the rows' requests,
        truncating each row at its finish."""
        for i, req in rows:
            sl = self._slots[i]
            if sl is None or sl.request is not req:
                continue      # evicted earlier (or reused): junk row
            for tok in block[i].tolist():
                sl.out.append(tok)
                sl.last_token = tok
                sl.pos += 1
                self.stats.step_tokens += 1
                self.stats.tokens_generated += 1
                if sl.request.on_token is not None:
                    self._safe_on_token(sl.request, tok)
                if self._maybe_finish(i):
                    break     # rest of the row is junk past eos

    def _loop(self):
        with torch.no_grad():
            if self.paged:
                self._loop_paged()
            else:
                self._loop_dense()

    # ------------------------------------------------ dense engine loop

    def _loop_dense(self):
        """Pipelined: quantum k+1 is dispatched before quantum k's
        tokens are read and processed, so the device never idles on the
        host's fetch or bookkeeping.  The price is a one-block admission
        and eviction lag, which the request-identity checks in
        ``_process_rows`` make safe."""
        inflight = None       # (fetch, admitted, rows)
        while True:
            with self._lock:
                while (not self._closed and not self._pending
                       and all(s is None for s in self._slots)
                       and inflight is None):
                    self._lock.wait()
                if self._closed:
                    victims = ([s.request for s in self._slots
                                if s is not None]
                               + ([r for r, _ in inflight[1]]
                                  if inflight else [])
                               + list(self._pending))
                    self._pending.clear()
                    for req in victims:
                        self._safe_deliver(
                            req, False, RuntimeError("engine closed"))
                    return
                admits = []
                while self._pending and self._free:
                    admits.append((self._pending.popleft(),
                                   self._free.pop()))
            try:
                nxt = self._dispatch_quantum(admits, inflight)
                if inflight is not None:
                    self._process_quantum(inflight)
                inflight = nxt
            except Exception as e:   # engine-fatal (OOM, launch failure)
                with self._lock:
                    victims = ([s.request for s in self._slots
                                if s is not None]
                               + [r for r, _ in admits]
                               + ([r for r, _ in inflight[1]]
                                  if inflight else [])
                               + list(self._pending))
                    self._pending.clear()
                    self._slots = [None] * self.num_slots
                    self._free = list(range(self.num_slots))[::-1]
                inflight = None
                # fail the requests first: after a device fault the reset
                # below may raise too, and no submitter may be left waiting
                for req in victims:
                    self._safe_deliver(req, False, e)
                for layer in self._cache:
                    layer.zero_()
                self._init_state()

    def _dispatch_quantum(self, admits: list, inflight):
        """Prefill this quantum's admissions wave by wave, scatter their
        first tokens, positions and temperatures into the decode state,
        and dispatch one block.  Returns (fetch of [block | first
        tokens], admitted, rows) or None when nothing runs.  ``rows``
        snapshots the (slot, request) pairs this block carries, the
        previous quantum's admissions included: they decode on the
        device but reach ``_slots`` only when processed."""
        admitted, firsts = [], []
        for bucket, chunk, wave in self._wave_chunks(
                admits, lambda a: len(a[0].prompt)):
            packed = np.zeros((wave, bucket + 3), np.int32)
            packed[:, bucket] = 1
            packed[:, bucket + 1] = self.num_slots    # pad rows: scratch
            for r, (req, slot) in enumerate(chunk):
                packed[r, :len(req.prompt)] = req.prompt
                packed[r, bucket] = len(req.prompt)
                packed[r, bucket + 1] = slot
                packed[r, bucket + 2] = int(req.temperature * 1e6)
            dev = torch.from_numpy(packed).to(self.device)
            firsts.append(self._prefill_dense(dev, bucket)[:len(chunk)])
            admitted.extend(chunk)
            self.stats.prefills += len(chunk)
        rows = [(i, s.request) for i, s in enumerate(self._slots)
                if s is not None]
        if inflight is not None:
            rows += [(slot, req) for req, slot in inflight[1]]
        rows += [(slot, req) for req, slot in admitted]
        if not rows:
            return None
        block_parts = []
        if admitted:
            meta = torch.from_numpy(np.array(
                [[slot, len(req.prompt), int(req.temperature * 1e6)]
                 for req, slot in admitted], np.int32)).to(self.device)
            a_firsts = torch.cat(firsts)
            slots = meta[:, 0].long()
            self._tokens[slots] = a_firsts
            self._positions[slots] = meta[:, 1]
            self._temps[slots] = meta[:, 2].float() / 1e6
            block_parts.append(a_firsts)
        block = self._block_step()
        self.stats.steps += self.block_size
        return (_HostFetch(torch.cat([block] + block_parts)), admitted,
                rows)

    def _process_quantum(self, quantum) -> None:
        fetch, admitted, rows = quantum
        host = fetch.result().numpy()      # the ONE fetch this quantum
        n = self._rows * self.block_size
        for (req, slot), first in zip(admitted, host[n:].tolist()):
            self._finish_admit(req, slot, first)
        self._process_rows(host[:n].reshape(self._rows, self.block_size),
                           rows)

    def _finish_admit(self, req: _Request, slot: int, first: int):
        self.stats.tokens_generated += 1
        self._slots[slot] = _Slot(req, len(req.prompt), first)
        if req.on_token is not None:
            self._safe_on_token(req, first)
        # a 1-token request (or instant eos) finishes without stepping
        self._maybe_finish(slot)

    # ------------------------------------------------ prompt-prefix cache

    def prefix_digests(self, limit: int = 64) -> List[str]:
        """Boundary digests of retained prefix runs, newest entries
        first: what a replica advertises to prefix-aware routers."""
        if not self.prefix_cache_pages:
            return []
        out: List[str] = []
        with self._prefix_lock:
            for entry in reversed(self._prefix_entries.values()):
                take = entry.chain[:len(entry.pages)]
                rest = max(0, limit - len(out))
                out.extend(take[-rest:] if rest < len(take) else take)
                if len(out) >= limit:
                    break
        return out[:limit]

    def _prefix_lookup(self, req: _Request):
        """The deepest retained run covering a page-aligned prefix of
        ``req.prompt`` (loop thread, engine lock held), as (entry,
        cover_pages), or None.  The hit leaves at least one suffix token
        to prefill (it samples the first token), and the padded suffix
        window must fit max_seq_len."""
        digests = req.digests
        if not digests or not self.prefix_cache_pages:
            return None
        # never borrow the page holding the last prompt token
        max_cover = (len(req.prompt) - 1) // self.page_size
        with self._prefix_lock:
            for i in range(min(len(digests), max_cover) - 1, -1, -1):
                found = self._prefix_index.get(digests[i])
                if found is None:
                    continue
                entry, cover = found
                cover = min(cover, max_cover, len(entry.pages))
                if cover <= 0:
                    continue
                suffix = len(req.prompt) - cover * self.page_size
                if (cover * self.page_size + self._bucket(suffix)
                        > self.cfg.max_seq_len):
                    continue   # padded window would overflow the span
                entry.refs += 1
                self._prefix_seq += 1
                entry.last_used = self._prefix_seq
                self._prefix_entries.move_to_end(entry.chain[-1])
                return entry, cover
        return None

    def _prefix_drop_locked(self, key: str, entry: _PrefixEntry) -> int:
        """Evict one idle entry: its digests leave the index and its
        pages return to the free list.  Caller holds _prefix_lock."""
        for d in entry.chain:
            if self._prefix_index.get(d, (None,))[0] is entry:
                del self._prefix_index[d]
        self._prefix_entries.pop(key, None)
        n = len(entry.pages)
        self._prefix_pages_used -= n
        self._free_pages.extend(entry.pages)
        entry.pages = []
        self.stats.prefix_evictions += 1
        return n

    def _prefix_evict_locked(self, need: int) -> bool:
        """Evict refs == 0 entries, oldest first, until ``need`` budget
        pages are free.  Caller holds _prefix_lock; loop thread only."""
        if need > self.prefix_cache_pages:
            return False
        victims = [(k, e) for k, e in self._prefix_entries.items()
                   if e.refs == 0]
        for key, entry in victims:
            if self._prefix_pages_used + need <= self.prefix_cache_pages:
                break
            self._prefix_drop_locked(key, entry)
        return self._prefix_pages_used + need <= self.prefix_cache_pages

    def _prefix_reclaim(self, need_free: int) -> None:
        """Admission pressure valve (loop thread, engine lock held): the
        FIFO head needs ``need_free`` pages the free list lacks, so idle
        retained runs are evicted rather than wedging admission."""
        if not self.prefix_cache_pages:
            return
        with self._prefix_lock:
            freed = 0
            for key, entry in list(self._prefix_entries.items()):
                if freed >= need_free:
                    break
                if not entry.refs:
                    freed += self._prefix_drop_locked(key, entry)

    def _prefix_retain(self, sl: _Slot) -> int:
        """Move a finishing slot's leading full prompt pages into the
        cache (loop thread).  Returns how many of ``sl.pages`` the cache
        took; 0 when retention is off, the prompt spans no full page,
        the run is cached already, or the budget cannot fit it."""
        req = sl.request
        if (not self.prefix_cache_pages or not req.digests
                or sl.borrowed):
            return 0
        n_full = min(sl.prompt_len // self.page_size, len(req.digests),
                     len(sl.pages))
        if n_full <= 0:
            return 0
        chain = req.digests[:n_full]
        with self._prefix_lock:
            known = self._prefix_index.get(chain[-1])
            if known is not None and known[1] >= n_full:
                return 0                    # already resident
            if not self._prefix_evict_locked(n_full):
                return 0
            entry = _PrefixEntry(sl.pages[:n_full], chain)
            self._prefix_seq += 1
            entry.last_used = self._prefix_seq
            for i, d in enumerate(chain):
                self._prefix_index[d] = (entry, i + 1)
            self._prefix_entries[chain[-1]] = entry
            self._prefix_entries.move_to_end(chain[-1])
            self._prefix_pages_used += n_full
        return n_full

    def _prefix_release(self, sl: _Slot) -> None:
        """Free a paged slot's pages with prefix accounting: borrowed
        pages go back to their entry (refcount), owned pages are offered
        to retention first, the rest return to the pool."""
        kept = self._prefix_retain(sl)
        self._free_pages.extend(sl.pages[max(kept, sl.borrowed):])
        if sl.prefix_entry is not None:
            with self._prefix_lock:
                sl.prefix_entry.refs -= 1
            sl.prefix_entry = None
        sl.pages = []
        sl.borrowed = 0

    def _prefix_reset(self) -> None:
        """Engine-fatal recovery: the pool was rebuilt, so every retained
        page id is meaningless; drop the cache wholesale."""
        with self._prefix_lock:
            self._prefix_index.clear()
            self._prefix_entries.clear()
            self._prefix_pages_used = 0

    # ------------------------------------------------ paged engine loop

    def _pages_needed(self, req: _Request) -> int:
        if req.export:
            # prefill-only: it holds its prompt's pages until the export
            # gather frees them (the importer allocates the whole span)
            return -(-len(req.prompt) // self.page_size)
        span = min(len(req.prompt) + req.max_new_tokens,
                   self.cfg.max_seq_len)
        return -(-span // self.page_size)

    def _loop_paged(self):
        """Each iteration (1) takes as many imports and queued prompts
        as the pool allows, scatters the imports and dispatches the
        prompts' prefill (prefix-cache hits as suffix waves), (2)
        installs ready requests into free slots and dispatches the next
        block, (3) processes the PREVIOUS block's fetch, (4) reads this
        iteration's first tokens and ships exports.  TTFT is one prefill
        round trip, independent of slot turnover."""
        inflight = None       # (fetch, rows)
        while True:
            with self._lock:
                while (not self._closed and not self._pending
                       and not self._imports and not self._ready
                       and all(s is None for s in self._slots)
                       and inflight is None):
                    self._lock.wait()
                if self._closed:
                    victims = (
                        [s.request for s in self._slots if s is not None]
                        + [pf.slot_state.request for pf in self._ready]
                        + [imp.request for imp in self._imports]
                        + list(self._pending))
                    self._pending.clear()
                    self._ready.clear()
                    self._imports.clear()
                    for req in victims:
                        self._safe_deliver(
                            req, False, RuntimeError("engine closed"))
                    return
                # imports first, FIFO: the head waits for pages and
                # nothing bypasses it; idle retained prefixes yield
                import_todo = []
                while self._imports:
                    short = self._imports[0].need - len(self._free_pages)
                    if short > 0:
                        self._prefix_reclaim(short)
                    if self._imports[0].need > len(self._free_pages):
                        break
                    imp = self._imports.popleft()
                    import_todo.append((imp, [self._free_pages.pop()
                                              for _ in range(imp.need)]))
                todo, hits, oversized = [], [], []
                while self._pending:
                    need = self._pages_needed(self._pending[0])
                    if need > self.kv_pool_pages - 1:
                        # can never fit: fail it rather than spin forever
                        oversized.append(self._pending.popleft())
                        continue
                    hit = self._prefix_lookup(self._pending[0])
                    fresh = need - (hit[1] if hit else 0)
                    if fresh > len(self._free_pages):
                        self._prefix_reclaim(fresh - len(self._free_pages))
                    if fresh > len(self._free_pages):
                        if hit is not None:
                            with self._prefix_lock:
                                hit[0].refs -= 1
                        break          # FIFO: no bypass, no starvation
                    req = self._pending.popleft()
                    pages = [self._free_pages.pop() for _ in range(fresh)]
                    if hit is not None:
                        entry, cover = hit
                        self.stats.prefix_hits += 1
                        self.stats.prefix_tokens_saved += \
                            cover * self.page_size
                        hits.append((req, entry.pages[:cover] + pages,
                                     cover, entry))
                    else:
                        if self.prefix_cache_pages and req.digests:
                            self.stats.prefix_misses += 1
                        todo.append((req, pages, 0, None))
            for req in oversized:
                self._safe_deliver(req, False, ValueError(
                    f"request needs {self._pages_needed(req)} KV pages; "
                    f"pool holds {self.kv_pool_pages - 1}"))
            try:
                # scatter imports before taking installs: an import can
                # land in a free slot this same iteration, and the block
                # is dispatched after the scatter in stream order
                self._dispatch_import_waves(import_todo)
                with self._lock:
                    installs = []
                    while self._free and self._ready:
                        installs.append((self._ready.popleft(),
                                         self._free.pop()))
                prefills = self._fetch_prefills(
                    self._dispatch_prefill_waves(todo, False)
                    + self._dispatch_prefill_waves(hits, True))
                nxt = self._dispatch_block_paged(installs)
                if inflight is not None:
                    self._process_block_paged(inflight)
                self._process_exports(self._process_prefill_waves(prefills))
                inflight = nxt
            except Exception as e:   # engine-fatal (OOM, launch failure)
                with self._lock:
                    victims = (
                        [s.request for s in self._slots if s is not None]
                        + [pf.slot_state.request for pf in self._ready]
                        + [item[0] for item in todo + hits]
                        + [imp.request for imp, _ in import_todo]
                        + [imp.request for imp in self._imports]
                        + ([r for _, r in inflight[1]] if inflight else [])
                        + list(self._pending))
                    self._pending.clear()
                    self._ready.clear()
                    self._imports.clear()
                    self._slots = [None] * self.num_slots
                    self._free = list(range(self.num_slots))[::-1]
                    self._free_pages = list(
                        range(1, self.kv_pool_pages))[::-1]
                    self._stale_slots.clear()
                self._prefix_reset()
                inflight = None
                # fail the requests first: after a device fault the reset
                # below may raise too, and no submitter may be left waiting
                for req in victims:
                    self._safe_deliver(req, False, e)
                for pool in self._cache:
                    pool.zero_()
                self._init_state()

    def _dispatch_prefill_waves(self, items: list,
                                prefix_attend: bool) -> list:
        """Batch (req, pages, cover, entry) items by the bucket of the
        tokens they prefill (the prompt past its ``cover`` borrowed
        pages) into slotless prefill waves that write straight into
        their pages.  Returns [(first tokens on the device, metas)]."""
        ps = self.page_size
        waves = []
        for bucket, chunk, wave in self._wave_chunks(
                items, lambda it: len(it[0].prompt) - it[2] * ps):
            packed = np.zeros((wave, bucket + 3 + self.max_pages), np.int32)
            packed[:, bucket] = 1        # pad rows: s_real 1, table -> 0
            metas = []
            for r, (req, pages, cover, entry) in enumerate(chunk):
                suffix = req.prompt[cover * ps:]
                packed[r, :len(suffix)] = suffix
                packed[r, bucket] = len(suffix)
                packed[r, bucket + 1] = int(req.temperature * 1e6)
                packed[r, bucket + 2] = cover * ps
                packed[r, bucket + 3:bucket + 3 + len(pages)] = pages
                metas.append((req, pages, packed[r, bucket + 3:].copy(),
                              cover, entry))
            dev = torch.from_numpy(packed).to(self.device)
            waves.append((self._prefill_paged(dev, bucket, prefix_attend)
                          [:len(chunk)], metas))
            self.stats.prefills += len(chunk)
        return waves

    @staticmethod
    def _fetch_prefills(waves: list):
        """Start one fetch of every wave's first tokens: (fetch, metas),
        or None."""
        if not waves:
            return None
        return (_HostFetch(torch.cat([f for f, _ in waves])),
                [m for _, metas in waves for m in metas])

    def _process_prefill_waves(self, prefills) -> list:
        """Requests finish here if one token was all they wanted,
        otherwise they join the ready queue holding their first token.
        Export requests are returned for ``_process_exports``."""
        if prefills is None:
            return []
        fetch, metas = prefills
        exports = []
        for (req, pages, table, borrowed, entry), first in zip(
                metas, fetch.result().tolist()):
            self.stats.tokens_generated += 1
            sl = _Slot(req, len(req.prompt), first, pages, borrowed, entry)
            if req.export:
                exports.append((req, sl))
                continue
            if req.on_token is not None:
                self._safe_on_token(req, first)
            reason = self._finish_reason(sl, self.cfg.max_seq_len)
            if reason is not None:
                # never installed, so nothing junk-steps these pages
                self._prefix_release(sl)
                self._deliver_result(sl, reason)
            else:
                with self._lock:
                    self._ready.append(_Prefilled(sl, table))
        return exports

    def _process_exports(self, exports: list) -> None:
        """Gather the exported requests' prompt pages into one host
        tensor (one device gather per layer and ONE fetch), free the
        pages, and deliver PrefillHandoffs.  Dispatched after this
        iteration's block step, so the gather reads the pool in stream
        order; the freed pages recycle only through later dispatches."""
        gather = []
        for req, sl in exports:
            reason = self._finish_reason(sl, self.cfg.max_seq_len)
            if reason is not None:
                # done at its first token: nothing to decode anywhere
                self._prefix_release(sl)
                self.stats.requests_completed += 1
                self.stats.exports += 1
                self._safe_deliver(req, True, PrefillHandoff(
                    kv=None, page_size=self.page_size, npages=0,
                    prompt_len=sl.pos, first_token=sl.out[0],
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, eos_id=req.eos_id,
                    finish_reason=reason))
                continue
            gather.append((req, sl, -(-sl.pos // self.page_size)))
        if not gather:
            return
        t0 = time.monotonic()
        idx = torch.tensor([p for _, sl, n in gather for p in sl.pages[:n]],
                           dtype=torch.long, device=self.device)
        host = _HostFetch(torch.stack([pool[idx] for pool in self._cache])
                          ).result()
        # amortized per request, as the import side divides its cost
        ms = round((time.monotonic() - t0) * 1e3 / len(gather), 3)
        off = 0
        for req, sl, n in gather:
            kv = host[:, off:off + n].clone()
            off += n
            self._prefix_release(sl)
            self.stats.exports += 1
            self._safe_deliver(req, True, PrefillHandoff(
                kv=kv, page_size=self.page_size, npages=n,
                prompt_len=sl.pos, first_token=sl.out[0],
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, eos_id=req.eos_id,
                export_ms=ms))

    def _dispatch_import_waves(self, todo: list) -> None:
        """Scatter admitted handoffs' prompt K/V into their freshly
        allocated pages (one upload, one scatter per layer) and queue
        them ready to install with their first token known: no prefill,
        no fetch."""
        if not todo:
            return
        t0 = time.monotonic()
        idx = torch.tensor([p for imp, pages in todo
                            for p in pages[:imp.handoff.npages]],
                           dtype=torch.long, device=self.device)
        kv = torch.cat([imp.kv for imp, _ in todo], dim=1).to(
            self.device, self._cache[0].dtype)
        for layer, pool in enumerate(self._cache):
            pool[idx] = kv[layer]
        if self.on_import_admit is not None:
            ms = (time.monotonic() - t0) * 1e3 / len(todo)
            for _ in todo:
                self.on_import_admit(ms)
        for imp, pages in todo:
            h = imp.handoff
            sl = _Slot(imp.request, h.prompt_len, h.first_token, pages)
            self.stats.imports += 1
            reason = self._finish_reason(sl, self.cfg.max_seq_len)
            if reason is not None:
                # a 1-token import finishes without ever stepping
                self._free_pages.extend(sl.pages)
                sl.pages = []
                self._deliver_result(sl, reason)
                continue
            table = np.zeros((self.max_pages,), np.int32)
            table[:len(pages)] = pages
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
        host = fetch.result().numpy()      # the ONE fetch this quantum
        self._process_rows(host.reshape(self._rows, self.block_size), rows)
