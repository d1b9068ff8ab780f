"""Paged (block) KV-cache attention for continuous-batching decode
(counterpart of ray_tpu/ops/paged_attention.py).

Pool layout, kept from the JAX package so page handoffs stay
interchangeable:

  kv_pages:     [num_pages, kv_heads, page_size, 2*head_dim]  (per layer,
                K in [..., :head_dim], V in [..., head_dim:])
  block_tables: [rows, max_pages_per_seq] int32  (logical -> physical)

Two implementations:

  - ``paged_attention_ref`` — the plain version: gather the table span,
    mask by length, dense attention.  It answers
    ``ray_tpu.ops.paged_attention.paged_attention_xla``.  The CPU tests
    use it, and the card's checks hold the kernel against it.
  - ``paged_attention_cuda`` — the hand-written CUDA kernel
    (``ray_tpu_torch/csrc/paged_attention.cu``), which replaces the
    Pallas kernel ``_tpu_kernel`` and keeps its fp32 arithmetic: per
    (row, kv head) it reads only the row's occupied positions, in
    64-position chunks through the table, with bf16 tensor-core products
    and an online softmax, and splits a row's chunks over several thread
    blocks when the batch alone would leave SMs idle (the splits merge in
    the same launch).  ``paged_attention_ref`` on bf16 tensors rounds the
    softmax probabilities to bf16 before P.V, as ``paged_attention_xla``
    does; on fp32 copies of the same tensors it computes what the kernel
    and ``_tpu_kernel`` compute.

``paged_attention`` dispatches on where the tensors lie: CPU tensors go
to the plain version, CUDA tensors to the kernel, and a shape the kernel
does not take raises.  There is no fallback from the card to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import dense_attention

_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE_SIZE = 128
# positions per chunk the kernel stages, and query heads per thread block
CHUNK = 64
HEADS_PER_BLOCK = 16


def paged_attention_ref(q: torch.Tensor, kv_pages: torch.Tensor,
                        block_tables: torch.Tensor, lengths: torch.Tensor, *,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Gather-based paged decode attention (one query token per row).

    q:            [rows, heads, head_dim]
    kv_pages:     [num_pages, kv_heads, page_size, 2*head_dim]
    block_tables: [rows, max_pages] physical page ids, position-ordered
    lengths:      [rows] number of valid positions (current pos + 1)
    returns       [rows, heads, head_dim]
    """
    rows, _, hd = q.shape
    _, kvh, ps, _ = kv_pages.shape
    # [rows, mp, kvh, ps, 2hd] -> [rows, mp*ps, kvh, 2hd] position-major
    kv = kv_pages[block_tables.long()].movedim(2, 3).reshape(
        rows, -1, kvh, 2 * hd)
    span = kv.shape[1]
    mask = (torch.arange(span, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    out = dense_attention(q[:, None], kv[..., :hd], kv[..., hd:],
                          causal=False, mask=mask, sm_scale=sm_scale)
    return out[:, 0]


def _lib():
    from ray_tpu_torch.ops._build import load_library
    lib = load_library("paged_attention")
    if not getattr(lib, "_rt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_paged_attention_bf16.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, p]
        lib.rt_paged_attention_bf16.restype = i
        lib.rt_paged_attention_usage.argtypes = [i, ctypes.POINTER(i)]
        lib.rt_paged_attention_usage.restype = i
        lib._rt_typed = True
    return lib


def splits(resident: int, blocks: int, positions: int):
    """(chunks per split, splits) for ``blocks`` (row, kv head, head
    group) blocks over a table span of ``positions``, on a card that holds
    ``resident`` such blocks at once: no split when the blocks already
    fill it, else about two full residencies if every row were full.  From
    shapes alone: the lengths stay on the device, and reading them would
    stall the host.  A split whose chunks lie past a row's length exits at
    once."""
    chunks = max(1, -(-positions // CHUNK))
    want = 1 if blocks >= resident else min(chunks, -(-2 * resident //
                                                      blocks))
    per_split = -(-chunks // want)
    return per_split, -(-chunks // per_split)


@functools.cache
def _resident_blocks(device: int, hd: int) -> int:
    """Blocks of the kernel at head_dim ``hd`` that card ``device`` holds
    at once (the CUDA runtime's occupancy, times the SMs)."""
    u = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _lib().rt_paged_attention_usage(hd, u)
    if err != 0:
        raise RuntimeError(f"paged_attention occupancy query failed: "
                           f"cudaError_t {err}")
    return u[2] * torch.cuda.get_device_properties(
        device).multi_processor_count


# (device index, stream) -> the splits' scratch: part_acc, part_ml and the
# tickets, which every launch leaves at 0.  Launches on one stream run in
# order, so they can share it; kept rather than made per call, where fresh
# zeroed tickets would take a launch of their own.
_scratch: dict = {}


def _split_scratch(dev: torch.device, stream: int, parts: int, hd: int,
                   groups: int):
    """The scratch of launches on ``stream``, grown to ``parts`` split
    partials at head_dim ``hd`` and ``groups`` tickets."""
    key = (dev.index, stream)
    acc, ml, tickets = _scratch.get(key, (None, None, None))
    if acc is None or acc.numel() < parts * HEADS_PER_BLOCK * hd:
        acc = torch.empty(parts * HEADS_PER_BLOCK * hd, dtype=torch.float32,
                          device=dev)
    if ml is None or ml.numel() < parts * HEADS_PER_BLOCK * 2:
        ml = torch.empty(parts * HEADS_PER_BLOCK * 2, dtype=torch.float32,
                         device=dev)
    if tickets is None or tickets.numel() < groups:
        tickets = torch.zeros(groups, dtype=torch.int32, device=dev)
    _scratch[key] = (acc, ml, tickets)
    return acc, ml, tickets


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         *, sm_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (shapes as in
    ``paged_attention_ref``).  Takes bf16 q and pool, head_dim 64, 128 or
    256, page_size up to 128, any GQA group, a positive scale; int32
    tables and lengths; all contiguous on one CUDA device, q and the pool
    on 16 bytes.  Raises on anything else, and when the launch fails.
    Every launch adds one to ``paged_attention_cuda.launches``.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("paged_attention_cuda takes CUDA tensors; CPU "
                         "tensors go through paged_attention_ref")
    for name, t in (("kv_pages", kv_pages), ("block_tables", block_tables),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype != torch.bfloat16 or kv_pages.dtype != torch.bfloat16:
        raise ValueError(f"kernel takes bf16 q and kv_pages, got "
                         f"{q.dtype} and {kv_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if q.dim() != 3 or kv_pages.dim() != 4 or block_tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("expected q [rows, heads, hd], kv_pages [pages, "
                         "kvh, ps, 2hd], block_tables [rows, max_pages], "
                         "lengths [rows]")
    rows, heads, hd = q.shape
    num_pages, kvh, ps, hd2 = kv_pages.shape
    max_pages = block_tables.shape[1]
    if hd not in _HEAD_DIMS or hd2 != 2 * hd:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS} with a "
                         f"[..., 2*head_dim] pool; got q head_dim {hd}, "
                         f"pool minor dim {hd2}")
    if not 1 <= ps <= _MAX_PAGE_SIZE:
        raise ValueError(f"page_size {ps} outside 1..{_MAX_PAGE_SIZE}")
    if heads % kvh:
        raise ValueError(f"heads {heads} not a multiple of kv_heads {kvh}")
    if block_tables.shape[0] != rows or lengths.shape[0] != rows \
            or not 1 <= rows <= 65535 or max_pages < 1:
        raise ValueError(f"rows disagree or out of range: q {rows}, "
                         f"tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kv_pages", kv_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    if not scale > 0:
        raise ValueError(f"sm_scale must be positive, got {scale}")
    lib = _lib()
    groups = rows * kvh * -(-(heads // kvh) // HEADS_PER_BLOCK)
    per_split, n_split = splits(_resident_blocks(dev.index, hd), groups,
                                max_pages * ps)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_acc = part_ml = tickets = None
    if n_split > 1:
        part_acc, part_ml, tickets = (
            t.data_ptr() for t in _split_scratch(dev, stream,
                                                 groups * n_split, hd,
                                                 groups))
    with torch.cuda.device(dev):
        err = lib.rt_paged_attention_bf16(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc, part_ml, tickets,
            rows, heads, kvh, hd, ps, num_pages, max_pages, per_split,
            n_split, scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention(q, kv_pages, block_tables, lengths, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (which raises on a shape it does not
    take)."""
    fn = paged_attention_cuda if q.is_cuda else paged_attention_ref
    return fn(q, kv_pages, block_tables, lengths, sm_scale=sm_scale)
