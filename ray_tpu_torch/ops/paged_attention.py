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
    Pallas kernel ``_tpu_kernel``: per (row, kv head) it reads only the
    row's occupied pages, with an online softmax, and splits a row's
    pages over several thread blocks when the batch alone would leave
    SMs idle.

``paged_attention`` dispatches on where the tensors lie: CPU tensors go
to the plain version, CUDA tensors to the kernel, and a shape the kernel
does not take raises.  There is no fallback from the card to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import dense_attention

# per-block shared memory an H100 block may opt into (227 KB)
_MAX_SMEM = 232448
_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE_SIZE = 128


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
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float,
            p]
        lib.rt_paged_attention_bf16.restype = i
        lib.rt_paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.rt_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib._rt_typed = True
    return lib


def _splits(dev: torch.device, blocks: int, max_pages: int):
    """(pages per split, splits): enough blocks for about two waves
    over the card's SMs, from shapes alone (the lengths stay on the
    device, and reading them would stall the host).  A split whose pages
    lie past a row's length does no work."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = min(max_pages, max(1, -(-2 * sms // blocks)))
    per_split = -(-max_pages // want)
    return per_split, -(-max_pages // per_split)


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         *, sm_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (shapes as in
    ``paged_attention_ref``).  Takes bf16 q and pool, head_dim 64, 128 or
    256, page_size up to 128, any GQA group; int32 tables and lengths; all
    contiguous on one CUDA device.  Raises on anything else, and when the
    launch fails.  Every launch adds one to ``paged_attention_cuda.launches``.
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
    lib = _lib()
    smem = lib.rt_paged_attention_smem_bytes(heads // kvh, hd, ps)
    if smem > _MAX_SMEM:
        raise ValueError(f"GQA group {heads // kvh} x head_dim {hd} x "
                         f"page_size {ps} needs {smem} B of shared memory "
                         f"per block; the card allows {_MAX_SMEM}")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    per_split, n_split = _splits(dev, rows * kvh, max_pages)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        g = heads // kvh
        part_acc = torch.empty(rows * kvh * n_split * g * hd,
                               dtype=torch.float32, device=dev)
        part_ml = torch.empty(rows * kvh * n_split * g * 2,
                              dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rt_paged_attention_bf16(
            q.data_ptr(), kv_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
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
