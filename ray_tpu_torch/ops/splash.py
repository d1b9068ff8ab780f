"""Splash attention: block-sparse attention driven by a mask table
(counterpart of ray_tpu/ops/splash.py).

The JAX function builds a ``MultiHeadMask`` of ``CausalMask`` or
``FullMask`` and hands it to JAX's ``make_splash_mha``, whose three TPU
kernels skip the empty blocks of the mask and apply the element mask only
in the partial ones.  The port keeps its own copy of those masks, reduces
a mask to a table of tiles on the host (``mask_table``), and walks that
table in three kernels of ``ray_tpu_torch/csrc/splash_attention.cu``:

  - K5-fwd ``splash_fwd_cuda``: O and the fp32 log-sum-exp of each row
    (the library's ``flash_attention_kernel``); on bf16 inputs the
    tensor-core forward it shares with K1 (``csrc/attention_fwd_tc.cuh``),
    which needs every row of q, k and v on 16 bytes;
  - K5-dQ ``splash_bwd_dq_cuda`` (``_flash_attention_dq_kernel``); on
    bf16 inputs the tensor-core dQ it shares with K2
    (``csrc/attention_bwd_dq_tc.cuh``), which needs every row of q, k, v
    and dout on 16 bytes;
  - K5-dKV ``splash_bwd_dkv_cuda`` (``_flash_attention_dkv_kernel``); on
    bf16 inputs the tensor-core dK/dV it shares with K3
    (``csrc/attention_bwd_dkv_tc.cuh``), with the same row rule.

They take the head_dims of the flash kernels (``_HEAD_DIMS``): 32, 64,
128 and 256, in fp32 and in bf16.

Semantics kept from the JAX side:

  - q is scaled by ``sm_scale`` in q's dtype before the products
    (``splash.py:51``; the scale itself is rounded to that dtype, as a
    Python float is in JAX), so dq is the kernel's gradient times the
    scale, again in q's dtype;
  - masked scores take ``MASK_VALUE`` = -0.7 * FLT_MAX;
  - the forward keeps P in fp32 for P.V (the library casts v to fp32;
    the bf16 kernel carries ~16 bits of P as two bf16 terms);
    the backward rounds P (for dV) and dS (for dQ and dK) to the input
    dtype before their products, as the library does;
  - ``delta = rowsum(dO * O)`` is computed in fp32 outside the kernels;
  - q_len and kv_len are multiples of the library's 128-row blocks, and
    causal needs q_len == kv_len.

Unlike the JAX function, grouped-query heads are taken as they are: the
kernels read ``kv_head = head // (heads // kv_heads)``, and dK/dV are the
sums over each group.  The plain versions ``splash_fwd_ref``,
``splash_bwd_dq_ref`` and ``splash_bwd_dkv_ref`` compute dense fp32
scores under the dense mask.  ``splash_attention`` takes them only for
CPU tensors; on CUDA tensors it launches the kernels, which raise on what
they do not take.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.ops.flash_attention import _DTYPES, _HEAD_DIMS  # noqa: F401
from ray_tpu_torch.ops.flash_attention import _check as _check_flash
from ray_tpu_torch.ops.flash_attention import (_expand, _fold,
                                               check_rows_aligned)

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# the library's default q and kv block: it refuses lengths that are not
# multiples of it
BLOCK = 128
# the kernels' tile (rows of a q tile and of a kv tile); divides BLOCK
TILE = 64
_FWD, _DQ, _DKV = 0, 1, 2


# --------------------------------------------------------------------------- #
# Masks (the kinds ray_tpu/ops/splash.py builds)                              #
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class FullMask:
    """Every query attends to every key."""
    shape: Tuple[int, int]

    def rows(self, q0: int, q1: int) -> np.ndarray:
        """The bool mask of query rows [q0, q1) over all keys."""
        return np.ones((q1 - q0, self.shape[1]), dtype=bool)


@dataclass(frozen=True)
class CausalMask:
    """Query i attends to keys j <= i."""
    shape: Tuple[int, int]

    def rows(self, q0: int, q1: int) -> np.ndarray:
        return (np.arange(q0, q1)[:, None]
                >= np.arange(self.shape[1])[None, :])


@dataclass(frozen=True)
class MultiHeadMask:
    """One 2-D mask per head, all of one shape."""
    masks: Tuple[Union[FullMask, CausalMask], ...]

    def __post_init__(self):
        object.__setattr__(self, "masks", tuple(self.masks))
        if not self.masks or len({m.shape for m in self.masks}) != 1:
            raise ValueError("a MultiHeadMask needs one or more masks of "
                             "one shape")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.masks), *self.masks[0].shape)


def make_mask(n_heads: int, q_len: int, kv_len: int,
              causal: bool) -> MultiHeadMask:
    """The mask ``ray_tpu.ops.splash._make_kernel`` builds."""
    mask = (CausalMask if causal else FullMask)((q_len, kv_len))
    return MultiHeadMask((mask,) * n_heads)


# --------------------------------------------------------------------------- #
# Mask table                                                                  #
# --------------------------------------------------------------------------- #

EMPTY, FULL, PARTIAL = 0, 1, 2


def tile_kinds(mask: Union[FullMask, CausalMask], tile: int) -> np.ndarray:
    """int8 [q tiles, kv tiles]: EMPTY, FULL or PARTIAL per tile of the
    mask, from the mask's rows one q tile at a time."""
    q_len, kv_len = mask.shape
    nq, nkv = q_len // tile, kv_len // tile
    kinds = np.empty((nq, nkv), dtype=np.int8)
    for i in range(nq):
        blk = mask.rows(i * tile, (i + 1) * tile).reshape(tile, nkv, tile)
        any_, all_ = blk.any(axis=(0, 2)), blk.all(axis=(0, 2))
        kinds[i] = np.where(all_, FULL, np.where(any_, PARTIAL, EMPTY))
    return kinds


def _csr(kinds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(ptr [rows + 1], entries) of the non-empty tiles of each row, in
    order; an entry is (column << 1) | partial."""
    rows, cols = np.nonzero(kinds)
    ent = (cols << 1) | (kinds[rows, cols] == PARTIAL)
    return np.concatenate([[0], np.cumsum((kinds != EMPTY).sum(1))]), ent


def _stack_csr(grids) -> Tuple[np.ndarray, np.ndarray]:
    """int32 (ptr [U, rows + 1], entries) of several kind grids, their
    offsets running over the concatenated entries."""
    ptrs, ents, base = [], [], 0
    for grid in grids:
        ptr, ent = _csr(grid)
        ptrs.append(ptr + base)
        ents.append(ent)
        base += len(ent)
    return (np.stack(ptrs).astype(np.int32),
            np.concatenate(ents).astype(np.int32))


@dataclass(frozen=True, eq=False)
class MaskTable:
    """A mask reduced to tiles.  Heads whose masks are equal share one
    unique mask u = ``head_map[h]``.  ``row_ptr[u, i]:row_ptr[u, i + 1]``
    index ``row_ent``: the non-empty kv tiles of q tile i in order, each
    (kv tile << 1) | partial.  ``col_ptr``/``col_ent`` hold the
    transpose, per kv tile, for the dK/dV kernel.  Offsets run over the
    concatenation of all unique masks' entries."""
    tile: int
    head_map: np.ndarray     # [H] int32
    kinds: np.ndarray        # [U, nq, nkv] int8
    row_ptr: np.ndarray      # [U, nq + 1] int32
    row_ent: np.ndarray      # int32
    col_ptr: np.ndarray      # [U, nkv + 1] int32
    col_ent: np.ndarray      # int32

    @property
    def visited(self) -> int:
        """Tiles the kernels visit over all heads (of one example)."""
        return int((self.kinds[self.head_map] != EMPTY).sum())

    @property
    def partial(self) -> int:
        return int((self.kinds[self.head_map] == PARTIAL).sum())

    @property
    def dense(self) -> int:
        """Tiles a dense loop would visit over all heads."""
        return len(self.head_map) * self.kinds[0].size


def _unique(mask: MultiHeadMask):
    """(the distinct head masks in order, int32 [H] index of each
    head's)."""
    unique = list(dict.fromkeys(mask.masks))
    return unique, np.array([unique.index(m) for m in mask.masks], np.int32)


@functools.lru_cache(maxsize=64)
def mask_table(mask: MultiHeadMask, tile: int = TILE) -> MaskTable:
    """The table of ``mask`` at ``tile``, built once per (mask, tile)."""
    _, q_len, kv_len = mask.shape
    if q_len % tile or kv_len % tile:
        raise ValueError(f"tile {tile} does not divide the mask's shape "
                         f"{mask.shape}")
    unique, head_map = _unique(mask)
    kinds = np.stack([tile_kinds(m, tile) for m in unique])
    tables = (*_stack_csr(kinds), *_stack_csr(k.T for k in kinds))
    return MaskTable(tile, head_map, kinds, *tables)


@functools.lru_cache(maxsize=64)
def _device_table(mask: MultiHeadMask, device: torch.device):
    """(head_map, row_ptr, row_ent, col_ptr, col_ent) as int32 tensors on
    ``device``, copied once per (mask, device)."""
    t = mask_table(mask, TILE)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (t.head_map, t.row_ptr, t.row_ent, t.col_ptr, t.col_ent))


@functools.lru_cache(maxsize=4)
def _keep(mask: MultiHeadMask, device: torch.device) -> torch.Tensor:
    """The dense bool mask [H, Sq, Skv] on ``device`` (plain versions)."""
    unique, head_map = _unique(mask)
    dense = torch.from_numpy(np.stack(
        [m.rows(0, m.shape[0]) for m in unique])).to(device)
    return dense[torch.from_numpy(head_map).long().to(device)]


def check_lengths(q_len: int, kv_len: int) -> None:
    """The library's rule: q_len and kv_len are multiples of its block."""
    if q_len % BLOCK:
        raise ValueError(f"q_block_size={BLOCK} should divide "
                         f"q_seq_len={q_len}.")
    if kv_len % BLOCK:
        raise ValueError(f"kv_block_size={BLOCK} should divide "
                         f"kv_seq_len={kv_len}.")


def dtype_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``, as JAX rounds a Python float that
    multiplies an array of that dtype."""
    return float(torch.tensor(scale, dtype=dtype))


# --------------------------------------------------------------------------- #
# Plain versions                                                              #
# --------------------------------------------------------------------------- #

def _scores(qs, k, mask: MultiHeadMask) -> torch.Tensor:
    """fp32 [B, H, Sq, Skv] scores of the pre-scaled q, MASK_VALUE where
    the mask is False; k is already expanded to q's heads."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    return torch.where(_keep(mask, qs.device), s, MASK_VALUE)


def splash_fwd_ref(q, k, v, mask: MultiHeadMask, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, fp32 lse [B, H, Sq]) from dense fp32 scores; P
    stays fp32 for P.V."""
    qs = q * dtype_scale(scale, q.dtype)
    k, v, _ = _expand(q, k, v)
    s = _scores(qs, k, mask)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _bwd_common(q, k, v, o, lse, do, mask, scale):
    """(pre-scaled q, expanded k, group, fp32 P, fp32 dS)."""
    qs = q * dtype_scale(scale, q.dtype)
    k, v, g = _expand(q, k, v)
    p = torch.exp(_scores(qs, k, mask) - lse.float()[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, H, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return qs, k, g, p, (dp - delta[..., None]) * p


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def splash_bwd_dq_ref(q, k, v, o, lse, do, mask: MultiHeadMask,
                      scale: float) -> torch.Tensor:
    """dq = (dS K in q's dtype) * scale in q's dtype, with dS rounded to
    q's dtype."""
    _, k, _, _, ds = _bwd_common(q, k, v, o, lse, do, mask, scale)
    dqs = torch.einsum("bhqk,bkhd->bqhd", _round(ds, q.dtype), k.float())
    return dqs.to(q.dtype) * dtype_scale(scale, q.dtype)


def splash_bwd_dkv_ref(q, k, v, o, lse, do, mask: MultiHeadMask,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dS^T q_scaled and dV = P^T dO with dS and P rounded to the
    input dtype, summed over each kv head's query heads."""
    qs, _, g, p, ds = _bwd_common(q, k, v, o, lse, do, mask, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, q.dtype), qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, q.dtype), do.float())
    return _fold(dk, g).to(k.dtype), _fold(dv, g).to(v.dtype)


def splash_bwd_ref(q, k, v, o, lse, do, mask: MultiHeadMask, scale: float):
    """(dq, dk, dv) of the plain versions."""
    return (splash_bwd_dq_ref(q, k, v, o, lse, do, mask, scale),
            *splash_bwd_dkv_ref(q, k, v, o, lse, do, mask, scale))


# --------------------------------------------------------------------------- #
# Kernel launchers                                                            #
# --------------------------------------------------------------------------- #

def _lib():
    from ray_tpu_torch.ops._build import load_library
    lib = load_library("splash_attention")
    if not getattr(lib, "_rt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_splash_attention.argtypes = [
            i, i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
            ctypes.c_float, p]
        lib.rt_splash_attention.restype = i
        lib.rt_splash_smem_bytes.argtypes = [i, i, i]
        lib.rt_splash_smem_bytes.restype = ctypes.c_size_t
        for fn in (lib.rt_splash_fwd_usage, lib.rt_splash_dq_usage,
                   lib.rt_splash_dkv_usage):
            fn.argtypes = [i, ctypes.POINTER(i)]
            fn.restype = i
        lib.rt_splash_fp32_usage.argtypes = [i, i, ctypes.POINTER(i)]
        lib.rt_splash_fp32_usage.restype = i
        lib._rt_typed = True
    return lib


def _check(name: str, q, k, v, mask: MultiHeadMask, do=None, lse=None,
           delta=None) -> None:
    """Raise ValueError on anything the kernels do not take: the flash
    kernels' rules (device, dtypes, shapes, head_dim, strides, the
    backward's extra inputs), the library's lengths, and a mask of
    q's heads and lengths."""
    _check_flash(name, q, k, v, False, do, lse, delta)
    _, sq, h, _ = q.shape
    skv = k.shape[1]
    check_lengths(sq, skv)
    if mask.shape != (h, sq, skv):
        raise ValueError(f"mask shape {mask.shape} != (heads, q_len, "
                         f"kv_len) {(h, sq, skv)}")


def _launch(kind: int, q, k, v, mask: MultiHeadMask, scale: float, *,
            dout=None, out=None, dk=None, dv=None, lse=None,
            delta=None) -> None:
    lib = _lib()
    d = q.shape[-1]
    head_map, row_ptr, row_ent, col_ptr, col_ent = _device_table(
        mask, q.device)
    ptr, ent = (col_ptr, col_ent) if kind == _DKV else (row_ptr, row_ent)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])

    def addr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rt_splash_attention(
            kind, _DTYPES[q.dtype], addr(q), addr(k), addr(v), addr(dout),
            addr(out), addr(dk), addr(dv), addr(lse), addr(delta),
            addr(head_map), addr(ptr), addr(ent), strides, q.shape[0],
            q.shape[2], k.shape[2], q.shape[1], k.shape[1], d,
            dtype_scale(scale, q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"splash attention kernel {kind} launch failed: "
                           f"cudaError_t {err}")


def splash_fwd_cuda(q, k, v, mask: MultiHeadMask, *, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5-fwd: (o [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]).
    bf16 rows must start on 16 bytes.  Every launch adds one to
    ``splash_fwd_cuda.launches``."""
    _check("splash_fwd_cuda", q, k, v, mask)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("splash_fwd_cuda", q=q, k=k, v=v)
    b, sq, h, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch(_FWD, q, k, v, mask, sm_scale, out=out, lse=lse)
    splash_fwd_cuda.launches += 1
    return out, lse


def splash_bwd_dq_cuda(q, k, v, do, lse, delta, mask: MultiHeadMask, *,
                       sm_scale: float) -> torch.Tensor:
    """K5-dQ: dq [B, Sq, H, D] in q's dtype from contiguous ``do`` and
    fp32 ``lse``/``delta`` [B, H, Sq].  bf16 rows of q, k, v and do must
    start on 16 bytes.  Every launch adds one to
    ``splash_bwd_dq_cuda.launches``."""
    _check("splash_bwd_dq_cuda", q, k, v, mask, do, lse, delta)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("splash_bwd_dq_cuda", q=q, k=k, v=v, dout=do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_DQ, q, k, v, mask, sm_scale, dout=do, out=dq, lse=lse,
            delta=delta)
    splash_bwd_dq_cuda.launches += 1
    return dq


def splash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask: MultiHeadMask, *,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5-dKV: (dk, dv) [B, Skv, KVH, D] in k's dtype, each kv head's sum
    over its query heads.  bf16 rows of q, k, v and do must start on 16
    bytes.  Every launch adds one to ``splash_bwd_dkv_cuda.launches``."""
    _check("splash_bwd_dkv_cuda", q, k, v, mask, do, lse, delta)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("splash_bwd_dkv_cuda", q=q, k=k, v=v, dout=do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _launch(_DKV, q, k, v, mask, sm_scale, dout=do, dk=dk, dv=dv, lse=lse,
            delta=delta)
    splash_bwd_dkv_cuda.launches += 1
    return dk, dv


splash_fwd_cuda.launches = 0
splash_bwd_dq_cuda.launches = 0
splash_bwd_dkv_cuda.launches = 0


# --------------------------------------------------------------------------- #
# autograd wrapper                                                            #
# --------------------------------------------------------------------------- #

class _Splash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask: MultiHeadMask, scale: float):
        if q.is_cuda:
            o, lse = splash_fwd_cuda(q, k, v, mask, sm_scale=scale)
        else:
            o, lse = splash_fwd_ref(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.scale = mask, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mask, scale = ctx.mask, ctx.scale
        if not q.is_cuda:
            return (*splash_bwd_ref(q, k, v, o, lse, do, mask, scale),
                    None, None)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = splash_bwd_dq_cuda(q, k, v, do, lse, delta, mask,
                                sm_scale=scale)
        dk, dv = splash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask,
                                     sm_scale=scale)
        return dq, dk, dv, None, None


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """[B, S, H, D] q and [B, Skv, KVH, D] k, v -> [B, S, H, D], with the
    JAX function's rules: causal needs q_len == kv_len, and both lengths
    are multiples of 128."""
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    if causal and s != kv_len:
        raise ValueError(
            "causal splash attention requires q_len == kv_len (got "
            f"{s} vs {kv_len}); decode-style queries use ops.attention "
            "with q_offset")
    check_lengths(s, kv_len)
    if h % k.shape[2]:
        raise ValueError(f"heads {h} not a multiple of kv_heads "
                         f"{k.shape[2]}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    return _Splash.apply(q, k, v, make_mask(h, s, kv_len, causal),
                         float(scale))
