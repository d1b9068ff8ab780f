"""Flash attention forward and backward (counterpart of
ray_tpu/ops/flash_attention.py).

Layout as in the JAX package: ``q`` [B, S, heads, head_dim]; ``k``/``v``
[B, Skv, kv_heads, head_dim].  Unlike the JAX function, grouped-query
heads are taken as they are (``kv_head = head // (heads // kv_heads)``);
nothing expands K and V.

Three kernels in ``ray_tpu_torch/csrc/flash_attention.cu`` replace the
Pallas kernels of the JAX package:

  - K1 ``flash_fwd_cuda``: O and the fp32 log-sum-exp of each row
    (``_fwd_kernel``).  On bf16 inputs it is the tensor-core forward of
    ``csrc/attention_fwd_tc.cuh``, which copies rows 16 bytes at a time:
    q, k and v must then start every row on 16 bytes
    (``check_rows_aligned``); fp32 inputs take the CUDA-core kernel;
  - K2 ``flash_bwd_dq_cuda``: dQ (``_bwd_dq_kernel``).  On bf16 inputs
    it is the tensor-core dQ of ``csrc/attention_bwd_dq_tc.cuh``, which
    copies rows 16 bytes at a time: q, k, v and dout must then start
    every row on 16 bytes; fp32 inputs take the CUDA-core kernel;
  - K3 ``flash_bwd_dkv_cuda``: dK and dV (``_bwd_dkv_kernel``).  On bf16
    inputs it is the tensor-core dK/dV of
    ``csrc/attention_bwd_dkv_tc.cuh``, with the same row rule; fp32
    inputs take the CUDA-core kernel.

The kernels take head_dim 32 (the Decision Transformer's ``rl/dt.py``
heads), 64, 128 and 256, in fp32 and in bf16.

``flash_attention`` wraps them in a ``torch.autograd.Function``: the
forward launches K1 and saves (q, k, v, o, lse); the backward computes
``delta = rowsum(dO * O)`` in fp32 outside the kernels, as the JAX
package does, then launches K2 and K3.  Beside them stand the plain
versions, ``flash_fwd_ref`` and ``flash_bwd_dq_ref`` /
``flash_bwd_dkv_ref`` (``flash_bwd_ref`` for all three gradients): dense
fp32 scores, and the backward from the kernels' own formulas (P from the
LSE, dS = P * (dP - delta)).  The CPU tests use them, and the card's
checks hold each kernel against its own.

The autograd function takes the plain versions only for CPU tensors.  On
CUDA tensors it launches the kernels, which raise on what they do not
take; there is no fallback.  LSE and delta are fp32 [B, heads, S].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import NEG_INF, repeat_kv

_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64
_FWD, _DQ, _DKV = 0, 1, 2


# --------------------------------------------------------------------------- #
# Plain versions                                                              #
# --------------------------------------------------------------------------- #

def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 [B, H, Sq, Skv] scores of pre-scaled q, -1e30 above the
    diagonal when causal; k is already expanded to q's heads."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        q_len, kv_len = s.shape[-2:]
        keep = (torch.arange(q_len, device=q.device)[:, None]
                >= torch.arange(kv_len, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    return s


def _expand(q, k, v):
    g = q.shape[2] // k.shape[2]
    return repeat_kv(k, g), repeat_kv(v, g), g


def flash_fwd_ref(q, k, v, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, fp32 lse [B, H, Sq]) from dense fp32 scores."""
    k, v, _ = _expand(q, k, v)
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _bwd_common(q, k, v, o, lse, do, causal: bool, scale: float):
    """(expanded k and v, group, fp32 P and dS = P * (dP - delta))."""
    k, v, g = _expand(q, k, v)
    p = torch.exp(_scores(q, k, causal, scale) - lse.float()[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, H, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return k, v, g, p, p * (dp - delta[..., None])


def _fold(x, g: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, H // g, D], summing each group's heads."""
    b, s, h, d = x.shape
    return x.view(b, s, h // g, g, d).sum(3)


def flash_bwd_dq_ref(q, k, v, o, lse, do, causal: bool, scale: float
                     ) -> torch.Tensor:
    """dQ = dS K * scale, in q's dtype."""
    k, _, _, _, ds = _bwd_common(q, k, v, o, lse, do, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
            ).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, o, lse, do, causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dS^T q * scale and dV = P^T dO, summed over each kv head's
    query heads, in k's and v's dtypes."""
    _, _, g, p, ds = _bwd_common(q, k, v, o, lse, do, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return _fold(dk, g).to(k.dtype), _fold(dv, g).to(v.dtype)


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) of the plain versions."""
    return (flash_bwd_dq_ref(q, k, v, o, lse, do, causal, scale),
            *flash_bwd_dkv_ref(q, k, v, o, lse, do, causal, scale))


# --------------------------------------------------------------------------- #
# Kernel launchers                                                            #
# --------------------------------------------------------------------------- #

def _lib():
    from ray_tpu_torch.ops._build import load_library
    lib = load_library("flash_attention")
    if not getattr(lib, "_rt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_flash_attention.argtypes = [
            i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
            ctypes.c_float, p]
        lib.rt_flash_attention.restype = i
        lib.rt_flash_smem_bytes.argtypes = [i, i, i]
        lib.rt_flash_smem_bytes.restype = ctypes.c_size_t
        for fn in (lib.rt_flash_fwd_usage, lib.rt_flash_dq_usage,
                   lib.rt_flash_dkv_usage):
            fn.argtypes = [i, ctypes.POINTER(i)]
            fn.restype = i
        lib.rt_flash_fp32_usage.argtypes = [i, i, ctypes.POINTER(i)]
        lib.rt_flash_fp32_usage.restype = i
        lib._rt_typed = True
    return lib


def _check(name: str, q, k, v, causal: bool, do=None, lse=None,
           delta=None) -> None:
    """Raise ValueError on anything the kernels do not take (``do``,
    ``lse`` and ``delta`` are the backward kernels' extra inputs)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors; CPU tensors go "
                         "through the plain versions")
    bwd = () if do is None else (("do", do), ("lse", lse), ("delta", delta))
    for tname, t in (("k", k), ("v", v), *bwd):
        if t.device != dev:
            raise ValueError(f"{tname} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernels take fp32 or bf16 q, k and v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("expected q [B, S, H, D] and k, v [B, Skv, KVH, D]")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernels take head_dim in {_HEAD_DIMS}, got {d}")
    if causal and sq != skv:
        raise ValueError(f"causal attention needs q_len == kv_len, got "
                         f"{sq} and {skv}")
    if min(sq, skv) < 1 or max(-(-sq // _TILE), -(-skv // _TILE)) > 65535 \
            or b * h >= 2 ** 31:
        raise ValueError(f"shape out of the kernels' grid: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{tname} must have a contiguous head_dim")
    if do is None:
        return
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError("do must match q's dtype and shape")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(f"{tname} must be fp32 [B, H, Sq] = "
                             f"{(b, h, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for tname, t in bwd:
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def check_rows_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise ValueError unless every row of each tensor starts on 16
    bytes: its data pointer and its (batch, seq, head) strides in bytes
    are multiples of 16.  The bf16 tensor-core kernels copy rows 16 bytes
    at a time; a tensor that breaks the rule is refused, not copied."""
    for tname, t in tensors.items():
        esize = t.element_size()
        if t.data_ptr() % 16 or any(st * esize % 16 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: every row of {tname} must start on 16 bytes (data "
                f"pointer {t.data_ptr() % 16} bytes past 16, strides "
                f"{tuple(t.stride())} of {esize}-byte elements)")


def _launch(kind: int, q, k, v, causal: bool, scale: float, *, dout=None,
            out=None, dk=None, dv=None, lse=None, delta=None) -> None:
    lib = _lib()
    d = q.shape[-1]
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rt_flash_attention(
            kind, _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(dout),
            ptr(out), ptr(dk), ptr(dv), ptr(lse), ptr(delta), strides,
            q.shape[0], q.shape[2], k.shape[2], q.shape[1], k.shape[1], d,
            int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {kind + 1} launch "
                           f"failed: cudaError_t {err}")


def flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]).  bf16
    rows must start on 16 bytes.  Every launch adds one to
    ``flash_fwd_cuda.launches``."""
    _check("flash_fwd_cuda", q, k, v, causal)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("flash_fwd_cuda", q=q, k=k, v=v)
    b, sq, h, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch(_FWD, q, k, v, causal, sm_scale, out=out, lse=lse)
    flash_fwd_cuda.launches += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool,
                      sm_scale: float) -> torch.Tensor:
    """K2: dq [B, Sq, H, D] in q's dtype from contiguous ``do`` and fp32
    ``lse``/``delta`` [B, H, Sq].  bf16 rows of q, k, v and do must start
    on 16 bytes.  Every launch adds one to ``flash_bwd_dq_cuda.launches``.
    """
    _check("flash_bwd_dq_cuda", q, k, v, causal, do, lse, delta)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("flash_bwd_dq_cuda", q=q, k=k, v=v, dout=do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_DQ, q, k, v, causal, sm_scale, dout=do, out=dq, lse=lse,
            delta=delta)
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool,
                       sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B, Skv, KVH, D] in k's dtype, each kv head's sum over
    its query heads.  bf16 rows of q, k, v and do must start on 16 bytes.
    Every launch adds one to ``flash_bwd_dkv_cuda.launches``."""
    _check("flash_bwd_dkv_cuda", q, k, v, causal, do, lse, delta)
    if q.dtype == torch.bfloat16:
        check_rows_aligned("flash_bwd_dkv_cuda", q=q, k=k, v=v, dout=do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _launch(_DKV, q, k, v, causal, sm_scale, dout=do, dk=dk, dv=dv,
            lse=lse, delta=delta)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0


# --------------------------------------------------------------------------- #
# autograd wrapper                                                            #
# --------------------------------------------------------------------------- #

class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.is_cuda:
            o, lse = flash_fwd_cuda(q, k, v, causal=causal, sm_scale=scale)
        else:
            o, lse = flash_fwd_ref(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if not q.is_cuda:
            return (*flash_bwd_ref(q, k, v, o, lse, do, causal, scale),
                    None, None)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                               sm_scale=scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                                    sm_scale=scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024
                    ) -> torch.Tensor:
    """Flash attention on [B, S, H, D] / [B, Skv, KVH, D] inputs, with the
    JAX function's signature.  ``block_q``/``block_k`` are accepted for
    that signature and not used: the kernels choose their own 64 x 64
    tiles (the TPU's 1024-row blocks do not fit a Hopper SM)."""
    del block_q, block_k
    q_len, d = q.shape[1], q.shape[-1]
    kv_len = k.shape[1]
    if causal and q_len != kv_len:
        raise ValueError(
            "causal flash attention requires q_len == kv_len (got "
            f"{q_len} vs {kv_len}); use ops.attention with q_offset for "
            "decode-style queries")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"heads {q.shape[2]} not a multiple of kv_heads "
                         f"{k.shape[2]}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    return _Flash.apply(q, k, v, causal, float(scale))
