"""Multi-head attention with a selectable implementation (counterpart of
ray_tpu/ops/attention.py).

``impl``:
  - ``"xla"``   — ``dense_attention``: einsum attention with fp32 logits;
                  runs everywhere, materialises [Sq, Skv].
  - ``"flash"`` — ``ops/flash_attention.py``: the hand-written CUDA kernels
                  on CUDA tensors, their plain versions on CPU tensors.
  - ``"splash"`` — ``ops/splash.py``: block-sparse attention driven by a
                  mask table (kernel K5, the counterpart of JAX's splash
                  library kernel); its plain versions on CPU tensors.
                  Lengths must be multiples of 128.
  - ``"auto"``  — flash for CUDA tensors, ``dense_attention`` for CPU ones.
  - ``"ring"``, ``"ulysses"`` — not ported yet; they raise and name their
    ROADMAP items.

Layout as in the JAX package: ``q`` [batch, q_len, heads, head_dim];
``k``/``v`` [batch, kv_len, kv_heads, head_dim], grouped-query when
``kv_heads < heads``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

_UNPORTED = {
    "ring": "ring attention is not ported yet: ROADMAP.md Queue 1 item 4 "
            "(long context)",
    "ulysses": "ulysses attention is not ported yet: ROADMAP.md Queue 1 "
               "item 4 (long context)",
}


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KvH, D] -> [B, S, KvH*n_rep, D] for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    q_offset: int = 0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Einsum attention with fp32 logits and softmax and an output in
    q's dtype: the port of ``ray_tpu.ops.attention.xla_attention``.

    ``q_offset``: global position of q[0] relative to k[0].
    ``mask``: a key-padding mask [B, Kv] (bool or 0/1 int, True/1 =
    attend), or a boolean or additive [B, 1|H, Q, Kv] mask.  A 2-D float
    mask is refused: the additive convention would be silently inverted.
    """
    q_len, heads, head_dim = q.shape[-3:]
    kv_len, kv_heads = k.shape[-3], k.shape[-2]
    if kv_heads != heads:
        k = repeat_kv(k, heads // kv_heads)
        v = repeat_kv(v, heads // kv_heads)
    scale = sm_scale if sm_scale is not None else head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(q_len, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(kv_len, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, NEG_INF)
    if mask is not None:
        if mask.dim() == 2:
            if mask.is_floating_point():
                raise ValueError(
                    "2-D attention masks must be bool/int key-padding "
                    "masks (True/1 = attend); pass additive float masks "
                    "as [B, 1|H, Q, Kv]")
            mask = mask.bool()[:, None, None, :]
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              impl: str = "auto",
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention entry point (see the module docstring).  A ``mask`` sends
    flash and splash calls to ``dense_attention``, as in the JAX package:
    the kernels have no padding-mask path.  The flash and splash kernels
    take grouped-query heads as they are, with no ``repeat_kv`` copy."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl in ("flash", "splash") and mask is not None:
        impl = "xla"
    if impl in _UNPORTED:
        raise NotImplementedError(_UNPORTED[impl])
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "splash":
        from ray_tpu_torch.ops.splash import splash_attention
        return splash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "xla":
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               mask=mask)
    raise ValueError(f"unknown attention impl: {impl!r}")
