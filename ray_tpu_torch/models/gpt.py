"""Decoder-only transformer, LLaMA-style: RMSNorm, RoPE, SwiGLU, GQA
(counterpart of ray_tpu/models/gpt.py).

The JAX model scans one block over a stacked layer axis; here the layers
are an ``nn.ModuleList``.  Parameter names follow the flax tree
(``blocks.{i}.attn.wq`` for ``blocks/attn/wq``), so
``models/convert.py`` maps one onto the other.  Parameters are stored in
``param_dtype`` and every projection computes in ``cfg.dtype``, as flax's
``DenseGeneral(dtype, param_dtype)`` does (``Dense``).

The JAX module chooses its path from ``decode``/``paged_pages``
attributes; here the caller's arguments choose it:

  - ``kv_pools`` and ``block_tables`` given -> paged decode
    (``_decode_attend_paged``): T > 1 is prompt prefill (with
    ``prefix_attend``, a suffix prefill over cached pages), T == 1 a
    decode step through ``ops/paged_attention.py``.  The pools belong to
    the caller (the serving engine) and are updated in place.
  - ``kv_cache`` given -> dense slot decode (``_decode_attend``) over
    per-row cache rows (``models/generate.py`` ``init_dense_cache``),
    updated in place.
  - neither -> the training forward: causal attention through
    ``ops/attention.py`` with ``cfg.attention_impl``, each block under
    ``torch.utils.checkpoint`` per ``cfg.remat``/``remat_policy``/
    ``remat_layers`` when gradients are on.

Blocks of a config with ``moe_experts`` hold ``ops/moe.py``'s ``MoEMLP``
in place of the MLP.  Its aux loss reaches the caller only with
``return_aux`` (the loss functions of ``train/step.py``); the decode
paths drop it, as the reference's sow outside a mutable collection does.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.ops.attention import attention, dense_attention
from ray_tpu_torch.ops.layers import (Dense, apply_rope, rms_norm,
                                      rope_frequencies)
from ray_tpu_torch.ops.moe import MoEMLP
from ray_tpu_torch.ops.paged_attention import paged_attention

_aten = torch.ops.aten
# the remat ladder of ray_tpu/models/gpt.py stack_layers, least to most
# memory: "nothing" recomputes the whole block, "block_outs" keeps the
# residual stream after attention (two checkpointed halves), "dots" keeps
# the outputs of the projections (matmuls with no batch dimension), and
# "dots_all" those of every matmul
_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.addmm.default],
    "dots_all": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                 _aten.baddbmm.default],
}
REMAT_POLICIES = ("nothing", "block_outs", "dots", "dots_all")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_gate = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, **kw)
        self.w_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, **kw)
        self.w_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, **kw)

    def forward(self, y):
        return self.w_down(F.silu(self.w_gate(y)) * self.w_up(y))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d, h * hd, cfg.dtype, **kw)
        self.wk = Dense(d, kvh * hd, cfg.dtype, **kw)
        self.wv = Dense(d, kvh * hd, cfg.dtype, **kw)
        self.wo = Dense(h * hd, d, cfg.dtype, **kw)

    def forward(self, x, cos, sin, positions=None, block_tables=None,
                kv=None, prefix_attend: bool = False):
        """``kv``: this layer's paged pool (with ``block_tables``) or its
        dense cache [2, rows, S, kvh, hd] (without)."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.wq(x).view(b, t, h, hd)
        k = self.wk(x).view(b, t, kvh, hd)
        v = self.wv(x).view(b, t, kvh, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if kv is not None and block_tables is not None:
            out = self._decode_attend_paged(q, k, v, positions, block_tables,
                                            kv, prefix_attend)
        elif kv is not None:
            out = self._decode_attend(q, k, v, positions, kv)
        else:
            out = self._train_attend(q, k, v)
        return self.wo(out.reshape(b, t, h * hd))

    def _train_attend(self, q, k, v):
        """Causal self-attention over the window, through the dispatcher
        with ``cfg.attention_impl`` (GQA heads go to the kernels as they
        are)."""
        return attention(q, k, v, causal=True, impl=self.cfg.attention_impl)

    def _decode_attend(self, q, k, v, positions, cache):
        """Write K/V into the dense cache at per-row positions, then
        attend over the whole row under a position mask.

        ``positions`` [B, T]: absolute positions, contiguous per row
        from ``positions[:, 0]``; rows may sit at different offsets (each
        row is its own request in the serving engine).  ``cache`` [2, B,
        S, kvh, hd] (K, then V) is written in place; as JAX's
        ``dynamic_update_slice``, a window that would run past S starts
        at S - T.  Key j is visible to the query at position p iff
        j <= p.  The reference computes this with XLA (``xla_attention``
        over the row), not with a Pallas kernel, so it runs as plain
        PyTorch (``dense_attention``) here.
        """
        if positions is None:
            raise ValueError("dense decode requires positions")
        b, t = q.shape[:2]
        s = cache.shape[2]
        positions = positions.long()
        start = positions[:, 0].clamp(min=0, max=s - t)
        idx = start[:, None] + torch.arange(t, device=q.device)
        rows = torch.arange(b, device=q.device)[:, None]
        cache[0][rows, idx] = k.to(cache.dtype)
        cache[1][rows, idx] = v.to(cache.dtype)
        k_idx = torch.arange(s, device=q.device)
        mask = k_idx[None, None, None, :] <= positions[:, None, :, None]
        return dense_attention(q, cache[0], cache[1], causal=False,
                               mask=mask)

    def _decode_attend_paged(self, q, k, v, positions, block_tables,
                             kv_pool, prefix_attend):
        """Scatter this call's K/V into the rows' pages, then attend.

        ``positions`` [B, T]: absolute positions, contiguous per row;
        rows may sit at different offsets.  ``block_tables`` [B,
        max_pages] maps a row's logical page (position // page_size) to
        a page of ``kv_pool`` [num_pages, kvh, ps, 2*hd].  T > 1 is
        prompt prefill: the window is causal over itself, so the scatter
        is its whole pool interaction; right-pad garbage past a real
        prompt is overwritten by decode writes before any length mask
        makes it visible.  Table entries that are 0 point at scratch
        page 0, which absorbs padded rows' writes.

        JAX donates the pool and returns the updated copy; here the
        scatter writes the caller's pool in place.
        """
        if positions is None:
            raise ValueError("paged decode requires positions and "
                             "block_tables")
        ps = kv_pool.shape[2]
        positions = positions.long()
        pages = torch.gather(block_tables.long(), 1, positions // ps)
        offs = positions % ps
        kv = torch.cat([k, v], dim=-1).to(kv_pool.dtype)
        # advanced indices at dims 0 and 2 around a slice -> the value
        # layout is [B, T, kvh, 2hd], as in the JAX scatter
        kv_pool[pages, :, offs] = kv
        if q.shape[1] > 1:
            if not prefix_attend:
                return dense_attention(q, k, v, causal=True)
            # suffix prefill: leading table entries hold a cached prompt
            # prefix, so gather the row's whole logical span back out of
            # the pool and mask by absolute position.  Unallocated entries
            # point at scratch page 0, whose garbage sits past every real
            # query position.  XLA computes this in the reference, so it
            # is plain PyTorch here too.
            hd = q.shape[-1]
            gathered = kv_pool[block_tables.long()]  # [B, mp, kvh, ps, 2hd]
            span = gathered.transpose(2, 3).reshape(
                q.shape[0], -1, kv_pool.shape[1], 2 * hd)
            k_idx = torch.arange(span.shape[1], device=q.device)
            mask = k_idx[None, None, None, :] <= positions[:, None, :, None]
            return dense_attention(q, span[..., :hd], span[..., hd:],
                                   causal=False, mask=mask)
        out = paged_attention(q[:, 0], kv_pool, block_tables,
                              (positions[:, 0] + 1).to(torch.int32))
        return out[:, None]


class Block(nn.Module):
    """Attention, then the SwiGLU ``mlp`` or, when ``cfg.moe_experts``,
    the mixture of experts ``moe`` (``ops/moe.py``).  ``forward``
    returns (x, the MoE aux loss or None)."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.moe = (MoEMLP(cfg.d_model, cfg.moe_experts, cfg.d_ff,
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           aux_loss_coef=cfg.moe_aux_coef,
                           compute_dtype=cfg.dtype, **kw)
                    if cfg.moe_experts else None)
        if self.moe is None:
            self.mlp = MLP(cfg, **kw)

    def forward(self, x, cos, sin, positions=None, block_tables=None,
                kv=None, prefix_attend: bool = False):
        x = self.attn_half(x, cos, sin, positions, block_tables, kv,
                           prefix_attend)
        return self.mlp_half(x)

    def attn_half(self, x, cos, sin, positions=None, block_tables=None,
                  kv=None, prefix_attend: bool = False):
        return x + self.attn(self.attn_norm(x), cos, sin, positions,
                             block_tables, kv, prefix_attend)

    def mlp_half(self, x):
        y = self.mlp_norm(x)
        if self.moe is None:
            return x + self.mlp(y), None
        y, aux = self.moe(y)
        return x + y, aux


def remat_block(blk: Block, policy: str, x, *args):
    """``blk(x, *args)`` under per-block activation checkpointing with one
    of ``REMAT_POLICIES``.  Remat changes memory, never values."""
    if policy == "nothing":
        return checkpoint(blk, x, *args, use_reentrant=False)
    if policy == "block_outs":
        x = checkpoint(blk.attn_half, x, *args, use_reentrant=False)
        return checkpoint(blk.mlp_half, x, use_reentrant=False)
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat_policy {policy!r}; choose one of "
                         f"{sorted(REMAT_POLICIES)}")
    ctx = functools.partial(create_selective_checkpoint_contexts,
                            _SAVED_OPS[policy])
    return checkpoint(blk, x, *args, use_reentrant=False, context_fn=ctx)


class GPT(nn.Module):
    """Decoder-only LM.  ``forward`` returns fp32 logits [B, S, vocab], or
    the post-final-norm hidden states [B, S, d_model] with
    ``return_hidden=True`` (``head`` projects them).

    Runs on the card unless ``device="cpu"`` is passed; parameters are
    made in ``dtype`` (default ``cfg.param_dtype``) and activations are
    ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or cfg.param_dtype
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, **kw))
        # fp32 tables, as the JAX model computes them; buffers, so they
        # follow .to(device) but are never cast with the parameters
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def _n_remat(self, decoding: bool) -> int:
        """How many leading blocks run under checkpointing: none when
        decoding or without gradients; else ``remat_layers`` when it lies
        strictly between 0 and n_layers, and all of them otherwise (as
        the JAX model splits its stack)."""
        cfg = self.cfg
        if not cfg.remat or decoding or not torch.is_grad_enabled():
            return 0
        n = cfg.n_layers if cfg.remat_layers is None else cfg.remat_layers
        return n if 0 < n < cfg.n_layers else cfg.n_layers

    def forward(self, tokens, positions=None, *, return_hidden: bool = False,
                block_tables=None, kv_pools: Optional[List] = None,
                kv_cache: Optional[List] = None,
                prefix_attend: bool = False, return_aux: bool = False):
        """``kv_pools`` with ``block_tables``: paged decode; ``kv_cache``:
        dense slot decode (see the module docstring).  ``return_aux``:
        return (output, the MoE blocks' summed aux loss, None without
        experts); it is returned and not kept on a module, so a remat
        recompute cannot overwrite it."""
        cfg = self.cfg
        if kv_pools is not None and kv_cache is not None:
            raise ValueError("pass kv_pools (paged) or kv_cache (dense), "
                             "not both")
        if (kv_pools is None) != (block_tables is None):
            raise ValueError("paged decode takes kv_pools and block_tables "
                             "together")
        caches = kv_pools if kv_pools is not None else kv_cache
        if caches is not None and len(caches) != cfg.n_layers:
            raise ValueError(f"{len(caches)} KV caches for "
                             f"{cfg.n_layers} layers")
        x = F.embedding(tokens.long(), self.embed).to(cfg.dtype)
        n_remat = self._n_remat(caches is not None)
        aux = None
        for i, blk in enumerate(self.blocks):
            args = (self.cos, self.sin, positions, block_tables,
                    None if caches is None else caches[i], prefix_attend)
            if i < n_remat:
                x, a = remat_block(blk, cfg.remat_policy, x, *args)
            else:
                x, a = blk(x, *args)
            if a is not None:
                aux = a if aux is None else aux + a
        x = self.final_norm(x)
        out = x if return_hidden else self.head(x)
        return (out, aux) if return_aux else out

    def head(self, x):
        """[..., d_model] post-norm hidden -> fp32 logits [..., vocab]."""
        if self.lm_head is None:
            return (x @ self.embed.to(self.cfg.dtype).T).float()
        return self.lm_head(x).float()
