"""Shared bidirectional transformer encoder stack, the body of ViT, BERT
and T5 (counterpart of ray_tpu/models/encoder.py).

The blocks are the decoder's (``models/gpt.py``: RMSNorm, SwiGLU,
``Dense`` projections computing in ``cfg.dtype``) with non-causal
attention through ``ops/attention.py``: flash (kernels K1-K3) on CUDA
tensors under ``"auto"``, with ``cfg.attention_impl`` otherwise.  As in
the reference, ``ring`` and ``ulysses`` (causal-LM context machinery)
become ``auto``, and a mask sends the call to ``dense_attention``.  The
kernels take grouped-query heads as they are, so nothing repeats K and V.

Parameter names follow the flax tree (``blocks.{i}.attn.wq.weight`` for
``blocks/attn/wq/kernel``), as ``models/convert.py`` maps them.  Under
``cfg.remat`` every block runs under ``gpt.remat_block`` when gradients
are on: the JAX ``Encoder`` stacks its layers with one ``stack_layers``
call, so it ignores ``remat_layers``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.gpt import MLP, RMSNorm, remat_block
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import Dense


class EncoderAttention(nn.Module):
    """Bidirectional attention; cross-attention over ``kv`` when given."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d, h * hd, cfg.dtype, **kw)
        self.wk = Dense(d, kvh * hd, cfg.dtype, **kw)
        self.wv = Dense(d, kvh * hd, cfg.dtype, **kw)
        self.wo = Dense(h * hd, d, cfg.dtype, **kw)

    def forward(self, x, kv=None, mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        kv_in = x if kv is None else kv
        b, t, _ = x.shape
        s = kv_in.shape[1]
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.wq(x).view(b, t, h, hd)
        k = self.wk(kv_in).view(b, s, kvh, hd)
        v = self.wv(kv_in).view(b, s, kvh, hd)
        impl = cfg.attention_impl
        if impl in ("ring", "ulysses"):
            impl = "auto"
        out = attention(q, k, v, causal=False, impl=impl, mask=mask)
        return self.wo(out.reshape(b, t, h * hd))


class EncoderBlock(nn.Module):
    """Pre-norm attention, then the SwiGLU MLP.  ``attn_half`` and
    ``mlp_half`` are the two halves ``remat_block``'s ``block_outs``
    policy checkpoints apart.  Built on the card unless ``device="cpu"``
    is passed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device),
                  dtype=dtype or cfg.param_dtype)
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.attn = EncoderAttention(cfg, **kw)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, mask=None):
        return self.mlp_half(self.attn_half(x, mask))

    def attn_half(self, x, mask=None):
        return x + self.attn(self.attn_norm(x), mask=mask)

    def mlp_half(self, x):
        return x + self.mlp(self.mlp_norm(x))


def run_blocks(blocks, cfg: TransformerConfig, x, *args):
    """``x`` through every block of ``blocks`` with ``*args``, each under
    ``remat_block`` when ``cfg.remat`` is on and gradients are; the
    reference stacks such blocks with one ``stack_layers`` call, so
    ``remat_layers`` does not apply."""
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in blocks:
        x = (remat_block(blk, cfg.remat_policy, x, *args) if remat
             else blk(x, *args))
    return x


class Encoder(nn.Module):
    """Stack of bidirectional blocks and ``final_norm``; the input is an
    embedded sequence [B, S, d_model] in ``cfg.dtype``.  Built on the
    card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device),
                  dtype=dtype or cfg.param_dtype)
        self.cfg = cfg
        self.blocks = nn.ModuleList(EncoderBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        return self.final_norm(run_blocks(self.blocks, self.cfg, x, mask))


def learned_positions(cfg: TransformerConfig, length: int, *, device=None,
                      dtype=None) -> nn.Parameter:
    """The learned absolute position table [length, d_model] (BERT / ViT
    style), registered by the caller as ``pos_embed``; ``init_weights``
    draws it from normal(0.02) as flax does."""
    return nn.Parameter(torch.zeros(length, cfg.d_model, device=device,
                                    dtype=dtype))
