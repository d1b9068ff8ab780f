"""T5-style encoder-decoder for seq2seq (counterpart of
ray_tpu/models/t5.py).

The shared bidirectional ``Encoder`` for the source; a decoder whose
blocks are causal self-attention (the decoder's ``Attention`` with RoPE,
so the flash kernels K1-K3 causal), cross-attention over the encoder
memory (``EncoderAttention``: K1-K3 non-causal with q_len != kv_len) and
the shared SwiGLU MLP.  RoPE replaces T5's relative-position bias, as in
the reference.  ``seq2seq_loss_fn`` plugs into ``train/step.py``
``make_train``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.encoder import (Encoder, EncoderAttention,
                                          run_blocks)
from ray_tpu_torch.models.gpt import MLP, Attention, RMSNorm
from ray_tpu_torch.ops.layers import rope_frequencies
from ray_tpu_torch.ops.losses import softmax_cross_entropy


class DecoderBlock(nn.Module):
    """Causal self-attention, cross-attention over ``memory``, then the
    MLP; ``attn_half`` (both attentions) and ``mlp_half`` are the halves
    ``remat_block``'s ``block_outs`` policy checkpoints apart."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.self_attn = Attention(cfg, **kw)
        self.cross_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.cross_attn = EncoderAttention(cfg, **kw)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, memory, cos, sin, enc_mask=None):
        return self.mlp_half(self.attn_half(x, memory, cos, sin, enc_mask))

    def attn_half(self, x, memory, cos, sin, enc_mask=None):
        x = x + self.self_attn(self.self_norm(x), cos, sin)
        return x + self.cross_attn(self.cross_norm(x), kv=memory,
                                   mask=enc_mask)

    def mlp_half(self, x):
        return x + self.mlp(self.mlp_norm(x))


class T5(nn.Module):
    """``forward(enc_tokens [B, Se], dec_tokens [B, Sd], enc_mask [B,
    Se]?)`` -> fp32 logits [B, Sd, vocab], one shared embedding.

    ``memory=`` skips the encoder (a decode loop encodes once, then feeds
    the memory); ``return_memory=True`` returns the encoder output
    instead of logits.  Runs on the card unless ``device="cpu"`` is
    passed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or cfg.param_dtype
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        self.encoder = Encoder(cfg, **kw)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def forward(self, enc_tokens, dec_tokens,
                enc_mask: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                return_memory: bool = False):
        cfg = self.cfg
        mask = None if enc_mask is None else enc_mask.bool()
        if memory is None:
            src = F.embedding(enc_tokens.long(), self.embed).to(cfg.dtype)
            memory = self.encoder(src, mask)
        if return_memory:
            return memory
        x = F.embedding(dec_tokens.long(), self.embed).to(cfg.dtype)
        x = run_blocks(self.blocks, cfg, x, memory, self.cos, self.sin,
                       mask)
        x = self.final_norm(x)
        return (x @ self.embed.to(cfg.dtype).T).float()


def seq2seq_loss_fn(model: nn.Module, batch: Dict[str, Any],
                    z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced seq2seq loss: batch {"enc_tokens" [B, Se],
    "dec_tokens" [B, Sd+1], "enc_mask"?, "dec_mask"? [B, Sd+1]}.  Plugs
    into ``make_train(loss_fn=...)``."""
    dev = model.embed.device
    dec = torch.as_tensor(batch["dec_tokens"], device=dev)
    inputs, targets = dec[:, :-1], dec[:, 1:]
    mask = batch.get("dec_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)[:, 1:].float()
    enc_mask = batch.get("enc_mask")
    logits = model(torch.as_tensor(batch["enc_tokens"], device=dev), inputs,
                   None if enc_mask is None
                   else torch.as_tensor(enc_mask, device=dev))
    loss, denom = softmax_cross_entropy(logits, targets, mask, z_loss)
    return loss, {"loss": loss, "tokens": denom}


@torch.no_grad()
def greedy_decode(model: T5, enc_tokens, *, max_len: int, bos_id: int,
                  eos_id: Optional[int] = None, enc_mask=None):
    """Greedy decoding with the encoder run once and a fixed-shape decoder
    buffer [B, max_len + 1], as the reference decodes (causal attention
    keeps the trailing zeros inert).  Rows that emitted ``eos_id`` keep
    emitting it, and the loop stops once every row has.  Returns the
    int32 tokens [B, n_emitted]."""
    dev = model.embed.device
    enc_tokens = torch.as_tensor(enc_tokens, device=dev)
    if enc_mask is not None:
        enc_mask = torch.as_tensor(enc_mask, device=dev)
    b = enc_tokens.shape[0]
    memory = model(enc_tokens, None, enc_mask, return_memory=True)
    dec = torch.zeros((b, max_len + 1), dtype=torch.int32, device=dev)
    dec[:, 0] = bos_id
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    n_emitted = 0
    for i in range(max_len):
        logits = model(enc_tokens, dec, enc_mask, memory=memory)
        nxt = logits[rows, i].argmax(-1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(finished, eos_id, nxt)
            finished |= nxt == eos_id
        dec[:, i + 1] = nxt
        n_emitted = i + 1
        if eos_id is not None and bool(finished.all()):
            break
    return dec[:, 1:n_emitted + 1]
