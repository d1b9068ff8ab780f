"""Loss functions for LM training (counterpart of ray_tpu/ops/losses.py).

``chunked_lm_loss`` is the memory-lean head: the [B, S, vocab] logits
never materialise at once.  The final projection and the cross-entropy
run per sequence chunk under ``torch.utils.checkpoint``, so only one
chunk's logits live at a time and the backward recomputes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float = 0.0) -> torch.Tensor:
    """Unreduced per-token CE (+ z-loss) in fp32: the shared core of the
    dense and chunked heads."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    label_logits = torch.gather(logits32, -1,
                                labels.long()[..., None]).squeeze(-1)
    losses = lse - label_logits
    if z_loss:
        losses = losses + z_loss * lse.square()
    return losses


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with optional z-loss; returns (mean_loss,
    denominator).

    logits: [..., vocab] (any dtype; softmax in fp32), labels: [...] int,
    mask: [...] with 0 to exclude (padding).
    """
    losses = _token_ce(logits, labels, z_loss)
    if mask is not None:
        mask = mask.to(losses.dtype)
        losses = losses * mask
        denom = mask.sum().clamp(min=1.0)
    else:
        denom = torch.tensor(float(losses.numel()), device=losses.device)
    return losses.sum() / denom, denom


class _Fp32Logits(torch.autograd.Function):
    """[n, D] @ [D, V] of bf16 CUDA tensors, summed and returned in fp32
    by ``torch.mm(..., out_dtype=torch.float32)``, which aten registers
    for bf16 CUDA tensors but has no derivative for.  The gradients are
    the fp32 products of the operands taken to fp32, rounded to their
    dtypes, as JAX's transpose of the fp32-accumulating einsum gives
    them."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = (g @ w.float().T).to(h.dtype) if ctx.needs_input_grad[0] \
            else None
        gw = (h.float().T @ g).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return gh, gw


def _chunk_logits(h, w):
    """fp32 logits [B, C, V] of one chunk h [B, C, D] and w [D, V] of one
    dtype, summed in fp32 as JAX's ``preferred_element_type=float32``
    sums them: on bf16 CUDA tensors by ``_Fp32Logits`` (the bf16
    products on the tensor cores), else as the product of the operands
    taken to fp32 (bf16 products are exact in fp32, so the same function
    up to summation order)."""
    if h.is_cuda and h.dtype == torch.bfloat16:
        b, c, d = h.shape
        return _Fp32Logits.apply(h.reshape(b * c, d), w).view(b, c, -1)
    return h.float() @ w.float()


def _chunk_loss(h, w, t, m, z_loss: float, transpose_weight: bool):
    w = w.to(h.dtype)
    logits = _chunk_logits(h, w.T if transpose_weight else w)
    return (_token_ce(logits, t, z_loss) * m).sum()


def chunked_lm_loss(hidden: torch.Tensor, weight: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    z_loss: float = 0.0,
                    chunk_size: int = 128,
                    transpose_weight: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE over a chunked final projection: loss(hidden @ W, labels)
    without materialising the full logits (see the module docstring).

    hidden: [B, S, D] (post final-norm); weight: [D, V] (a flax-layout
    head kernel) or [V, D] with ``transpose_weight`` (the port's
    ``lm_head.weight`` and the tied embedding); labels: [B, S]; mask:
    [B, S] with 0 to exclude.  Returns (mean_loss, denominator).

    Each chunk casts the weight to hidden's dtype, as the JAX function
    does, so that the weight's gradient sums the chunks' terms in the
    weight's own dtype (a cast outside the chunks would sum them in
    hidden's).  Each chunk's logits are summed and kept in fp32, as its
    ``preferred_element_type=jnp.float32`` keeps them (never rounded to
    hidden's dtype): on bf16 CUDA tensors through
    ``torch.mm(..., out_dtype=torch.float32)``, which the card's torch
    build (2.11, CUDA 12.8) registers for bf16; elsewhere from the
    operands taken to fp32.
    """
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones(b, s, dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    if s % chunk_size:
        # pad the sequence up to a chunk multiple; padded rows get mask 0
        pad = chunk_size - s % chunk_size
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        s += pad
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], weight,
                                   labels[:, sl], mask[:, sl], z_loss,
                                   transpose_weight, use_reentrant=False)
    denom = mask.sum().clamp(min=1.0)
    return total / denom, denom
