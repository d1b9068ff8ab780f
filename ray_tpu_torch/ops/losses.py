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


def _chunk_loss(h, w, t, m, z_loss: float, transpose_weight: bool):
    logits = h @ (w.T if transpose_weight else w)
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

    The weight is cast to hidden's dtype once, outside the chunks.  The
    chunk's logits come out of the matmul in hidden's dtype and are then
    taken to fp32, as the dense head's are; the JAX function accumulates
    them straight into fp32.  In fp32 the two are the same.
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
    w = weight.to(hidden.dtype)
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], w,
                                   labels[:, sl], mask[:, sl], z_loss,
                                   transpose_weight, use_reentrant=False)
    denom = mask.sum().clamp(min=1.0)
    return total / denom, denom
