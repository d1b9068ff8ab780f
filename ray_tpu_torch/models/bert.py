"""BERT-family masked-LM encoder (counterpart of ray_tpu/models/bert.py).

Learned positions, the shared bidirectional ``Encoder``
(``models/encoder.py``) and a tied-embedding MLM head.  Padding reaches
attention as a key mask, which sends it to ``dense_attention``: the
kernels have no padding-mask path, in the reference as here.
``mlm_loss_fn`` plugs into ``train/step.py`` ``make_train``;
``masked_batch`` builds BERT's 80/10/10 corruption with the reference's
numpy draws, so one seed gives the same batch in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.encoder import Encoder, learned_positions
from ray_tpu_torch.models.gpt import RMSNorm
from ray_tpu_torch.ops.layers import Dense

IGNORE = -100                      # label value for unmasked positions


class BERT(nn.Module):
    """``forward(tokens [B, S], attn_mask [B, S]?)`` -> fp32 logits
    [B, S, vocab].  Runs on the card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or cfg.param_dtype
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        self.pos_embed = learned_positions(cfg, cfg.max_seq_len, **kw)
        self.encoder = Encoder(cfg, **kw)
        self.mlm_transform = Dense(cfg.d_model, cfg.d_model, cfg.dtype, **kw)
        self.mlm_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)

    def forward(self, tokens, attn_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed).to(cfg.dtype)
        x = x + self.pos_embed[:tokens.shape[1]].to(cfg.dtype)
        mask = None if attn_mask is None else attn_mask.bool()
        x = self.encoder(x, mask)
        # flax's nn.gelu is the tanh approximation
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = self.mlm_norm(x)
        return (x @ self.embed.to(cfg.dtype).T).float()


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def mlm_loss_fn(model: nn.Module, batch: Dict[str, Any],
                z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Masked-LM loss: batch {"tokens", "labels" (IGNORE elsewhere),
    "attn_mask"?}.  Plugs into ``make_train(loss_fn=...)``."""
    dev = _device(model)
    mask = batch.get("attn_mask")
    logits = model(torch.as_tensor(batch["tokens"], device=dev),
                   None if mask is None else torch.as_tensor(mask,
                                                             device=dev))
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, safe[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    if z_loss:
        loss = loss + z_loss * torch.where(valid, lse.square(),
                                           0.0).sum() / denom
    acc = (valid & (logits.argmax(-1) == safe)).sum() / denom
    return loss, {"loss": loss, "mlm_accuracy": acc,
                  "masked_tokens": denom}


def masked_batch(tokens: np.ndarray, vocab_size: int, *,
                 mask_token: int, mask_prob: float = 0.15,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """BERT corruption: of the selected 15%, 80% -> [MASK], 10% -> random,
    10% unchanged; labels carry the original ids, IGNORE elsewhere."""
    rng = np.random.default_rng(seed)
    tokens = np.asarray(tokens)
    sel = rng.random(tokens.shape) < mask_prob
    labels = np.where(sel, tokens, IGNORE)
    r = rng.random(tokens.shape)
    corrupted = tokens.copy()
    corrupted[sel & (r < 0.8)] = mask_token
    rand_ids = rng.integers(0, vocab_size, tokens.shape)
    swap = sel & (r >= 0.8) & (r < 0.9)
    corrupted[swap] = rand_ids[swap]
    return {"tokens": corrupted, "labels": labels}
