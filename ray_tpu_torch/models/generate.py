"""Sampling and decode-cache allocation (counterpart of
ray_tpu/models/generate.py).

``Generator`` (lone generation over the dense cache) is not ported yet:
ROADMAP.md Queue 1 item 2.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ray_tpu_torch.models.configs import TransformerConfig


def _trim_logits(logits: torch.Tensor, top_k: int,
                 top_p: float) -> torch.Tensor:
    """Mask to -inf every logit outside the top-k, then outside the
    smallest top-p nucleus, as ``ray_tpu.models.generate._trim_logits``."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p; an index
        # past the end clamps to the last entry, as JAX's gather does
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max sampling, as ``jax.random.categorical`` does it; no
    host synchronisation.  The bits differ from JAX's."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits: torch.Tensor, *,
                  temperature: Union[float, torch.Tensor] = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Sample token ids from [B, V] logits (greedy where temperature is 0).

    ``temperature`` may be a scalar or a per-row [B] tensor: greedy rows
    take the argmax under the same call.  ``torch.argmax`` returns the
    first maximal index, as ``jnp.argmax`` does, so greedy ties resolve
    alike in both packages."""
    if not torch.is_tensor(temperature):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _categorical(_trim_logits(logits / temperature, top_k, top_p),
                            generator).to(torch.int32)
    temps = temperature.to(device=logits.device, dtype=torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temps > 0, temps, 1.0)
    trimmed = _trim_logits(logits / safe_t[:, None], top_k, top_p)
    sampled = _categorical(trimmed, generator)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def init_decode_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
                      *, device, dtype: Optional[torch.dtype] = None
                      ) -> List[torch.Tensor]:
    """Zeroed paged KV pools, one per layer, each
    [num_pages, kv_heads, page_size, 2*head_dim] in ``dtype`` (default
    ``cfg.dtype``); page 0 is the scratch page."""
    shape = (num_pages, cfg.n_kv_heads, page_size, 2 * cfg.head_dim)
    return [torch.zeros(shape, device=device, dtype=dtype or cfg.dtype)
            for _ in range(cfg.n_layers)]
