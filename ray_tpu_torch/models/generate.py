"""Autoregressive decoding: sampling, the decode caches, and
``Generator`` (counterpart of ray_tpu/models/generate.py).

``Generator`` runs the model's dense slot decode path (``kv_cache``): a
prefill that is one wide step at offset 0, then one step per token.  The
serving engine (``serve/llm_engine.py``) shares the sampler and both
caches.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Union

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.gpt import GPT


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


def init_dense_cache(cfg: TransformerConfig, rows: int, *, device,
                     seq_len: Optional[int] = None) -> List[torch.Tensor]:
    """Zeroed dense KV cache, one tensor per layer, each [2, rows,
    seq_len, kv_heads, head_dim] (K, then V; ``seq_len`` defaults to
    ``cfg.max_seq_len``) in ``cfg.dtype``: the cache JAX's
    ``init_decode_cache`` builds for a dense decode model."""
    shape = (2, rows, seq_len or cfg.max_seq_len, cfg.n_kv_heads,
             cfg.head_dim)
    return [torch.zeros(shape, device=device, dtype=cfg.dtype)
            for _ in range(cfg.n_layers)]


class Generator:
    """A model held for repeated generation over the dense cache.

    ``params_or_model``: the port's ``GPT``, used as it is, or its state
    dict, loaded into a new ``GPT`` in ``cfg.param_dtype``.  Runs on the
    card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: TransformerConfig,
                 params_or_model: Union[GPT, Mapping[str, torch.Tensor]], *,
                 device=None):
        self.cfg = cfg
        if isinstance(params_or_model, GPT):
            self.model = params_or_model
            self.device = self.model.embed.device
        else:
            self.device = resolve_device(device)
            self.model = GPT(cfg, device=self.device)
            self.model.load_state_dict(params_or_model)
            self.model.eval()

    def init_cache(self, batch_size: int) -> List[torch.Tensor]:
        return init_dense_cache(self.cfg, batch_size, device=self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, *, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """prompt_tokens [B, S] -> generated ids [B, <= max_new_tokens]
        (int32).

        Stops early only when *every* row has emitted ``eos_id``; rows
        that finished earlier keep their first eos and are padded with
        it.  ``generator``: the sampler's random stream (default: one
        seeded with 0 on the model's device)."""
        tokens = torch.as_tensor(prompt_tokens, dtype=torch.int32,
                                 device=self.device)
        b, s = tokens.shape
        if s + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {s} + {max_new_tokens} new > max_seq_len "
                f"{self.cfg.max_seq_len}")
        if max_new_tokens <= 0:
            return torch.zeros(b, 0, dtype=torch.int32, device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        cache = self.init_cache(b)
        positions = torch.arange(s, device=self.device).expand(b, s)
        logits = self.model(tokens, positions, kv_cache=cache)[:, -1]
        out = []
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        for i in range(max_new_tokens):
            token = sample_logits(logits, temperature=temperature,
                                  top_k=top_k, top_p=top_p,
                                  generator=generator)
            if eos_id is not None:
                token = torch.where(done, eos_id, token).to(torch.int32)
                done = done | (token == eos_id)
            out.append(token)
            if i == max_new_tokens - 1 or (eos_id is not None
                                           and bool(done.all())):
                break   # the logits for a further token are never needed
            pos = torch.full((b, 1), s + i, device=self.device)
            logits = self.model(token[:, None], pos, kv_cache=cache)[:, -1]
        return torch.stack(out, dim=1)


def generate(cfg: TransformerConfig, params_or_model, prompt_tokens, *,
             device=None, **kwargs) -> torch.Tensor:
    """One-shot convenience wrapper around ``Generator``."""
    return Generator(cfg, params_or_model, device=device).generate(
        prompt_tokens, **kwargs)
