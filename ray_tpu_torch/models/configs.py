"""Model configuration presets (counterpart of ray_tpu/models/configs.py).

A copy of ``TransformerConfig`` and ``PRESETS`` with torch dtypes; the
port imports nothing of ray_tpu.  Field names and preset values stay
identical so a config means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None       # None -> = n_heads (MHA)
    d_ff: Optional[int] = None             # None -> 4 * d_model
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16    # activation dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"           # auto | xla | flash | splash | ring | ulysses
    remat: bool = True
    remat_layers: Optional[int] = None
    remat_policy: str = "dots"
    scan_layers: bool = True
    tie_embeddings: bool = False
    z_loss: float = 1e-4
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if self.n_kv_heads is None:
            self.n_kv_heads = self.n_heads
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        attn = self.d_model * self.head_dim * (
            self.n_heads * 2 + self.n_kv_heads * 2)
        mlp = 3 * self.d_model * self.d_ff
        norms = 2 * self.d_model
        return emb + self.n_layers * (attn + mlp + norms) + self.d_model


PRESETS = {
    "tiny": TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                              n_heads=4, d_ff=128, max_seq_len=128,
                              dtype=torch.float32, remat=False),
    "tiny-moe": TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                  n_heads=4, d_ff=128, max_seq_len=128,
                                  dtype=torch.float32, remat=False,
                                  moe_experts=8, moe_top_k=2),
    "mixtral-8x7b": TransformerConfig(vocab_size=32000, d_model=4096,
                                      n_layers=32, n_heads=32, n_kv_heads=8,
                                      d_ff=14336, max_seq_len=8192,
                                      rope_theta=1e6, moe_experts=8,
                                      moe_top_k=2),
    "gpt-small": TransformerConfig(vocab_size=50304, d_model=768, n_layers=12,
                                   n_heads=12, max_seq_len=1024),
    "gpt-medium": TransformerConfig(vocab_size=50304, d_model=1024,
                                    n_layers=24, n_heads=16,
                                    max_seq_len=1024),
    "gpt-large": TransformerConfig(vocab_size=50304, d_model=1280,
                                   n_layers=36, n_heads=20,
                                   max_seq_len=1024),
    "gpt-xl": TransformerConfig(vocab_size=50304, d_model=2048, n_layers=24,
                                n_heads=16, max_seq_len=2048),
    "gptj-6b": TransformerConfig(vocab_size=50400, d_model=4096, n_layers=28,
                                 n_heads=16, max_seq_len=2048),
    # LLaMA-3-8B shapes: the serving slice's model
    "llama3-8b": TransformerConfig(vocab_size=128256, d_model=4096,
                                   n_layers=32, n_heads=32, n_kv_heads=8,
                                   d_ff=14336, max_seq_len=8192,
                                   rope_theta=500000.0),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    base = PRESETS[name]
    return dataclasses.replace(base, **overrides) if overrides else base
