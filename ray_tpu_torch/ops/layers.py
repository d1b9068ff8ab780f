"""Layer primitives: the bias-free projection ``Dense``, RMSNorm, rotary
embeddings, SwiGLU (counterpart of ray_tpu/ops/layers.py).

Plain tensor code: none of these is a TPU kernel in the JAX package
(XLA fuses them there), so none is a hand-written kernel here yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """A bias-free projection with flax ``DenseGeneral(dtype,
    param_dtype)`` semantics: ``weight`` [out, in] is stored in the
    parameter dtype, and each call casts it and the input to
    ``compute_dtype``."""

    def __init__(self, d_in: int, d_out: int, compute_dtype: torch.dtype,
                 *, device=None, dtype=None):
        super().__init__(d_in, d_out, bias=False, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt, w = self.compute_dtype, self.weight
        # the dtype tests keep a model already in compute_dtype (serving)
        # free of per-call cast dispatches
        if w.dtype != dt:
            w = w.to(dt)
        if x.dtype != dt:
            x = x.to(dt)
        return F.linear(x, w)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_len, head_dim // 2], fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                             dtype=torch.float32) / head_dim))
    t = torch.arange(max_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding on [B, S, H, D], D split into two halves (not
    interleaved pairs), in fp32.  ``positions``: [B, S] absolute
    positions; default arange(S)."""
    s = x.shape[1]
    if positions is None:
        cos_s = cos[:s][None, :, None, :]
        sin_s = sin[:s][None, :, None, :]
    else:
        positions = positions.long()
        cos_s = cos[positions][:, :, None, :]
        sin_s = sin[positions][:, :, None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s],
                        dim=-1)
    return rotated.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
