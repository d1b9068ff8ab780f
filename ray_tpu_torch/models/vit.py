"""ViT: the Vision Transformer image classifier (counterpart of
ray_tpu/models/vit.py).

Patchify as a reshape (not a convolution), one ``patch_proj`` matmul, a
learned ``pos_embed``, the shared bidirectional ``Encoder``
(``models/encoder.py``), a mean over the patches (no class token) and a
bias-free ``head``.  Images arrive NHWC, as in the JAX API.  No
BatchNorm, so ``train/step.py`` ``make_vision_train`` trains it as it
trains ResNet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.configs import TransformerConfig
from ray_tpu_torch.models.encoder import Encoder, learned_positions
from ray_tpu_torch.ops.layers import Dense


@dataclasses.dataclass
class ViTConfig:
    """The reference's ``ViTConfig`` with torch dtypes, and
    ``attention_impl`` for the encoder (the reference's encoder takes
    ``TransformerConfig``'s default, ``"auto"``)."""
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    encoder: TransformerConfig = None          # set in __post_init__

    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    scan_layers: bool = True
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        if self.encoder is None:
            self.encoder = TransformerConfig(
                vocab_size=1,  # unused by the encoder body
                d_model=self.d_model, n_layers=self.n_layers,
                n_heads=self.n_heads, d_ff=self.d_ff,
                max_seq_len=self.num_patches,
                dtype=self.dtype, param_dtype=self.param_dtype,
                remat=self.remat, scan_layers=self.scan_layers,
                attention_impl=self.attention_impl)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_PRESETS = {
    "vit-tiny-test": ViTConfig(image_size=32, patch_size=8, num_classes=10,
                               d_model=64, n_layers=2, n_heads=4, d_ff=128,
                               dtype=torch.float32),
    "vit-s16": ViTConfig(d_model=384, n_layers=12, n_heads=6),
    "vit-b16": ViTConfig(d_model=768, n_layers=12, n_heads=12),
    "vit-l16": ViTConfig(d_model=1024, n_layers=24, n_heads=16),
}


def get_vit_config(name: str, **overrides) -> ViTConfig:
    # always copy: presets are shared mutable dataclasses
    return dataclasses.replace(VIT_PRESETS[name], encoder=None, **overrides)


class ViT(nn.Module):
    """``forward(images [B, H, W, C])`` -> fp32 logits [B, num_classes].

    Runs on the card unless ``device="cpu"`` is passed; parameters are
    made in ``dtype`` (default ``cfg.param_dtype``)."""

    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        enc = cfg.encoder
        dtype = dtype or enc.param_dtype
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_proj = Dense(p * p * 3, enc.d_model, enc.dtype, **kw)
        self.pos_embed = learned_positions(enc, cfg.num_patches, **kw)
        self.encoder = Encoder(enc, **kw)
        self.head = Dense(enc.d_model, cfg.num_classes, enc.dtype, **kw)

    def forward(self, images):
        cfg, enc = self.cfg, self.cfg.encoder
        p = cfg.patch_size
        b, hh, ww, c = images.shape
        if c * p * p != self.patch_proj.in_features:
            raise ValueError(f"patch_proj takes {self.patch_proj.in_features}"
                             f" features, the images give {c * p * p}")
        # [B, H/p, W/p, p*p*C]: a reshape; the projection is then one
        # matmul over every patch
        x = images.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.num_patches,
                                                 p * p * c)
        x = self.patch_proj(x.to(enc.dtype))
        x = x + self.pos_embed.to(enc.dtype)
        x = self.encoder(x)
        return self.head(x.mean(dim=1)).float()
