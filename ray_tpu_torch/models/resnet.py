"""ResNet family (v1.5), the vision baseline model (counterpart of
ray_tpu/models/resnet.py).

Images arrive NHWC, as in the JAX API; the model views them as NCHW in
channels-last memory, the layout cuDNN's bf16 convolutions take without
a transpose.  The reference runs its convolutions as XLA convolutions,
not Pallas kernels, so here they are ``F.conv2d``.  Where a direct
translation would give other numbers, this follows flax:

  - ``padding="SAME"`` is asymmetric at stride 2 (7x7/2 on 224 pads
    (2, 3), 3x3/2 on 56 pads (0, 1)); ``same_padding`` computes it as
    ``lax.padtype_to_pads`` does, and the max pool pads with -inf;
  - flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
    normalises with the biased batch variance E[x^2] - E[x]^2 and keeps
    that same value in its running variance (``torch.nn.BatchNorm2d``
    keeps the unbiased one, and its momentum 0.1 is flax's 0.9);
  - the BatchNorm output is fp32, so ReLU and the residual add run in
    fp32; only each convolution's input is cast to ``dtype``;
  - the classifier ``head`` is fp32 with a bias.

The reference's ``train`` attribute is the module's mode here: in
training mode (the default) BatchNorm normalises with the batch's
statistics and updates its ``mean`` / ``var`` buffers in the forward,
in eval mode it uses them.  Parameter and buffer names map onto the
flax tree in ``models/convert.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device

_DIMS = (0, 2, 3)          # BatchNorm's reduction axes over NCHW


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under flax's "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded as "SAME" needs: (padded x, symmetric
    padding left for the op), so a symmetric case costs no copy."""
    (t, b), (l, r) = (same_padding(n, kernel, stride) for n in x.shape[2:])
    if t == b and l == r and value == 0.0:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class Conv(nn.Module):
    """Bias-free 2-D convolution with flax ``Conv(padding="SAME",
    use_bias=False, dtype)`` semantics: ``weight`` [out, in, kh, kw]
    (channels-last memory) is stored in the parameter dtype, and each
    call casts it and the input to ``compute_dtype``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 device=None, dtype=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(
            c_out, c_in, kernel, kernel, device=device, dtype=dtype,
            memory_format=torch.channels_last))

    def forward(self, x):
        x, pad = _pad_same(x.to(self.compute_dtype), self.kernel,
                           self.stride)
        return F.conv2d(x, self.weight.to(self.compute_dtype),
                        stride=self.stride, padding=pad)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over NCHW ``x`` of any float dtype, as
    flax computes it: fp32 statistics, mean E[x] and biased variance
    E[x^2] - E[x]^2 clipped at 0, y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias in fp32.  Returns (y, mean, var).  It saves ``x`` in
    its own dtype and the per-channel statistics, not the fp32 copies
    that autograd through the same ops would keep; the backward is the
    analytic gradient of the same function."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        x32 = x.float()
        mean = x32.mean(_DIMS)
        var = (x32.square().mean(_DIMS) - mean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x32 - mean[:, None, None]) * (invstd * scale)[:, None, None]
        y += bias[:, None, None]
        ctx.save_for_backward(x, mean, invstd, scale)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, mean, invstd, scale = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        dbias = dy.sum(_DIMS)
        dscale = (dy * xhat).sum(_DIMS)
        dx = dy - (dbias / n)[:, None, None]
        dx -= xhat * (dscale / n)[:, None, None]
        dx *= (scale * invstd)[:, None, None]
        return dx.to(x.dtype), dscale, dbias, None


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum, epsilon, dtype=float32)`` over the
    channels of NCHW input: fp32 ``scale`` and ``bias`` parameters (flax's
    names), running ``mean`` and ``var`` buffers (flax's ``batch_stats``)
    updated as ``momentum * running + (1 - momentum) * batch`` in
    training mode.  ``scale_init`` is the value ``init_weights`` gives the
    scale: 0 for the last norm of each residual block, as in the
    reference.  The output is fp32."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, scale_init: float = 1.0, *,
                 device=None):
        super().__init__()
        self.momentum, self.eps, self.scale_init = momentum, eps, scale_init
        kw = dict(device=device, dtype=torch.float32)
        self.scale = nn.Parameter(torch.full((channels,), scale_init, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("mean", torch.zeros(channels, **kw))
        self.register_buffer("var", torch.ones(channels, **kw))

    def forward(self, x):
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                                 self.eps)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1 - m)
                self.var.mul_(m).add_(var, alpha=1 - m)
            return y
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return ((x.float() - self.mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.conv0 = Conv(c_in, filters, 3, stride, dtype, **kw)
        self.norm0 = BatchNorm(filters, device=device)
        self.conv1 = Conv(filters, filters, 3, 1, dtype, **kw)
        self.norm1 = BatchNorm(filters, scale_init=0.0, device=device)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or c_in != filters:
            self.conv_proj = Conv(c_in, filters, 1, stride, dtype, **kw)
            self.norm_proj = BatchNorm(filters, device=device)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        return F.relu(_residual(self, x) + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        out = filters * 4
        self.conv0 = Conv(c_in, filters, 1, 1, dtype, **kw)
        self.norm0 = BatchNorm(filters, device=device)
        self.conv1 = Conv(filters, filters, 3, stride, dtype, **kw)
        self.norm1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, out, 1, 1, dtype, **kw)
        self.norm2 = BatchNorm(out, scale_init=0.0, device=device)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or c_in != out:
            self.conv_proj = Conv(c_in, out, 1, stride, dtype, **kw)
            self.norm_proj = BatchNorm(out, device=device)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        return F.relu(_residual(self, x) + y)


def _residual(block, x):
    """The block's shortcut: ``x``, or its projection where the block
    changes the shape (flax builds ``conv_proj`` where
    ``residual.shape != y.shape``: a stride or a channel change)."""
    if block.conv_proj is None:
        return x
    return block.norm_proj(block.conv_proj(x))


class ResNet(nn.Module):
    """``forward(images [B, H, W, C])`` -> fp32 logits [B, num_classes].

    Runs on the card unless ``device="cpu"`` is passed.  Images have 3
    channels (flax infers the stem's input width; it is made here).
    Parameters are fp32 (flax's default ``param_dtype``); convolutions
    compute in ``dtype``.  ``small_inputs``: the CIFAR stem, 3x3/1 and
    no max pool."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 small_inputs: bool = False, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes = list(stage_sizes)
        self.block_cls = block_cls
        self.num_classes, self.num_filters = num_classes, num_filters
        self.dtype, self.small_inputs = dtype, small_inputs
        kw = dict(device=device, dtype=torch.float32)
        self.conv_init = (Conv(3, num_filters, 3, 1, dtype, **kw)
                          if small_inputs else
                          Conv(3, num_filters, 7, 2, dtype, **kw))
        self.bn_init = BatchNorm(num_filters, device=device)
        blocks, c_in = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(c_in, filters, stride, dtype,
                                        device=device))
                c_in = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(c_in, num_classes, **kw)

    def forward(self, images):
        # NHWC -> an NCHW view in channels-last memory: no copy
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_inputs:
            x, _ = _pad_same(x, 3, 2, value=-torch.inf)
            x = F.max_pool2d(x, 3, 2)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x.mean(dim=(2, 3))).float()


def _preset(stages, block):
    def make(num_classes: int = 1000, **kwargs) -> ResNet:
        return ResNet(stages, block, num_classes=num_classes, **kwargs)
    return make


ResNet18 = _preset([2, 2, 2, 2], BasicBlock)
ResNet34 = _preset([3, 4, 6, 3], BasicBlock)
ResNet50 = _preset([3, 4, 6, 3], BottleneckBlock)
ResNet101 = _preset([3, 4, 23, 3], BottleneckBlock)
