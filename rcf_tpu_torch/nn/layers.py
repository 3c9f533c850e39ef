"""Shared building blocks: a conv with a compute dtype, BatchNorm with the
JAX package's statistics, ConvModule.

Modules take and return channel-last tensors at their public ``forward``
where the JAX package does; inside, convolutions run on a permuted view
(NCHW shape, channels-last memory), so no copy is made at the boundary.

Compute dtype, as Flax's module ``dtype``: parameters stay f32; a conv
casts its input, kernel and bias to the compute dtype and returns that
dtype; BatchNorm takes its batch statistics and normalizes in f32 (its
running statistics stay f32) and returns the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# torch BatchNorm2d defaults, as in rcf_tpu/nn/layers.py: momentum 0.1 (Flax's
# 0.9 on the old value), eps 1e-5.
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``, as ``flax.linen.Conv(dtype=...)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW with Flax's running statistics.

    Training normalizes with the batch statistics, as ``nn.BatchNorm2d``
    does, but updates ``running_var`` with the *biased* batch variance, as
    Flax (and so the JAX package) does; torch's own module uses the
    unbiased one. State: ``weight``, ``bias``, ``running_mean``,
    ``running_var``. Computes in f32 and returns ``compute_dtype``.
    """

    def __init__(self, num_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, BN_EPS).to(self.compute_dtype)
        # momentum=1 makes the fused op hand back the batch mean and the
        # unbiased batch variance in these scratch buffers.
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(xf, mean, var, self.weight, self.bias, True, 1.0, BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m * (n - 1) / n)
        return y.to(self.compute_dtype)


def he_normal_(w: torch.Tensor, generator: torch.Generator | None = None,
               scale: float = 2.0) -> torch.Tensor:
    """Flax's ``he_normal``: truncated normal (+-2 sd), variance scale/fan_in
    (``scale=1`` is ``lecun_normal``, Flax's ``Dense`` default)."""
    fan_in = w[0].numel()
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(lo, hi, generator=generator).erfinv_().mul_(std * math.sqrt(2.0))
    return w


def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Initialize every conv as the JAX package does: he-normal kernels, zero biases.

    A ``Conv1d`` with a kernel of 1 is a Flax ``Dense`` there (the flow
    head's ``flow_feat_after_agg``) and gets its lecun-normal kernel.
    Modules that need another init (``FCNHead.conv_seg``) override it after.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv1d)):
            he_normal_(m.weight, generator, scale=1.0 if isinstance(m, nn.Conv1d) else 2.0)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


class ConvModule(nn.Module):
    """3x3 conv (no bias) -> BN -> ReLU, the mmcv ConvModule contract (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=dilation,
                           dilation=dilation, bias=False, compute_dtype=dtype)
        self.bn = BatchNorm2d(out_channels, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))
