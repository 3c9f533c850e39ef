"""mmseg-flavoured ResNet backbone (port of ``rcf_tpu/nn/resnet.py``).

Depths 18/34/50/101/152, per-stage strides and dilations,
``contract_dilation``, multi-feature ``out_indices``, 'pytorch' style
(stride on the bottleneck's 3x3 conv), 7x7 stem. The AMD config runs depth 50,
strides [1, 2, 1, 1], dilations [1, 1, 1, 2], no contract_dilation:
output stride 8; the RCF recipes dilations [1, 1, 2, 4] with
contract_dilation.

``norm_cfg`` and ``style`` are accepted for config parity, as in JAX
(SyncBN is plain BN on one card; the style is 'pytorch').
``norm_eval=True`` keeps every BN on its running statistics, in training
too: ``train()`` leaves them in eval mode.

State-dict keys follow torchvision/mmseg (``conv1``, ``bn1``,
``layer{s}.{b}.conv{i}``, ``layer{s}.{b}.downsample.{0,1}``). ``forward``
takes NHWC frames and returns NHWC features. ``dtype`` is the compute
dtype of the convolutions and batch norms (``nn/layers.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, to_nchw, to_nhwc

_STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
_BASIC_DEPTHS = (18, 34)


def _conv(cin, cout, k, stride=1, dilation=1, dtype=torch.float32):
    return Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2 * dilation,
                  dilation=dilation, bias=False, compute_dtype=dtype)


def _downsample(cin, cout, stride, dtype):
    return nn.Sequential(_conv(cin, cout, 1, stride, dtype=dtype), BatchNorm2d(cout, dtype))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, dilation, has_downsample, dtype):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, 1, dilation, dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.downsample = (_downsample(inplanes, planes, stride, dtype) if has_downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, dilation, has_downsample, dtype):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4, dtype)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype) if has_downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 contract_dilation: bool = False, norm_eval: bool = False,
                 style: str = "pytorch", norm_cfg: dict | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        block = BasicBlock if depth in _BASIC_DEPTHS else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        inplanes = 64
        self.num_stages = num_stages
        stage_channels = []
        for stage, num_blocks in enumerate(_STAGE_BLOCKS[depth][:num_stages]):
            planes = 64 * 2**stage
            stride, dilation = strides[stage], dilations[stage]
            blocks = []
            for blk in range(num_blocks):
                if blk == 0:
                    d0 = dilation // 2 if (dilation > 1 and contract_dilation) else dilation
                    has_ds = stride != 1 or inplanes != planes * block.expansion
                    blocks.append(block(inplanes, planes, stride, d0, has_ds, dtype))
                    inplanes = planes * block.expansion
                else:
                    blocks.append(block(inplanes, planes, 1, dilation, False, dtype))
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            stage_channels.append(inplanes)
        # Channels of each returned feature, in ``forward``'s order.
        self.out_channels = tuple(c for i, c in enumerate(stage_channels) if i in self.out_indices)
        self.train()  # a new module trains: with norm_eval, its BNs do not

    def train(self, mode: bool = True) -> "ResNet":
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x [N, H, W, 3] -> the ``out_indices`` stage features, each [N, h, w, C]."""
        x = F.relu(self.bn1(self.conv1(to_nchw(x))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(to_nhwc(x))
        return tuple(outs)
