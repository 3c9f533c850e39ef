"""FCN decode head, single-input path (port of ``rcf_tpu/nn/fcn_head.py``).

``in_index`` picks one backbone feature; ``num_convs`` dilated 3x3
ConvModules (BN+ReLU), channel dropout (Dropout2d) and a 1x1 ``conv_seg``
classifier initialized N(0, 0.01). The ``resize_concat`` input
transform, the ``concat_input`` fusion conv and the fused resize-conv of
the RCF heads are not ported yet: ``concat_input`` defaults to True as in
JAX, so a head built without the key raises with the rest.

State-dict keys follow the reference FCNHead (``convs.{i}.conv``,
``convs.{i}.bn``, ``conv_seg``). ``forward`` takes the NHWC
feature tuple and returns NHWC logits, in the compute ``dtype``
(``nn/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, ConvModule, to_nchw, to_nhwc


class FCNHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int, channels: int = 256,
                 num_convs: int = 2, dilation: int = 1, dropout_ratio: float = 0.1,
                 in_index: int = -1, concat_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if concat_input or not isinstance(in_index, int):
            raise NotImplementedError(
                "the port's FCNHead takes one input feature (int in_index, concat_input false)")
        self.in_index = in_index
        self.dropout_ratio = dropout_ratio
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else channels, channels, dilation=dilation,
                       dtype=dtype)
            for i in range(num_convs))
        self.conv_seg = Conv2d(channels, num_classes, 1, compute_dtype=dtype)

    def init_conv_seg_(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.conv_seg.weight.normal_(0.0, 0.01, generator=generator)
            self.conv_seg.bias.zero_()

    def forward(self, inputs, generator: torch.Generator | None = None) -> torch.Tensor:
        out = to_nchw(inputs[self.in_index])
        for conv in self.convs:
            out = conv(out)
        if self.training and self.dropout_ratio > 0:
            # Dropout2d: drop whole channels per sample, keep-scaled.
            keep = torch.rand(out.shape[0], out.shape[1], 1, 1, generator=generator,
                              device=out.device) >= self.dropout_ratio
            out = out * keep.to(out.dtype) / (1.0 - self.dropout_ratio)
        return to_nhwc(self.conv_seg(out))
