"""FCN decode head (port of ``rcf_tpu/nn/fcn_head.py``).

* input transforms: ``resize_concat`` (upsample the picked features to the
  first pick's size, concat on channels), or one integer ``in_index``
  (``input_transform: null``); ``multiple_select`` raises, as the JAX head
  fails on it (it hands a list to conv0). A tuple *element* of the inputs
  is a deferred frame-major channel concat (the RCF residual head's
  two-frame features);
* ``num_convs`` dilated ``kernel_size`` ConvModules (BN+ReLU), the first
  at ``input_dilation`` (default ``dilation``) and ``input_stride``; the
  optional ``concat_input`` fusion conv ``conv_cat``; channel dropout
  (Dropout2d, drawn from the caller's generator for the whole batch over
  the ranks, so that a row's draw does not depend on which rank holds
  it: ``rows_per_sample`` rows make one sample); and a 1x1 ``conv_seg``
  classifier initialized N(0, 0.01).

``fast_resize_concat`` (default True, as in JAX) computes conv0 of a
multi-source input per source, with its slice of the kernel: a source at
the target size convolved as it is, a smaller one at its own resolution
through ``ops/fused_resize_conv.py``. The same math as conv0 over the
materialized concat, which stays the path taken whenever the fused
conv returns ``None`` for a source, ``concat_input`` needs the concat or
conv0 has a stride (where JAX takes its plain conv0 too).

State-dict keys follow the reference FCNHead (``convs.{i}.conv``,
``convs.{i}.bn``, ``conv_cat``, ``conv_seg``). ``forward`` takes the NHWC
feature tuple and returns NHWC logits, in the compute ``dtype``
(``nn/layers.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resize_bilinear
from ..parallel import dist
from ..ops.fused_resize_conv import fused_resize_conv, same_conv
from .layers import Conv2d, ConvModule, to_nchw, to_nhwc


class FCNHead(nn.Module):
    def __init__(self, num_classes: int, in_channels, channels: int = 256,
                 num_convs: int = 2, kernel_size: int = 3, dilation: int = 1,
                 input_dilation: int | None = None, input_stride: int = 1,
                 concat_input: bool = True, dropout_ratio: float = 0.1, in_index=-1,
                 input_transform: str | None = None, align_corners: bool = False,
                 norm_cfg: dict | None = None, fast_resize_concat: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_transform == "multiple_select":
            raise NotImplementedError(
                "multiple_select hands a list of features to conv0; the JAX head fails on it")
        if input_transform == "resize_concat" and isinstance(in_channels, int):
            raise ValueError("resize_concat needs one in_channels entry per in_index")
        self.in_index = in_index
        self.input_transform = input_transform
        self.align_corners = align_corners
        self.concat_input = concat_input
        self.dropout_ratio = dropout_ratio
        self.compute_dtype = dtype
        self.fast = fast_resize_concat and not concat_input and input_stride == 1
        cin = sum(in_channels) if isinstance(in_channels, (list, tuple)) else in_channels
        d0 = dilation if input_dilation is None else input_dilation
        self.convs = nn.ModuleList(
            [ConvModule(cin, channels, dilation=d0, dtype=dtype, kernel_size=kernel_size,
                        stride=input_stride)]
            + [ConvModule(channels, channels, dilation=dilation, dtype=dtype,
                          kernel_size=kernel_size) for _ in range(num_convs - 1)])
        if concat_input:
            self.conv_cat = ConvModule(cin + channels, channels, dilation=dilation, dtype=dtype,
                                       kernel_size=kernel_size)
        self.conv_seg = Conv2d(channels, num_classes, 1, compute_dtype=dtype)

    def init_conv_seg_(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.conv_seg.weight.normal_(0.0, 0.01, generator=generator)
            self.conv_seg.bias.zero_()

    def _transform_inputs(self, inputs) -> torch.Tensor:
        """The head's input as one NHWC tensor (the plain path)."""
        if self.input_transform == "resize_concat":
            picked = [inputs[i] for i in self.in_index]
            target_hw = tuple(picked[0].shape[-3:-1])
            return torch.cat([resize_bilinear(x, target_hw, self.align_corners) for x in picked],
                             dim=-1)
        x = inputs[self.in_index]
        return torch.cat(list(x), dim=-1) if isinstance(x, (list, tuple)) else x

    def _picked(self, inputs) -> list | None:
        """The sources of a split conv0, or None where conv0 takes one tensor."""
        if self.input_transform == "resize_concat":
            return [inputs[i] for i in self.in_index]
        x = inputs[self.in_index]
        return list(x) if isinstance(x, (list, tuple)) else None

    def _split_conv0(self, picked: list) -> torch.Tensor | None:
        """conv0's convolution as a sum over sources (NHWC), or None if a source
        needs the plain path."""
        conv = self.convs[0].conv
        kernel, dt = conv.weight.to(self.compute_dtype), self.compute_dtype
        d = conv.dilation[0]
        target_hw = tuple(picked[0].shape[-3:-1])
        out, off = None, 0
        for p in picked:
            ksl = kernel[:, off:off + p.shape[-1]]
            off += p.shape[-1]
            xp = p.to(dt)
            if tuple(p.shape[-3:-1]) == target_hw:
                y = same_conv(xp, ksl, d)
            else:
                y = fused_resize_conv(xp, ksl, target_hw, d, self.align_corners)
                if y is None:
                    return None
            out = y if out is None else out + y
        return out

    def forward(self, inputs, generator: torch.Generator | None = None,
                rows_per_sample: int = 1) -> torch.Tensor:
        picked = self._picked(inputs) if self.fast else None
        y = self._split_conv0(picked) if picked is not None else None
        if y is not None:
            out = F.relu(self.convs[0].bn(to_nchw(y)))
        else:
            x = to_nchw(self._transform_inputs(inputs))
            out = self.convs[0](x)
        for conv in self.convs[1:]:
            out = conv(out)
        if self.concat_input:
            out = self.conv_cat(torch.cat([x.to(out.dtype), out], dim=1))
        if self.training and self.dropout_ratio > 0:
            # Dropout2d: drop whole channels per sample, keep-scaled; drawn for
            # the whole batch, of which this rank keeps its rows.
            draw = torch.rand(out.shape[0] * dist.world(), out.shape[1], 1, 1,
                              generator=generator, device=out.device)
            keep = dist.local_rows(draw, rows_per_sample) >= self.dropout_ratio
            out = out * keep.to(out.dtype) / (1.0 - self.dropout_ratio)
        return to_nhwc(self.conv_seg(out))
