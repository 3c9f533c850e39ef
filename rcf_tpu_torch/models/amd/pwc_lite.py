"""PWC-Lite with per-mask constant flow groups (port of ``rcf_tpu/models/amd/pwc_lite.py``).

A 6-level conv feature pyramid, a coarse-to-fine loop over the top 5
levels with flow upsampling (x2, align_corners=True), backward warping of
the second frame's features, a 9x9 cost volume, a dense-connected flow
estimator, and per-mask *constant* flows: the estimator features are
mask-average-pooled, pushed through the same 1x1 prediction head,
broadcast over space, accumulated across levels and composited through
the masks.

Tensors are channel-last, as in the JAX package; each conv runs on a
permuted view. ``dtype`` is the compute dtype of the convolutions and the
cost volume; flows, their upsampling and their accumulation stay f32, and
the mask-weighted flow sums promote to f32 (JAX ``pwc_lite.py``). State-dict keys follow the reference PWCLite
(``feature_pyramid_extractor.convs.{l}.{j}.0``,
``flow_estimators.{name}.0``, ``conv_1x1.{i}.0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv2d, to_nchw, to_nhwc
from ...ops import resize_bilinear
from ...ops.warp import correlation, flow_warp

NUM_CHS = (3, 16, 32, 64, 96, 128, 192)  # pyramid channels, input first
SEARCH_RANGE = 4  # cost volume over (2*4+1)^2 = 81 displacements
OUTPUT_LEVEL = 4  # the loop runs the 5 coarsest of the 6 pyramid levels


def _conv(cin, cout, kernel_size=3, stride=1, dilation=1,
          dtype=torch.float32) -> nn.Sequential:
    pad = ((kernel_size - 1) * dilation) // 2
    return nn.Sequential(Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
                                dilation=dilation, bias=True, compute_dtype=dtype))


def _apply(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv over an NHWC tensor, NHWC out."""
    return to_nhwc(conv(to_nchw(x)))


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def mask_pool(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask-average-pooled features [B, M, C] f32 of feat [B, C, h, w] under mask [B, h, w, M].

    As JAX does it: the mask is cast to the feature dtype for the product,
    which accumulates in f32, and the denominator is the f32 sum of the
    uncast mask (for bf16 features the mask rounds to bf16 in the product).
    """
    b, c, h, w = feat.shape
    mflat = mask.reshape(b, h * w, mask.shape[-1]).float()
    pooled = torch.einsum("bcp,bpm->bmc", feat.reshape(b, c, h * w).float(),
                          mflat.to(feat.dtype).float())
    return pooled / mflat.sum(dim=1)[..., None]


class FeatureExtractor(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.ModuleList([_conv(cin, cout, stride=2, dtype=dtype), _conv(cout, cout, dtype=dtype)])
            for cin, cout in zip(NUM_CHS[:-1], NUM_CHS[1:]))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = to_nchw(x)
        pyramid = []
        for conv0, conv1 in self.convs:
            x = _lrelu(conv1(_lrelu(conv0(x))))
            pyramid.append(to_nhwc(x))
        return pyramid[::-1]  # coarsest first


class FlowEstimatorReduce(nn.Module):
    def __init__(self, in_channels: int, mask_layer: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_layer = mask_layer
        self.conv1 = _conv(in_channels, 128, dtype=dtype)
        self.conv2 = _conv(128, 128, dtype=dtype)
        self.conv3 = _conv(128 + 128, 96, dtype=dtype)
        self.conv4 = _conv(128 + 96, 64, dtype=dtype)
        self.conv5 = _conv(96 + 64, 32, dtype=dtype)
        self.predict_flow1 = _conv(64 + 32, 64, kernel_size=1, dtype=dtype)
        self.predict_flow2 = _conv(64, 2, kernel_size=1, dtype=dtype)

    def _head(self, f: torch.Tensor) -> torch.Tensor:
        return self.predict_flow2(_lrelu(self.predict_flow1(f))).float()

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x [B,h,w,Cin]; mask [B,h,w,M] -> (feat, flow groups, direct flow), NHWC."""
        x = to_nchw(x)
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(x1))
        x3 = _lrelu(self.conv3(torch.cat([x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x2, x3], 1)))
        x5 = _lrelu(self.conv5(torch.cat([x3, x4], 1)))
        feat = torch.cat([x4, x5], 1)
        flow_direct = to_nhwc(self._head(feat))

        # Mask-average-pooled features -> constant flow per mask channel.
        b, _, h, w = feat.shape
        pooled = mask_pool(feat, mask)
        # The same 1x1 head on the pooled vectors: [B, M, 2].
        const = self._head(pooled.to(feat.dtype).permute(0, 2, 1)[..., None])[..., 0].permute(0, 2, 1)
        flow_group = [const[:, m, None, None, :].expand(b, h, w, 2)
                      for m in range(self.mask_layer)]
        return to_nhwc(x5), flow_group, flow_direct


class PWCLite(nn.Module):
    def __init__(self, mask_layer: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_layer = mask_layer
        self.feature_pyramid_extractor = FeatureExtractor(dtype)
        n_corr = (2 * SEARCH_RANGE + 1) ** 2
        self.flow_estimators = FlowEstimatorReduce(n_corr + 32 + 2, mask_layer, dtype)
        # conv_1x1[level] sees the pyramid level `level`, coarsest first.
        self.conv_1x1 = nn.ModuleList(_conv(ch, 32, kernel_size=1, dtype=dtype)
                                      for ch in NUM_CHS[::-1][:OUTPUT_LEVEL + 1])

    def _one_direction(self, x1_pyr, x2_pyr, mask):
        b, h0, w0, _ = x1_pyr[0].shape
        dev = x1_pyr[0].device
        flow = torch.zeros(b, h0, w0, 2, device=dev)
        flow_all = torch.zeros(b, h0, w0, 2, device=dev)
        sum_group = [torch.zeros(b, h0, w0, 2, device=dev) for _ in range(self.mask_layer)]
        flows, flows_all = [], []
        for level, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            hw = tuple(x1.shape[1:3])
            if level >= 1:
                flow = resize_bilinear(flow * 2, hw, align_corners=True)
                flow_all = resize_bilinear(flow_all * 2, hw, align_corners=True)
                sum_group = [resize_bilinear(g * 2, hw, align_corners=True) for g in sum_group]
            x2_warp = x2 if level == 0 else flow_warp(x2, flow)
            corr = _lrelu(correlation(x1, x2_warp, SEARCH_RANGE))
            x1_1by1 = _lrelu(_apply(self.conv_1x1[level], x1))
            mask_resize = resize_bilinear(mask, hw, align_corners=True)
            inputs = torch.cat([corr, x1_1by1, flow.to(x1_1by1.dtype)], dim=-1)
            _, flow_group, flow_all_res = self.flow_estimators(inputs, mask_resize)
            sum_group = [g + fg for g, fg in zip(sum_group, flow_group)]
            flow = sum(mask_resize[..., m:m + 1] * sum_group[m] for m in range(self.mask_layer))
            flow_all = flow_all + flow_all_res
            flows.append(flow)
            flows_all.append(flow_all)
            if level == OUTPUT_LEVEL:
                break

        def up4(f):
            return resize_bilinear(f * 4, (f.shape[1] * 4, f.shape[2] * 4), align_corners=True)

        return ([up4(f) for f in flows][::-1], [up4(f) for f in flows_all][::-1],
                [up4(g) for g in sum_group])

    def forward(self, img1, img2, mask1, mask2, with_bk: bool = True) -> dict:
        """imgs [B, H, W, 3] in [0, 1]; masks [B, Hm, Wm, M]."""
        p1 = self.feature_pyramid_extractor(img1)
        p2 = self.feature_pyramid_extractor(img2)
        out = {}
        out["flows_fw"], out["flows_fw_all"], out["flows_fw_group"] = self._one_direction(p1, p2, mask2)
        if with_bk:
            out["flows_bw"], out["flows_bw_all"], out["flows_bw_group"] = self._one_direction(p2, p1, mask1)
        return out
