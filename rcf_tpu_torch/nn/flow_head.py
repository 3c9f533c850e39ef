"""Flow-aggregation head: learned per-mask constant flow + residual + affine.

Port of ``rcf_tpu/nn/flow_head.py::FlowAggregationHead`` (the reference's
``FlowAggregationHeadWithResidual``):

* two 3x3 convs embed the target flow (2 -> 64 -> 64, LeakyReLU 0.1);
* the embedding is pooled by the spatially normalized masks to one feature
  per mask, pushed through two per-mask dense layers (1x1 ``Conv1d``s in
  the reference's state dict) to a constant flow per mask, and painted back
  through the raw masks;
* ``free_residual``: a tanh-bounded, mask-gated residual from the residual
  head, resized to ``mask_size``; ``free_residual_with_affine`` adds the
  closed-form per-mask affine flow (``losses/common_fate.py``);
* the forward and backward losses are the L1 (or outlier-robust) gaps.

Both directions run as one batch: frame-1 masks with the forward flow,
frame-2 masks with the backward flow. State-dict keys as the reference
(``flow_feat_before_agg.{0,2}``, ``flow_feat_after_agg.{0,2}``). Inputs
are channel-last; ``dtype`` is the compute dtype of the convs and dense
layers, and the pooling and painting promote as ``jnp.einsum`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..losses.common_fate import (common_fate_loss, demean_affine_flow, norm_and_clamp_flow,
                                  promoted_einsum, residual_adjustment)
from ..ops import resize_bilinear
from .layers import Conv2d, to_nchw, to_nhwc


class FlowAggregationHead(nn.Module):
    def __init__(self, mask_layer: int = 4, num_flow_feat_channels: int = 64,
                 flow_feat_before_agg_kernel_size: int = 3, mask_size=(96, 96),
                 norm_flow: bool = False, clamp_flow_t: float | None = 20.0,
                 filter_flow_t: float | None = None, outlier_robust_loss: bool = False,
                 eps: float = 0.01, q: float = 0.4, residual_adjustment_scale: float = 10.0,
                 pred_div_coeff: float = 10.0, free_residual: bool = False,
                 free_residual_with_affine: bool = False,
                 free_residual_with_affine_quadratic: bool = False,
                 allow_residual_resize: bool = True, align_corners: bool = False,
                 ssim_sz: int = 1, create_flownet: bool = True, free_scale: bool = False,
                 object_free_residual: bool = False, affine_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        # ssim_sz .. affine_residual: accepted for config parity, unused (as in JAX).
        super().__init__()
        self.mask_layer = mask_layer
        self.mask_size = tuple(mask_size)
        self.norm_flow, self.clamp_flow_t, self.filter_flow_t = norm_flow, clamp_flow_t, filter_flow_t
        self.outlier_robust_loss, self.eps, self.q = outlier_robust_loss, eps, q
        self.residual_adjustment_scale = residual_adjustment_scale
        self.pred_div_coeff = pred_div_coeff
        self.free_residual = free_residual
        self.free_residual_with_affine = free_residual_with_affine
        self.quadratic = free_residual_with_affine_quadratic
        self.allow_residual_resize = allow_residual_resize
        self.align_corners = align_corners
        self.compute_dtype = dtype
        ch, k = num_flow_feat_channels, flow_feat_before_agg_kernel_size
        self.flow_feat_before_agg = nn.Sequential(
            Conv2d(2, ch, k, padding=(k - 1) // 2, compute_dtype=dtype), nn.LeakyReLU(0.1),
            Conv2d(ch, ch, k, padding=(k - 1) // 2, compute_dtype=dtype), nn.LeakyReLU(0.1))
        self.flow_feat_after_agg = nn.Sequential(
            nn.Conv1d(ch, ch, 1), nn.LeakyReLU(0.1), nn.Conv1d(ch, 2, 1))

    def _dense(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 ``Conv1d`` ``flow_feat_after_agg[idx]`` as Flax's Dense over the last axis."""
        conv, dt = self.flow_feat_after_agg[idx], self.compute_dtype
        return F.linear(x.to(dt), conv.weight[:, :, 0].to(dt), conv.bias.to(dt))

    def _constant_flow(self, masks: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """Learned per-mask constant flow painted through the masks.

        masks [N, H, W, C], flow [N, H, W, 2] -> [N, H, W, 2].
        """
        n, h, w, c = masks.shape
        feat = to_nhwc(self.flow_feat_before_agg(to_nchw(flow))).reshape(n, h * w, -1)
        mask_flat = masks.reshape(n, h * w, c)
        mask_hat = mask_flat / mask_flat.sum(1, keepdim=True)
        pooled = promoted_einsum("npf,npc->ncf", feat, mask_hat)
        pooled = F.leaky_relu(self._dense(0, pooled), 0.1)
        const = self._dense(2, pooled)  # [N, C, 2]
        return promoted_einsum("nck,npc->npk", const, mask_flat).reshape(n, h, w, 2)

    def _aggregate(self, masks, flow, residual) -> dict:
        """One batch of directions: masks [N,H,W,C], flow [N,H,W,2], residual [N,h,w,2C]."""
        overall = flow_agg = self._constant_flow(masks, flow)
        parts = {"agg": flow_agg}
        if self.free_residual or self.free_residual_with_affine:
            if self.allow_residual_resize and tuple(residual.shape[1:3]) != self.mask_size:
                residual = resize_bilinear(residual, self.mask_size, self.align_corners)
            n, h, w, _ = residual.shape
            adj = residual_adjustment(residual.reshape(n, h, w, 2, self.mask_layer), masks,
                                      scale=self.residual_adjustment_scale,
                                      div_coeff=self.pred_div_coeff)
            parts["residual_adj"] = adj
            overall = overall + adj
            if self.free_residual_with_affine:
                affine = demean_affine_flow(masks, flow, quadratic=self.quadratic)
                parts["affine"] = affine
                overall = overall + affine
        parts["overall"] = overall
        return parts

    def forward(self, masks, gt_fw_flows, gt_bw_flows, residual_fw, residual_bw):
        """masks [B, 2, H, W, C]; gt flows [B, 1, H, W, 2]; residuals [B, h, w, 2C].

        Returns (losses, flows): ``seg_fw``, ``seg_bw``, ``seg``; each flow as
        a (forward, backward) pair.
        """
        if masks.shape[1] != 2:
            raise ValueError(f"two-frame windows only, got {masks.shape[1]} frames")
        prep = dict(norm_flow=self.norm_flow, clamp_flow_t=self.clamp_flow_t,
                    filter_flow_t=self.filter_flow_t)
        gt_fw = norm_and_clamp_flow(gt_fw_flows[:, 0], **prep)
        gt_bw = norm_and_clamp_flow(gt_bw_flows[:, 0], **prep)
        parts = self._aggregate(torch.cat([masks[:, 0], masks[:, 1]], 0),
                                torch.cat([gt_fw, gt_bw], 0),
                                torch.cat([residual_fw, residual_bw], 0))
        b = masks.shape[0]
        fw, bw = parts["overall"][:b], parts["overall"][b:]
        robust = (self.outlier_robust_loss, self.eps, self.q)
        loss_fw, loss_bw = common_fate_loss(gt_fw, fw, *robust), common_fate_loss(gt_bw, bw, *robust)
        losses = {"seg_fw": loss_fw, "seg_bw": loss_bw, "seg": loss_fw + loss_bw}
        names = {"overall": "pred_flow", "agg": "agg_flow", "residual_adj": "residual_adj",
                 "affine": "affine_flow"}
        flows = {"gt_flow": (gt_fw, gt_bw)}
        flows.update({names[k]: (v[:b], v[b:]) for k, v in parts.items()})
        return losses, flows
