"""AMD baseline: appearance-motion decomposition (port of ``rcf_tpu/models/amd/amd_model.py``).

An OS8 ResNet backbone (dilations [1,1,1,2], no contract_dilation) with a
single-input stage-4 FCN mask head at 1/8 resolution; motion from a
learned PWC-Lite flownet over per-mask constant flow groups; the loss is
the unsupervised photometric flow loss over the segment-wise
piecewise-constant flows. Images are un-normalized back to [0, 1] and
resized to ``flow_size`` (align_corners=True) before the flownet.

``dtype`` is the compute dtype (``tpu.compute_dtype`` of a recipe,
``train.compute_dtype``): the backbone, the mask head and the flownet's
convolutions run in it, and so do the resized frames; parameters, flows
and losses stay f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ...losses.unflow import UnFlowLossCfg, unflow_loss
from ...nn import FCNHead, ResNet
from ...nn.layers import init_weights
from ...ops import resize_bilinear
from ...utils import resolve_device
from .pwc_lite import PWCLite

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_FLOW_CFG = UnFlowLossCfg(
    alpha=10, ssim_sz=1, occ_from_back=True, w_l1=0.15,
    w_scales=(1.0, 1.0, 1.0, 1.0, 0.0), w_sm_scales=(1.0, 0.0, 0.0, 0.0, 0.0),
    w_real_smooth=0.0, w_ssim=0.85, w_ternary=0.0, warp_pad="border", with_bk=True,
)


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(IMAGENET_MEAN, IMAGENET_STD) on ``device``, copied there once."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def maybe_normalize(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized f32 (no-op for float inputs)."""
    if imgs.dtype == torch.uint8:
        mean, std = _imagenet_stats(imgs.device)
        return (imgs.float() / 255.0 - mean) / std
    return imgs


def build_amd_model(model_kwargs: dict, device: str | torch.device = "cuda",
                    seed: int = 0, dtype: torch.dtype = torch.float32) -> "AMDModel":
    """AMDModel from the config's ``model_kwargs``, initialized from ``seed`` on ``device``,
    computing in ``dtype``.

    The weights are drawn on the CPU from one ``torch.Generator``, so a seed
    gives the same model on every device.
    """
    dev = resolve_device(device)
    kwargs = dict(model_kwargs)
    backbone_cfg = {k: v for k, v in dict(kwargs.pop("backbone2")).items()
                    if k not in ("type", "create_ema")}
    mask_cfg = {k: v for k, v in dict(kwargs.pop("decode_head2")).items()
                if k not in ("type", "create_ema", "loss_decode")}
    kwargs.pop("decode_head", None)  # flownet config is fixed (create_flownet path)
    known = ("mask_layer", "w_seg", "flow_size", "log_whole_flow_loss")
    kwargs = {k: v for k, v in kwargs.items() if k in known}
    model = AMDModel(backbone_cfg, mask_cfg, dtype=dtype, **kwargs)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    model.decode_head2.init_conv_seg_(gen)
    return model.to(dev)


class AMDModel(nn.Module):
    def __init__(self, backbone_cfg: dict, mask_head_cfg: dict, mask_layer: int = 5,
                 w_seg: float = 1.0, flow_size: tuple[int, int] = (384, 640),
                 log_whole_flow_loss: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_layer = mask_layer
        self.w_seg = w_seg
        self.flow_size = tuple(flow_size)
        # The reference computes the unconstrained ("whole") flows' loss but
        # never uses it; True reports it as ``loss_warp_whole``, outside ``loss``.
        self.log_whole_flow_loss = log_whole_flow_loss
        self.compute_dtype = dtype
        self.backbone2 = ResNet(**backbone_cfg, dtype=dtype)
        head_cfg = dict(mask_head_cfg)
        head_cfg.setdefault("in_channels", self.backbone2.out_channels[head_cfg.get("in_index", -1)])
        self.decode_head2 = FCNHead(**head_cfg, dtype=dtype)
        self.flownet = PWCLite(mask_layer=mask_layer, dtype=dtype)

    def mask_probs(self, imgs_flat: torch.Tensor) -> torch.Tensor:
        """imgs [N, H, W, 3] -> softmax mask probabilities [N, h, w, M]."""
        feats = self.backbone2(maybe_normalize(imgs_flat))
        return torch.softmax(self.decode_head2(feats), dim=-1)

    def forward(self, imgs: torch.Tensor, generator: torch.Generator | None = None):
        """imgs [B, 2, H, W, 3] normalized (or uint8). Returns (losses, probs).

        ``generator`` drives the mask head's channel dropout in training.
        """
        b, im_num = imgs.shape[:2]
        if im_num != 2:
            raise ValueError(f"AMD takes frame pairs, got {im_num} frames")
        imgs_flat = maybe_normalize(imgs.reshape(b * im_num, *imgs.shape[2:]))
        feats = self.backbone2(imgs_flat)
        logits = self.decode_head2(feats, generator=generator, rows_per_sample=im_num)
        h, w = logits.shape[1:3]
        probs = torch.softmax(logits.reshape(b, im_num, h, w, self.mask_layer), dim=-1)

        # Un-normalize to [0, 1] and resize for the flownet.
        if imgs.dtype == torch.uint8:
            raw = imgs.float() / 255.0
        else:
            mean, std = _imagenet_stats(imgs.device)
            raw = imgs * std + mean
        dt = self.compute_dtype
        im1 = resize_bilinear(raw[:, 0], self.flow_size, align_corners=True).to(dt)
        im2 = resize_bilinear(raw[:, 1], self.flow_size, align_corners=True).to(dt)

        res = self.flownet(im1, im2, probs[:, 0], probs[:, 1], with_bk=True)

        def stacked(fw_list, bw_list):
            return [torch.cat([f, bw], dim=-1) for f, bw in zip(fw_list, bw_list)]

        # Only the segment-wise flows are scored.
        loss_seg, *_ = unflow_loss(stacked(res["flows_fw"], res["flows_bw"]), im1, im2, _FLOW_CFG)
        losses = {"loss_warp_seg": loss_seg, "loss": loss_seg * self.w_seg}
        if self.log_whole_flow_loss:
            losses["loss_warp_whole"] = unflow_loss(
                stacked(res["flows_fw_all"], res["flows_bw_all"]), im1, im2, _FLOW_CFG)[0]
        return losses, probs
