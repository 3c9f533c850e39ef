"""Unsupervised multi-scale photometric flow loss (port of ``rcf_tpu/losses/unflow.py``).

Per pyramid level: area-resize the image pair, backward-warp each image
by the other's flow (the CUDA warp kernel: ``grad_img=False``), score L1
(w=0.15) + SSIM (w=0.85) (+ optional ternary census) under occlusion masks
from the finest level (nearest-downsampled for coarser levels): the
backward flow's correspondence density (the CUDA splat) or, with
``occ_from_back=False``, the forward-backward flow check (the CUDA warp
with its image gradient). Optional edge-aware 1st/2nd-order smoothness.
All tensors channel-last. bf16 frames keep JAX's dtype flow: the resized
frames and the warps stay bf16, the masked terms and the means are f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops import resize_nearest
from ..ops.warp import flow_warp, occu_mask_backward, occu_mask_bidirection
from ..parallel import dist


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def area_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """'area' interpolation for integer downscale factors."""
    k = x.shape[1] // out_hw[0]
    if x.shape[1] != out_hw[0] * k or x.shape[2] != out_hw[1] * k:
        raise ValueError(f"area resize needs integer factors: {tuple(x.shape)} -> {out_hw}")
    return _avg_pool(x, k)


def ssim_dist(x: torch.Tensor, y: torch.Tensor, md: int = 1) -> torch.Tensor:
    """(1 - SSIM)/2 clipped to [0,1]; valid (unpadded) windows only."""
    k = 2 * md + 1
    c1, c2 = 0.01**2, 0.03**2

    def pool(z):
        # Valid-mode average pooling, window k, stride 1, as k shifted adds per axis.
        h, w = z.shape[1], z.shape[2]
        zh = sum(z[:, i:h - k + 1 + i] for i in range(k))
        return sum(zh[:, :, j:w - k + 1 + j] for j in range(k)) / (k * k)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x**2
    sigma_y = pool(y * y) - mu_y**2
    sigma_xy = pool(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - num / den) / 2, 0.0, 1.0)


def ternary_dist(im: torch.Tensor, im_warp: torch.Tensor, max_distance: int = 1) -> torch.Tensor:
    """Census-transform hamming distance with a valid-border mask."""
    k = 2 * max_distance + 1

    def gray(image):
        return (image[..., 0] * 0.2989 + image[..., 1] * 0.5870 + image[..., 2] * 0.1140)[..., None]

    def census(image):
        inten = gray(image) * 255.0
        m = max_distance
        padded = F.pad(inten, (0, 0, m, m, m, m))
        b, h, w, _ = inten.shape
        patches = torch.stack(
            [padded[:, i:i + h, j:j + w, 0] for i in range(k) for j in range(k)], dim=-1)
        t = patches - inten
        return t / torch.sqrt(0.81 + t**2)

    dist = (census(im) - census(im_warp)) ** 2
    dist = torch.mean(dist / (0.1 + dist), dim=-1, keepdim=True)
    mask = torch.zeros_like(dist)
    mask[:, max_distance:-max_distance, max_distance:-max_distance] = 1.0
    return dist * mask


def _gradients(x):
    dx = x[:, :, 1:] - x[:, :, :-1]
    dy = x[:, 1:, :] - x[:, :-1, :]
    return dx, dy


def smooth_grad_1st(flow, image, alpha):
    img_dx, img_dy = _gradients(image)
    wx = torch.exp(-torch.mean(torch.abs(img_dx), -1, keepdim=True) * alpha)
    wy = torch.exp(-torch.mean(torch.abs(img_dy), -1, keepdim=True) * alpha)
    dx, dy = _gradients(flow)
    return torch.mean(wx * torch.abs(dx) / 2) / 2 + torch.mean(wy * torch.abs(dy) / 2) / 2


def smooth_grad_2nd(flow, image, alpha):
    img_dx, img_dy = _gradients(image)
    wx = torch.exp(-torch.mean(torch.abs(img_dx), -1, keepdim=True) * alpha)
    wy = torch.exp(-torch.mean(torch.abs(img_dy), -1, keepdim=True) * alpha)
    dx, dy = _gradients(flow)
    dx2, _ = _gradients(dx)
    _, dy2 = _gradients(dy)
    return torch.mean(wx[:, :, 1:] * torch.abs(dx2)) / 2 + torch.mean(wy[:, 1:, :] * torch.abs(dy2)) / 2


@dataclass
class UnFlowLossCfg:
    alpha: float = 10.0
    ssim_sz: int = 1
    occ_from_back: bool = True
    w_l1: float = 0.15
    w_ssim: float = 0.85
    w_ternary: float = 0.0
    w_scales: tuple = (1.0, 1.0, 1.0, 1.0, 0.0)
    w_sm_scales: tuple = (1.0, 0.0, 0.0, 0.0, 0.0)
    w_real_smooth: float = 0.0
    smooth_2nd: bool = False
    warp_pad: str = "border"
    with_bk: bool = True


def unflow_loss(pyramid_flows, im1, im2, cfg: UnFlowLossCfg = UnFlowLossCfg()):
    """pyramid_flows: list of [B, h, w, 4] (fw|bw), finest first; images
    [B, H, W, 3] in [0, 1]. Returns (total, warp, smooth, mean |flow0|)."""

    def photometric(im_scaled, im_recons, occu):
        losses = []
        if cfg.w_l1 > 0:
            losses.append(cfg.w_l1 * torch.abs(im_scaled - im_recons) * occu)
        if cfg.w_ssim > 0:
            losses.append(cfg.w_ssim * ssim_dist(im_recons * occu, im_scaled * occu, cfg.ssim_sz))
        if cfg.w_ternary > 0:
            losses.append(cfg.w_ternary * ternary_dist(im_recons * occu, im_scaled * occu))
        # A ratio of batch means: over several ranks, the whole batch's ratio.
        return dist.global_ratio(sum(torch.mean(l) for l in losses), torch.mean(occu))

    warp_losses, smooth_losses = [], []
    occu1_0 = occu2_0 = None
    s = 1.0
    for i, flow in enumerate(pyramid_flows):
        if cfg.w_scales[i] == 0:
            warp_losses.append(0.0)
            smooth_losses.append(0.0)
            continue
        h, w = flow.shape[1:3]
        im1_s = area_resize(im1, (h, w))
        im2_s = area_resize(im2, (h, w))
        # grad_img=False: the warped operands are input frames (pure data);
        # gradients flow through the sampling coordinates only.
        im1_recons = flow_warp(im2_s, flow[..., :2], pad=cfg.warp_pad, grad_img=False)
        im2_recons = flow_warp(im1_s, flow[..., 2:], pad=cfg.warp_pad, grad_img=False)
        if i == 0:
            # Both directions in one batched call.
            fw, bw = flow[..., :2], flow[..., 2:]
            if cfg.occ_from_back:
                both = occu_mask_backward(torch.cat([bw, fw], dim=0), th=0.2)[..., None]
            else:
                both = occu_mask_bidirection(torch.cat([fw, bw], dim=0),
                                             torch.cat([bw, fw], dim=0))[..., None]
            occu1, occu2 = 1.0 - both[: flow.shape[0]], 1.0 - both[flow.shape[0]:]
            occu1_0, occu2_0 = occu1, occu2
            s = min(h, w)
        else:
            occu1 = resize_nearest(occu1_0, (h, w))
            occu2 = resize_nearest(occu2_0, (h, w))
        loss_warp = photometric(im1_s, im1_recons, occu1)
        loss_smooth = 0.0
        if cfg.w_real_smooth > 0:
            fn = smooth_grad_2nd if cfg.smooth_2nd else smooth_grad_1st
            loss_smooth = fn(flow[..., :2] / s, im1_s, cfg.alpha)
        if cfg.with_bk:
            loss_warp = (loss_warp + photometric(im2_s, im2_recons, occu2)) / 2.0
            if cfg.w_real_smooth > 0:
                loss_smooth = (loss_smooth + fn(flow[..., 2:] / s, im1_s, cfg.alpha)) / 2.0
        warp_losses.append(loss_warp)
        smooth_losses.append(loss_smooth)

    warp_loss = sum(l * w for l, w in zip(warp_losses, cfg.w_scales))
    smooth_loss = cfg.w_real_smooth * sum(l * w for l, w in zip(smooth_losses, cfg.w_sm_scales))
    total = warp_loss + smooth_loss
    return total, warp_loss, smooth_loss, torch.mean(torch.abs(pyramid_flows[0]))
