"""Flow warping, occlusion masks, cost volume (channel-last tensors).

Port of ``rcf_tpu/ops/warp.py``. Routing:

* ``flow_warp`` of a map with C <= 8 (images, flows) runs the hand-written
  CUDA warp (``warp_kernels``) at every size. Its backward is the kernel
  that also gives the image cotangent where the image needs a gradient
  (``grad_img=True`` and an image that requires one, as the flow warp of
  ``occu_mask_bidirection`` differentiated in its flow), else the
  coordinate-only kernel (``grad_img=False``: every photometric warp of
  the unFlow loss);
* ``flow_warp`` of a feature map (C > 8, PWC-Lite's pyramid warps, image
  gradient needed) uses ``F.grid_sample`` in f32, as the JAX package
  leaves those to XLA's gather (which returns f32 for bf16 features);
* ``corresponding_map`` / ``occu_mask_backward`` run the CUDA splat;
* ``correlation`` stays plain tensor code, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .warp_kernels import splat, warp


def _base_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return xs[None], ys[None]


def _abs_coords(flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute f32 sample coordinates base + flow (flow [B,H,W,2], u=x, v=y)."""
    h, w = flow.shape[1:3]
    xs, ys = _base_grid(h, w, flow.device)
    fl = flow.float()
    return xs + fl[..., 0], ys + fl[..., 1]


def _grid_sample_nhwc(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      pad: str) -> torch.Tensor:
    """grid_sample(align_corners=True) at absolute coordinates, NHWC in, NHWC f32 out.

    The grid stays f32 (bf16's spacing near +-1 is 2^-8, a third of a pixel
    at 160 wide), and a bf16 map is sampled in f32: JAX's gather blends bf16
    values with f32 weights, which promotes the result to f32.
    """
    h, w = img.shape[1:3]
    grid = torch.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode=pad, align_corners=True)
    return out.permute(0, 2, 3, 1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, pad: str = "border",
              grad_img: bool = True) -> torch.Tensor:
    """Backward-warp x [B, H, W, C] by flow [B, H, W, 2] (u=x, v=y).

    Coordinates are always f32; only the image values follow the caller's
    dtype. ``grad_img=False`` declares the image pure data (no gradient).
    """
    if pad not in ("border", "zeros"):
        raise ValueError(f"unsupported pad {pad!r}")
    h, w, c = x.shape[1:]
    cx, cy = _abs_coords(flow)
    if c > 8:
        return _grid_sample_nhwc(x, cx, cy, pad)
    if pad == "border":
        # grid_sample(border) == sampling at box-clamped coordinates.
        cx = cx.clamp(0.0, float(w - 1))
        cy = cy.clamp(0.0, float(h - 1))
    return warp(x if grad_img else x.detach(), cx, cy)


def corresponding_map(flow: torch.Tensor) -> torch.Tensor:
    """Forward-splat an all-ones map along flow [B, H, W, 2] -> [B, H, W] f32.

    Bilinear splat of 1 at base + flow, out-of-range corners dropped
    (reference ``utils/warp_utils.py:27-81``). Not differentiable.
    """
    h, w = flow.shape[1:3]
    tx, ty = _abs_coords(flow.detach())
    return splat(tx, ty, h, w)


def occu_mask_backward(flow21: torch.Tensor, th: float = 0.2) -> torch.Tensor:
    """[B, H, W] float mask: 1 where occluded (correspondence density < th)."""
    corr = corresponding_map(flow21).clamp(0.0, 1.0)
    return (corr < th).float()


def occu_mask_bidirection(flow12: torch.Tensor, flow21: torch.Tensor,
                          scale: float = 0.01, bias: float = 0.5) -> torch.Tensor:
    """[B, H, W] float mask: 1 where the forward-backward flow check fails."""
    flow21_warped = flow_warp(flow21, flow12, pad="zeros")
    diff = flow12 + flow21_warped
    mag = torch.sum(flow12**2, -1) + torch.sum(flow21_warped**2, -1)
    occ = torch.sum(diff**2, -1) > (scale * mag + bias)
    return occ.float()


def correlation(x1: torch.Tensor, x2: torch.Tensor, max_displacement: int = 4) -> torch.Tensor:
    """Cost volume [B, H, W, (2d+1)^2]: mean over channels of x1 * shift(x2)."""
    b, h, w, c = x1.shape
    d = max_displacement
    x2p = F.pad(x2, (0, 0, d, d, d, d))
    outs = []
    for i in range(2 * d + 1):
        for j in range(2 * d + 1):
            shifted = x2p[:, i:i + h, j:j + w]
            # Channel mean accumulates in f32 even for bf16 features.
            outs.append(torch.mean(x1 * shifted, dim=-1, dtype=torch.float32))
    return torch.stack(outs, dim=-1).to(x1.dtype)
