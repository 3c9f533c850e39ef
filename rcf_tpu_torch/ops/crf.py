"""Dense-CRF mean-field refinement (port of ``rcf_tpu/ops/crf.py``).

Stage 2.1's in-training target: a binary mean field over the frames'
pixels, its unary from a soft object mask, its pairwise term the exact
normalized Gaussian filter over appearance features ``(x/sxy, y/sxy,
r/srgb, g/srgb, b/srgb)`` with weight ``scomp`` (and, where ``scomp_smooth``
and ``sxy_smooth`` are set, over ``(x/sxy_s, y/sxy_s)``). Binary labels let
it track the foreground alone:

    q1 <- sigmoid(du + scomp * (2 filter(q1) - 1) [+ scomp_smooth * (2 filter_s(q1) - 1)])

with ``du`` the unary's background minus foreground energy. The filter is
``crf_kernels.crf_filter``: a hand-written CUDA kernel on the card, the
JAX package's chunked attention on the CPU.

The mean field runs batched over images (JAX ``vmap``s one image's).
With ``stable_exit`` each image stops at the first iteration that leaves
its MAP unchanged, frozen there by a device-side ``done`` mask, and
counts its own iterations, as JAX's ``while_loop`` under ``vmap`` does;
the host reads the batch's "all done" flag every ``SYNC_EVERY``
iterations only (extra iterations leave frozen images as they are).
The fixed count makes no host sync.

Values that are quantized to uint8 (the unary's levels, the RGB, the
resized RGB) are computed in JAX's order and dtype, so that a last-ulp
difference does not flip a level: the mask's scale ``255/crf_scale`` is
rounded to the mask's dtype first (bf16 for the SegTrackv2 recipe), and
the features divide by exact f32 tables made in numpy (on the card,
PyTorch divides by a Python scalar as a multiply by its reciprocal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.constants import device_constant
from .crf_kernels import crf_filter
from .resize import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# stable_exit: the host reads the batch's "all done" flag after every
# SYNC_EVERY-th iteration. An extra iteration (~0.9 ms at the DAVIS batch on
# an H100 80GB HBM3 at 700 W, PERF.md) costs more than a sync (tens of us),
# so the flag is read often.
SYNC_EVERY = 2

# Mean-field iterations run and host syncs made, summed over calls since the
# last reset_stats() (the iterations the batch ran, not per image).
STATS = {"iterations": 0, "host_syncs": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


@dataclass(frozen=True)
class CRFParams:
    # The reference's defaults (models/crf_head.py:13-27), as the JAX package's.
    srgb: float = 5.0
    scomp: float = 5.0
    sxy: float = 60.0
    scomp_smooth: float = 0.0
    sxy_smooth: float = 0.0
    refine_iters: int = 50
    crf_scale: float = 0.7
    # Stop each image at the first iteration that leaves its MAP unchanged;
    # refine_iters stays the cap (the JAX package's CRFParams.stable_exit).
    stable_exit: bool = False


def _const(x: torch.Tensor, build, *args) -> torch.Tensor:
    return device_constant(build, args, x.device)


def _imagenet(which: str) -> np.ndarray:
    return IMAGENET_MEAN if which == "mean" else IMAGENET_STD


def unnormalize_to_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized float frames [..., 3] -> uint8 RGB (clip, then a
    truncating cast); uint8 frames pass through."""
    if imgs.dtype == torch.uint8:
        return imgs
    x = imgs * _const(imgs, _imagenet, "std") + _const(imgs, _imagenet, "mean")
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def mask_levels(mask: torch.Tensor, crf_scale: float = 0.7) -> torch.Tensor:
    """The unary's uint8 levels of a soft mask, computed in the mask's dtype:
    ``255/crf_scale`` rounded to that dtype first, as JAX's weak-typed constant."""
    scale = float(torch.tensor(255.0 / crf_scale, dtype=mask.dtype))
    return torch.clamp(mask * scale, 0.0, 255.0).to(torch.uint8)


def mask_to_unary(mask: torch.Tensor, crf_scale: float = 0.7) -> torch.Tensor:
    """Soft mask [..., H, W] -> unary energies [..., H, W, 2] (bg, fg), f32."""
    u = mask_levels(mask, crf_scale).float()
    u = u / (u.amax((-2, -1), keepdim=True) + 1e-8)
    u = torch.clamp(u, 1e-6, 1.0 - 1e-6)
    return torch.stack([-torch.log(1.0 - u), -torch.log(u)], dim=-1)


def _axis_table(size: int, s: float) -> np.ndarray:
    return np.arange(size, dtype=np.float32) / np.float32(s)


def _xy_table(h: int, w: int, sx: float, sy: float) -> np.ndarray:
    xs = np.broadcast_to(_axis_table(w, sx)[None, :], (h, w))
    ys = np.broadcast_to(_axis_table(h, sy)[:, None], (h, w))
    return np.stack([xs, ys], axis=-1).reshape(h * w, 2)


def xy_features(h: int, w: int, sxy: float, xy_scale=(1.0, 1.0),
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[H*W, 2] features (x/sx, y/sy), sx = sxy * xy_scale[0], sy = sxy * xy_scale[1]:
    ``xy_scale`` keeps the kernel's full-resolution width on a smaller grid."""
    sx, sy = sxy * xy_scale[0], sxy * xy_scale[1]
    return device_constant(_xy_table, (h, w, sx, sy), torch.device(device))


def pixel_features(rgb_u8: torch.Tensor, sxy: float, srgb: float,
                   xy_scale=(1.0, 1.0)) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> [B, H*W, 5] appearance features
    (x/sx, y/sy, r/srgb, g/srgb, b/srgb)."""
    b, h, w, _ = rgb_u8.shape
    xy = xy_features(h, w, sxy, xy_scale, rgb_u8.device).expand(b, -1, -1)
    rgb = _const(rgb_u8, _axis_table, 256, srgb)[rgb_u8.reshape(b, h * w, 3).long()]
    return torch.cat([xy, rgb], dim=-1)


def mean_field(rgb_u8: torch.Tensor, masks: torch.Tensor, params: CRFParams,
               xy_scale=(1.0, 1.0), chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean field of each image: uint8 frames [B, h, w, 3], soft masks [B, h, w]
    -> (q1 [B, h, w] f32 before the threshold, iterations [B] int32)."""
    b, h, w = masks.shape
    unary = mask_to_unary(masks, params.crf_scale).reshape(b, h * w, 2)
    app = pixel_features(rgb_u8, params.sxy, params.srgb, xy_scale)
    use_smooth = params.scomp_smooth > 0.0 and params.sxy_smooth > 0.0
    smooth = (xy_features(h, w, params.sxy_smooth, xy_scale, masks.device)
              .expand(b, -1, -1).contiguous() if use_smooth else None)

    du = unary[..., 0] - unary[..., 1]
    q1 = torch.sigmoid(du)

    def one_iter(q1):
        logit = du + params.scomp * (2.0 * crf_filter(app, q1, chunk) - 1.0)
        if use_smooth:
            logit = logit + params.scomp_smooth * (2.0 * crf_filter(smooth, q1, chunk) - 1.0)
        return torch.sigmoid(logit)

    if not params.stable_exit:
        for _ in range(params.refine_iters):
            q1 = one_iter(q1)
        STATS["iterations"] += params.refine_iters
        iters = torch.full((b,), params.refine_iters, dtype=torch.int32, device=masks.device)
        return q1.reshape(b, h, w), iters

    # Each image runs until an iteration leaves its MAP unchanged (or the cap),
    # then stays as it was: JAX's while_loop under vmap.
    done = torch.zeros(b, dtype=torch.bool, device=masks.device)
    iters = torch.zeros(b, dtype=torch.int32, device=masks.device)
    for t in range(params.refine_iters):
        new = one_iter(q1)
        active = ~done
        stable = ((new > 0.5) == (q1 > 0.5)).all(-1)
        q1 = torch.where(active[:, None], new, q1)
        iters += active
        done = done | stable
        STATS["iterations"] += 1
        if (t + 1) % SYNC_EVERY == 0 and t + 1 < params.refine_iters:
            STATS["host_syncs"] += 1
            if bool(done.all()):
                break
    return q1.reshape(b, h, w), iters


def crf_soft_single(rgb_u8: torch.Tensor, mask: torch.Tensor, params: CRFParams,
                    chunk: int = 1024, xy_scale=(1.0, 1.0)) -> torch.Tensor:
    """One image, as the JAX package's ``crf_soft_single`` gives the stage-2
    tools: uint8 [H, W, 3] and a soft mask [H, W] -> the binary MAP [H, W] f32,
    through the batched ``mean_field`` (B = 1; ``crf_filter`` on the card)."""
    q1, _ = mean_field(rgb_u8[None], mask[None].float(), params, xy_scale, chunk)
    return (q1[0] > 0.5).float()


def make_crf_fn(resolution=None, chunk: int = 1024, engine: str = "attention", **kwargs):
    """Batched CRF: (normalized frames [N, H, W, 3], masks [N, H, W]) -> [N, H, W] f32.

    ``resolution``: run the mean field on that grid (the frames and masks
    resized bilinearly with ``align_corners=False``, the resized RGB clipped
    and cast to uint8 again, the MAP resized back), with the spatial widths
    scaled by the grid ratio so that they keep their full-resolution
    geometry; ``None`` runs at the frames' size. ``chunk``: the plain
    filter's tiling. Other keys of ``CRFParams`` are read from ``kwargs``;
    the rest are ignored, as in JAX. ``crf_fn.soft`` gives the mean field's
    q1 on the CRF grid and each image's iterations.
    """
    if engine != "attention":
        raise ValueError(f"unknown CRF engine {engine!r}")
    params = CRFParams(**{k: v for k, v in kwargs.items() if k in CRFParams.__dataclass_fields__})

    def prepare(imgs: torch.Tensor, masks: torch.Tensor):
        h, w = masks.shape[1:]
        rgb = unnormalize_to_uint8(imgs)
        if resolution is None or (h, w) == tuple(resolution):
            return rgb, masks, (1.0, 1.0)
        rgb_run = torch.clamp(resize_bilinear(rgb.float(), tuple(resolution)), 0, 255)
        masks_run = resize_bilinear(masks[..., None], tuple(resolution))[..., 0]
        return rgb_run.to(torch.uint8), masks_run, (resolution[1] / w, resolution[0] / h)

    def soft(imgs: torch.Tensor, masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(q1 on the CRF grid before the threshold, each image's iterations)."""
        rgb_run, masks_run, xy_scale = prepare(imgs, masks)
        return mean_field(rgb_run, masks_run, params, xy_scale, chunk)

    def crf_fn(imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        h, w = masks.shape[1:]
        refined = (soft(imgs, masks)[0] > 0.5).float()
        if tuple(refined.shape[1:]) != (h, w):
            refined = resize_bilinear(refined[..., None], (h, w))[..., 0]
        return refined

    crf_fn.soft, crf_fn.params, crf_fn.resolution = soft, params, resolution
    return crf_fn
