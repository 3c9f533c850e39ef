"""The feed ``texture_frames``: a small pool of frame batches made on the card from
the seed at set-up and cycled, each frame with a soft mask of its object.

A frame follows ``chip_smoke.py::_texture``: smooth coloured noise (N(0, 1)
at an eighth of the size, min-max scaled, resized bilinearly) mixed with a
base colour (``noise`` of the noise to ``1 - noise`` of the base; 0.6 in
``chip_smoke.py``): a dark background (base 10-60 of 255 a channel) and a
bright ellipse (170-250) at a random place and size. A ViT at random
weights tells patches apart by their colour alone (its keys are close to a
random projection of the ImageNet-normalised pixels), so the object's and
the background's colours lie on either side of ImageNet's mean: the
affinity then separates them, as trained DINO weights separate an object
from its background. Where both lie on one side, nearly every pair is
above tau, the NCut value is nearly flat, and its Adam steps empty some
masks (0 / 0, every cell NaN). Its mask stands in for the stage-2.1
export's soft mask: a sigmoid blob over an ellipse shifted and stretched
from the object's by up to a tenth, so that the NCut refinement has
something to correct. RGB in [0, 1], channel-last. Traffic keys: ``frames``
(a batch), ``hw`` (the frame's height and width), ``pool``, ``noise``.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def _texture(gen, n: int, h: int, w: int, base: torch.Tensor, noise_share: float) -> torch.Tensor:
    noise = torch.randn(n, 3, h // 8 + 2, w // 8 + 2, generator=gen, device=base.device)
    lo = noise.amin(dim=(1, 2, 3), keepdim=True)
    hi = noise.amax(dim=(1, 2, 3), keepdim=True)
    img = F.interpolate((noise - lo) / (hi - lo + 1e-9), size=(h, w), mode="bilinear", align_corners=False)
    return (noise_share * img + (1.0 - noise_share) * base[:, :, None, None]).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def _ellipse(yy, xx, centre, radii) -> torch.Tensor:
    """The normalised radius of each pixel about each frame's ellipse: [n, h, w]."""
    dy = (yy[None] - centre[:, 0, None, None]) / radii[:, 0, None, None]
    dx = (xx[None] - centre[:, 1, None, None]) / radii[:, 1, None, None]
    return torch.sqrt(dy * dy + dx * dx)


def batch(gen, n: int, h: int, w: int, device, noise: float) -> dict:
    """``n`` frames [n, h, w, 3] and their soft masks [n, h, w]."""
    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=device)

    bg = _texture(gen, n, h, w, uniform(n, 3, lo=10 / 255, hi=60 / 255), noise)
    fg = _texture(gen, n, h, w, uniform(n, 3, lo=170 / 255, hi=250 / 255), noise)
    radii = torch.stack([uniform(n, lo=h / 6, hi=h / 3), uniform(n, lo=w / 8, hi=w / 4)], dim=1)
    centre = torch.stack([uniform(n, lo=h / 4, hi=3 * h / 4), uniform(n, lo=w / 4, hi=3 * w / 4)], dim=1)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    inside = (_ellipse(yy, xx, centre, radii) <= 1.0)[..., None]
    frames = torch.where(inside, fg, bg)
    shift = centre + radii * uniform(n, 2, lo=-0.1, hi=0.1)
    stretch = radii * uniform(n, 2, lo=0.9, hi=1.1)
    masks = torch.sigmoid(8.0 * (1.0 - _ellipse(yy, xx, shift, stretch)))
    return {"imgs01": frames.contiguous(), "masks": masks}


class Feed:
    def __init__(self, wl: dict, seed: int, dev):
        tr = wl["traffic"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed ^ 0x7E57F4A3)
        h, w = (int(s) for s in tr["hw"])
        self.batches = [batch(gen, int(tr["frames"]), h, w, dev, float(tr["noise"]))
                        for _ in range(int(tr["pool"]))]
        self.it = itertools.cycle(self.batches)

    def next(self) -> dict:
        return next(self.it)

    def close(self) -> None:
        self.it = self.batches = None


def make(wl: dict, cfg: dict, stage, seed: int, dev) -> Feed:
    return Feed(wl, seed, dev)
