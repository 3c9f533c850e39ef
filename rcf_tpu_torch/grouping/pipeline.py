"""Shared plumbing of the visual-grouping tools (port of ``rcf_tpu/grouping/pipeline.py``).

The reference's NCutEvalHead / NCutHead feature path
(`tools/SemanticConstraintsAndMAA/maa.py:39-139`,
`semantic_constraints.py:78-190`): frames resized bilinearly to
(480, 856), DINO ViT-S/8 last-attention key features, masks resized
nearest to the 60x107 feature grid.

DINO weights are a local checkpoint (torch format, the official
``dino_deitsmall8_300ep_pretrain.pth``) given by ``--dino-checkpoint`` or
``DINO_CHECKPOINT``, or a ``DinoViT`` with given weights
(``DinoFeatures(model=...)``). Without either, ``DinoFeatures`` uses centred
mean-colour patch features instead of a random ViT, as the JAX package
does, and logs a warning: this is the tools' behaviour without weights, on
any device.

A ViT forward is the span ``rcf.dino.forward``, each block's attention inside
it ``rcf.dino.attention`` (``train/metrics.py``); ``grouping.STATS`` counts
its frames, tokens and attention pairs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.resize import resize_bilinear, resize_nearest
from ..utils import get_logger, resolve_device
from ..utils.constants import device_constant
from ..utils.precision import full_f32
from . import STATS

logger = get_logger()

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

VAL_SEQS = {
    "davis": [
        "blackswan", "bmx-trees", "breakdance", "camel", "car-roundabout",
        "car-shadow", "cows", "dance-twirl", "dog", "drift-chicane",
        "drift-straight", "goat", "horsejump-high", "kite-surf", "libby",
        "motocross-jump", "paragliding-launch", "parkour", "scooter-black", "soapbox",
    ],
    "stv2": [
        "bird_of_paradise", "birdfall", "bmx", "cheetah", "drift", "frog", "girl",
        "hummingbird", "monkey", "monkeydog", "parachute", "penguin", "soldier", "worm",
    ],
    "fbms59": [
        "camel01", "cars1", "cars10", "cars4", "cars5", "cats01", "cats03", "cats06",
        "dogs01", "dogs02", "farm01", "giraffes01", "goats01", "horses02", "horses04",
        "horses05", "lion01", "marple12", "marple2", "marple4", "marple6", "marple7",
        "marple9", "people03", "people1", "people2", "rabbits02", "rabbits03",
        "rabbits04", "tennis",
    ],
}

DATA_ROOTS = {
    "davis": ("data/data_davis", "JPEGImages/480p"),
    "stv2": ("data/data_SegTrackv2_resized", "JPEGImages"),
    "fbms59": ("data/data_fbms59_resized", "JPEGImages"),
}


def _imagenet(which: str) -> np.ndarray:
    return IMAGENET_MEAN if which == "mean" else IMAGENET_STD


def _attention_span():
    return record_function("rcf.dino.attention")


class DinoFeatures:
    """DINO ViT last-attention key features of (480, 856)-resized frames, on ``device``.

    ``model``: a ``nn.dino_vit.DinoViT`` with given weights, used in eval mode
    on its own device and at its own patch size (``checkpoint``, ``arch``,
    ``patch_size`` and ``device`` are then not read)."""

    def __init__(self, checkpoint: str | None = None, arch: str = "vit_small",
                 patch_size: int = 8, resize_imgs_size: tuple[int, int] = (480, 856),
                 device: torch.device | str = "cuda", model=None):
        from ..nn.dino_vit import get_dino_model

        if model is not None:
            patch_size, device = model.patch_size, next(model.parameters()).device
        self.device = resolve_device(device)
        self.patch_size, self.resize_imgs_size = patch_size, tuple(resize_imgs_size)
        self.grid_hw = (resize_imgs_size[0] // patch_size, resize_imgs_size[1] // patch_size)
        ckpt_path = checkpoint or os.environ.get("DINO_CHECKPOINT")
        if model is not None:
            self.model = model.eval()
        elif ckpt_path and os.path.exists(ckpt_path):
            # DINO, MoCo-v3 and MAE checkpoint layouts (get_dino_model).
            self.model, _ = get_dino_model(arch, patch_size, ckpt_path, self.device)
            logger.info(f"Loaded {arch} weights from {ckpt_path}")
        else:
            # A random ViT gives an uninformative affinity that zeroes every
            # merged pseudo-label; centred patch colour keeps the tools
            # meaningful without weights (the JAX package's choice).
            self.model = None
            logger.warning("No DINO checkpoint available — using hand-crafted color patch "
                           "features (set DINO_CHECKPOINT for real runs)")

    def _color_feats(self, imgs: torch.Tensor) -> torch.Tensor:
        b = imgs.shape[0]
        gh, gw = self.grid_hw
        p = self.patch_size
        x = imgs.reshape(b, gh, p, gw, p, 3).mean(dim=(2, 4)).reshape(b, gh * gw, 3)
        x = x - x.mean(dim=1, keepdim=True)  # centred: distinct colours -> cos < tau
        cls = torch.ones((b, 1, 3), dtype=x.dtype, device=x.device)  # dropped by the NCut
        return torch.cat([cls, x], dim=1)

    @torch.no_grad()
    def __call__(self, imgs01: np.ndarray) -> torch.Tensor:
        """imgs01 [B, H, W, 3] float RGB in [0, 1] -> key features [B, N+1, D] on the device."""
        x = self.to_device(imgs01)
        b, tokens = x.shape[0], self.grid_hw[0] * self.grid_hw[1] + 1
        STATS["frames"] += b
        STATS["tokens"] += b * tokens
        with full_f32():
            if self.model is None:
                return self._color_feats(resize_bilinear(x, self.resize_imgs_size))
            with record_function("rcf.dino.forward"):
                mean = device_constant(_imagenet, ("mean",), self.device)
                std = device_constant(_imagenet, ("std",), self.device)
                x = resize_bilinear((x - mean) / std, self.resize_imgs_size)
                STATS["attention_pairs"] += (b * self.model.blocks[0].attn.num_heads * tokens ** 2
                                             * (self.model.depth - 1))
                return self.model(x, return_last_k=True, attention_span=_attention_span)

    def to_device(self, x) -> torch.Tensor:
        """A numpy array or tensor as f32 on the device."""
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def mask_to_grid(self, mask) -> torch.Tensor:
        """[..., H, W] -> the masks resized nearest to the feature grid, on the device."""
        with full_f32():
            return resize_nearest(self.to_device(mask)[..., None], self.grid_hw)[..., 0]
