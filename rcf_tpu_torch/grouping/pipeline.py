"""Shared plumbing of the visual-grouping tools (port of ``rcf_tpu/grouping/pipeline.py``).

The reference's NCutEvalHead / NCutHead feature path
(`tools/SemanticConstraintsAndMAA/maa.py:39-139`,
`semantic_constraints.py:78-190`): frames resized bilinearly to
(480, 856), DINO ViT-S/8 last-attention key features, masks resized
nearest to the 60x107 feature grid.

DINO weights are a local checkpoint (torch format, the official
``dino_deitsmall8_300ep_pretrain.pth``) given by ``--dino-checkpoint`` or
``DINO_CHECKPOINT``. Without one, ``DinoFeatures`` uses centred mean-colour
patch features instead of a random ViT, as the JAX package does, and logs
a warning: this is the tools' behaviour without weights, on any device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.resize import resize_bilinear, resize_nearest
from ..utils import get_logger, resolve_device
from ..utils.precision import full_f32

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


class DinoFeatures:
    """DINO ViT last-attention key features of (480, 856)-resized frames, on ``device``."""

    def __init__(self, checkpoint: str | None = None, arch: str = "vit_small",
                 patch_size: int = 8, resize_imgs_size: tuple[int, int] = (480, 856),
                 device: torch.device | str = "cuda"):
        from ..nn.dino_vit import get_dino_model

        self.device = resolve_device(device)
        self.patch_size, self.resize_imgs_size = patch_size, tuple(resize_imgs_size)
        self.grid_hw = (resize_imgs_size[0] // patch_size, resize_imgs_size[1] // patch_size)
        ckpt_path = checkpoint or os.environ.get("DINO_CHECKPOINT")
        if ckpt_path and os.path.exists(ckpt_path):
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
        with full_f32():
            if self.model is not None:
                mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
                std = torch.from_numpy(IMAGENET_STD).to(self.device)
                x = (x - mean) / std
            x = resize_bilinear(x, self.resize_imgs_size)
            if self.model is None:
                return self._color_feats(x)
            return self.model(x, return_last_k=True)

    def to_device(self, x) -> torch.Tensor:
        """A numpy array or tensor as f32 on the device."""
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def mask_to_grid(self, mask) -> torch.Tensor:
        """[H, W] -> the mask resized nearest to the feature grid, on the device."""
        with full_f32():
            return resize_nearest(self.to_device(mask)[None, ..., None], self.grid_hw)[0, ..., 0]
