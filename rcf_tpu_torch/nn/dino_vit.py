"""DINO Vision Transformer (ViT-S/8 and friends), port of ``rcf_tpu/nn/dino_vit.py``.

The stage-2 tools (MAA, semantic constraints) read the key features of the
last attention layer (the reference hooks ``blocks[-1].attn.qkv``); here
``forward(imgs, return_last_k=True)`` returns them. Parameter names are the
official DINO state dict's (``patch_embed.proj``, ``blocks.{i}.norm1``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.proj``, ``blocks.{i}.norm2``,
``blocks.{i}.mlp.fc1``/``fc2``, ``norm``, ``cls_token``, ``pos_embed``), so
``load_state_dict`` reads a DINO ``.pth`` and the JAX package's
``import_dino_torch`` reads the port's state dict.

Position embeddings trained at ``train_grid``² are resized bicubically
(torch's a = -0.75, with DINO's +0.1 offset on the scale factor) by
matrices made in numpy, as in JAX. Attention is ``ops/attention_kernels.py::
dino_attention`` on the ``qkv`` linear's output as it lies: the hand-written
kernel on the card (forward only), the plain product, softmax, product on
the CPU. The linears are ``Linear``, an ``nn.Linear`` (its parameters'
names, its hooks) whose forward is ``ops/linear_kernels.py::dino_linear``,
with ``fc1``'s GELU and the blocks' residual adds in its epilogue: the
split-TF32 kernel on the card (forward only), ``F.linear``, ``F.gelu`` and
``+`` on the CPU. ``forward``'s ``attention_span`` (a context manager factory, the
tools' profiler span) is entered around each block's call, so that no span
sits in this module. Inputs are ``[B, H, W, 3]``
(ImageNet-normalized), as in JAX. The forward runs with TF32 off
(``utils/precision.full_f32``): the keys feed a thresholded affinity.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import warnings

import numpy as np
import torch
from torch import nn

from ..ops.attention_kernels import dino_attention
from ..ops.linear_kernels import dino_linear
from ..utils.constants import device_constant
from ..utils.platform import resolve_device
from ..utils.precision import full_f32


@functools.lru_cache(maxsize=64)
def _cubic_matrix(in_size: int, scale: float) -> np.ndarray:
    """[out, in] torch-style bicubic (a=-0.75) interpolation matrix with
    ``scale_factor`` semantics: out = floor(in * scale)."""
    a = -0.75
    out_size = int(math.floor(in_size * scale))
    out = np.arange(out_size, dtype=np.float64)
    src = (out + 0.5) / scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    mat = np.zeros((out_size, in_size), np.float32)

    def w(t):
        t = np.abs(t)
        return np.where(
            t <= 1, (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
        )

    for k in range(-1, 3):
        idx = np.clip(lo + k, 0, in_size - 1)
        mat[np.arange(out_size), idx] += w(frac - k).astype(np.float32)
    return mat


class Linear(nn.Linear):
    """``nn.Linear`` whose forward is ``dino_linear``: ``act(x W^T + b) (+
    residual)`` in one call, ``act`` exact GELU with ``gelu``."""

    def __init__(self, in_features: int, out_features: int, gelu: bool = False):
        super().__init__(in_features, out_features)
        self.gelu = gelu

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        return dino_linear(x, self.weight, self.bias, gelu=self.gelu, residual=residual)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, return_k: bool = False, span=contextlib.nullcontext,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """proj(attention(qkv(x))) (+ residual, in the projection's epilogue),
        or the keys with ``return_k``."""
        b, n, d = x.shape
        hd = d // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        if return_k:
            return qkv[:, :, 1].reshape(b, n, d)
        with span():
            out = dino_attention(qkv)  # [B, N, heads hd]
        return self.proj(out, residual=residual)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden, gelu=True)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        """fc2(GELU(fc1(x))) (+ residual, in fc2's epilogue)."""
        return self.fc2(self.fc1(x), residual=residual)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, return_k: bool = False,
                span=contextlib.nullcontext) -> torch.Tensor:
        if return_k:
            return self.attn(self.norm1(x), return_k=True)
        x = self.attn(self.norm1(x), span=span, residual=x)
        return self.mlp(self.norm2(x), residual=x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    """ViT with DINO's parameter names; ``train_grid``: the position embeddings'
    grid (224 / patch for every supported checkpoint)."""

    def __init__(self, patch_size: int = 8, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, train_grid: int = 28):
        super().__init__()
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.train_grid = train_grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, train_grid * train_grid + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        nn.init.normal_(self.pos_embed, std=0.02)

    def _interp_pos_embed(self, h0: int, w0: int) -> torch.Tensor:
        n = self.train_grid
        if (h0, w0) == (n, n):
            return self.pos_embed
        cls_pe, patch_pe = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        grid = patch_pe.reshape(1, n, n, self.embed_dim)
        dev = grid.device
        # DINO's +0.1 offset, then a scale-factor bicubic.
        mh = device_constant(_cubic_matrix, (n, (h0 + 0.1) / n), dev)
        mw = device_constant(_cubic_matrix, (n, (w0 + 0.1) / n), dev)
        grid = torch.einsum("oh,bhwc->bowc", mh, grid)
        grid = torch.einsum("pw,bowc->bopc", mw, grid)
        if tuple(grid.shape[1:3]) != (h0, w0):
            raise AssertionError(f"position grid {tuple(grid.shape[1:3])} != {(h0, w0)}")
        return torch.cat([cls_pe, grid.reshape(1, h0 * w0, self.embed_dim)], dim=1)

    def forward(self, imgs: torch.Tensor, return_last_k: bool = False,
                attention_span=contextlib.nullcontext) -> torch.Tensor:
        """imgs [B, H, W, 3] -> normed tokens [B, N+1, D], or the last block's
        key features [B, N+1, D] with ``return_last_k`` (whose last block runs
        no attention). ``attention_span()`` is entered around each block's
        attention call."""
        with full_f32():
            b = imgs.shape[0]
            x = self.patch_embed.proj(imgs.permute(0, 3, 1, 2))  # [B, D, h0, w0]
            h0, w0 = x.shape[2], x.shape[3]
            x = x.flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
            x = x + self._interp_pos_embed(h0, w0)
            for i, blk in enumerate(self.blocks):
                if return_last_k and i == self.depth - 1:
                    return blk(x, return_k=True)
                x = blk(x, span=attention_span)
            return self.norm(x)


def vit_small(patch_size: int = 8, **kwargs) -> DinoViT:
    return DinoViT(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kwargs)


def vit_base(patch_size: int = 8, **kwargs) -> DinoViT:
    return DinoViT(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kwargs)


def moco_vit_small(patch_size: int = 16, **kwargs) -> DinoViT:
    # Reference quirk kept: MoCo-v3 ViT-S uses 12 heads at embed 384
    # (`models/dino_vit.py:300-305`), unlike DINO ViT-S's 6.
    return DinoViT(patch_size=patch_size, embed_dim=384, depth=12, num_heads=12, **kwargs)


def moco_vit_base(patch_size: int = 16, **kwargs) -> DinoViT:
    return DinoViT(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kwargs)


def mae_vit_base(patch_size: int = 16, **kwargs) -> DinoViT:
    return DinoViT(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kwargs)


def strip_dino(ckpt: dict) -> dict:
    return ckpt


def strip_moco_v3(ckpt: dict) -> dict:
    """MoCo-v3 checkpoint: ``module.base_encoder.*`` minus the head, prefix
    stripped (`models/dino_vit.py:487-496`)."""
    sd = ckpt.get("state_dict", ckpt)
    prefix = "module.base_encoder."
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.startswith(prefix + "head")}


def strip_mae(ckpt: dict) -> dict:
    """MAE checkpoint: ``ckpt['model']`` minus ``decoder*``/``mask_token``
    (`models/dino_vit.py:497-506`)."""
    sd = ckpt.get("model", ckpt)
    return {k: v for k, v in sd.items()
            if not (k.startswith("decoder") or k.startswith("mask_token"))}


_DINO_ARCHS = {
    "vit_small": (vit_small, strip_dino),
    "vit_base": (vit_base, strip_dino),
    "moco_vit_small": (moco_vit_small, strip_moco_v3),
    "moco_vit_base": (moco_vit_base, strip_moco_v3),
    "mae_vit_base": (mae_vit_base, strip_mae),
}


def load_weights(model: DinoViT, sd: dict) -> dict:
    """Copy the model's own keys from ``sd`` (extra keys ignored, as JAX's
    importer ignores them; a missing key raises) and return them."""
    own = {k: torch.as_tensor(sd[k]) for k in model.state_dict()}
    model.load_state_dict(own)
    return own


def get_dino_model(arch: str, patch_size: int, checkpoint_path: str | None = None,
                   device: torch.device | str = "cuda") -> tuple[DinoViT, dict | None]:
    """(model on ``device`` in eval mode, its loaded state dict or ``None``).

    Runs on the card unless the caller passes ``device="cpu"``; a missing
    card raises (``utils/platform.resolve_device``).

    The checkpoint is a local path (or ``DINO_CHECKPOINT``), read with
    ``torch.load(weights_only=True)``; without one the weights stay random
    and a warning says so, as in JAX. Every supported checkpoint was trained
    at 224², so ``train_grid = 224 // patch_size``.
    """
    if arch not in _DINO_ARCHS:
        raise NotImplementedError(f"unknown DINO arch {arch}")
    device = resolve_device(device)
    ctor, strip = _DINO_ARCHS[arch]
    model = ctor(patch_size=patch_size, train_grid=224 // patch_size)
    checkpoint_path = checkpoint_path or os.environ.get("DINO_CHECKPOINT") or None
    sd = None
    if checkpoint_path is None:
        warnings.warn(f"no checkpoint for {arch}/{patch_size}: using random weights")
    else:
        ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        sd = load_weights(model, strip(ckpt))
    return model.to(device).eval(), sd
