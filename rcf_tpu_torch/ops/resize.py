"""Separable image resize as two small matmuls, channel-last.

Port of ``rcf_tpu/ops/resize.py``: static 1-D interpolation matrices
(built once per size pair in numpy) applied over the spatial axes of a
``[..., H, W, C]`` tensor. Matches ``F.interpolate`` (bilinear with either
``align_corners``, and ``nearest``) without antialiasing, and computes
exactly what the JAX package computes.

The matrices are copied to a device once and kept there
(``utils/constants.py::device_constant``, keyed by the size pair, the mode,
``align_corners``, the device and the dtype), as JAX keeps them as
compile-time constants: after the first call a resize makes no
host-to-device copy, which on a card would wait for the stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.constants import device_constant


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out_size, in_size] row-stochastic linear interpolation matrix."""
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = out * ((in_size - 1) / (out_size - 1)) if out_size > 1 else np.zeros_like(out)
    else:
        src = (out + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, hi), frac.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=256)
def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] one-hot nearest-neighbour matrix (torch 'nearest')."""
    out = np.arange(out_size, dtype=np.float64)
    src = np.minimum(np.floor(out * (in_size / out_size)), in_size - 1).astype(np.int64)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), src] = 1.0
    return mat


def _apply_separable(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """Apply row/col matrices over the (-3, -2) spatial axes of ``x`` (...HWC), in f32."""
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    y = torch.einsum("pw,...owc->...opc", mw, y)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of a channel-last image batch ``[..., H, W, C]``."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    dev = x.device
    return _apply_separable(x, device_constant(_linear_matrix, (h, oh, align_corners), dev),
                            device_constant(_linear_matrix, (w, ow, align_corners), dev))


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of ``[..., H, W, C]`` (torch 'nearest' grid)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    dev = x.device
    return _apply_separable(x, device_constant(_nearest_matrix, (h, oh), dev),
                            device_constant(_nearest_matrix, (w, ow), dev))
