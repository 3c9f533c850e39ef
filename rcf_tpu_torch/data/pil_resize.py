"""PIL's ``Image.resize`` for uint8 images, bit for bit, without PIL.

The machine with the card has no PIL, and the stage-2 tools resize masks
the way the reference does: ``Image.open(p).resize((w, h))`` (PIL's
default BICUBIC for an ``L`` image: MAA, CRF post-processing, the
SegTrackv2/FBMS evaluator) and ``resize(..., resample=BILINEAR)`` (the
DAVIS evaluator). ``resize(img, (w, h), filter)`` returns what PIL returns
for an ``L`` (``[H, W]``) or ``RGB`` (``[H, W, 3]``) uint8 image, as
``ImagingResample`` computes it (``libImaging/Resample.c``):

* the filter's support is scaled by the reduction factor (antialiasing);
* each output pixel's taps weigh ``filter((x + xmin - center + 0.5) / filterscale)``
  in double, normalized by their sum, then turned into 22-bit fixed point
  (``PRECISION_BITS = 32 - 8 - 2``), rounded half away from zero;
* a pass adds ``1 << 21`` and shifts right by 22, clipping to uint8;
* the horizontal pass first, then the vertical; a pass whose size does not
  change is skipped, and an equal size returns a copy.

Bicubic uses ``a = -0.5`` (not torch's -0.75). The sums are exact integers,
so the order of the taps does not matter; they stay far inside int32 as in
PIL's C code.
"""

from __future__ import annotations

import functools
import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
BILINEAR, BICUBIC = "bilinear", "bicubic"


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int, filt: str) -> tuple[np.ndarray, np.ndarray]:
    """(tap indices [out, ksize], fixed-point weights [out, ksize]) of one
    axis, as ``precompute_coeffs`` and ``normalize_coeffs_8bpc``; unused taps
    weigh 0 and point at index 0."""
    fn, support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # C's truncating cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = fn((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = float(np.cumsum(w)[-1]) if xmax else 0.0  # summed in order, as the C loop
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        idx[xx, :xmax] = np.arange(xmax) + xmin
    fixed = kk * (1 << PRECISION_BITS)
    fixed = np.where(kk < 0, -0.5 + fixed, 0.5 + fixed).astype(np.int64)  # trunc toward 0
    return idx, fixed


def _pass(img: np.ndarray, axis: int, out_size: int, filt: str) -> np.ndarray:
    """One pass along ``axis`` (1: horizontal, 0: vertical) of a [H, W, C] uint8 image."""
    idx, k = _coeffs(img.shape[axis], out_size, filt)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(idx.shape[1]):
        acc += src[idx[:, j]] * k[:, j, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: tuple[int, int], filt: str = BICUBIC) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, filter))`` for uint8
    ``[H, W]`` or ``[H, W, 3]``; ``size`` is (width, height) as in PIL."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 [H, W] or [H, W, C], got {img.dtype} {img.shape}")
    if filt not in _FILTERS:
        raise ValueError(f"unknown filter {filt!r} (one of {sorted(_FILTERS)})")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"bad size {size}")
    if img.shape[:2] == (h, w):
        return img.copy()
    out = img[..., None] if img.ndim == 2 else img
    if out.shape[1] != w:
        out = _pass(out, 1, w, filt)
    if out.shape[0] != h:
        out = _pass(out, 0, h, filt)
    return out[..., 0] if img.ndim == 2 else out
