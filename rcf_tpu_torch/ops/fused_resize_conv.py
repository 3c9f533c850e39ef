"""Exact fused bilinear-upsample -> dilated conv, the mask head's conv0.

Port of ``rcf_tpu/ops/fused_resize_conv.py``. The RCF mask head
(``input_transform: resize_concat``) upsamples the stage-4 features 2x
(48^2 -> 96^2 at 384^2 frames, 2048 channels) and runs a 3x3 dilation-6
conv over the concat: the model's largest conv, ~98 GFLOPs a frame. With
a linear upsample U by an integer scale s (align_corners=False) and a conv
whose dilation d is a multiple of s, every tap lands on the same phase, so

    conv_d(U(x)) == U(conv_{d/s}(x))

except on a few output lines where U's edge clamping meets the conv's zero
padding. ``_wrong_lines`` finds those lines numerically from the
interpolation matrices; they are recomputed exactly from gathered taps and
spliced in (``index_copy`` with device index tensors made once), so every
output equals the direct path up to float re-association, for s^2 fewer
conv FLOPs on that source.

``fused_resize_conv`` returns ``None`` where the identity does not apply
(non-integer scale, a dilation not divisible by it, align_corners=True),
and the caller resizes, then convolves. Tensors are channel-last; the
kernel is the port's OIHW conv weight. The convolutions are cuDNN's (the
JAX version is XLA convolutions, not a Pallas kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.constants import device_constant
from .resize import _linear_matrix, resize_bilinear


def _shift_matrix(n: int, k: int) -> np.ndarray:
    """[n, n] matrix of y[p] = x[p + k] with zeros outside (conv zero pad)."""
    m = np.zeros((n, n))
    p = np.arange(max(0, -k), min(n, n - k))
    m[p, p + k] = 1.0
    return m


@functools.lru_cache(maxsize=256)
def _wrong_lines(in_size: int, out_size: int, dilation: int, align_corners: bool,
                 kernel_size: int) -> tuple[int, ...] | None:
    """Output lines where conv-of-upsample != upsample-of-conv, or None if
    the factorization is ineligible or the mismatch set is dense."""
    if out_size % in_size or out_size == in_size:
        return None
    s = out_size // in_size
    if dilation % s:
        return None
    r = _linear_matrix(in_size, out_size, align_corners).astype(np.float64)
    wrong: set[int] = set()
    for t in range(-(kernel_size // 2), kernel_size // 2 + 1):
        if t == 0:
            continue
        e = _shift_matrix(out_size, dilation * t) @ r - r @ _shift_matrix(in_size, dilation // s * t)
        wrong.update(np.where(np.abs(e).sum(axis=1) > 1e-9)[0].tolist())
    if len(wrong) > 4 * kernel_size:  # dense mismatch (e.g. align_corners=True)
        return None
    return tuple(sorted(wrong))


def _tap_gather_matrix(in_size: int, out_size: int, dilation: int, align_corners: bool,
                       kernel_size: int, lines: tuple[int, ...]) -> np.ndarray:
    """[len(lines)*k, in_size]: row i*k+j reads upsampled line ``lines[i] +
    d*(j - k//2)`` directly from the source (zero row = conv zero pad)."""
    r = _linear_matrix(in_size, out_size, align_corners)
    a = np.zeros((len(lines) * kernel_size, in_size), np.float32)
    for i, p in enumerate(lines):
        for j in range(kernel_size):
            q = p + dilation * (j - kernel_size // 2)
            if 0 <= q < out_size:
                a[i * kernel_size + j] = r[q]
    return a


def _index(lines: tuple[int, ...]) -> np.ndarray:
    return np.asarray(lines, np.int64)


def _conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, padding, dilation) -> torch.Tensor:
    return F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=padding,
                    dilation=dilation).permute(0, 2, 3, 1)


def same_conv(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """NHWC conv of an OIHW kernel, 'same' zero padding, no bias."""
    pad = (kernel.shape[-1] - 1) // 2 * dilation
    return _conv_nhwc(x, kernel, pad, dilation)


def fused_resize_conv(x: torch.Tensor, kernel: torch.Tensor, target_hw: tuple[int, int],
                      dilation: int, align_corners: bool) -> torch.Tensor | None:
    """``same_conv(resize_bilinear(x, target_hw), kernel, dilation)`` at source
    resolution with the exact lines spliced in; None if ineligible.

    Wrong rows are tap-gathered along H (exact) and convolved and upsampled
    along W (so wrong at the wrong columns), wrong columns symmetrically,
    and the (rows x columns) corner block is recomputed from 2-D tap
    gathers last: every output ends up exact while the heavy convs stay on
    the source grid. x [N, h, w, C] and the OIHW kernel in one dtype.
    """
    ht, wt = target_hw
    n, h, w, _ = x.shape
    k = kernel.shape[-1]
    if kernel.shape[-2] != k:
        return None
    rows = _wrong_lines(h, ht, dilation, align_corners, k)
    cols = _wrong_lines(w, wt, dilation, align_corners, k)
    if rows is None or cols is None:
        return None
    f = kernel.shape[0]
    dev, dt = x.device, x.dtype
    dl_h, dl_w = dilation // (ht // h), dilation // (wt // w)
    pad_h, pad_w = (k - 1) // 2 * dl_h, (k - 1) // 2 * dl_w

    lo = _conv_nhwc(x, kernel, (pad_h, pad_w), (dl_h, dl_w))
    main = resize_bilinear(lo, target_hw, align_corners)
    gather = functools.partial(device_constant, _tap_gather_matrix, device=dev, dtype=dt)
    if rows:
        a_h = gather((h, ht, dilation, align_corners, k, rows))
        row_idx = device_constant(_index, (rows,), dev, torch.int64)
    if cols:
        a_w = gather((w, wt, dilation, align_corners, k, cols))
        col_idx = device_constant(_index, (cols,), dev, torch.int64)

    if rows:
        # Exact along H (tap gather), factorized along W (wrong at the
        # wrong columns, which the column pass overwrites).
        taps = torch.einsum("rh,nhwc->nrwc", a_h, x).reshape(n * len(rows), k, w, -1)
        ex = _conv_nhwc(taps, kernel, (0, pad_w), (1, dl_w)).reshape(n, len(rows), w, f)
        rw = device_constant(_linear_matrix, (w, wt, align_corners), dev, dt)
        main = main.index_copy(1, row_idx, torch.einsum("Ww,nrwf->nrWf", rw, ex))

    if cols:
        taps = (torch.einsum("cw,nhwk->nhck", a_w, x)
                .reshape(n, h, len(cols), k, -1).permute(0, 2, 1, 3, 4)
                .reshape(n * len(cols), h, k, -1))
        ex = _conv_nhwc(taps, kernel, (pad_h, 0), (dl_h, 1)).reshape(n, len(cols), h, f)
        rh = device_constant(_linear_matrix, (h, ht, align_corners), dev, dt)
        ex = torch.einsum("Hh,nchf->nHcf", rh, ex)
        if rows:
            corner_taps = torch.einsum("rh,cw,nhwk->nrck", a_h, a_w, x).reshape(
                n, len(rows), k, len(cols), k, -1)
            corners = torch.einsum("naibjc,fcij->nabf", corner_taps, kernel)
            ex = ex.index_copy(1, row_idx, corners)
        main = main.index_copy(2, col_idx, ex)
    return main
