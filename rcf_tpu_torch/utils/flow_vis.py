"""Optical-flow colorization (Baker et al. color wheel), numpy.

Own copy of ``rcf_tpu/utils/flow_vis.py`` (numpy only): the colorization the
reference takes from the `flow_vis` package for its training grids.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """flow [H, W, 2] (u, v) -> uint8 RGB [H, W, 3]."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip is not None:
        u, v = np.clip(u, -clip, clip), np.clip(v, -clip, clip)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v, rad = u / rad_max, v / rad_max, rad / rad_max

    n = _WHEEL.shape[0]
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for ch in range(3):
        c0 = _WHEEL[k0, ch] / 255.0
        c1 = _WHEEL[k1, ch] / 255.0
        col = (1 - f) * c0 + f * c1
        col = 1 - rad * (1 - col)
        img[..., ch] = np.floor(255 * col)
    return img
