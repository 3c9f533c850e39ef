"""Paired augmentation pipeline without cv2 (port of ``rcf_tpu/data/transforms.py``).

The same transforms, drawing the same ``np.random.Generator`` calls in the
same order, so that a sample and a seed give the JAX package's output.
The machine with the card has no cv2, so the three cv2 operations the JAX
pipeline uses are written here in numpy, vectorised, computing what
OpenCV 5.0 computes on uint8 (``tests/test_torch_data.py`` holds them to
cv2):

* ``cv2.resize(..., INTER_LINEAR)`` on uint8: pixel-centre mapping
  ``(x + 0.5) * scale - 0.5`` in float32, 11-bit coefficients
  (``saturate_cast<short>(w * 2048)``), the columns clamped with their
  weight moved to the edge, the rows clamped with their weights kept; a
  horizontal pass into int32, then OpenCV's vector vertical pass on every
  element: ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``.
  An exact 2x downscale in both axes takes cv2's area path instead
  (``(a + b + c + d + 2) >> 2``); an equal size is a copy.
* ``cv2.resize(..., INTER_NEAREST)``: ``min(floor(x * (1 / (dw / sw))),
  sw - 1)`` in double, for any dtype (flows, pseudo-labels).
* ``COLOR_RGB2HSV`` (integer, 12-bit division tables; H in [0, 180)) and
  ``COLOR_HSV2RGB`` (float32, the products under ``1 -`` fused; whole
  32-pixel blocks of a row truncated to uint8 as cv2's AVX2 loop does,
  the rest of the row rounded as its scalar tail does).

The quirks stay: the flip moves flows without negating them, a frame
shorter than the crop is first resized to ``(2000, crop_h)``, and
``keep_uint8`` skips the f32 normalize.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def rescale_size(old_hw: tuple[int, int], scale: tuple[int, int]) -> tuple[int, int]:
    """Keep-ratio target size fitting within (long_edge, short_edge) bounds."""
    h, w = old_hw
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5)


def imrescale(img: np.ndarray, scale: tuple[int, int], interpolation: str = "bilinear") -> np.ndarray:
    """Keep-ratio rescale (mmcv.imrescale semantics)."""
    new_h, new_w = rescale_size(img.shape[:2], scale)
    return imresize(img, (new_h, new_w), interpolation)


def _linear_taps(src: int, dst: int, clamp_edges: bool):
    """cv2's source index and 11-bit weights of each output position."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_edges:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return s, w0, w1


def _resize_linear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    if (h, w) == (oh, ow):
        return img.copy()
    scale_x, scale_y = 1.0 / (ow / w), 1.0 / (oh / h)
    if (abs(scale_x - round(scale_x)) < np.finfo(np.float64).eps
            and abs(scale_y - round(scale_y)) < np.finfo(np.float64).eps
            and round(scale_x) == 2 and round(scale_y) == 2):
        s = src.astype(np.int32)
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
        return out.astype(np.uint8).reshape(oh, ow, *img.shape[2:])
    sx, ax0, ax1 = _linear_taps(w, ow, clamp_edges=True)
    sx1 = np.minimum(sx + 1, w - 1)
    sy, by0, by1 = _linear_taps(h, oh, clamp_edges=False)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    rows = np.unique(np.concatenate([r0, r1]))
    s = src[rows].astype(np.int32)
    hor = s[:, sx] * ax0[None, :, None] + s[:, sx1] * ax1[None, :, None]  # [rows, ow, c]
    pos = np.searchsorted(rows, np.arange(h))  # source row -> its index in ``rows``
    s0 = hor[pos[r0]] >> 4
    s1 = hor[pos[r1]] >> 4
    out = ((s0 * by0[:, None, None]) >> 16) + ((s1 * by1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape(oh, ow, *img.shape[2:])


def _resize_nearest(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return img[ys[:, None], xs[None, :]]


def imresize(img: np.ndarray, out_hw: tuple[int, int], interpolation: str = "bilinear") -> np.ndarray:
    """``cv2.resize`` to ``out_hw``: bilinear on uint8 images, nearest on any array."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if interpolation == "nearest":
        return np.ascontiguousarray(_resize_nearest(img, oh, ow))
    if interpolation != "bilinear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if img.dtype != np.uint8:
        raise NotImplementedError("bilinear resize is written for uint8 frames only "
                                  "(the pipelines resize other fields with nearest)")
    return _resize_linear_u8(img, oh, ow)


# ---------------------------------------------------------------------------
# Photometric distortion (uint8 RGB, cv2's HSV convention).
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
_i = np.arange(256, dtype=np.float64)
_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / _i[1:])
_HDIV = np.zeros(256, np.int64)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * _i[1:]))
_HSV_BLOCK = 32  # pixels per iteration of cv2's AVX2 HSV2RGB loop (4 x 8 lanes)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8 (integer, division tables)."""
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` on uint8 [H, W, 3].

    float32 with ``1 - s * h`` and ``1 - s * (1 - h)`` fused; cv2's vector
    loop (whole blocks of ``_HSV_BLOCK`` pixels of a row) truncates to
    uint8, its scalar tail rounds to nearest.
    """
    f32, one = np.float32, np.float32(1.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = (h - sector).astype(f32)
    sector = sector.astype(np.int64) % 6

    def fused(a, b):  # fma(-a, b, 1) rounded once to f32
        return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * fused(s, h), v * fused(s, one - h)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTORS[sector], axis=-1)[..., ::-1] * f32(255.0)
    width = hsv.shape[-2]
    vector = np.arange(width) < (width // _HSV_BLOCK) * _HSV_BLOCK
    out = np.where(vector[:, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)


def _convert(img: np.ndarray, alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


@dataclass
class PhotoMetricDistortion:
    """Brightness/contrast/saturation/hue jitter, identical across the pair
    (each sub-op fires with p=0.5; contrast is applied first or last at random)."""

    brightness_delta: float = 32.0
    contrast_range: tuple[float, float] = (0.5, 1.5)
    saturation_range: tuple[float, float] = (0.5, 1.5)
    hue_delta: float = 18.0

    def _saturation(self, imgs, alpha):
        out = []
        for img in imgs:
            hsv = rgb_to_hsv(img)
            hsv[:, :, 1] = _convert(hsv[:, :, 1], alpha=alpha)
            out.append(hsv_to_rgb(hsv))
        return out

    def _hue(self, imgs, delta):
        out = []
        for img in imgs:
            hsv = rgb_to_hsv(img)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int) + delta) % 180
            out.append(hsv_to_rgb(hsv))
        return out

    def __call__(self, imgs: list[np.ndarray], rng: np.random.Generator) -> list[np.ndarray]:
        if rng.integers(2):
            beta = rng.uniform(-self.brightness_delta, self.brightness_delta)
            imgs = [_convert(im, beta=beta) for im in imgs]
        contrast_last = rng.integers(2) == 0
        if not contrast_last and rng.integers(2):
            alpha = rng.uniform(*self.contrast_range)
            imgs = [_convert(im, alpha=alpha) for im in imgs]
        if rng.integers(2):
            imgs = self._saturation(imgs, rng.uniform(*self.saturation_range))
        if rng.integers(2):
            imgs = self._hue(imgs, rng.uniform(-self.hue_delta, self.hue_delta))
        if contrast_last and rng.integers(2):
            alpha = rng.uniform(*self.contrast_range)
            imgs = [_convert(im, alpha=alpha) for im in imgs]
        return imgs


# ---------------------------------------------------------------------------
# Standalone geometry helpers (the transform API; the pipelines do not use them).
# ---------------------------------------------------------------------------


def center_crop(arr: np.ndarray, crop_hw: tuple[int, int]) -> np.ndarray:
    ch, cw = crop_hw
    oy = max(arr.shape[0] - ch, 0) // 2
    ox = max(arr.shape[1] - cw, 0) // 2
    return arr[oy : oy + ch, ox : ox + cw]


def pad_to(arr: np.ndarray, size_hw: tuple[int, int] | None = None,
           size_divisor: int | None = None, pad_val: float = 0) -> np.ndarray:
    """Bottom/right pad to a fixed size or to a multiple of size_divisor."""
    if (size_hw is None) == (size_divisor is None):
        raise ValueError("give exactly one of size_hw and size_divisor")
    h, w = arr.shape[:2]
    if size_divisor is not None:
        size_hw = (-(-h // size_divisor) * size_divisor, -(-w // size_divisor) * size_divisor)
    pads = [(0, size_hw[0] - h), (0, size_hw[1] - w)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads, constant_values=pad_val)


def seg_rescale(arr: np.ndarray, scale_factor: float) -> np.ndarray:
    if scale_factor == 1:
        return arr
    out_hw = (int(arr.shape[0] * scale_factor + 0.5), int(arr.shape[1] * scale_factor + 0.5))
    return imresize(arr, out_hw, "nearest")


# ---------------------------------------------------------------------------
# Composite pipelines.
# ---------------------------------------------------------------------------


def _resize_all(sample: dict, scale: tuple[int, int]) -> dict:
    sample["imgs"] = [imrescale(im, scale, "bilinear") for im in sample["imgs"]]
    for key in sample["seg_fields"]:
        sample[key] = [imrescale(arr, scale, "nearest") for arr in sample[key]]
    return sample


# Fused uint8 -> normalized-f32 affine (a plain /255 would promote to f64).
_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_BIAS = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def _normalize(imgs: list[np.ndarray]) -> np.ndarray:
    stacked = np.stack(imgs)
    return stacked.astype(np.float32) * _NORM_SCALE + _NORM_BIAS


def _arrays(sample: dict, keep_uint8: bool) -> dict:
    return {
        "imgs": np.stack(sample["imgs"]) if keep_uint8 else _normalize(sample["imgs"]),
        "seq_ids": sample["seq_ids"],
        "seq_names": sample["seq_names"],
        "paths": sample["paths"],
        "frame_ind_start": sample["frame_ind_start"],
    }


@dataclass
class TrainTransform:
    strong_aug: bool = True
    has_pl: bool = False
    scale_flow: bool = False
    crop_size: tuple[int, int] = (384, 384)
    base_scale: tuple[int, int] = (9999, 400)
    ratio_range: tuple[float, float] = (0.96, 1.0)
    # keep_uint8: emit uint8 frames; the model normalizes on the device.
    keep_uint8: bool = False

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        # 1. Keep-ratio resize with a sampled global ratio.
        ratio = rng.random() * (self.ratio_range[1] - self.ratio_range[0]) + self.ratio_range[0]
        scale = (int(self.base_scale[0] * ratio), int(self.base_scale[1] * ratio))
        old_hw = sample["imgs"][0].shape[:2]
        sample = _resize_all(sample, scale)
        new_hw = sample["imgs"][0].shape[:2]
        scale_factor = np.array(
            [new_hw[1] / old_hw[1], new_hw[0] / old_hw[0]], np.float32
        )  # (w_scale, h_scale)

        # 2. Random crop (upscale first if shorter than the crop).
        ch, cw = self.crop_size
        if sample["imgs"][0].shape[0] < ch:
            sample = _resize_all(sample, (2000, ch))
        h, w = sample["imgs"][0].shape[:2]
        oy = int(rng.integers(0, max(h - ch, 0) + 1))
        ox = int(rng.integers(0, max(w - cw, 0) + 1))
        sample["imgs"] = [im[oy : oy + ch, ox : ox + cw] for im in sample["imgs"]]
        for key in sample["seg_fields"]:
            sample[key] = [arr[oy : oy + ch, ox : ox + cw] for arr in sample[key]]

        # 3. Strong augmentation: flip + photometric.
        if self.strong_aug:
            if rng.random() < 0.5:
                sample["imgs"] = [im[:, ::-1] for im in sample["imgs"]]
                for key in sample["seg_fields"]:
                    sample[key] = [np.ascontiguousarray(arr[:, ::-1]) for arr in sample[key]]
            sample["imgs"] = PhotoMetricDistortion()(sample["imgs"], rng)

        # 4. To arrays (normalized f32, or uint8 for device-side normalize).
        out = _arrays(sample, self.keep_uint8)
        if "gt_fw_flows" in sample:
            fw = np.stack(sample["gt_fw_flows"]).astype(np.float32)
            bw = np.stack(sample["gt_bw_flows"]).astype(np.float32)
            if self.scale_flow:
                fw = fw * scale_factor
                bw = bw * scale_factor
            out["gt_fw_flows"], out["gt_bw_flows"] = fw, bw
        if self.has_pl and "pl_masks" in sample:
            out["pl_masks"] = np.stack(sample["pl_masks"]).astype(np.float32) / 255.0
        return out


@dataclass
class EvalTransform:
    strong_aug: bool = False  # accepted for config parity; unused
    base_scale: tuple[int, int] = (9999, 400)
    ratio: float = 0.98
    keep_uint8: bool = False

    def __call__(self, sample: dict, rng: np.random.Generator | None = None) -> dict:
        scale = (int(self.base_scale[0] * self.ratio), int(self.base_scale[1] * self.ratio))
        sample = _resize_all(sample, scale)
        out = _arrays(sample, self.keep_uint8)
        if "ann" in sample:
            out["ann"] = sample["ann"]  # original resolution, never resized
        return out


def get_transform(cfg, training: bool):
    kwargs = dict(cfg.train_transform_kwargs if training else cfg.test_transform_kwargs)
    if training:
        return TrainTransform(**kwargs)
    return EvalTransform(**kwargs)
