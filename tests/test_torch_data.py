"""The port's data pipeline against the JAX package's and against PIL and cv2.

The machine with the card has neither PIL nor cv2, so the port decodes
images with its own codec (``rcf_tpu_torch/data/image_io.py``, host C++
built with the host compiler) and resizes and converts colours in numpy
(``rcf_tpu_torch/data/transforms.py``). Limits:

* JPEG decode against PIL: the aim and the reading is exact; the limit is
  max |delta| <= 1 LSB (libjpeg's islow IDCT, fancy upsampling and
  fixed-point YCbCr are what the codec computes);
* PNG decode, port-encoded PNGs read back through PIL, header probes,
  resizes, HSV conversions: exact;
* port-encoded q90 JPEGs read through PIL: PSNR >= 38 dB;
* transforms, datasets and loaders against the JAX package on the same
  sample and seed: flows, pseudo-labels and uint8 frames exact, normalized
  f32 frames within 1e-6.
"""

from __future__ import annotations

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from rcf_tpu.data import DataLoader as JaxLoader
from rcf_tpu.data import VideoDataset as JaxDataset
from rcf_tpu.data import transforms as jt
from rcf_tpu_torch.data import DataLoader, VideoDataset, image_io
from rcf_tpu_torch.data import transforms as pt

TRAIN_KW = dict(training=True, frame_num=2, load_flow=True, flow_suffix="_T")


def _smooth(rng, h, w, noise=10.0):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17 + c) * np.cos(y / 23 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_within_one_lsb(ours, theirs):
    d = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert ours.shape == theirs.shape and d.max() <= 1, (d.max(), (d > 0).mean())
    return d


# ---------------------------------------------------------------------------
# Image I/O
# ---------------------------------------------------------------------------


def test_fixture_jpegs_decode_as_pil(davis_like):
    """The davis_like frames: PIL q75, 4:2:0, random pixels."""
    paths = sorted((davis_like / "JPEGImages/480p").rglob("*.jpg"))
    assert len(paths) == 7
    for p in paths:
        ref = np.asarray(Image.open(p).convert("RGB"))
        d = _assert_within_one_lsb(image_io.read_image(str(p)), ref)
        assert d.max() == 0
        assert image_io.image_size(str(p)) == Image.open(p).size


@pytest.mark.parametrize("size,kw", [
    ((480, 854), dict(quality=95, subsampling=2)),
    ((121, 213), dict(quality=95, subsampling=2)),
    ((121, 213), dict(quality=95, subsampling=0, restart_marker_blocks=3)),
    ((57, 90), dict(quality=90, subsampling=1, restart_marker_rows=1)),
    ((13, 7), dict(quality=75)),
])
def test_jpeg_decode_matches_pil(size, kw):
    rng = np.random.default_rng(sum(size))
    for img in (_smooth(rng, *size), rng.integers(0, 256, (*size, 3), np.uint8)):
        data = _pil_jpeg(img, **kw)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        d = _assert_within_one_lsb(image_io.decode_jpeg(data), ref)
        assert d.max() == 0
        assert image_io.jpeg_info(data)[:2] == (size[1], size[0])
    gray = _pil_jpeg(img[..., 0], quality=90)
    for mode in ("RGB", "L"):
        assert np.array_equal(image_io.decode_jpeg(gray, mode),
                              np.asarray(Image.open(io.BytesIO(gray)).convert(mode)))


def test_unsupported_jpegs_raise_naming_the_reason(tmp_path):
    img = _smooth(np.random.default_rng(0), 40, 48)
    p = tmp_path / "progressive.jpg"
    p.write_bytes(_pil_jpeg(img, progressive=True))
    with pytest.raises(ValueError, match="progressive") as info:
        image_io.read_image(str(p))
    assert str(p) in str(info.value)
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        image_io.read_image(str(cmyk))
    other = tmp_path / "frame.bmp"
    Image.fromarray(img).save(other)
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        image_io.read_image(str(other))


def _png_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit PNG whose every row uses filter ``ftype`` (PNG spec, 9.2)."""
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int32)
    out = np.zeros((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = ftype
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(ch, np.int32), x[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out[y, 1:] = (x - pred) % 256
    ctype = 0 if ch == 1 else 2

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes())) + chunk(b"IEND", b""))


def test_png_decode_matches_pil_every_filter_and_kind(davis_like):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (23, 31, 3), np.uint8)
    for ftype in range(5):
        for img in (rgb, rgb[..., 1]):
            data = _png_with_filter(img, ftype)
            for mode in ("RGB", "L"):
                ref = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
                assert np.array_equal(image_io.decode_png(data, mode), ref), (ftype, mode)
    kinds = {
        "L": Image.fromarray(rgb[..., 0]), "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray(rgb).convert("RGBA"), "LA": Image.fromarray(rgb).convert("LA"),
        "1": Image.fromarray(rgb[..., 0]).convert("1"),
    }
    for colours in (3, 14, 200):  # PIL writes P;2, P;4 and P (8-bit) palettes
        pal = Image.fromarray(rng.integers(0, colours, (23, 31), np.uint8), "P")
        pal.putpalette(list(rng.integers(0, 256, 3 * colours)))
        kinds[f"P{colours}"] = pal
    for name, im in kinds.items():
        buf = io.BytesIO()
        im.save(buf, "PNG")
        for mode in ("RGB", "L"):
            ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert(mode))
            assert np.array_equal(image_io.decode_png(buf.getvalue(), mode), ref), (name, mode)
    ann = sorted((davis_like / "Annotations/480p").rglob("*.png"))[0]
    assert np.array_equal(image_io.read_image(str(ann)), np.asarray(Image.open(ann).convert("RGB")))
    assert image_io.image_size(str(ann)) == Image.open(ann).size


def test_encoders_read_back_through_pil(tmp_path):
    rng = np.random.default_rng(2)
    for h, w in ((120, 214), (121, 213), (9, 5)):
        img = _smooth(rng, h, w, noise=2.0)
        for arr in (img, img[..., 0]):
            p = tmp_path / "x.png"
            image_io.write_png(str(p), arr)
            assert np.array_equal(np.asarray(Image.open(p)), arr)
        jpg = image_io.encode_jpeg(img, quality=90)
        back = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB")).astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / np.mean((back - img) ** 2))
        assert psnr >= 38.0, psnr
        # The port's decoder reads its own encoder's files as PIL does.
        assert np.array_equal(image_io.decode_jpeg(jpg), back.astype(np.uint8))


# ---------------------------------------------------------------------------
# cv2-free resize and colour conversion
# ---------------------------------------------------------------------------


def test_resizes_match_cv2_exactly():
    rng = np.random.default_rng(3)
    for trial in range(120):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        oh, ow = (int(v) for v in rng.integers(1, 260, 2))
        if trial % 8 == 0:  # cv2's exact-2x area path
            oh, ow, h, w = max(oh // 2, 1), max(ow // 2, 1), 2 * max(oh // 2, 1), 2 * max(ow // 2, 1)
        if trial % 8 == 1:
            oh, ow = h, w
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(pt.imresize(img, (oh, ow), "bilinear"), ref), (h, w, oh, ow)
        flow = rng.standard_normal((h, w, 2)).astype(np.float32)
        ref = cv2.resize(flow, (ow, oh), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(pt.imresize(flow, (oh, ow), "nearest"), ref)
        mask = rng.integers(0, 256, (h, w, 1), np.uint8)
        assert np.array_equal(pt.imresize(mask, (oh, ow), "nearest"),
                              jt.imresize(mask, (oh, ow), "nearest"))


def test_hsv_conversions_match_cv2_on_every_value():
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 3),
                               indexing="ij"), -1).astype(np.uint8).reshape(256, -1, 3)
    assert np.array_equal(pt.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).astype(np.uint8).reshape(-1, 3)
    for width in (384, 33, 1):  # cv2's vector blocks, a block and a tail, the tail alone
        n = len(hsv) // width * width
        part = hsv[:n].reshape(-1, width, 3) if width > 1 else hsv[::97, None]
        assert np.array_equal(pt.hsv_to_rgb(part), cv2.cvtColor(part, cv2.COLOR_HSV2RGB)), width


# ---------------------------------------------------------------------------
# Transforms, datasets, loaders against the JAX package
# ---------------------------------------------------------------------------


def _assert_sample_equal(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        mine = ours[key]
        if isinstance(mine, torch.Tensor):
            mine = mine.numpy()
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype and mine.shape == value.shape, key
            if value.dtype == np.float32 and key == "imgs":
                np.testing.assert_allclose(mine, value, rtol=0, atol=1e-6, err_msg=key)
            else:
                assert np.array_equal(mine, value), key
        else:
            assert mine == value, key


@pytest.mark.parametrize("kind", ["strong", "plain", "uint8", "upscale"])
def test_train_transform_equals_jax_over_seeds(davis_like, kind):
    """24 seeds: every photometric branch, the flip and both crop offsets fire."""
    kw = {"strong": {}, "plain": {"strong_aug": False}, "uint8": {"keep_uint8": True},
          "upscale": {"base_scale": (9999, 300)}}[kind]
    jds, pds = JaxDataset(str(davis_like), "trainval.txt", **TRAIN_KW), \
        VideoDataset(str(davis_like), "trainval.txt", **TRAIN_KW)
    seeds = range(24) if kind == "strong" else range(4)
    for seed in seeds:
        idx = seed % len(jds)
        theirs = jt.TrainTransform(**kw)(jds[idx], np.random.default_rng(seed))
        ours = pt.TrainTransform(**kw)(pds[idx], np.random.default_rng(seed))
        _assert_sample_equal(ours, theirs)


def test_eval_transform_and_dataset_equal_jax(davis_like):
    jds = JaxDataset(str(davis_like), "val.txt", training=False, frame_num=1)
    pds = VideoDataset(str(davis_like), "val.txt", training=False, frame_num=1)
    assert (pds.seq_names, pds.seq_paths) == (jds.seq_names, jds.seq_paths)
    for idx in range(len(jds)):
        a, b = jds[idx], pds[idx]
        assert np.array_equal(a["ann"], b["ann"]) and a["paths"] == b["paths"]
        _assert_sample_equal(pt.EvalTransform()(b), jt.EvalTransform()(a))
    sub = VideoDataset(str(davis_like), "val.txt", training=False, frame_num=1,
                       subsample_frame_interval=-1)
    assert len(sub) == 2


def test_pseudo_labels_load_as_jax(davis_like, tmp_path):
    pl_root = tmp_path / "pl"
    pl_root.mkdir()
    rng = np.random.default_rng(4)
    for seq, n in (("bear", 4), ("cows", 3)):
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (120, 214), np.uint8)).save(
                pl_root / f"pred_seg_{seq}_{i:05d}_0000000.png")
    kw = dict(TRAIN_KW, load_pl=True, pl_root=str(pl_root))
    jds, pds = JaxDataset(str(davis_like), "trainval.txt", **kw), \
        VideoDataset(str(davis_like), "trainval.txt", **kw)
    for seed, idx in ((0, 3), (1, 5)):
        _assert_sample_equal(
            pt.TrainTransform(has_pl=True)(pds[idx], np.random.default_rng(seed)),
            jt.TrainTransform(has_pl=True)(jds[idx], np.random.default_rng(seed)))


def _batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _assert_sample_equal(a, b)


def test_train_loader_equals_jax_for_two_epochs(davis_like):
    """7 samples, batch 4: a permutation per epoch wrap-padded to 8."""
    jl = JaxLoader(JaxDataset(str(davis_like), "trainval.txt", **TRAIN_KW),
                   jt.TrainTransform(), batch_size=4, shuffle=True, seed=3, num_workers=2)
    pl = DataLoader(VideoDataset(str(davis_like), "trainval.txt", **TRAIN_KW),
                    pt.TrainTransform(), batch_size=4, shuffle=True, seed=3, num_workers=2)
    assert len(pl) == len(jl) == 2
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert np.array_equal(pl._epoch_indices(), jl._epoch_indices())
        _batches_equal(pl, jl)


def test_eval_loader_buckets_as_jax(davis_like, tmp_path):
    """Eval batches are bucketed by the source frame size (read from the header)."""
    root = tmp_path / "mixed"
    rng = np.random.default_rng(5)
    lines = []
    for seq, (h, w), n in (("wide", (60, 107), 3), ("tall", (80, 60), 2), ("wide2", (60, 107), 2)):
        for sub in ("JPEGImages/480p", "Annotations/480p"):
            (root / sub / seq).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                root / "JPEGImages/480p" / seq / f"{i:05d}.jpg")
            Image.fromarray(rng.integers(0, 2, (h, w), np.uint8) * 255).save(
                root / "Annotations/480p" / seq / f"{i:05d}.png")
        lines.append(f"JPEGImages/480p/{seq}/ " + " ".join(f"{i:05d}.jpg" for i in range(n)))
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    kw = dict(training=False, frame_num=1)
    jl = JaxLoader(JaxDataset(str(root), "val.txt", **kw), jt.EvalTransform(), batch_size=2,
                   shuffle=False, drop_last=False, group_by_shape=True, num_workers=2)
    pl = DataLoader(VideoDataset(str(root), "val.txt", **kw), pt.EvalTransform(), batch_size=2,
                    shuffle=False, drop_last=False, group_by_shape=True, num_workers=2)
    assert [b.tolist() for b in pl.batches_of_indices()] == \
        [b.tolist() for b in jl._batches_of_indices()]
    _batches_equal(pl, jl)
