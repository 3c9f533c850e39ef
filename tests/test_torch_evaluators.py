"""The port's evaluators and their helpers against PIL and the JAX package, on the CPU.

Limits: PIL's resample (BICUBIC, BILINEAR; up and down between the tools'
sizes) and the as-stored reads exact (PIL 12's output, 0 LSB); J, F, the
statistics, ``evaluate`` and ``summarize`` of the DAVIS evaluator within
1e-12 of ``rcf_tpu.eval.davis`` (integer counts, the same float64
ratios); the SegTrackv2/FBMS59 evaluator equal; CRF post-processing's
native engine equal to JAX's PNGs, its device engine (on the CPU here)
equal except where JAX's mean field leaves q1 within 1e-4 of 0.5.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcf_tpu.eval import crf_pp as jax_crf_pp
from rcf_tpu.eval import davis as jax_davis
from rcf_tpu.eval import stv2_fbms as jax_stv2
from rcf_tpu.ops import crf as jax_crf
from rcf_tpu.ops import resize_bilinear as jax_resize
from rcf_tpu_torch.data import pil_resize
from rcf_tpu_torch.data.image_io import read_image
from rcf_tpu_torch.eval import crf_pp, davis, stv2_fbms

SIZES = [(64, 64), (427, 240), (854, 480), (856, 480), (1280, 720)]  # (W, H)


def _test_image(w: int, h: int, channels: int = 1) -> np.ndarray:
    """Smooth gradients, a hard-edged bright block and noise: every tap sign."""
    rng = np.random.default_rng(w * 7 + h)
    y, x = np.mgrid[0:h, 0:w]
    base = 110 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0)
    base[h // 4: h // 2, w // 3: w // 2] = 250
    base[: h // 8] = 3
    img = base[..., None] + rng.normal(0, 25, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("src", SIZES)
@pytest.mark.parametrize("filt", [pil_resize.BICUBIC, pil_resize.BILINEAR])
def test_pil_resize_is_exact(src, filt):
    img = _test_image(*src)
    pil_filter = Image.BICUBIC if filt == pil_resize.BICUBIC else Image.BILINEAR
    for dst in SIZES + [(107, 60), (192, 96)]:
        ref = np.asarray(Image.fromarray(img).resize(dst, pil_filter))
        np.testing.assert_array_equal(pil_resize.resize(img, dst, filt), ref,
                                      err_msg=f"{src} -> {dst} {filt}")


def test_pil_resize_default_rgb_and_equal_size():
    """PIL's default filter for ``L`` is bicubic; RGB bands resample alike; an
    equal size returns a copy."""
    img = _test_image(192, 96)
    np.testing.assert_array_equal(pil_resize.resize(img, (854, 480)),
                                  np.asarray(Image.fromarray(img).resize((854, 480))))
    rgb = _test_image(107, 60, 3)
    np.testing.assert_array_equal(pil_resize.resize(rgb, (854, 480)),
                                  np.asarray(Image.fromarray(rgb).resize((854, 480))))
    same = pil_resize.resize(img, (192, 96))
    np.testing.assert_array_equal(same, img)
    assert not np.shares_memory(same, img)


def _palette_png(path, arr: np.ndarray, bits: int = 8):
    im = Image.fromarray(arr, "P")
    im.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] + [0] * 756)
    im.save(path, bits=bits)


@pytest.mark.parametrize("kind", ["palette", "palette4", "gray", "rgb", "rgba", "bool", "jpeg"])
def test_read_as_stored_equals_pil(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = tmp_path / (f"{kind}.jpg" if kind == "jpeg" else f"{kind}.png")
    if kind.startswith("palette"):
        _palette_png(path, rng.integers(0, 4, (37, 53), dtype=np.uint8),
                     bits=4 if kind == "palette4" else 8)
    elif kind == "gray":
        Image.fromarray(rng.integers(0, 256, (37, 53), dtype=np.uint8)).save(path)
    elif kind in ("rgb", "rgba", "jpeg"):
        c = 4 if kind == "rgba" else 3
        Image.fromarray(rng.integers(0, 256, (37, 53, c), dtype=np.uint8)).save(path)
    else:
        Image.fromarray(rng.random((37, 53)) > 0.5).save(path)
    ref = np.array(Image.open(path))
    ours = read_image(str(path), None)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# DAVIS
# ---------------------------------------------------------------------------


def _blob(rng, h, w, shift=0):
    m = np.zeros((h, w), bool)
    y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
    m[y0 + shift: y0 + h // 3 + shift, x0: x0 + w // 3] = True
    m ^= rng.random((h, w)) < 0.01  # ragged boundaries
    return m


@pytest.mark.parametrize("case", ["random", "empty_fg", "empty_gt", "both_empty", "equal"])
def test_jaccard_and_boundary_f_equal_jax(case):
    """One 480x854 frame: the disk's radius comes from its diagonal (8)."""
    rng = np.random.default_rng(7)
    h, w = 480, 854
    gt, fg = _blob(rng, h, w), _blob(rng, h, w, shift=9)
    if case in ("empty_fg", "both_empty"):
        fg[:] = False
    if case in ("empty_gt", "both_empty"):
        gt[:] = False
    if case == "equal":
        fg = gt.copy()
    assert math.ceil(0.008 * np.linalg.norm((h, w))) == 8
    ours = davis.boundary_f_measure(fg, gt, device="cpu")
    assert ours == pytest.approx(jax_davis.boundary_f_measure(fg, gt), abs=1e-12)
    np.testing.assert_allclose(davis.jaccard(gt, fg, device="cpu"), jax_davis.jaccard(gt, fg),
                               atol=1e-12, rtol=0)


def test_jaccard_and_boundary_f_batched_equal_jax():
    rng = np.random.default_rng(8)
    gts = np.stack([_blob(rng, 60, 107) for _ in range(5)])
    fgs = np.stack([_blob(rng, 60, 107, shift=2) for _ in range(5)])
    np.testing.assert_allclose(davis.jaccard(gts, fgs, device="cpu"),
                               jax_davis.jaccard(gts, fgs), atol=1e-12, rtol=0)
    ref = [jax_davis.boundary_f_measure(f, g) for f, g in zip(fgs, gts)]
    np.testing.assert_allclose(davis.boundary_f_frames(fgs, gts, device="cpu"), ref,
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("n", [1, 3, 20, 60, 300])
def test_db_statistics_equal_jax(n):
    vals = np.random.default_rng(n).random(n)
    vals[:: 7] = np.nan
    assert davis.db_statistics(vals) == pytest.approx(jax_davis.db_statistics(vals), abs=1e-12,
                                                      nan_ok=True)


def _mini_davis(tmp_path, gray_annotations: bool):
    """DAVIS layout at 480x854: four sequences of 3 frames, one with two
    objects and one with none; annotations as palette indices (or 0/255 L
    PNGs), predictions at 2x the 96^2 mask size, some shifted."""
    rng = np.random.default_rng(0)
    root, results = tmp_path / "davis", tmp_path / "results"
    results.mkdir()
    lines = []
    for seq, shift, two in (("boxy", 0, False), ("shifty", 30, False), ("pair", 12, True),
                            ("blank", 0, False)):
        (root / "Annotations/480p" / seq).mkdir(parents=True)
        frames = []
        for t in range(3):
            ann = np.zeros((480, 854), np.uint8)
            if seq != "blank":
                ann[100 + 10 * t: 300 + 10 * t, 200: 500] = 1
            if two:
                ann[320:420, 600 + 5 * t: 760] = 2
            path = root / "Annotations/480p" / seq / f"{t:05d}.png"
            if gray_annotations:
                Image.fromarray((ann > 0).astype(np.uint8) * 255).save(path)
            else:
                _palette_png(path, ann)
            pred = np.zeros((480, 854), np.float32)
            pred[100 + 10 * t + shift: 300 + 10 * t + shift, 200 + shift: 500 + shift] = 1
            pred = np.clip(pred + rng.normal(0, 0.2, pred.shape), 0, 1)
            small = np.asarray(Image.fromarray((pred * 255).astype(np.uint8)).resize((192, 192)))
            Image.fromarray(small).save(results / f"pred_seg_{seq}_{t:05d}_0000000.png")
            frames.append(f"{t:05d}.jpg")
        lines.append(f"JPEGImages/480p/{seq}/ " + " ".join(frames))
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    return root, results


@pytest.fixture()
def mini_davis(tmp_path):
    return _mini_davis(tmp_path, gray_annotations=False)


def _assert_tree_close(ours, ref, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for k in ref:
            _assert_tree_close(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_tree_close(a, b, f"{path}[{i}]")
    else:
        assert ours == pytest.approx(ref, abs=1e-12, nan_ok=True), path


@pytest.mark.parametrize("year,gray", [("2016", True), ("2016", False), ("2017", False)])
def test_davis_evaluate_and_summarize_equal_jax(tmp_path, year, gray):
    root, results = _mini_davis(tmp_path, gray)
    ours = davis.evaluate(str(root), str(results), "val", year, 0, device="cpu")
    ref = jax_davis.evaluate(str(root), str(results), "val", year, 0)
    _assert_tree_close(ours, ref)
    _assert_tree_close(davis.summarize(ours), jax_davis.summarize(ref))
    seq, frames = "shifty", ["00000", "00001", "00002"]
    np.testing.assert_array_equal(davis.read_result_masks(str(results), seq, frames, 0),
                                  jax_davis.read_result_masks(str(results), seq, frames, 0))
    np.testing.assert_array_equal(davis.read_gt_masks(str(root), "pair", frames, True),
                                  jax_davis.read_gt_masks(str(root), "pair", frames, True))


def test_davis_main_writes_the_csv(mini_davis, capsys):
    root, results = mini_davis
    assert davis.main(["--davis_path", str(root), "--results_path", str(results)],
                      device="cpu") == 0
    ours_out = capsys.readouterr().out
    assert jax_davis.main(["--davis_path", str(root), "--results_path", str(results)]) == 0
    assert capsys.readouterr().out == ours_out
    assert (results / "global_results-val.csv").read_text().splitlines()[0].startswith("J&F-Mean")


# ---------------------------------------------------------------------------
# SegTrackv2 / FBMS59
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["SegTrackv2", "FBMS59"])
def test_stv2_fbms_evaluate_equals_jax(tmp_path, dataset):
    """Annotations at 259x327 (not the export's size), one all-empty frame (NaN),
    FBMS59 with a frame without GT (skipped)."""
    rng = np.random.default_rng(1)
    root, pred_dir = tmp_path / "data", tmp_path / "pred"
    pred_dir.mkdir()
    use_png = dataset == "FBMS59"
    lines = []
    for seq in ("alpha", "beta"):
        (root / "Annotations" / seq).mkdir(parents=True)
        names = []
        for t in range(4):
            name = f"{seq}_{t:03d}.jpg"
            names.append(name)
            ann = np.zeros((259, 327), np.uint8)
            if not (seq == "beta" and t == 1):
                ann[50 + 9 * t: 180, 60: 200 + 5 * t] = 255
            gt_name = name.replace(".jpg", ".png") if use_png else name
            if not (use_png and t == 2):
                Image.fromarray(ann).save(root / "Annotations" / seq / gt_name, quality=95)
            pred = np.zeros((259, 327), np.float32)
            if not (seq == "beta" and t == 1):
                pred[55 + 9 * t: 190, 50: 210] = 0.9
            pred = np.clip(pred + rng.normal(0, 0.15, pred.shape), 0, 1)
            small = Image.fromarray((pred * 255).astype(np.uint8)).resize((192, 192))
            small.save(pred_dir / f"pred_seg_{seq}_{t:05d}_0000000.png")
        lines.append(f"JPEGImages/{seq}/ " + " ".join(names))
    split = "val_all.txt" if use_png else "trainval.txt"
    (root / split).write_text("\n".join(lines) + "\n")
    ours = stv2_fbms.evaluate(dataset, str(pred_dir), str(root))
    ref = jax_stv2.evaluate(dataset, str(pred_dir), str(root))
    _assert_tree_close(ours, ref)
    assert ours["num_frames"] == (6 if use_png else 8)


# ---------------------------------------------------------------------------
# CRF post-processing
# ---------------------------------------------------------------------------


def _crf_set(tmp_path, h=32, w=40, n=3):
    """A sequence of n frames (two colour regions) and their exported masks at 96^2."""
    rng = np.random.default_rng(4)
    images, ann = tmp_path / "JPEGImages" / "seq0", tmp_path / "export" / "0"
    images.mkdir(parents=True)
    ann.mkdir(parents=True)
    for t in range(n):
        img = np.zeros((h, w, 3), np.float32)
        img[:, : w // 2 + t] = (200, 40, 30)
        img[:, w // 2 + t:] = (30, 60, 190)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(images / f"{t:05d}.jpg", quality=95)
        m = np.where(np.arange(96)[None, :] < 50, 170, 40) + rng.normal(0, 40, (96, 96))
        Image.fromarray(np.clip(m, 0, 255).astype(np.uint8)).save(
            ann / f"pred_seg_seq0_{t:05d}_0000000.png")
    return str(tmp_path / "JPEGImages"), str(ann)


def _read_dir(d: str) -> dict:
    import os

    return {n: np.array(Image.open(os.path.join(d, n))) for n in sorted(os.listdir(d))}


def test_crf_pp_native_equals_jax(tmp_path):
    images, ann = _crf_set(tmp_path)
    out = crf_pp.run(images, ann, engine="native", jobs=2)
    ours = _read_dir(out)
    import shutil

    shutil.rmtree(out)
    assert jax_crf_pp.run(images, ann, engine="native", jobs=2) == out
    ref = _read_dir(out)
    assert len(ours) == 3 and ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _jax_q1(img_u8, mask01, crf_scale, iters, resolution):
    """JAX's device-engine mean field before the threshold, on its run grid."""
    h, w = mask01.shape
    xy_scale = (1.0, 1.0)
    img, mask = jnp.asarray(img_u8), jnp.asarray(mask01)
    if resolution is not None:
        img = jnp.clip(jax_resize(img.astype(jnp.float32)[None], resolution)[0], 0, 255)
        img = img.astype(jnp.uint8)
        mask = jax_resize(mask[None, ..., None], resolution)[0, ..., 0]
        xy_scale = (resolution[1] / w, resolution[0] / h)
    params = jax_crf.CRFParams(crf_scale=crf_scale, refine_iters=iters)
    hr, wr = mask.shape

    @jax.jit
    def run(img, mask):
        unary = jax_crf.mask_to_unary(mask, params.crf_scale).reshape(hr * wr, 2)
        feat = jax_crf._pixel_features(img, params.sxy, params.srgb, xy_scale)
        du = unary[:, 0] - unary[:, 1]

        def one(_, q1):
            filt = jax_crf._normalized_filter(feat, q1[:, None], 1024)[:, 0]
            return jax.nn.sigmoid(du + params.scomp * (2.0 * filt - 1.0))

        return jax.lax.fori_loop(0, iters, one, jax.nn.sigmoid(du))

    return np.asarray(run(img, mask)).reshape(hr, wr)


@pytest.mark.parametrize("resolution", [None, (16, 20)])
def test_crf_pp_device_engine_matches_jax(tmp_path, resolution):
    """The device engine on the CPU (the plain filter), batched 2 + 1 frames."""
    images, ann = _crf_set(tmp_path)
    out = crf_pp.run(images, ann, engine="device", batch=2, resolution=resolution, iters=20,
                     device="cpu")
    ours = _read_dir(out)
    import shutil

    shutil.rmtree(out)
    jax_crf_pp.run(images, ann, engine="device", batch=2, resolution=resolution, iters=20)
    ref = _read_dir(out)
    assert len(ours) == 3 and ours.keys() == ref.keys()
    for k, (img_path, ann_path) in zip(sorted(ref), [
            (f"{images}/seq0/{t:05d}.jpg", f"{ann}/pred_seg_seq0_{t:05d}_0000000.png")
            for t in range(3)]):
        img, mask01 = jax_crf_pp._load_pair(img_path, ann_path)
        near = np.abs(_jax_q1(img, mask01, 0.8, 20, resolution) - 0.5) < 1e-4
        if resolution is not None:  # every output pixel whose bilinear taps touch one
            near = np.asarray(jax_resize(jnp.asarray(near, jnp.float32)[None, ..., None],
                                         mask01.shape))[0, ..., 0] > 0
        np.testing.assert_array_equal(ours[k][~near], ref[k][~near], err_msg=k)
        assert 0 < (ours[k] > 127).mean() < 1


def test_crf_pp_load_pair_equals_jax(tmp_path):
    images, ann = _crf_set(tmp_path, n=1)
    img_path, ann_path = f"{images}/seq0/00000.jpg", f"{ann}/pred_seg_seq0_00000_0000000.png"
    for a, b in zip(crf_pp._load_pair(img_path, ann_path),
                    jax_crf_pp._load_pair(img_path, ann_path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_device_engine_needs_a_card_unless_given_cpu(tmp_path, monkeypatch):
    images, ann = _crf_set(tmp_path, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        crf_pp.run(images, ann, engine="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        davis.jaccard(np.zeros((2, 2), bool), np.zeros((2, 2), bool))
