"""The port's stage-2 grouping (DINO ViT, soft NCut, DINO features, the native
CRF bridge, semantic constraints, MAA) against the JAX package's, on the CPU.

Limits: the tiny ViT's tokens and last-layer keys within 1e-4 absolute in
both directions of the weight conversion; ``_cubic_matrix`` and the
thresholded affinity equal (on features whose products all lie at least
1e-5 from tau); the NCut value within 1e-5 relative; ``ncut_refine``
within 1e-4; DINO features within 1e-5 (colour) and 1e-4 (ViT); the
native lattice bit for bit (one source, one compiler and flags); the
pseudo-labels and MAA's exit code equal, its values within 1e-5; the
attention engine's MAP equal except where JAX's q1 lies within 1e-4 of 0.5.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcf_tpu.grouping import maa as jax_maa
from rcf_tpu.grouping import ncut as jax_ncut
from rcf_tpu.grouping import semantic_constraints as jax_sc
from rcf_tpu.grouping.pipeline import DinoFeatures as JaxDinoFeatures
from rcf_tpu.nn import dino_vit as jax_vit
from rcf_tpu.ops import crf as jax_crf
from rcf_tpu.ops import crf_native as jax_native
from rcf_tpu.ops import resize_bilinear as jax_resize
from rcf_tpu_torch.convert import dino_state_from_jax
from rcf_tpu_torch.grouping import maa, ncut, semantic_constraints
from rcf_tpu_torch.grouping.pipeline import DinoFeatures
from rcf_tpu_torch.nn import dino_vit
from rcf_tpu_torch.ops import crf_native
from torch_parity import init_variables

TAU = 0.2


def _tiny_vit_pair():
    jm = jax_vit.DinoViT(patch_size=8, embed_dim=64, depth=2, num_heads=2, train_grid=4)
    return jm, dino_vit.DinoViT(patch_size=8, embed_dim=64, depth=2, num_heads=2, train_grid=4)


def _imgs(seed=0, b=2, h=48, w=40):
    return np.random.default_rng(seed).standard_normal((b, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("last_k", [False, True])
def test_tiny_vit_matches_jax_with_jax_weights(last_k):
    """JAX weights -> ``dino_state_from_jax`` -> the port; the 48x40 input puts
    the 4x4 position grid through the bicubic interpolation (6x5)."""
    jm, m = _tiny_vit_pair()
    x = _imgs()
    variables = init_variables(jm, jnp.asarray(x))
    m.load_state_dict(dino_state_from_jax(variables["params"], depth=2))  # strict
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), return_last_k=last_k))
    with torch.no_grad():
        ours = m(torch.from_numpy(x), return_last_k=last_k).numpy()
    assert ours.shape == ref.shape == (2, 31, 64)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("last_k", [False, True])
def test_jax_reads_the_port_state_dict(last_k):
    """The port's state dict (DINO keys) -> JAX's own ``import_dino_torch``."""
    jm, m = _tiny_vit_pair()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.2)
    x = _imgs(1)
    params = jax_vit.import_dino_torch(m.state_dict(), depth=2)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), return_last_k=last_k))
    with torch.no_grad():
        ours = m(torch.from_numpy(x), return_last_k=last_k).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,out", [(4, 6), (4, 5), (14, 10), (14, 27), (28, 60), (28, 107)])
def test_cubic_matrix_equals_jax(n, out):
    scale = (out + 0.1) / n
    mat = dino_vit._cubic_matrix(n, scale)
    np.testing.assert_array_equal(mat, jax_vit._cubic_matrix(n, scale))
    assert mat.shape == (out, n)


def _official_keys(depth: int, prefix: str = "") -> list:
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight", "patch_embed.proj.bias",
            "norm.weight", "norm.bias"]
    for i in range(depth):
        keys += [f"blocks.{i}.{k}" for k in (
            "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.qkv.weight",
            "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias", "mlp.fc1.weight",
            "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")]
    return [prefix + k for k in keys]


@pytest.mark.parametrize("arch", ["moco_vit_small", "mae_vit_base"])
def test_checkpoint_stripping_keeps_jax_keys(arch, monkeypatch):
    """MoCo-v3 keeps ``module.base_encoder.*`` minus the head, MAE drops the
    decoder and mask token: the same keys and values reach JAX's importer."""
    prefix = "module.base_encoder." if arch.startswith("moco") else ""
    sd = {k: torch.full((1,), float(i)) for i, k in enumerate(_official_keys(2, prefix))}
    if arch.startswith("moco"):
        sd.update({prefix + "head.weight": torch.zeros(1), "module.momentum_encoder.x": torch.zeros(1)})
        ckpt = {"state_dict": sd, "epoch": 3}
    else:
        sd.update({"decoder_embed.weight": torch.zeros(1), "mask_token": torch.zeros(1)})
        ckpt = {"model": sd}
    seen = {}
    monkeypatch.setattr(jax_vit, "import_dino_torch", lambda d, depth=12: seen.update(d))
    jax_vit._DINO_ARCHS[arch][1](ckpt, depth=2)
    ours = dino_vit._DINO_ARCHS[arch][1](ckpt)
    assert set(ours) == set(seen) == set(_official_keys(2))
    assert all(ours[k] is seen[k] for k in ours)


@pytest.fixture(scope="module")
def vit_small_ckpt(tmp_path_factory):
    """A seeded random ViT-S/8 saved in the official DINO layout (plus a head
    key that loading ignores)."""
    torch.manual_seed(0)
    sd = dino_vit.vit_small(patch_size=8).state_dict()
    sd = {k: v.normal_(0.0, 0.05) if k != "pos_embed" else v for k, v in sd.items()}
    sd["head.weight"] = torch.zeros(3)
    path = tmp_path_factory.mktemp("dino") / "dino_vits8_random.pth"
    torch.save(sd, path)
    return str(path)


def test_get_dino_model_loads_what_jax_loads(vit_small_ckpt):
    model, sd = dino_vit.get_dino_model("vit_small", 8, vit_small_ckpt, device="cpu")
    jmodel, params = jax_vit.get_dino_model("vit_small", 8, vit_small_ckpt)
    ref = dino_state_from_jax(params, depth=12)
    assert set(sd) == set(ref) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    assert (model.train_grid, jmodel.train_grid, model.depth) == (28, 28, 12)
    with pytest.warns(UserWarning, match="random weights"):
        _, none = dino_vit.get_dino_model("vit_small", 8, None, device="cpu")
    assert none is None


def _margin_feats(seed: int, n: int = 65, d: int = 16) -> np.ndarray:
    feats = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    f = feats[1:].astype(np.float64)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    assert np.abs(f @ f.T - TAU).min() >= 1e-5  # no product near the threshold
    return feats


@pytest.mark.parametrize("seed", [0, 2])
def test_ncut_matches_jax(seed):
    feats = _margin_feats(seed)
    mask = np.random.default_rng(10 + seed).random((8, 8)).astype(np.float32)
    tf, tm = torch.from_numpy(feats), torch.from_numpy(mask)
    np.testing.assert_array_equal(ncut.build_affinity(tf).numpy(),
                                  np.asarray(jax_ncut.build_affinity(jnp.asarray(feats))))
    ref = float(jax_ncut.soft_ncut_value(jnp.asarray(feats), jnp.asarray(mask)))
    assert float(ncut.soft_ncut_value(tf, tm)) == pytest.approx(ref, rel=1e-5)
    refined = ncut.ncut_refine(tf, tm).numpy()
    np.testing.assert_allclose(refined, np.asarray(jax_ncut.ncut_refine(jnp.asarray(feats),
                                                                         jnp.asarray(mask))),
                               atol=1e-4, rtol=0)
    assert refined.min() >= 0 and refined.max() <= 1


def _frame(seed: int, h: int = 48, w: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Two colour regions with noise, and a noisy soft mask of the left one."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2, 0] = 0.8
    img[:, w // 2:, 2] = 0.7
    img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    mask = np.clip(np.where(np.arange(w)[None, :] < w // 2 + 3, 0.75, 0.1)
                   + rng.normal(0, 0.15, (h, w)), 0, 1).astype(np.float32)
    return img, mask


@pytest.mark.parametrize("ckpt", [False, True])
def test_dino_features_match_jax(ckpt, vit_small_ckpt):
    """The colour path (no checkpoint) and the ViT-S/8 path, at a 64x64 resize."""
    path = vit_small_ckpt if ckpt else "/nonexistent"
    ours = DinoFeatures(checkpoint=path, resize_imgs_size=(64, 64), device="cpu")
    ref = JaxDinoFeatures(checkpoint=path, resize_imgs_size=(64, 64))
    img, mask = _frame(0)
    np.testing.assert_allclose(ours(img[None]).numpy(), np.asarray(ref(img[None])),
                               atol=1e-4 if ckpt else 1e-5, rtol=0)
    np.testing.assert_array_equal(ours.mask_to_grid(mask).numpy(),
                                  np.asarray(ref.mask_to_grid(mask)))
    assert ours.grid_hw == ref.grid_hw == (8, 8)


@pytest.mark.parametrize("crf_scale", [0.5, 0.7, 0.8])
def test_native_crf_is_bitwise_jax(crf_scale):
    img, mask = _frame(1)
    rgb = (img * 255).astype(np.uint8)
    ours = crf_native.crf_soft_native(rgb, mask, crf_scale=crf_scale)
    np.testing.assert_array_equal(ours, jax_native.crf_soft_native(rgb, mask, crf_scale=crf_scale))
    assert 0 < ours.mean() < 1


def _jax_q1(rgb_u8: np.ndarray, mask: np.ndarray, params) -> np.ndarray:
    """JAX's mean field before the threshold (``crf_soft_single``'s loop)."""
    h, w = mask.shape

    @jax.jit
    def run(rgb, mask):
        unary = jax_crf.mask_to_unary(mask, params.crf_scale).reshape(h * w, 2)
        feat = jax_crf._pixel_features(rgb, params.sxy, params.srgb)
        du = unary[:, 0] - unary[:, 1]

        def one(_, q1):
            filt = jax_crf._normalized_filter(feat, q1[:, None], 1024)[:, 0]
            return jax.nn.sigmoid(du + params.scomp * (2.0 * filt - 1.0))

        return jax.lax.fori_loop(0, params.refine_iters, one, jax.nn.sigmoid(du))

    return np.asarray(run(jnp.asarray(rgb_u8), jnp.asarray(mask))).reshape(h, w)


@pytest.mark.parametrize("engine", ["native", "attention"])
def test_refine_frame_matches_jax(engine):
    """CRF -> NCut -> CRF -> merge on a 48x64 frame, colour features at 64x64."""
    img, mask = _frame(2, 40, 48)
    ours = semantic_constraints.refine_frame(
        DinoFeatures(resize_imgs_size=(64, 64), device="cpu"), img, mask, None, crf_engine=engine)
    jdino = JaxDinoFeatures(checkpoint="/nonexistent", resize_imgs_size=(64, 64))
    ref = jax_sc.refine_frame(jdino, img, mask, None, crf_engine=engine)
    assert 0 < ours.mean() < 1
    if engine == "native":
        np.testing.assert_array_equal(ours, ref)
        return
    # Where JAX's q1 of either pass lies within 1e-4 of 0.5, a last-ulp
    # difference of the filter may flip the MAP.
    rgb = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    grid = jax_ncut.ncut_refine(jdino(img[None])[0], jdino.mask_to_grid(mask))
    second = np.asarray(jax_resize(grid[None, ..., None], mask.shape))[0, ..., 0]
    near = np.zeros(mask.shape, bool)
    for m, scale in ((mask, 0.7), (second, 0.5)):
        near |= np.abs(_jax_q1(rgb, m, jax_crf.CRFParams(crf_scale=scale)) - 0.5) < 1e-4
    np.testing.assert_array_equal(ours[~near], ref[~near])


def _grouping_set(tmp_path, seqs=("seqa", "seqb"), frames=2, h=48, w=64):
    """data/data_davis/JPEGImages/480p/<seq>/*.jpg (PIL, quality 95) and each
    frame's exported masks for 4 channels (L PNGs at 96x96) under
    <pretrain>/<export>/<channel>/."""
    images = tmp_path / "data" / "data_davis" / "JPEGImages" / "480p"
    pretrain = tmp_path / "pretrain"
    rng = np.random.default_rng(5)
    for s, seq in enumerate(seqs):
        (images / seq).mkdir(parents=True)
        for t in range(frames):
            img, _ = _frame(10 * s + t, h, w)
            Image.fromarray((img * 255).astype(np.uint8)).save(images / seq / f"{t:05d}.jpg",
                                                                quality=95)
            for export in ("saved_eval_export", "saved_eval_export_trainval_ema"):
                for ch in range(4):
                    d = pretrain / export / str(ch)
                    d.mkdir(parents=True, exist_ok=True)
                    left = np.arange(96)[None, :] < 48 + 8 * ch
                    m = np.where(left if ch % 2 == 0 else left.T, 200, 30) + rng.normal(0, 20, (96, 96))
                    Image.fromarray(np.clip(m, 0, 255).astype(np.uint8)).save(
                        d / f"pred_seg_{seq}_{t:05d}_0000000.png")
    return tmp_path / "data", pretrain


def test_maa_elects_as_jax(tmp_path):
    data, pretrain = _grouping_set(tmp_path)
    argv = ["--pretrain_dir", str(pretrain), "--dataset", "davis", "--data-dir", str(data),
            "--seqs", "seqa,seqb", "--first-frames-only"]
    elected = maa.main(argv, device="cpu")
    assert elected == jax_maa.main(argv)
    images = str(data / "data_davis" / "JPEGImages" / "480p")
    pred = str(pretrain / "saved_eval_export")
    dino = DinoFeatures(device="cpu")
    jdino = JaxDinoFeatures(checkpoint="/nonexistent")
    values = []
    for ch in range(4):
        ours = maa.maa_for_channel(dino, images, pred, ch, ["seqa", "seqb"], 0, False)
        ref = jax_maa.maa_for_channel(jdino, images, pred, ch, ["seqa", "seqb"], 0, False)
        assert ours == pytest.approx(ref, abs=1e-5)
        values.append(ours)
    assert len(set(values)) == 4
    # FBMS59: frames without an annotation are left out (only seqa/00001 has one).
    gt_dir = tmp_path / "gt"
    (gt_dir / "seqa").mkdir(parents=True)
    Image.fromarray(np.zeros((48, 64), np.uint8)).save(gt_dir / "seqa" / "00001.png")
    ours = maa.maa_for_channel(dino, images, pred, 2, ["seqa", "seqb"], 0, False, str(gt_dir))
    assert ours == pytest.approx(jax_maa.maa_for_channel(
        jdino, images, pred, 2, ["seqa", "seqb"], 0, False, str(gt_dir)), abs=1e-5)
    feats = dino(maa.load_image(images, "seqa", "00001")[None])[0]
    grid = dino.mask_to_grid(maa.load_pred_mask(pred, 2, "seqa", "00001", 0))
    assert ours == -float(ncut.soft_ncut_value(feats, grid))
    np.testing.assert_array_equal(
        maa.load_pred_mask(pred, 1, "seqa", "00001", 0),
        jax_maa.load_pred_mask(pred, 1, "seqa", "00001", 0))


def test_semantic_constraints_writes_jax_pseudo_labels(tmp_path):
    data, pretrain = _grouping_set(tmp_path)
    argv = ["--pretrain_dir", str(pretrain), "--object-channel", "2", "--dataset", "davis",
            "--data-dir", str(data), "--crf-engine", "native"]
    assert semantic_constraints.main(argv, device="cpu") == 0
    out = pretrain / ("saved_eval_export_trainval_ema" + semantic_constraints.SAVE_SUFFIX) / "2"
    ours = {p.name: np.array(Image.open(p)) for p in sorted(out.iterdir())}
    assert len(ours) == 4
    os.rename(out, str(out) + "_port")
    assert jax_sc.main(argv) == 0
    for name, arr in ours.items():
        np.testing.assert_array_equal(arr, np.array(Image.open(out / name)), err_msg=name)
    with pytest.raises(FileExistsError, match="refusing to overwrite"):
        semantic_constraints.main(argv, device="cpu")


def test_auto_engine_raises_when_the_build_fails(tmp_path, monkeypatch):
    """``auto`` is the native lattice; a compiler that fails raises, and the
    attention engine is never taken in its place."""
    monkeypatch.setattr(crf_native, "_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building the native CRF"):
        semantic_constraints.resolve_crf_engine("auto")
    data, pretrain = _grouping_set(tmp_path, seqs=("seqa",), frames=1)
    with pytest.raises(RuntimeError, match="building the native CRF"):
        semantic_constraints.main(["--pretrain_dir", str(pretrain), "--object-channel", "0",
                                   "--data-dir", str(data)], device="cpu")
    img, mask = _frame(3, 16, 24)
    with pytest.raises(RuntimeError, match="building the native CRF"):
        semantic_constraints.refine_frame(DinoFeatures(resize_imgs_size=(16, 24), device="cpu"),
                                          img, mask, None, crf_engine="auto")
    assert semantic_constraints.resolve_crf_engine("attention") == "attention"
