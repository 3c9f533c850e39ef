"""The port's dense CRF (``rcf_tpu_torch/ops/crf.py``, ``crf_kernels.py``)
against the JAX package's (``rcf_tpu/ops/crf.py``), on the CPU.

Inputs are made with numpy from a seed and go through both packages: the
uint8 quantizations (frames, the unary's levels, in f32 and bf16), the
features, the filter's plain version against ``_normalized_filter`` at a
ragged N, the batched mean field against ``crf_soft_single`` under
``vmap`` (q1 before the threshold, the MAP, each image's iterations, with
``stable_exit`` on and off), ``make_crf_fn`` on a reduced grid, and the
dense numpy golden of ``tests/test_crf.py`` (copied here); a model of the
kernel's split-TF32 operands against float64 logits, and a float64 model of
its tile-pair schedule against the plain filter. The kernel itself runs
only on the card: ``test_torch_crf_card.py``.
"""

from __future__ import annotations

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.ops import crf as jcrf
from rcf_tpu_torch.ops import crf as tcrf
from rcf_tpu_torch.ops import crf_kernels as ck

import kernel_sets as ks

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# f32 values computed in the same order on both sides (the unary, the
# features): relative error. Measured: the features equal, the unary within
# one ulp (the two frameworks' logs).
REL_F32 = 1e-6
# The filter at the recipes' feature scales (srgb 5: half-norms ~1e3): each
# logit cancels terms of ~1e3, so it carries ~1e-4 of f32 rounding, which
# XLA's dot and the port's per-dimension products round differently; the
# filtered values lie in [0, 1]. Measured 4.4e-5 (D = 5) and 2.4e-7 (D = 2);
# each side is as far from a float64 filter (3.1e-5 and 2.4e-5 at D = 5).
FILTER_ATOL = 1e-4
# q1 after the mean field, the port against JAX: the filter's difference
# above, through the iterations of a contraction. Measured <= 1.4e-5.
Q1_ATOL = 1e-4


def soft_masks(frames: np.ndarray, seed: int = 0, noise: float = 0.25) -> np.ndarray:
    """Soft masks [b, h, w] f32 near the disc of ``synthetic_frames``: its
    colour distance to the background, plus noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    f = frames.astype(np.float32)
    d = np.abs(f - f[:, :1, :1]).sum(-1)
    m = 0.7 * (d > 30) + rng.normal(0, noise, d.shape)
    return np.clip(m, 0, 1).astype(np.float32)


def normalize(frames: np.ndarray) -> np.ndarray:
    return ((frames.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unnormalize_to_uint8_matches_jax(dtype):
    """Normalized frames (exact levels, levels +-0.5 and N(0, 1) values that
    clip) back to uint8: equal levels; uint8 passes through."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    half_level = 0.5 / 255.0 / IMAGENET_STD
    near = normalize(frames) + rng.choice([-1.0, 0.0, 1.0], frames.shape) * half_level
    wild = rng.standard_normal((2, 16, 16, 3)).astype(np.float32) * 3.0
    for x in (normalize(frames), near.astype(np.float32), wild):
        ref = np.asarray(jcrf.unnormalize_to_uint8(jnp.asarray(x).astype(dtype)))
        ours = tcrf.unnormalize_to_uint8(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert ours.dtype == torch.uint8
        np.testing.assert_array_equal(ours.numpy(), ref)
    u8 = torch.from_numpy(frames)
    assert tcrf.unnormalize_to_uint8(u8) is u8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_to_unary_matches_jax(dtype):
    """The unary's uint8 levels equal (the scale 255/crf_scale rounded to the
    mask's dtype first, as JAX's weak-typed constant; in bf16 the product
    rounds in bf16) and the energies within REL_F32; masks at the levels'
    edges (k * crf_scale / 255), the documented values and uniform ones."""
    rng = np.random.default_rng(1)
    edges = (np.arange(256) * 0.7 / 255.0).astype(np.float32)
    mask = np.concatenate([edges, edges + 1e-7, [0.0, 0.35, 0.7, 1.0],
                           rng.uniform(0, 1, 252).astype(np.float32)]).reshape(2, 16, 24)
    jm = jnp.asarray(mask).astype(dtype)
    tm = torch.from_numpy(mask).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jm.astype(jnp.float32)), tm.float().numpy())
    ref_levels = np.asarray(jnp.clip(jm * (255.0 / 0.7), 0.0, 255.0).astype(jnp.uint8))
    np.testing.assert_array_equal(tcrf.mask_levels(tm, 0.7).numpy(), ref_levels)
    ref = np.asarray(jcrf.mask_to_unary(jm, crf_scale=0.7))
    ours = tcrf.mask_to_unary(tm, crf_scale=0.7)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=REL_F32, atol=0)


@pytest.mark.parametrize("xy_scale", [(1.0, 1.0), (0.25, 1.0 / 3.0)])
def test_features_match_jax(xy_scale):
    frames = ks.synthetic_frames(2, 12, 9)
    for k in range(2):
        ref = np.asarray(jcrf._pixel_features(jnp.asarray(frames[k]), 60.0, 5.0, xy_scale))
        ours = tcrf.pixel_features(torch.from_numpy(frames), 60.0, 5.0, xy_scale)[k].numpy()
        np.testing.assert_allclose(ours, ref, rtol=REL_F32, atol=0)
    ref = np.asarray(jcrf._xy_features(12, 9, 3.0, xy_scale))
    np.testing.assert_allclose(tcrf.xy_features(12, 9, 3.0, xy_scale).numpy(), ref,
                               rtol=REL_F32, atol=0)


@pytest.mark.parametrize("d", [5, 2])
def test_crf_filter_plain_matches_jax(d):
    """``crf_filter_plain`` against ``_normalized_filter`` at a ragged N (13 x 11
    = 143 pixels, chunk 32: padded keys), and the wrapper on CPU tensors takes
    the plain version and counts no launch."""
    feat, vals = ks.filter_inputs(d)
    f, v = torch.from_numpy(feat), torch.from_numpy(vals)
    ck.reset_launch_counts()
    ours = ck.crf_filter(f, v, chunk=32)
    assert ck.LAUNCHES["crf_filter"] == 0
    assert ck.STATS == {"pairs_evaluated": 0, "pairs_dense": 0}
    np.testing.assert_array_equal(ours.numpy(), ck.crf_filter_plain(f, v, 32).numpy())
    for k in range(feat.shape[0]):
        ref = jcrf._normalized_filter(jnp.asarray(feat[k]), jnp.asarray(vals[k])[:, None], 32)
        ref = np.asarray(ref)[:, 0]
        np.testing.assert_allclose(ours[k].numpy(), ref, rtol=0, atol=FILTER_ATOL)


def test_crf_filter_checks_its_inputs():
    feat = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        ck.crf_filter(feat, torch.zeros(1, 4))  # D = 3 is not compiled
    with pytest.raises(ValueError):
        ck.crf_filter(torch.zeros(1, 4, 5, dtype=torch.float64), torch.zeros(1, 4))
    with pytest.raises(ValueError):
        ck.crf_filter(torch.zeros(1, 4, 5), torch.zeros(1, 5))


def _jax_q1(rgb, mask, params, chunk, xy_scale=(1.0, 1.0)):
    """``crf_soft_single``'s loop from JAX's own pieces, returning q1 before the
    threshold and the iterations (held to ``crf_soft_single`` below)."""
    h, w = mask.shape
    unary = jcrf.mask_to_unary(mask, params.crf_scale).reshape(h * w, 2)
    feat = jcrf._pixel_features(rgb, params.sxy, params.srgb, xy_scale)
    use_smooth = params.scomp_smooth > 0.0 and params.sxy_smooth > 0.0
    sfeat = jcrf._xy_features(h, w, params.sxy_smooth, xy_scale) if use_smooth else None
    du = unary[:, 0] - unary[:, 1]

    def one_iter(q1):
        logit = du + params.scomp * (2.0 * jcrf._normalized_filter(feat, q1[:, None], chunk)[:, 0]
                                     - 1.0)
        if use_smooth:
            logit = logit + params.scomp_smooth * (
                2.0 * jcrf._normalized_filter(sfeat, q1[:, None], chunk)[:, 0] - 1.0)
        return jax.nn.sigmoid(logit)

    def cond(c):
        return jnp.logical_and(c[0] < params.refine_iters, jnp.logical_not(c[2]))

    def body(c):
        new = one_iter(c[1])
        return c[0] + 1, new, jnp.all((new > 0.5) == (c[1] > 0.5))

    q1 = jax.nn.sigmoid(du)
    if params.stable_exit:
        iters, q1, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), q1, jnp.bool_(False)))
    else:
        q1 = jax.lax.fori_loop(0, params.refine_iters, lambda _, q: one_iter(q), q1)
        iters = jnp.int32(params.refine_iters)
    return q1.reshape(h, w), iters


def _mean_field_case(seed=3, b=3, h=12, w=10):
    """Frames and masks where image 0 (a clean two-colour split, its mask on
    one side) converges at once and the others (noisy masks) later."""
    frames = ks.synthetic_frames(b, h, w, seed)
    masks = soft_masks(frames, seed, noise=0.35)
    frames[0, :, : w // 2] = [200, 30, 30]
    frames[0, :, w // 2:] = [30, 30, 200]
    masks[0] = np.where(np.arange(w)[None, :] < w // 2, 0.9, 0.05)
    return frames, masks


@pytest.mark.parametrize("stable_exit,smooth", [(True, False), (False, False), (True, True)])
def test_mean_field_matches_jax_vmap(stable_exit, smooth):
    """The batched mean field against ``crf_soft_single`` under ``vmap``: the MAP,
    each image's iterations (``stable_exit``: one image stops early, frozen at
    its own exit while the batch runs on) and q1 before the threshold (against
    JAX's loop rebuilt from its pieces, whose MAP and iterations equal
    ``crf_soft_single``'s)."""
    frames, masks = _mean_field_case()
    extra = {"scomp_smooth": 3.0, "sxy_smooth": 2.0} if smooth else {}
    params = tcrf.CRFParams(refine_iters=20, stable_exit=stable_exit, sxy=15.0, **extra)
    jparams = jcrf.CRFParams(refine_iters=20, stable_exit=stable_exit, sxy=15.0, **extra)
    xy_scale = (0.5, 0.5)
    jmap, jiters = jax.vmap(lambda im, mk: jcrf.crf_soft_single(
        im, mk, jparams, 32, xy_scale=xy_scale, return_iters=True))(
            jnp.asarray(frames), jnp.asarray(masks))
    jq1, jiters2 = jax.vmap(lambda im, mk: _jax_q1(im, mk, jparams, 32, xy_scale))(
        jnp.asarray(frames), jnp.asarray(masks))
    np.testing.assert_array_equal(np.asarray(jq1 > 0.5).astype(np.float32), np.asarray(jmap))
    np.testing.assert_array_equal(np.asarray(jiters2), np.asarray(jiters))

    tcrf.reset_stats()
    q1, iters = tcrf.mean_field(torch.from_numpy(frames), torch.from_numpy(masks), params,
                                xy_scale, chunk=32)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), rtol=0, atol=Q1_ATOL)
    np.testing.assert_array_equal((q1 > 0.5).float().numpy(), np.asarray(jmap))
    if stable_exit:
        assert iters.min() < iters.max() and int(iters[0]) == int(iters.min())
        # The batch stops at the first flag read after its last image's exit.
        k = tcrf.SYNC_EVERY
        assert tcrf.STATS["iterations"] == -(-int(iters.max()) // k) * k < params.refine_iters
        assert tcrf.STATS["host_syncs"] == tcrf.STATS["iterations"] // k
    else:
        assert (iters == 20).all() and tcrf.STATS == {"iterations": 20, "host_syncs": 0}


def test_frozen_images_do_not_move():
    """stable_exit: an image that has stopped keeps its q1 while the batch runs
    on (the per-image freeze): it equals the image's own run (up to the CPU's
    summation order in a batch, 1e-7), and differs from the image run on to
    the batch's count, which is what a batch-wide freeze would give."""
    frames, masks = _mean_field_case(seed=4)
    params = tcrf.CRFParams(refine_iters=20, stable_exit=True, sxy=15.0)
    q1, iters = tcrf.mean_field(torch.from_numpy(frames), torch.from_numpy(masks), params,
                                chunk=32)
    runs = int(iters.max())
    early = [k for k in range(frames.shape[0]) if int(iters[k]) < runs]
    assert early
    for k in range(frames.shape[0]):
        one = (torch.from_numpy(frames[k:k + 1]), torch.from_numpy(masks[k:k + 1]))
        qk, ik = tcrf.mean_field(*one, params, chunk=32)
        assert int(ik[0]) == int(iters[k])
        np.testing.assert_allclose(qk[0].numpy(), q1[k].numpy(), rtol=0, atol=1e-7)
        if k in early:
            fixed = tcrf.CRFParams(refine_iters=runs, sxy=15.0)
            q_on, _ = tcrf.mean_field(*one, fixed, chunk=32)
            assert (q_on[0] - q1[k]).abs().max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_crf_fn_on_a_reduced_grid_matches_jax(dtype):
    """``make_crf_fn`` with ``resolution`` (24 x 20 frames on a 12 x 10 grid: the
    RGB and masks resized, sxy scaled, the MAP resized back), the masks in the
    recipe's dtype, ``stable_exit`` on: the same output."""
    frames = ks.synthetic_frames(2, 24, 20, seed=5)
    masks = soft_masks(frames, seed=5)
    imgs = normalize(frames)
    kw = {"resolution": (12, 10), "chunk": 32, "refine_iters": 10, "stable_exit": True}
    ref = np.asarray(jcrf.make_crf_fn(**kw)(jnp.asarray(imgs), jnp.asarray(masks).astype(dtype)))
    fn = tcrf.make_crf_fn(**kw)
    ours = fn(torch.from_numpy(imgs), torch.from_numpy(masks).to(getattr(torch, dtype)))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert fn.params.stable_exit and fn.params.refine_iters == 10


def _numpy_crf(rgb_u8, mask, params):
    """Direct dense NxN mean field mirroring the CUDA semantics exactly
    (``tests/test_crf.py``'s golden, copied)."""
    h, w = mask.shape
    n = h * w
    u8 = np.clip(mask * 255.0 / params.crf_scale, 0, 255).astype(np.uint8).astype(np.float64)
    u = u8 / (u8.max() + 1e-8)
    u = np.clip(u, 1e-6, 1 - 1e-6)
    unary = np.stack([-np.log(1 - u), -np.log(u)], -1).reshape(n, 2)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    feat = np.concatenate(
        [xs.reshape(-1, 1) / params.sxy, ys.reshape(-1, 1) / params.sxy,
         rgb_u8.reshape(-1, 3).astype(np.float64) / params.srgb], -1)
    d2 = ((feat[:, None, :] - feat[None, :, :]) ** 2).sum(-1)
    k = np.exp(-d2 / 2)
    k = k / k.sum(-1, keepdims=True)
    q = np.exp(-unary)
    q = q / q.sum(-1, keepdims=True)
    for _ in range(params.refine_iters):
        msg = params.scomp * (k @ q)
        e = -unary + msg
        e = e - e.max(-1, keepdims=True)
        q = np.exp(e)
        q = q / q.sum(-1, keepdims=True)
    return (q[:, 1] > q[:, 0]).astype(np.float32).reshape(h, w)


def test_crf_matches_dense_numpy_golden():
    rng = np.random.default_rng(0)
    h, w = 12, 10
    rgb = rng.integers(0, 255, (h, w, 3), np.uint8)
    mask = rng.random((h, w)).astype(np.float32)
    params = tcrf.CRFParams(refine_iters=10)
    q1, _ = tcrf.mean_field(torch.from_numpy(rgb[None]), torch.from_numpy(mask[None]), params,
                            chunk=32)
    ours = (q1[0] > 0.5).float().numpy()
    assert (ours == _numpy_crf(rgb, mask, params)).mean() > 0.99


def test_crf_snaps_noisy_mask_to_color_region():
    """tests/test_crf.py's two-colour case: the noisy mask on the red half is
    cleaned into exactly the red half."""
    rng = np.random.default_rng(1)
    h, w = 32, 32
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, : w // 2, 0] = 200
    rgb[:, w // 2:, 2] = 200
    mask = np.zeros((h, w), np.float32)
    mask[:, : w // 2] = 0.7
    mask = np.clip(mask + rng.normal(0, 0.25, (h, w)).astype(np.float32), 0, 1)
    q1, _ = tcrf.mean_field(torch.from_numpy(rgb[None]), torch.from_numpy(mask[None]),
                            tcrf.CRFParams(refine_iters=20), chunk=128)
    out = (q1[0] > 0.5).float().numpy()
    assert out[:, : w // 2].mean() > 0.95 and out[:, w // 2:].mean() < 0.05


# A model of the kernel's operands (csrc/crf.cu): centred on the midpoint of the
# bounding box of a strip's queries (one tile), q' = log2(e) [f - c, -|f - c|^2/2, 1, 0...] and
# k' = [f - c, 1, -|f - c|^2/2, 0...] formed in f32, each split into TF32
# parts hi = rna(x), lo = rna(x - hi); the logit is hi.hi + hi.lo + lo.hi.
# The products here are float64, so what it holds is the operands' rounding:
# the part of the kernel's error that the design chose.
LOG2E = np.float32(1.4426950408889634)
# The logit in natural units against the exact one, where the weight is not
# negligible (l > -20); f32 logits of uncentred features carry ~5e-4.
SPLIT_LOGIT_ATOL = 2e-3


def _kernel_tile() -> int:
    """Pixels a tile of the kernel (a strip's queries, a pair's keys), from its
    source: 16 kTiles kWarps."""
    with open(os.path.join(ck.CSRC_DIR, "crf.cu")) as f:
        src = f.read()
    val = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kWarps", "kTiles")}
    return 16 * val["kWarps"] * val["kTiles"]


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32((x - hi).astype(np.float32))


def _operands(fq: np.ndarray, fk: np.ndarray, centre: np.ndarray):
    d = fq.shape[-1]
    qc, kc = (fq - centre).astype(np.float32), (fk - centre).astype(np.float32)
    hq = np.float32(0.5) * (qc * qc).sum(-1, dtype=np.float32)
    hk = np.float32(0.5) * (kc * kc).sum(-1, dtype=np.float32)
    q = np.zeros(fq.shape[:-1] + (8,), np.float32)
    k = np.zeros(fk.shape[:-1] + (8,), np.float32)
    q[:, :d], q[:, d], q[:, d + 1] = LOG2E * qc, -LOG2E * hq, LOG2E
    k[:, :d], k[:, d], k[:, d + 1] = kc, 1.0, -hk
    return q, k


def _split_logits(fq, fk, centre):
    """Natural-unit logits from the TF32 parts, products in float64."""
    (qh, ql), (kh, kl) = (_split(x) for x in _operands(fq, fk, centre))
    dot = lambda a, b: a.astype(np.float64) @ b.astype(np.float64).T  # noqa: E731
    return (dot(qh, kh) + dot(qh, kl) + dot(ql, kh)) / float(LOG2E)


def _exact_logits(fq, fk):
    a, b = fq.astype(np.float64), fk.astype(np.float64)
    return -0.5 * ((a[:, None, :] - b[None]) ** 2).sum(-1)


# The recipes' grids: DAVIS 96^2 at sxy 60 / 4, SegTrackv2 128^2 at sxy 60 / 3; srgb 5.
GRIDS = {"davis": (96, 0.25), "stv2": (128, 1 / 3)}


def _grid_features(grid: str) -> np.ndarray:
    hw, scale = GRIDS[grid]
    frames = ks.synthetic_frames(1, hw, hw, seed=6)
    return tcrf.pixel_features(torch.from_numpy(frames), 60.0, 5.0, (scale, scale))[0].numpy()


def _block_centre(fq: np.ndarray) -> np.ndarray:
    return (0.5 * (fq.min(0) + fq.max(0))).astype(np.float32)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_tf32_parts_rebuild_the_operands(grid):
    """Each operand of the kernel's dot is hi + lo within one f32 ulp, both parts
    TF32 (their 13 low mantissa bits 0)."""
    f = _grid_features(grid)
    fq = f[:_kernel_tile()]
    for x in _operands(fq, f, _block_centre(fq)):
        hi, lo = _split(x)
        for part in (hi, lo):
            assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
        err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - x.astype(np.float64))
        assert (err <= np.spacing(np.abs(x))).all()


@pytest.mark.parametrize("centred", [True, False], ids=["centred", "uncentred"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_tf32_logits_match_float64(grid, centred):
    """The logits rebuilt from the TF32 parts of a strip's queries against all keys
    lie within SPLIT_LOGIT_ATOL of float64 logits where their weight counts."""
    f = _grid_features(grid)
    fq = f[:_kernel_tile()]
    centre = _block_centre(fq) if centred else np.zeros(f.shape[1], np.float32)
    exact = _exact_logits(fq, f)
    err = np.abs(_split_logits(fq, f, centre) - exact)[exact > -20]
    assert err.max() <= SPLIT_LOGIT_ATOL


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_centring_leaves_the_split_logits(grid):
    """The logit is invariant to a translation: operands centred on the strip's
    midpoint and uncentred ones give the same logits to SPLIT_LOGIT_ATOL, and
    the self logits (exactly 0) stay within it of 0 (den >= 1 to rounding)."""
    f = _grid_features(grid)
    fq = f[:_kernel_tile()]
    exact = _exact_logits(fq, f)
    centred = _split_logits(fq, f, _block_centre(fq))
    uncentred = _split_logits(fq, f, np.zeros(f.shape[1], np.float32))
    assert np.abs(centred - uncentred)[exact > -20].max() <= SPLIT_LOGIT_ATOL
    assert np.abs(np.diag(centred[:, :len(fq)])).max() <= SPLIT_LOGIT_ATOL


# A float64 model of the kernel's schedule (csrc/crf.cu): tiles of T pixels,
# each tile pair (I, J) with I <= J formed once; a diagonal pair adds its
# weights to its rows only, an off-diagonal pair to its rows and its columns;
# pixels past N take the padded half-norm (and features 0), as either query
# or key, so that their weights are exactly 0.
PAD_HALF_NORM = 1e30
# N -> (images, h, w): below one tile of 256 (1, 7), one less, exactly one, one
# more, two and 5, a ragged DAVIS-sized N and the DAVIS grid.
SCHEDULE_SHAPES = {1: (2, 1, 1), 7: (2, 1, 7), 255: (2, 15, 17), 256: (2, 16, 16),
                   257: (2, 1, 257), 2 * 256 + 5: (2, 11, 47), 97 * 61: (1, 97, 61),
                   96 * 96: (1, 96, 96)}


def _schedule_filter(feat: np.ndarray, vals: np.ndarray, tile: int):
    """The filter as the kernel's tile pairs sum it, in float64; returns it and
    the logits formed (T^2 a tile pair)."""
    b, n, d = feat.shape
    nt = -(-n // tile)
    f = np.zeros((b, nt * tile, d))
    f[:, :n] = feat
    v = np.zeros((b, nt * tile))
    v[:, :n] = vals
    h = 0.5 * (f * f).sum(-1)
    h[:, n:] = PAD_HALF_NORM
    real = np.arange(nt * tile) < n
    num, den = np.zeros_like(v), np.zeros_like(v)
    formed = 0
    for i in range(nt):
        rows = slice(i * tile, (i + 1) * tile)
        for j in range(i, nt):
            cols = slice(j * tile, (j + 1) * tile)
            logit = (np.einsum("bid,bjd->bij", f[:, rows], f[:, cols])
                     - h[:, rows, None] - h[:, None, cols])
            w = np.exp(logit)
            assert not w[:, ~real[rows]].any() and not w[:, :, ~real[cols]].any()
            formed += tile * tile
            num[:, rows] += np.einsum("bij,bj->bi", w, v[:, cols])
            den[:, rows] += w.sum(-1)
            if j != i:
                num[:, cols] += np.einsum("bij,bi->bj", w, v[:, rows])
                den[:, cols] += w.sum(1)
    return num[:, :n] / den[:, :n], formed


def test_accumulators_grow_and_are_kept():
    """The kernel's accumulators are one set a device, zero, kept while a call
    fits them and grown to the larger of each extent when one does not."""
    dev = torch.device("cpu")
    ck._scratch.pop(dev.index, None)
    try:
        sums, done = ck._accumulators(dev, 2, 10)
        assert (sums.numel(), done.numel()) == (40, 2) and not sums.any() and not done.any()
        assert ck._accumulators(dev, 1, 5)[0] is sums
        sums, done = ck._accumulators(dev, 3, 10)
        assert (sums.numel(), done.numel()) == (60, 3)
        sums, done = ck._accumulators(dev, 1, 100)
        assert (sums.numel(), done.numel()) == (200, 3)
        assert sums.dtype == torch.float32 and done.dtype == torch.int64
    finally:
        ck._scratch.pop(dev.index, None)


@pytest.mark.parametrize("d", [5, 2])
@pytest.mark.parametrize("n", sorted(SCHEDULE_SHAPES))
def test_tile_pair_schedule_matches_plain(d, n):
    """The kernel's schedule (each tile pair once, diagonal pairs to rows only,
    padded rows and keys of weight 0) equals the filter: the float64 model
    against ``crf_filter_plain`` within FILTER_ATOL (the plain version's f32
    logits), at N below, at and past one tile, two tiles and 5, and the DAVIS
    sizes; ``schedule_pairs`` counts the logits the model forms, nT (nT + 1) / 2
    T^2 an image, with T the source's tile."""
    assert ck.TILE == _kernel_tile() == 256
    b, h, w = SCHEDULE_SHAPES[n]
    feat, vals = ks.filter_inputs(d, b, h, w)
    model, formed = _schedule_filter(feat.astype(np.float64), vals.astype(np.float64), ck.TILE)
    plain = ck.crf_filter_plain(torch.from_numpy(feat), torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(plain, model, rtol=0, atol=FILTER_ATOL)
    nt = -(-n // ck.TILE)
    assert formed == nt * (nt + 1) // 2 * ck.TILE ** 2
    assert ck.schedule_pairs(b, n) == b * formed


def _tool(name: str):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The source edits of the card tools: design variants and timing diagnostics
# (tools/time_crf_variants.py), planted faults (tools/smoke_fault_check.py).
SOURCE_EDITS = {**{f"variant {k}": v for k, v in _tool("time_crf_variants").VARIANTS.items()},
                **{f"fault {k}": v for k, v in _tool("smoke_fault_check").CRF_KERNEL_FAULTS.items()}}


@pytest.mark.parametrize("name", sorted(SOURCE_EDITS))
def test_kernel_source_edits_apply(name):
    """Each text a card tool replaces in crf.cu occurs there exactly once
    (``Library.build_patched`` raises otherwise), so the tools stay in step
    with the source."""
    with open(os.path.join(ck.CSRC_DIR, "crf.cu")) as f:
        src = f.read()
    for old, _ in SOURCE_EDITS[name]:
        assert src.count(old) == 1, old


def _measure():
    """Print the readings behind FILTER_ATOL and Q1_ATOL."""
    for d in (5, 2):
        feat, vals = ks.filter_inputs(d)
        ours = ck.crf_filter_plain(torch.from_numpy(feat), torch.from_numpy(vals), 32).numpy()
        ref = np.stack([np.asarray(jcrf._normalized_filter(
            jnp.asarray(feat[k]), jnp.asarray(vals[k])[:, None], 32))[:, 0] for k in range(2)])
        print(f"filter D={d}: max abs {np.abs(ours - ref).max():.3e}")
    for se, sm in ((True, False), (False, False), (True, True)):
        frames, masks = _mean_field_case()
        extra = {"scomp_smooth": 3.0, "sxy_smooth": 2.0} if sm else {}
        jp = jcrf.CRFParams(refine_iters=20, stable_exit=se, sxy=15.0, **extra)
        jq1, ji = jax.vmap(lambda im, mk: _jax_q1(im, mk, jp, 32, (0.5, 0.5)))(
            jnp.asarray(frames), jnp.asarray(masks))
        q1, it = tcrf.mean_field(torch.from_numpy(frames), torch.from_numpy(masks),
                                 tcrf.CRFParams(refine_iters=20, stable_exit=se, sxy=15.0, **extra),
                                 (0.5, 0.5), 32)
        err = np.abs(q1.numpy() - np.asarray(jq1)).max()
        print(f"q1 stable_exit={se} smooth={sm}: max abs {err:.3e}, iters {it.tolist()} "
              f"jax {np.asarray(ji).tolist()}")


if __name__ == "__main__":
    _measure()
