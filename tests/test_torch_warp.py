"""The port's warp and splat against the JAX package, on the CPU.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode and the plain
gather / dense references. Inputs come from numpy with a seed and go to
both frameworks. Coordinates are non-integer: at an exact integer the
TPU kernel's hat derivative is 0 while a gather's is one-sided
(``tests/test_warp_pallas.py``). The kernels against their plain versions
on the card: ``test_torch_warp_card.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.ops import warp as jwarp
from rcf_tpu.ops.pallas.warp_pallas import splat_pallas, warp_pallas
from rcf_tpu_torch.ops import warp as twarp
from rcf_tpu_torch.ops import warp_kernels as wk

import kernel_sets as ks

B, H, W, C = 2, 128, 384, 3

# Same 4-tap arithmetic in f32 on both sides, values in [0, 1).
TOL_VALUES = 1e-5
# Coordinate gradients: f32 sums of O(1) products over 3 channels.
TOL_GRADS = 1e-4
# Splat densities: f32 sums of up to a few dozen weights in another order.
TOL_SPLAT = 1e-5


@pytest.mark.parametrize("pad", ["border", "zeros"])
def test_warp_fwd_matches_pallas(pad):
    img = ks.image((B, H, W, C))
    cx, cy = ks.coords(ks.flow((B, H, W, 2), 5.0 if pad == "border" else 9.0))
    if pad == "border":
        cx, cy = np.clip(cx, 0, W - 1), np.clip(cy, 0, H - 1)
    ref = np.asarray(warp_pallas(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy), True))
    ours = wk.warp_fwd(torch.from_numpy(img), torch.from_numpy(cx), torch.from_numpy(cy))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL_VALUES)


def test_warp_coordinate_grads_match_pallas():
    img = ks.image((B, H, W, C))
    flow = ks.flow((B, H, W, 2), 5.0)
    wgt = ks.image((B, H, W, C), seed=5) - 0.5
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                          indexing="ij")

    def jloss(f):
        cx = jnp.clip(xs[None] + f[..., 0], 0, W - 1)
        cy = jnp.clip(ys[None] + f[..., 1], 0, H - 1)
        out = warp_pallas(jnp.asarray(img), cx, cy, True, False)
        return jnp.sum(out * wgt)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(flow))

    tf = torch.from_numpy(flow).requires_grad_(True)
    timg = torch.from_numpy(img).requires_grad_(True)
    out = twarp.flow_warp(timg, tf, pad="border", grad_img=False)
    tl = (out * torch.from_numpy(wgt)).sum()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), atol=TOL_GRADS)
    assert timg.grad is None  # grad_img=False: the image is data


@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("c", [3, 12])
def test_flow_warp_matches_jax_at_odd_sizes(pad, c):
    """C=3 runs the kernel route (plain here), C=12 the grid_sample route."""
    shape = (2, 7, 9, c)
    img = ks.image(shape)
    flow = ks.flow((2, 7, 9, 2), 3.0)
    wgt = ks.image(shape, seed=4) - 0.5
    grad_img = c > 8

    def jloss(im, f):
        return jnp.sum(jwarp.flow_warp(im, f, pad=pad, grad_img=grad_img) * wgt)

    jl, (jgi, jgf) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    ti = torch.from_numpy(img).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    tl = (twarp.flow_warp(ti, tf, pad=pad, grad_img=grad_img) * torch.from_numpy(wgt)).sum()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    # grid_sample normalizes coordinates by W-1 and back: ~1e-6 px of rounding.
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), atol=TOL_GRADS)
    if grad_img:
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=TOL_GRADS)


@pytest.mark.parametrize("pad", ["border", "zeros"])
def test_flow_warp_bf16_features_match_jax(pad):
    """A bf16 feature map (C > 8, PWC-Lite's warps) at 160 wide: JAX's gather
    blends the bf16 values with f32 weights at f32 coordinates and returns f32.
    The port must too (a bf16 grid would be off by up to 0.3 px here)."""
    img = ks.image((2, 24, 160, 12))
    flow = ks.flow((2, 24, 160, 2), 3.0)
    ref = np.asarray(jwarp.flow_warp(jnp.asarray(img, jnp.bfloat16), jnp.asarray(flow), pad=pad))
    ours = twarp.flow_warp(torch.from_numpy(img).bfloat16(), torch.from_numpy(flow), pad=pad)
    assert ref.dtype == np.float32 and ours.dtype == torch.float32
    # Values in [0, 1): the same bf16 inputs and f32 weights on both sides, but
    # grid_sample normalizes the coordinates by (W-1)/2 and back, ~2e-5 px of f32
    # rounding at 160 wide.
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)


# Image cotangent: f32 sums of up to a few dozen g * weight terms per source
# pixel, |g| <= 1, taken in another order than the Pallas kernel's matmuls.
TOL_DIMG = 1e-4


@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("c", [2, 3])
def test_warp_image_grad_matches_pallas(pad, c):
    """Kernel 4's plain version, and autograd through flow_warp(grad_img=True),
    against jax.grad of sum(sin(warp_pallas(img, cx, cy, need_dimg=True)))."""
    img = ks.image((B, H, W, c)) - 0.5
    flow = ks.flow((B, H, W, 2), 5.0 if pad == "border" else 9.0)
    cx, cy = ks.coords(flow)
    if pad == "border":
        cx, cy = np.clip(cx, 0, W - 1), np.clip(cy, 0, H - 1)

    def jloss(im, x, y):
        return jnp.sum(jnp.sin(warp_pallas(im, x, y, True, True)))

    jgi, jgx, jgy = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy))
    ti, tx, ty = (torch.from_numpy(a) for a in (img, cx, cy))
    g = torch.cos(wk.warp_fwd(ti, tx, ty))
    dimg, dcx, dcy = wk.warp_bwd_dimg_plain(ti, tx, ty, g)
    np.testing.assert_allclose(dimg.numpy(), np.asarray(jgi), atol=TOL_DIMG)
    np.testing.assert_allclose(dcx.numpy(), np.asarray(jgx), atol=TOL_GRADS)
    np.testing.assert_allclose(dcy.numpy(), np.asarray(jgy), atol=TOL_GRADS)

    # The same gradients through the op: flow_warp differentiated in the image
    # and the flow (d/dflow = d/dcoords where the border clamp lets it through).
    ti = torch.from_numpy(img).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    torch.sin(twarp.flow_warp(ti, tf, pad=pad, grad_img=True)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=TOL_DIMG)
    inside = ((cx > 0) & (cx < W - 1)) if pad == "border" else np.ones_like(cx, bool)
    np.testing.assert_allclose(tf.grad.numpy()[..., 0], np.where(inside, np.asarray(jgx), 0),
                               atol=TOL_GRADS)


@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 2), (1, 11, 5, 3)])
def test_flow_warp_image_grad_matches_gather(pad, shape):
    """flow_warp(grad_img=True), C <= 8, against jax.grad through JAX's
    flow_warp, which takes the plain gather (bilinear_sample) at these sizes."""
    img = ks.image(shape)
    flow = ks.flow((*shape[:3], 2), 3.0)
    wgt = ks.image(shape, seed=4) - 0.5

    def jloss(im, f):
        return jnp.sum(jwarp.flow_warp(im, f, pad=pad, grad_img=True) * wgt)

    jl, (jgi, jgf) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    ti = torch.from_numpy(img).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    tl = (twarp.flow_warp(ti, tf, pad=pad, grad_img=True) * torch.from_numpy(wgt)).sum()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=TOL_GRADS)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), atol=TOL_GRADS)


def test_occu_mask_bidirection_matches_jax():
    # A smooth flow12, and flow21 its negative plus noise: the check passes
    # where the noise is small and fails elsewhere and where taps leave the frame.
    rng = np.random.default_rng(6)
    ys, xs = np.meshgrid(np.arange(40), np.arange(56), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, (2, 1, 1, 2))
    flow12 = (3.0 * np.sin(ys[None, ..., None] / 7.0 + xs[None, ..., None] / 9.0 + phase)
              ).astype(np.float32)
    flow21 = (-flow12 + rng.standard_normal((2, 40, 56, 2)) * 0.6).astype(np.float32)
    ref = np.asarray(jwarp.occu_mask_bidirection(jnp.asarray(flow12), jnp.asarray(flow21)))
    ours = twarp.occu_mask_bidirection(torch.from_numpy(flow12), torch.from_numpy(flow21))
    # Equal wherever the check's two sides are not within 1e-4 of each other.
    fw = np.asarray(jwarp.flow_warp(jnp.asarray(flow21), jnp.asarray(flow12), pad="zeros"))
    lhs = np.sum((flow12 + fw) ** 2, -1)
    rhs = 0.01 * (np.sum(flow12**2, -1) + np.sum(fw**2, -1)) + 0.5
    clear = np.abs(lhs - rhs) > 1e-4
    assert clear.mean() > 0.99 and 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(ours.numpy()[clear], ref[clear])


@pytest.mark.parametrize("scale", [3.0, 12.0])
def test_splat_matches_pallas(scale):
    tx, ty = ks.coords(ks.flow((B, H, W, 2), scale))
    ref = np.asarray(splat_pallas(jnp.asarray(tx), jnp.asarray(ty), H, W, interpret=True))
    ours = wk.splat(torch.from_numpy(tx), torch.from_numpy(ty), H, W)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL_SPLAT)


def test_splat_matches_pallas_far_flow():
    """Far flows (N(0, 40^2), a tenth of the pixels 10^6 px out): the port's plain
    splat against the Pallas kernel. At 96 x 384 the kernel's [96, 384] window
    covers the frame, so it is exact for any flow (at larger frames its caller
    sends flows that leave the window to the dense path)."""
    tx, ty = ks.far_coords((B, 96, 384))
    ref = np.asarray(splat_pallas(jnp.asarray(tx), jnp.asarray(ty), 96, 384, interpret=True))
    ours = wk.splat(torch.from_numpy(tx), torch.from_numpy(ty), 96, 384)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL_SPLAT)


@pytest.mark.parametrize("shape", [(2, 12, 14), (3, 33, 47)])
def test_corresponding_map_matches_dense(shape):
    flow = ks.flow((*shape, 2), 4.0, seed=1)
    ref = np.asarray(jwarp._corresponding_map_dense(jnp.asarray(flow)))
    ours = twarp.corresponding_map(torch.from_numpy(flow))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL_SPLAT)


def test_occu_mask_backward_matches_jax():
    flow = ks.flow((2, 40, 56, 2), 4.0, seed=3)
    dens = np.asarray(jwarp._corresponding_map_dense(jnp.asarray(flow)))
    ref = np.asarray(jwarp.occu_mask_backward(jnp.asarray(flow), th=0.2))
    ours = twarp.occu_mask_backward(torch.from_numpy(flow), th=0.2).numpy()
    # Equal wherever the density is not within float noise of the threshold.
    clear = np.abs(np.clip(dens, 0, 1) - 0.2) > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ours[clear], ref[clear])


def test_correlation_matches_jax():
    x1 = np.random.default_rng(0).standard_normal((2, 9, 10, 6)).astype(np.float32)
    x2 = np.random.default_rng(1).standard_normal((2, 9, 10, 6)).astype(np.float32)
    ref = np.asarray(jwarp.correlation(jnp.asarray(x1), jnp.asarray(x2), 4))
    ours = twarp.correlation(torch.from_numpy(x1), torch.from_numpy(x2), 4)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_cpu_wrappers_run_plain_versions_without_launching():
    img = torch.from_numpy(ks.image((1, 8, 8, 3)))
    cx, cy = (torch.from_numpy(a) for a in ks.coords(ks.flow((1, 8, 8, 2), 2.0)))
    wk.reset_launch_counts()
    torch.testing.assert_close(wk.warp_fwd(img, cx, cy), wk.warp_fwd_plain(img, cx, cy),
                               rtol=0, atol=0)
    wk.warp_bwd(img, cx, cy, img)
    wk.warp_bwd_dimg(img, cx, cy, img)
    wk.splat(cx, cy, 8, 8)
    assert wk.LAUNCHES == {"warp_fwd": 0, "warp_bwd": 0, "warp_bwd_dimg": 0, "splat": 0}


def test_wrappers_reject_unsupported_inputs():
    img = torch.zeros(1, 8, 8, 3)
    cx = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError):
        wk.warp_fwd(img.double(), cx, cx)
    with pytest.raises(ValueError):
        wk.warp_fwd(img, cx[:, :4], cx)
    with pytest.raises(ValueError):
        wk.splat(cx.half(), cx.half(), 8, 8)
    with pytest.raises(ValueError):  # no silent fallback for another device
        wk.warp_fwd(img.to("meta"), cx.to("meta"), cx.to("meta"))


def test_warp_wrappers_reject_planes_past_32_bits():
    """warp_fwd and warp_bwd offset inside a plane in 32 bits and put the batch
    in the launch grid's z: a plane of more than 2^31 - 1 elements, more than
    65535 planes, or more rows than 65535 tiles of 8 raise, on every device.
    The tensors are stride-0 expansions, so nothing of that size is allocated."""
    h, w = 2**15, 2**14
    img = torch.zeros(1, 1, 1, 1).expand(1, h, w, 4)
    cx = torch.zeros(1, 1, 1).expand(1, h, w)
    with pytest.raises(ValueError, match="32-bit"):
        wk.warp_fwd(img, cx, cx)
    with pytest.raises(ValueError, match="32-bit"):
        wk.warp_bwd(img, cx, cx, img)
    wk._check_grid("warp_fwd", torch.zeros(1, 1, 1, 1).expand(1, h, w, 3))  # 1.6e9 fits
    for b, h in ((65536, 1), (1, 65535 * 8 + 1)):
        img = torch.zeros(1, 1, 1, 1).expand(b, h, 1, 1)
        cx = torch.zeros(1, 1, 1).expand(b, h, 1)
        with pytest.raises(ValueError, match="launch grid"):
            wk.warp_fwd(img, cx, cx)
        with pytest.raises(ValueError, match="launch grid"):
            wk.warp_bwd(img, cx, cx, img)
    wk._check_grid("warp_fwd", torch.zeros(1, 1, 1, 1).expand(65535, 65535 * 8, 1, 1))


@pytest.mark.parametrize("kernel", ["splat", "warp_bwd_dimg"])
def test_overlap_add_wrappers_reject_planes_past_32_bits(kernel):
    """The splat and warp_bwd_dimg offset inside a plane in 32 bits and put the
    batch in the launch grid's z, as warp_fwd and warp_bwd do: a plane (the
    splat's source or density) of more than 2^31 - 1 elements, more than 65535
    planes, or more rows than 65535 tiles (32 rows for the splat, 8 for
    warp_bwd_dimg) raise, on every device. Stride-0 tensors: nothing of that
    size is allocated."""
    def call(b, h, w, c=2, out=None):
        if kernel == "splat":
            t = torch.zeros(1, 1, 1).expand(b, h, w)
            return wk.splat(t, t, *(out or (1, 1)))
        img = torch.zeros(1, 1, 1, 1).expand(b, h, w, c)
        cx = torch.zeros(1, 1, 1).expand(b, h, w)
        return wk.warp_bwd_dimg(img, cx, cx, img)

    with pytest.raises(ValueError, match="32-bit"):
        call(1, 2**15, 2**16 if kernel == "splat" else 2**14, c=4)
    if kernel == "splat":
        with pytest.raises(ValueError, match="32-bit"):
            call(1, 1, 1, out=(2**16, 2**16))  # the density's plane
    rows = 65535 * (wk.SPLAT_TILE_ROWS if kernel == "splat" else wk.TILE_ROWS)
    for b, h in ((65536, 1), (1, rows + 1)):
        with pytest.raises(ValueError, match="launch grid"):
            call(b, h, 1)
    wk._check_launch(kernel, 65535, rows, 2**31 - 1,
                     wk.SPLAT_TILE_ROWS if kernel == "splat" else wk.TILE_ROWS)
