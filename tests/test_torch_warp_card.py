"""The warp and splat kernels (``csrc/warp.cu``) against their plain versions, on the card.

Every case needs a card (``cuda`` marker) and skips without one. The file
imports no JAX, so that the card runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_card.py

warp_fwd and warp_bwd at the CPU tests' level shape and the ragged shapes
(numpy inputs), at the AMD level-0 shape (8 x 384 x 640, f32 and bf16,
pad "border" and "zeros") and at the ragged shapes on the device;
warp_bwd_dimg and the splat at both, and on each set of
``kernel_sets.overlap_add_sets``, with the taps of each overlap-add branch
counted by the test build (``warp_kernels.COUNT_TAPS``) on the same inputs:
the far set must reach the device-memory branch, the gentle smooth set only
the shared window.
"""

from __future__ import annotations

import pytest
import torch

from rcf_tpu_torch.ops import warp_kernels as wk

import kernel_sets as ks

B, H, W, C = 2, 128, 384, 3  # the CPU tests' level shape

# Kernel against plain version on the card (same inputs, f32 arithmetic in
# both), on the device-made sets:
TOL = {
    # f32 output, same 4-tap arithmetic; contraction (FMA) order may differ.
    ("warp_fwd", "float32"): 1e-5,
    # bf16 output: both round one f32 value; at most one bf16 ulp (2^-7 at 1.0) apart.
    ("warp_fwd", "bfloat16"): 1e-2,
    # f32 sums over 3 channels of products of O(1) terms.
    ("warp_bwd", "float32"): 1e-4,
    ("warp_bwd", "bfloat16"): 1e-4,
    # dimg: f32 atomics in a run-dependent order, |g| < 1, a few taps per pixel;
    # dcx, dcy as warp_bwd (flow-valued C=2 maps reach |img| ~ 10: 1e-4 still).
    ("warp_bwd_dimg", "float32"): 1e-4,
    # bf16 dimg: both round an f32 sum (equal to ~1e-6) to bf16, so they are at
    # most one bf16 ulp apart: 2^-4 for |dimg| < 16. dcx, dcy stay f32 (1e-4).
    ("warp_bwd_dimg", "bfloat16"): 2.0**-4,
    # f32 atomics in an order that changes from run to run; densities O(1).
    ("splat", "float32"): 1e-4,
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# Widths that are no multiple of 32 (ragged tails, misaligned rows), every
# compiled channel count and the generic instance (C=5), three planes; and the
# tests' level shape.
_CARD_SHAPES = [(ks.RAGGED_B, h, w, c) for h in ks.RAGGED_H for w in ks.RAGGED_W
                for c in ks.RAGGED_C]
_CARD_SHAPES.append((B, H, W, C))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_warp_kernels_match_plain_on_card(cuda, dtype, tol):
    for shape in _CARD_SHAPES:
        img = torch.from_numpy(ks.image(shape)).to(cuda, dtype)
        cx, cy = (torch.from_numpy(a).to(cuda) for a in ks.coords(ks.flow((*shape[:3], 2), 9.0)))
        g = torch.from_numpy(ks.image(shape, seed=9) - 0.5).to(cuda, dtype)
        h, w = shape[1:3]
        for x, y in ((cx, cy), (cx.clamp(0, w - 1), cy.clamp(0, h - 1))):  # zeros, border
            out = wk.warp_fwd(img, x, y)
            torch.cuda.synchronize()
            assert (out.float() - wk.warp_fwd_plain(img, x, y).float()).abs().max() <= tol, shape
            for k, p in zip(wk.warp_bwd(img, x, y, g), wk.warp_bwd_plain(img, x, y, g)):
                torch.cuda.synchronize()
                assert (k - p).abs().max() <= 1e-4, shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 3])
def test_warp_bwd_dimg_kernel_matches_plain_on_card(cuda, dtype, c):
    """The level shape with C = c (flows N(0, 9^2), pad "zeros"); the ragged
    shapes (every C, flows N(0, 2^2), both pads: tiles past the edge, rows whose
    window flush has a head and a tail); and far flows (``far_coords``, pad
    "zeros"): taps outside the block's window, which go straight to device memory."""
    sets = [((B, H, W, c), ks.coords(ks.flow((B, H, W, 2), 9.0)), False)]
    sets += [(s, ks.coords(ks.flow((*s[:3], 2), 2.0)), True) for s in _CARD_SHAPES[:-1]]
    sets.append(((B, H, W, c), ks.far_coords((B, H, W)), False))
    for shape, coords, both_pads in sets:
        img = torch.from_numpy(ks.image(shape)).to(cuda, dtype)
        cx, cy = (torch.from_numpy(a).to(cuda) for a in coords)
        g = torch.from_numpy(ks.image(shape, seed=9) - 0.5).to(cuda, dtype)
        h, w = shape[1:3]
        pads = [(cx, cy)] + ([(cx.clamp(0, w - 1), cy.clamp(0, h - 1))] if both_pads else [])
        for x, y in pads:
            ours = wk.warp_bwd_dimg(img, x, y, g)
            torch.cuda.synchronize()
            plain = wk.warp_bwd_dimg_plain(img, x, y, g)
            # dimg: f32 atomics in a run-dependent order, then, for bf16 images, one
            # rounding to bf16 on each side (|dimg| < 4: one bf16 ulp is at most 2^-6).
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            assert (ours[0].float() - plain[0].float()).abs().max() <= tol, shape
            for k, p in zip(ours[1:], plain[1:]):
                assert (k - p).abs().max() <= 1e-4, shape


@pytest.mark.cuda
def test_splat_kernel_matches_plain_on_card(cuda):
    tx, ty = (torch.from_numpy(a).to(cuda) for a in ks.coords(ks.flow((B, H, W, 2), 6.0)))
    dens = wk.splat(tx, ty, H, W)
    torch.cuda.synchronize()
    assert (dens - wk.splat_plain(tx, ty, H, W)).abs().max() <= 1e-4


@pytest.mark.cuda
def test_splat_kernel_matches_plain_on_card_ragged_and_far(cuda):
    """The ragged source shapes into their own shape, a larger and a smaller
    density; and far flows (``far_coords``) at the level shape, whose taps
    leave the block's window and the image."""
    sets = []
    for b, h, w, _ in _CARD_SHAPES[:-1:5]:  # each (h, w) once
        coords = ks.coords(ks.flow((b, h, w, 2), 2.0))
        sets += [(coords, out) for out in ((h, w), (h + 5, 2 * w + 1), (max(h // 2, 1), max(w // 3, 1)))]
    sets.append((ks.far_coords((B, H, W)), (H, W)))
    for coords, (h, w) in sets:
        tx, ty = (torch.from_numpy(a).to(cuda) for a in coords)
        dens = wk.splat(tx, ty, h, w)
        torch.cuda.synchronize()
        assert (dens - wk.splat_plain(tx, ty, h, w)).abs().max() <= 1e-4, (tx.shape, h, w)


# ---- the AMD level-0 shape and the ragged shapes, inputs made on the device


@pytest.mark.cuda
@pytest.mark.parametrize("dn", sorted(DTYPES))
def test_warps_match_plain_at_level0(cuda, dn):
    """warp_fwd on border (pre-clamped, flows N(0, 5^2)) and zeros (unclamped,
    N(0, 9^2)) coordinates, warp_bwd on the border ones, at 8 x 384 x 640 x 3."""
    dtype, gen = DTYPES[dn], torch.Generator(device=cuda).manual_seed(1)
    img, cx, cy = ks.level0_inputs(dtype, gen)
    cxb, cyb = cx.clamp(0, ks.W - 1), cy.clamp(0, ks.H - 1)
    _, cxz, cyz = ks.level0_inputs(dtype, gen, scale=9.0)
    for pad, (x, y) in (("border", (cxb, cyb)), ("zeros", (cxz, cyz))):
        assert _err(wk.warp_fwd(img, x, y), wk.warp_fwd_plain(img, x, y)) \
            <= TOL[("warp_fwd", dn)], pad
    g = torch.randn(ks.B, ks.H, ks.W, ks.C, generator=gen, device=cuda).to(dtype)
    for k, p in zip(wk.warp_bwd(img, cxb, cyb, g), wk.warp_bwd_plain(img, cxb, cyb, g)):
        assert _err(k, p) <= TOL[("warp_bwd", dn)]


@pytest.mark.cuda
@pytest.mark.parametrize("dn", sorted(DTYPES))
def test_warps_match_plain_at_ragged_shapes(cuda, dn):
    """warp_fwd and warp_bwd at B=3, H in {1, 13}, W in {1, 3, 77}, C in 1..5,
    flows N(0, 2^2), pad "zeros" (unclamped, taps leave the image) and "border"
    (clamped), at the level-0 limits."""
    dtype, gen = DTYPES[dn], torch.Generator(device=cuda).manual_seed(1)
    for h in ks.RAGGED_H:
        for w in ks.RAGGED_W:
            for c in ks.RAGGED_C:
                img, cx, cy = ks.level0_inputs(dtype, gen, scale=2.0, b=ks.RAGGED_B, h=h, w=w, c=c)
                g = torch.randn(ks.RAGGED_B, h, w, c, generator=gen, device=cuda).to(dtype)
                for pad, (x, y) in (("zeros", (cx, cy)),
                                    ("border", (cx.clamp(0, w - 1), cy.clamp(0, h - 1)))):
                    case = (h, w, c, pad)
                    assert _err(wk.warp_fwd(img, x, y), wk.warp_fwd_plain(img, x, y)) \
                        <= TOL[("warp_fwd", dn)], case
                    for k, p in zip(wk.warp_bwd(img, x, y, g), wk.warp_bwd_plain(img, x, y, g)):
                        assert _err(k, p) <= TOL[("warp_bwd", dn)], case


@pytest.mark.cuda
@pytest.mark.parametrize("dn", sorted(DTYPES))
@pytest.mark.parametrize("c", [2, 3])
def test_warp_bwd_dimg_matches_plain_at_level0(cuda, c, dn):
    """C=2 (a flow, as the system calls it: |img| ~ 10) and C=3, flows N(0, 9^2),
    pad "zeros" and "border"."""
    dtype, gen = DTYPES[dn], torch.Generator(device=cuda).manual_seed(1)
    fl = torch.randn(ks.B, ks.H, ks.W, 2, generator=gen, device=cuda) * 5.0
    img = fl * 2.0 if c == 2 else torch.rand(ks.B, ks.H, ks.W, 3, generator=gen, device=cuda)
    img = img.to(dtype)
    _, cx, cy = ks.level0_inputs(dtype, gen, scale=9.0)
    g = (torch.rand(ks.B, ks.H, ks.W, c, generator=gen, device=cuda) * 2 - 1).to(dtype)
    for pad, (x, y) in (("zeros", (cx, cy)),
                        ("border", (cx.clamp(0, ks.W - 1), cy.clamp(0, ks.H - 1)))):
        ours, plain = wk.warp_bwd_dimg(img, x, y, g), wk.warp_bwd_dimg_plain(img, x, y, g)
        assert _err(ours[0], plain[0]) <= TOL[("warp_bwd_dimg", dn)], pad
        assert max(_err(a, b) for a, b in zip(ours[1:], plain[1:])) \
            <= TOL[("warp_bwd", "float32")], pad


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ks.overlap_add_sets(torch.Generator())))
def test_overlap_adds_match_plain_on_every_branch(cuda, name):
    """warp_bwd_dimg at C = 2, 3 (C = 1..5 on the ragged sets: every compiled
    channel count and the generic instance), f32 and bf16, pad "zeros" and,
    where few taps pile up on the image's edge (``iid``, ``smooth``, ragged),
    "border"; the splat over 2B maps (B on the ragged sets) into the source
    shape and, on the ragged sets, into (h + 5, 2w + 1) and (h/2, w/3) as
    well; each at the level-0 limits. Then the same calls through the test
    build, which counts the taps of each branch: the ``far`` set reaches the
    device-memory branch of both kernels, the ``smooth`` set the window alone."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, w, make = ks.overlap_add_sets(gen)[name]
    ragged = name.startswith("ragged")
    calls = []
    for dn, dtype in DTYPES.items():
        for c in (ks.RAGGED_C if ragged else (2, 3)):
            cx, cy = make(b, h, w)
            img = (torch.randn(b, h, w, c, generator=gen, device=cuda) * 5).to(dtype)
            g = (torch.rand(b, h, w, c, generator=gen, device=cuda) * 2 - 1).to(dtype)
            pads = [("zeros", (cx, cy))]
            if name in ("iid", "smooth") or ragged:
                # Clamped far-out coordinates pile up on the edge: the "far" and
                # "smooth8" sums there pass 16, where one bf16 ulp is above TOL.
                pads.append(("border", (cx.clamp(0, w - 1), cy.clamp(0, h - 1))))
            for pad, (x, y) in pads:
                ours = wk.warp_bwd_dimg(img, x, y, g)
                plain = wk.warp_bwd_dimg_plain(img, x, y, g)
                case = (c, dn, pad)
                assert _err(ours[0], plain[0]) <= TOL[("warp_bwd_dimg", dn)], case
                assert max(_err(a, p) for a, p in zip(ours[1:], plain[1:])) \
                    <= TOL[("warp_bwd", "float32")], case
                calls.append(("warp_bwd_dimg", wk.warp_bwd_dimg, (img, x, y, g)))
    tx, ty = make(b if ragged else 2 * ks.B, h, w)
    outs = ((h, w), (h + 5, 2 * w + 1), (max(h // 2, 1), max(w // 3, 1))) if ragged else ((h, w),)
    for oh, ow in outs:
        assert _err(wk.splat(tx, ty, oh, ow), wk.splat_plain(tx, ty, oh, ow)) \
            <= TOL[("splat", "float32")], (oh, ow)
        calls.append(("splat", wk.splat, (tx, ty, oh, ow)))
    taps = {"splat": (0, 0), "warp_bwd_dimg": (0, 0)}  # (shared window, device memory)
    with wk.LIB.patched(wk.COUNT_TAPS, "count_taps") as lib:
        for kernel, fn, args in calls:
            wk.tap_counts(lib)
            fn(*args)
            torch.cuda.synchronize()
            taps[kernel] = tuple(a + n for a, n in zip(taps[kernel], wk.tap_counts(lib)))
    if name == "far":
        assert all(n[1] > 0 for n in taps.values()), taps
    if name == "smooth":
        assert all(n[0] > 0 and n[1] == 0 for n in taps.values()), taps
