"""Input sets of the hand-written kernels (``rcf_tpu_torch/csrc/*.cu``).

One place for the inputs that the kernels' checks and the tools that time
them read: the CPU tests against the JAX package, the card tests
(``test_torch_*_card.py``, ``test_torch_dino_attention.py``), ``chip_smoke.py``'s
timing rows and ``tools/time_*_variants.py``. Imports no JAX, so the card
runs it.

* The warps: seeded numpy images, flows and coordinates (``image``, ``flow``,
  ``coords``, ``far_coords``); the AMD level-0 shape (``B, H, W, C``) and its
  inputs made on the device (``level0_inputs``); the ragged shapes; the sets
  that drive each branch of the overlap-adds (``overlap_add_sets``).
* crf_filter: seeded numpy features of synthetic frames (``filter_inputs``);
  five sets on the device (``crf_filter_sets``) with their limits
  (``CRF_TOL``) and the float64 yardstick (``crf_filter_f64``).
* dino_attention: the sets of ``ATTENTION_SETS`` (``attention_inputs``) and
  the gap to float64 (``attention_gap``).
* dino_linear: the sets of ``LINEAR_SETS`` (``linear_inputs``) and the gap
  to float64 (``linear_gap``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rcf_tpu_torch.ops import attention_kernels as ak
from rcf_tpu_torch.ops import crf as crf_ops
from rcf_tpu_torch.ops import linear_kernels as lk

# ---------------------------------------------------------------- warps

B, H, W, C = 8, 384, 640, 3  # AMD level 0: 8 pairs, flow_size 384x640, RGB
# Shapes whose widths and heights are no multiple of the 32 x 8 tile (threads
# past the edge), every compiled channel count (1-4) and the generic instance
# (5), three planes (the batch boundary).
RAGGED_B, RAGGED_H, RAGGED_W, RAGGED_C = 3, (1, 13), (1, 3, 77), (1, 2, 3, 4, 5)


def image(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def flow(shape, scale, seed=2) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def coords(fl: np.ndarray):
    """Absolute coordinates (x, y) [b, h, w] of a flow [b, h, w, 2]."""
    b, h, w, _ = fl.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    return xs[None] + fl[..., 0], ys[None] + fl[..., 1]


def far_coords(shape, seed=7):
    """Coordinates of i.i.d. N(0, 40^2) flows, one pixel in ten moved 10^6 px left or
    right and another one in ten up or down: taps far outside a kernel block's
    window and outside the image."""
    rng = np.random.default_rng(seed)
    out = []
    for t in coords(flow((*shape, 2), 40.0, seed=seed)):
        far = rng.random(t.shape) < 0.1
        out.append(np.where(far, t + 1e6 * rng.choice([-1.0, 1.0], t.shape), t)
                   .astype(np.float32))
    return out


def level0_inputs(dtype, gen, scale=5.0, b=B, h=H, w=W, c=C, smooth=False, smooth_scale=8.0):
    """img [b,h,w,c] in [0,1), non-integer absolute coords cx, cy [b,h,w] f32, on
    ``gen``'s device.

    The flow is i.i.d. N(0, scale^2) per pixel, or, with ``smooth``,
    N(0, smooth_scale^2) drawn at (h/4, w/4) and bilinearly upsampled x4, as
    the step's flows are predicted at a quarter of the resolution and upsampled.
    """
    dev = gen.device
    img = torch.rand(b, h, w, c, generator=gen, device=dev).to(dtype)
    if smooth:
        fl = torch.randn(b, 2, max(h // 4, 1), max(w // 4, 1), generator=gen,
                         device=dev) * smooth_scale
        fl = F.interpolate(fl, size=(h, w), mode="bilinear", align_corners=True)
        fl = fl.permute(0, 2, 3, 1)
    else:
        fl = torch.randn(b, h, w, 2, generator=gen, device=dev) * scale
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    return img, xs + fl[..., 0], ys + fl[..., 1]


def overlap_add_sets(gen) -> dict:
    """name -> (b, h, w, make(b, h, w) -> (cx, cy)): coordinates on ``gen``'s device
    that drive the overlap-adds (splat, warp_bwd_dimg) down each branch.

    ``iid``: the level-0 timing flows (i.i.d. N(0, 5^2)); ``smooth``: gentle
    smooth flows (N(0, 2^2) at a quarter of the resolution, upsampled), whose
    taps all fall in their block's window; ``smooth8``: the timing's smooth
    flows (N(0, 8^2)); ``far``: ``far_coords``, many taps outside a block's
    window (the device-memory branch) or the image; ``ragged``: B=3, H in
    {1, 13}, W in {1, 3, 77}, i.i.d. N(0, 2^2) (tiles past the edge, rows that
    are no multiple of 4 floats, so each row's head and tail quads)."""
    def level0(**kw):
        return lambda b, h, w: level0_inputs(torch.float32, gen, b=b, h=h, w=w, c=1, **kw)[1:]

    def far(b, h, w):
        return [torch.from_numpy(t).to(gen.device) for t in far_coords((b, h, w))]

    sets = {"iid": (B, H, W, level0()), "smooth": (B, H, W, level0(smooth=True, smooth_scale=2.0)),
            "smooth8": (B, H, W, level0(smooth=True)), "far": (B, H, W, far)}
    for h in RAGGED_H:
        for w in RAGGED_W:
            sets[f"ragged_{RAGGED_B}x{h}x{w}"] = (RAGGED_B, h, w, level0(scale=2.0))
    return sets


# ---------------------------------------------------------------- crf_filter

def synthetic_frames(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 frames [b, h, w, 3]: a flat background, a disc and a bar of other
    flat colours (edges), and +-3 levels of noise."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w, 3), np.float32)
    for k in range(b):
        cols = rng.integers(20, 235, (3, 3))
        img = np.broadcast_to(cols[0], (h, w, 3)).astype(np.float32).copy()
        cy, cx, r = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w, 0.3 * min(h, w)
        img[(ys - cy) ** 2 + (xs - cx) ** 2 < r * r] = cols[1]
        img[:, int(0.8 * w):] = cols[2]
        out[k] = img + rng.integers(-3, 4, (h, w, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def filter_inputs(d: int, b: int = 2, h: int = 13, w: int = 11, seed: int = 2):
    """Features at a recipe's scales (the DAVIS grid's sxy 60 / 4, srgb 5) of
    synthetic frames, or their xy part (D = 2), and values in [0, 1]."""
    frames = synthetic_frames(b, h, w, seed)
    feat = crf_ops.pixel_features(torch.from_numpy(frames), 60.0, 5.0, (0.25, 0.25))[..., 5 - d:]
    if d == 2:
        feat = crf_ops.xy_features(h, w, 3.0).expand(b, -1, -1)
    vals = np.random.default_rng(seed).uniform(0, 1, (b, h * w)).astype(np.float32)
    return feat.contiguous().numpy(), vals


def crf_frames(gen, n: int, hw: int, block: int = 32):
    """n normalized frames [n, hw, hw, 3] on ``gen``'s device with flat colour
    regions and edges: N(0, 1) colours on blocks of block^2 pixels, plus
    N(0, 0.05^2) (about 3 uint8 levels) of noise. The mean field runs several
    iterations on such content (1-16 measured on the card); on i.i.d. noise
    frames it stops after one or two."""
    dev = gen.device
    cells = -(-hw // block)
    c = torch.randn(n, cells, cells, 3, generator=gen, device=dev)
    x = c.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :hw, :hw]
    return x + 0.05 * torch.randn(n, hw, hw, 3, generator=gen, device=dev)


def crf_features(gen, b: int, h: int, w: int, scale: float):
    """Appearance features [b, h*w, 5] of ``crf_frames`` (blocks of 8 pixels on
    the grid, as 32 on the 384^2 frames) at the recipes' sxy 60 and srgb 5,
    with the grid's ``xy_scale``."""
    rgb = crf_ops.unnormalize_to_uint8(crf_frames(gen, b, max(h, w), block=8))
    return crf_ops.pixel_features(rgb[:, :h, :w].contiguous(), 60.0, 5.0, (scale, scale))


# crf_filter on the card against its plain version and against a float64
# filter, with TF32 matmuls and convolutions switched on (neither side may
# depend on the switch): the max abs error of each set of ``crf_filter_sets``
# (the filtered values lie in [0, 1]). Each logit cancels half-norms of ~1e3
# (srgb 5), so both sides carry ~1e-4 of f32 rounding in it; on the
# structured sets each side reads <= 3.6e-5 from a float64 filter, <= 5.0e-5
# from the other (an H100 80GB HBM3 at 700 W); the i.i.d. set, whose pixels
# have few near neighbours, reads up to 1.4e-4 from float64 on the CPU. The
# kernel's split-TF32 logits of centred features read <= 1.5e-5 from float64
# on the structured sets and 3.6e-5 on the i.i.d. one, 1.4e-4 from the plain
# version there (an H100 80GB HBM3 at 700 W).
CRF_TOL = {"davis": 2e-4, "iid": 1e-3, "ragged": 2e-4, "d2": 2e-4, "stv2": 2e-4}


def crf_filter_sets(gen) -> dict:
    """name -> (feat, values) on ``gen``'s device: the DAVIS grid (16 images of
    96^2, xy_scale 1/4), i.i.d. features at its scales (x, y in [0, 96/15),
    colours / 5 in [0, 51)), a ragged N (3 images of 97 x 61), D = 2 (xy
    features at sxy 3 on 96^2) and the SegTrackv2 grid (16 of 128^2, 1/3)."""
    dev, n = gen.device, 96 * 96
    iid = torch.cat([torch.rand(16, n, 2, generator=gen, device=dev) * (96 / 15),
                     torch.rand(16, n, 3, generator=gen, device=dev) * 51.0], dim=-1)
    feats = {"davis": crf_features(gen, 16, 96, 96, 0.25), "iid": iid,
             "ragged": crf_features(gen, 3, 97, 61, 0.25),
             "d2": crf_ops.xy_features(96, 96, 3.0, device=dev).expand(16, -1, -1).contiguous(),
             "stv2": crf_features(gen, 16, 128, 128, 1 / 3)}
    return {k: (f, torch.rand(f.shape[:2], generator=gen, device=dev)) for k, f in feats.items()}


def crf_filter_f64(feat, values, chunk: int = 512):
    """The filter in float64 (exp of exact-enough logits): the accuracy yardstick."""
    f, v = feat.double(), values.double()
    sq = (f * f).sum(-1) * 0.5
    out = []
    for c in range(0, f.shape[1], chunk):
        w = torch.exp(f[:, c:c + chunk] @ f.transpose(1, 2) - sq[:, None, :]
                      - sq[:, c:c + chunk, None])
        out.append((w * v[:, None, :]).sum(-1) / w.sum(-1))
    return torch.cat(out, dim=1).float()


# ---------------------------------------------------------------- dino_attention

# name -> (images, tokens, heads, head dim, spread of q, k and v, padding tokens):
# one frame of the DINO cell (vit_small/8 at 480 x 856) and moco_vit_small/16's
# head dim, at spreads 1 and 2 (2 makes the scores' spread 4: sharper
# weights); ragged N under a key tile, around one query warpgroup (64) and one
# block (128) at both head dims: the masked key tail and the unstored query
# rows, two images of 3 heads whose image stride runs past the view (3
# padding tokens).
ATTENTION_SETS = {"cell": (1, 6421, 6, 64, 1.0, 0), "cell_sharp": (1, 6421, 6, 64, 2.0, 0),
                  "moco": (1, 1591, 12, 32, 1.0, 0), "moco_sharp": (1, 1591, 12, 32, 2.0, 0),
                  **{f"ragged_{n}_{hd}": (2, n, 3, hd, 2.0, 3)
                     for n in (1, 63, 65, 129) for hd in (32, 64)}}


def attention_qkv(b, n, heads, hd, scale=1.0, seed=0, device="cpu", pad_tokens=0):
    """A [b, n, 3, heads, hd] view of a linear-like output [b, n + pad, 3 heads hd]:
    i.i.d. N(0, scale^2), the image stride past the view's tokens when padded."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((b, n + pad_tokens, 3 * heads * hd), generator=g) * scale
    return full.to(device)[:, :n].reshape(b, n, 3, heads, hd)


def attention_inputs(name: str, device="cuda"):
    """The qkv of the set ``name`` of ``ATTENTION_SETS``."""
    b, n, heads, hd, scale, pad = ATTENTION_SETS[name]
    return attention_qkv(b, n, heads, hd, scale, seed=n + hd, device=device, pad_tokens=pad)


def attention_gap(ours: torch.Tensor, qkv: torch.Tensor) -> float:
    """The largest |o - o64| over the largest |o64| of the call, against the
    plain attention in float64."""
    ref = ak.dino_attention_plain(qkv.double())
    return float((ours.double() - ref).abs().max() / ref.abs().max())


# ---------------------------------------------------------------- dino_linear

# name -> (rows, K, N, GELU, residual): the DINO cell's four linears at its
# M = 8 x 6,421 (vit_small/8 at 480 x 856: qkv, proj with the residual, fc1
# with GELU, fc2 with the residual); vit_base's widths (768 -> 2,304, 768 ->
# 3,072 with GELU, 3,072 -> 768 with the residual) at one frame; ragged M
# (1, 127 and 6,421 rows: under one tile, one short of it, a frame) with
# both epilogues. The cell's M is ragged too: 401 tiles of 128 and 40 rows.
LINEAR_SETS = {"qkv": (51368, 384, 1152, False, False), "proj": (51368, 384, 384, False, True),
               "fc1": (51368, 384, 1536, True, False), "fc2": (51368, 1536, 384, False, True),
               "base_qkv": (6421, 768, 2304, False, False),
               "base_fc1": (6421, 768, 3072, True, False),
               "base_fc2": (6421, 3072, 768, False, True),
               **{f"ragged_{m}": (m, 384, 1536, True, True) for m in (1, 127, 6421)}}


def linear_inputs(name: str, device="cuda") -> dict:
    """The keyword arguments of ``dino_linear`` for the set ``name``: x ~ N(0, 1)
    (a LayerNorm's output), weight ~ N(0, 1 / K) (a trained linear's scale),
    bias ~ N(0, 0.1^2), residual ~ N(0, 1); made on ``device`` from a seed."""
    m, k, n, gelu, res = LINEAR_SETS[name]
    g = torch.Generator(device=device).manual_seed(m + k + n)
    args = {"x": torch.randn((m, k), generator=g, device=device),
            "weight": torch.randn((n, k), generator=g, device=device) * k ** -0.5,
            "bias": torch.randn((n,), generator=g, device=device) * 0.1, "gelu": gelu}
    if res:
        args["residual"] = torch.randn((m, n), generator=g, device=device)
    return args


def linear_gap(ours: torch.Tensor, args: dict) -> float:
    """The largest |y - y64| over the largest |y64| of the call, against the
    plain linear, GELU and residual add in float64."""
    ref = lk.dino_linear_plain(**{k: v.double() if torch.is_tensor(v) else v
                                  for k, v in args.items()})
    return float((ours.double() - ref).abs().max() / ref.abs().max())
