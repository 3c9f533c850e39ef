"""The dense CRF's mean-field filter: CUDA build, ctypes binding, wrapper.

``crf_filter(feat [B,N,D] f32, values [B,N] f32) -> [B,N] f32`` is the
exact normalized Gaussian filter of one mean-field iteration:

    out[b,i] = sum_j exp(l_ij) v[b,j] / sum_j exp(l_ij),
    l_ij = f_i . f_j - |f_i|^2/2 - |f_j|^2/2,

the self term included. It replaces XLA code of the JAX package
(``rcf_tpu/ops/crf.py::_normalized_filter``), not a TPU kernel. The
hand-written kernel (``csrc/crf.cu``, D = 5 and D = 2) keeps no N x N
buffer and forms each unordered pixel pair once: the pixels are cut into
tiles of ``TILE``, and each tile pair (I, J) with I <= J adds its weights
to its rows' sums and, off the diagonal, to its columns'. The logits come
from tensor cores in split TF32 (each operand centred, then split into two
TF32 parts, three products), the weights from ``ex2``, the sums in f32;
its source note gives the schedule and the accuracy argument.
``crf_filter_plain`` is the same function as JAX's chunked attention,
batched, which the CPU takes.

The wrapper takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises, and adds one to
``LAUNCHES["crf_filter"]`` and the logits the launch forms to
``STATS["pairs_evaluated"]`` (``schedule_pairs``; B N^2 to
``STATS["pairs_dense"]``) where it launches. ``LIB``, a
``cuda_build.Library``, builds ``csrc/crf.cu`` at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import CSRC_DIR

SOURCES = ("crf.cu",)
FEATURE_DIMS = (2, 5)  # the compiled instances: xy features, and xy + rgb
GRID_Z_LIMIT = 65535  # images a call at most
N_LIMIT = 2**31 - 256  # tiles of 256, 32-bit pixel indices
TILE = 256  # pixels a tile of the kernel's schedule (csrc/crf.cu's kTile)

_P = ctypes.c_void_p
LIB = cuda_build.Library("librcf_crf", SOURCES,
                         {"rcf_crf_filter": [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                                             ctypes.c_int, _P]},
                         ("crf_filter",))
LAUNCHES = LIB.launches
# The logits the launches formed (T^2 a tile pair of the schedule, ragged
# tiles at their padded size) and those of the dense filter (B N^2).
STATS = {"pairs_evaluated": 0, "pairs_dense": 0}

# device index -> (sums f32, done i64): the kernel's per-image accumulators
# and pair counters, zero between calls (the kernel leaves them so).
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launch_counts() -> None:
    LIB.reset()
    STATS["pairs_evaluated"] = STATS["pairs_dense"] = 0


def schedule_pairs(b: int, n: int) -> int:
    """The logits the kernel forms for ``b`` images of ``n`` pixels: T^2 for each
    tile pair (I, J), I <= J, of the nT = ceil(n / T) tiles an image."""
    nt = -(-n // TILE)
    return b * (nt * (nt + 1) // 2) * TILE * TILE


def _accumulators(device: torch.device, b: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's accumulators, grown to ``b`` images of ``n`` pixels. One set a
    device: calls on it run in stream order (the step's one stream)."""
    sums, done = _scratch.get(device.index, (None, None))
    if sums is None or sums.numel() < 2 * b * n or done.numel() < b:
        size = max(2 * b * n, 0 if sums is None else sums.numel())
        count = max(b, 0 if done is None else done.numel())
        sums = torch.zeros(size, dtype=torch.float32, device=device)
        done = torch.zeros(count, dtype=torch.int64, device=device)
        _scratch[device.index] = (sums, done)
    return sums, done


def crf_filter_plain(feat: torch.Tensor, values: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """``_normalized_filter`` of the JAX package for each image of a batch.

    The queries in chunks of ``chunk``; the keys padded to a multiple of it,
    the padded keys' half-norms sent to +inf so that they weigh 0. The logits
    are built from explicit per-dimension products, in f32 whatever the
    global TF32 switch says: the half-norms reach ~1e3 at the recipes'
    feature scales, where a TF32 product would move a logit by ~1.
    """
    b, n, d = feat.shape
    sq = (feat * feat).sum(-1) * 0.5  # [B, N]
    pad = (-n) % chunk
    feat_p = torch.nn.functional.pad(feat, (0, 0, 0, pad))
    sq_p = torch.nn.functional.pad(sq, (0, pad))
    val_p = torch.nn.functional.pad(values, (0, pad))
    key_sq = sq_p.clone()
    key_sq[:, n:] = torch.inf
    outs = []
    for c in range(0, n + pad, chunk):
        f_q, s_q = feat_p[:, c:c + chunk], sq_p[:, c:c + chunk]
        dots = f_q[:, :, None, 0] * feat_p[:, None, :, 0]
        for k in range(1, d):
            dots = dots + f_q[:, :, None, k] * feat_p[:, None, :, k]
        w = torch.exp(dots - key_sq[:, None, :] - s_q[:, :, None])  # [B, chunk, Np] <= 0
        outs.append((w * val_p[:, None, :]).sum(-1) / w.sum(-1))
    return torch.cat(outs, dim=1)[:, :n]


def crf_filter(feat: torch.Tensor, values: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The normalized Gaussian filter of ``values`` [B,N] over features ``feat``
    [B,N,D] (D in ``FEATURE_DIMS``), f32 -> [B,N] f32. ``chunk``: the plain
    version's query tiling (the CPU's); the kernel does not read it."""
    if feat.dim() != 3 or values.shape != feat.shape[:2]:
        raise ValueError(f"feat must be [B,N,D] and values [B,N], got {tuple(feat.shape)}, "
                         f"{tuple(values.shape)}")
    if feat.dtype != torch.float32 or values.dtype != torch.float32:
        raise ValueError("feat and values must be float32")
    b, n, d = feat.shape
    if d not in FEATURE_DIMS:
        raise ValueError(f"crf_filter is compiled for D in {FEATURE_DIMS}, got {d}")
    if b > GRID_Z_LIMIT or n > N_LIMIT:
        raise ValueError(f"crf_filter takes at most {GRID_Z_LIMIT} images of {N_LIMIT} pixels, "
                         f"got {b} of {n}")
    if cuda_build.check_device("crf_filter", feat, values) == "cpu":
        return crf_filter_plain(feat, values, chunk)
    feat, values = feat.contiguous(), values.contiguous()
    out = torch.empty_like(values)
    sums, done = _accumulators(feat.device, b, n)
    LIB.launch("crf_filter", "rcf_crf_filter", feat.device, feat.data_ptr(), values.data_ptr(),
               out.data_ptr(), sums.data_ptr(), done.data_ptr(), b, n, d)
    STATS["pairs_evaluated"] += schedule_pairs(b, n)
    STATS["pairs_dense"] += b * n * n
    return out
