"""The dense CRF's mean-field filter: CUDA build, ctypes binding, wrapper.

``crf_filter(feat [B,N,D] f32, values [B,N] f32) -> [B,N] f32`` is the
exact normalized Gaussian filter of one mean-field iteration:

    out[b,i] = sum_j exp(l_ij) v[b,j] / sum_j exp(l_ij),
    l_ij = f_i . f_j - |f_i|^2/2 - |f_j|^2/2,

the self term included. It replaces XLA code of the JAX package
(``rcf_tpu/ops/crf.py::_normalized_filter``), not a TPU kernel. The
hand-written kernel (``csrc/crf.cu``, D = 5 and D = 2) keeps no N x N
buffer: the logits come from tensor cores in split TF32 (each operand
centred, then split into two TF32 parts, three products), the weights
from ``ex2``, the sums in f32; its source note gives the accuracy
argument. ``crf_filter_plain`` is the same function as JAX's chunked
attention, batched, which the CPU takes.

The wrapper takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises, and adds one to
``LAUNCHES["crf_filter"]`` where it launches. The library is built by
``cuda_build`` from ``csrc/crf.cu`` at the first launch (or ``build()``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import CSRC_DIR

SOURCES = ("crf.cu",)
_STEM = "librcf_crf"
FEATURE_DIMS = (2, 5)  # the compiled instances: xy features, and xy + rgb
GRID_Z_LIMIT = 65535  # the batch rides the launch grid's z
N_LIMIT = 2**31 - 256  # query blocks and key stages of 256, 32-bit pixel indices

LAUNCHES = {"crf_filter": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES["crf_filter"] = 0


def build(csrc_dir: str = CSRC_DIR) -> str:
    """Compile crf.cu if this source hash has not been built; returns the .so path."""
    return cuda_build.build(_STEM, SOURCES, csrc_dir)


def build_patched(replacements, tag: str) -> str:
    """Build a changed copy of crf.cu (``cuda_build.build_patched``) in ``build/<tag>/``."""
    return cuda_build.build_patched(_STEM, SOURCES, replacements, tag)


def load_library(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    lib.rcf_crf_filter.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, p]
    lib.rcf_crf_filter.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = load_library(build())
    return _lib


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
    cuda_build.launch(LAUNCHES, "crf_filter", _load().rcf_crf_filter, feat.device,
                      feat.data_ptr(), values.data_ptr(), out.data_ptr(), b, n, d)
    return out
