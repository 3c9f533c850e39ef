"""DINO's linears: CUDA build, ctypes binding, wrapper.

``dino_linear(x [.., K] f32, weight [N, K], bias [N], *, gelu=False,
residual=None) -> [.., N] f32`` is ``act(x weight^T + bias) (+ residual)``,
the ViT blocks' ``qkv``, ``proj``, ``fc1`` (with exact GELU) and ``fc2``
(``nn/dino_vit.py``; ``proj`` and ``fc2`` with the block's residual stream),
in one call.

It replaces XLA code of the JAX package (``rcf_tpu/nn/dino_vit.py``: dense
layers, GELU and adds), not a TPU kernel. The hand-written kernel
(``csrc/linear.cu``) forms the products on the tensor cores in split TF32:
each operand is split into two TF32 parts and each product is three TF32
products, which keeps float32 accuracy; the bias, GELU and residual add are
its epilogue. Its source note gives the schedule and the accuracy argument.
``dino_linear_plain`` is ``F.linear``, ``F.gelu`` and ``+`` as the ViT ran
them before, which the CPU takes.

The wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises (another width, layout or type).
Each call launches two kernels, each counted: ``LAUNCHES["dino_linear_split"]``
(the weight's split into scratch, freed when the call returns) and
``LAUNCHES["dino_linear"]`` (the product and epilogue), 45 each a ViT-S/8
call with ``return_last_k``. Every caller runs the ViT without gradients: an
input that requires one raises. ``LIB``, a ``cuda_build.Library``, builds
``csrc/linear.cu`` at the first launch.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from . import cuda_build
from .cuda_build import CSRC_DIR

SOURCES = ("linear.cu",)
ROWS, COLS, SLICE = 128, 128, 48  # csrc/linear.cu's kRows, kCols and kSlice
IN_FEATURES = (384, 768, 1536, 3072)  # K: every DinoViT width
OUT_FEATURES = (384, 768, 1152, 1536, 2304, 3072)  # N
M_LIMIT = 2**31 - 1 - ROWS  # rows: 32-bit indices in the kernel

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIB = cuda_build.Library("librcf_linear", SOURCES,
                         {"rcf_dino_linear_split": [_P, _P, _I32, _I32, _P],
                          "rcf_dino_linear": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P]},
                         ("dino_linear", "dino_linear_split"))
LAUNCHES = LIB.launches
reset_launch_counts = LIB.reset


def scratch_bytes(n_out: int, k: int) -> int:
    """The split pass's scratch: the weight's two TF32 parts, 4 bytes an element."""
    return 2 * n_out * k * 4


def dino_linear_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                      gelu: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
    """The ViT's linear, GELU and residual add as separate operations."""
    out = F.linear(x, weight, bias)
    if gelu:
        out = F.gelu(out, approximate="none")
    return out if residual is None else residual + out


def dino_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, gelu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(x weight^T + bias) (+ residual)``: x [.., K], weight [N, K], bias
    [N], residual [.., N] -> [.., N]. On the card: f32, K in ``IN_FEATURES``, N
    in ``OUT_FEATURES``, every tensor contiguous and x and weight 16-byte
    aligned (as nn.Linear's parameters and fresh activations are); anything
    else raises."""
    tensors = (x, weight, bias) + (() if residual is None else (residual,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("dino_linear is forward only: an input requires grad "
                         "(run the ViT under torch.no_grad())")
    if weight.dim() != 2 or bias.shape != weight.shape[:1] or x.shape[-1:] != weight.shape[1:]:
        raise ValueError(f"dino_linear takes x [.., K], weight [N, K] and bias [N]; got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    n_out, k = weight.shape
    if residual is not None and residual.shape != (*x.shape[:-1], n_out):
        raise ValueError(f"dino_linear: residual {tuple(residual.shape)} is not "
                         f"{(*x.shape[:-1], n_out)}")
    if cuda_build.check_device("dino_linear", *tensors) == "cpu":
        return dino_linear_plain(x, weight, bias, gelu=gelu, residual=residual)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"dino_linear takes float32 on the card, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if k not in IN_FEATURES or n_out not in OUT_FEATURES:
        raise ValueError(f"dino_linear is compiled for K in {IN_FEATURES} and N in "
                         f"{OUT_FEATURES}, got K {k}, N {n_out}")
    if (not all(t.is_contiguous() for t in tensors) or x.data_ptr() % 16 or weight.data_ptr() % 16
            or bias.data_ptr() % 8 or (residual is not None and residual.data_ptr() % 8)):
        raise ValueError("dino_linear needs contiguous tensors, x and weight 16-byte aligned, "
                         "bias and residual 8-byte aligned")
    m = x.numel() // k
    if m > M_LIMIT:
        raise ValueError(f"dino_linear takes at most {M_LIMIT} rows, got {m}")
    out = torch.empty((*x.shape[:-1], n_out), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    parts = torch.empty(scratch_bytes(n_out, k), dtype=torch.uint8, device=x.device)
    LIB.launch("dino_linear_split", "rcf_dino_linear_split", x.device, weight.data_ptr(),
               parts.data_ptr(), n_out, k)
    LIB.launch("dino_linear", "rcf_dino_linear", x.device, x.data_ptr(), parts.data_ptr(),
               bias.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
               m, n_out, k, int(gelu))
    return out
