"""DINO's attention: CUDA build, ctypes binding, wrapper.

``dino_attention(qkv [B, N, 3, heads, hd] f32) -> [B, N, heads hd] f32`` is
the ViT block's attention, softmax(q k^T / sqrt(hd)) v for each image and
head, with q, k and v the three slices of the ``qkv`` linear's output as it
lies (``nn/dino_vit.py::Attention``), and the heads' outputs side by side in
the layout the projection reads.

It replaces XLA code of the JAX package (``rcf_tpu/nn/dino_vit.py``: product,
softmax, product), not a TPU kernel. The hand-written kernel
(``csrc/attention.cu``, hd 64 and 32) keeps the scores in registers (an
online softmax over tiles of keys) and forms the products on the tensor
cores in split TF32: each operand is split into two TF32 parts and each
product is three TF32 products, which keeps float32 accuracy; its source note
gives the schedule and the accuracy argument. ``dino_attention_plain`` is the
three-step form the ViT ran before, with the same arithmetic, which the CPU
takes.

The wrapper takes the plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises (another head dim, layout or type),
and adds one to ``LAUNCHES["dino_attention"]`` a call. Every caller runs the
ViT without gradients: an input that requires one raises. ``LIB``, a
``cuda_build.Library``, builds ``csrc/attention.cu`` at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import CSRC_DIR

SOURCES = ("attention.cu",)
HEAD_DIMS = (32, 64)  # the compiled instances
KEYS = 32  # keys a tile of the split pass (csrc/attention.cu's kKeys)
GRID_Y_LIMIT = 65535  # images x heads a call at most
N_LIMIT = 2**31 - 2 * KEYS  # tokens: 32-bit indices in the kernel

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIB = cuda_build.Library("librcf_attention", SOURCES,
                         {"rcf_dino_attention": [_P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I64,
                                                 _P]},
                         ("dino_attention",))
LAUNCHES = LIB.launches
reset_launch_counts = LIB.reset


def scratch_bytes(b: int, n: int, heads: int, hd: int) -> int:
    """The split pass's scratch: four TF32 parts (K hi, K lo, V^T hi, V^T lo) of
    every tile of ``KEYS`` keys of every (image, head), 4 bytes an element."""
    return b * heads * (-(-n // KEYS)) * 4 * KEYS * hd * 4


def dino_attention_plain(qkv: torch.Tensor) -> torch.Tensor:
    """The ViT's three-step attention: scores, scaled softmax, weighted values."""
    b, n, _, heads, hd = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, heads, N, hd]
    attn = torch.softmax((q @ k.transpose(-2, -1)) * (hd ** -0.5), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, heads * hd)


def dino_attention(qkv: torch.Tensor) -> torch.Tensor:
    """Attention of ``qkv`` [B, N, 3, heads, hd] (the ``qkv`` linear's output,
    viewed) -> [B, N, heads hd]. On the card: f32, hd in ``HEAD_DIMS``, the last
    three dimensions contiguous, the image and token strides multiples of 4
    elements and the data 16-byte aligned (a view of a contiguous linear
    output is); anything else raises."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, N, 3, heads, hd], got {tuple(qkv.shape)}")
    if qkv.requires_grad:
        raise ValueError("dino_attention is forward only: qkv requires grad "
                         "(run the ViT under torch.no_grad())")
    if cuda_build.check_device("dino_attention", qkv) == "cpu":
        return dino_attention_plain(qkv)
    b, n, _, heads, hd = qkv.shape
    if qkv.dtype != torch.float32:
        raise ValueError(f"dino_attention takes float32 on the card, got {qkv.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"dino_attention is compiled for head dims {HEAD_DIMS}, got {hd}")
    sb, sn, s3, sh, sd = qkv.stride()
    if (s3, sh, sd) != (heads * hd, hd, 1) or (sb % 4) or (sn % 4) or qkv.data_ptr() % 16:
        raise ValueError(f"dino_attention needs [3, heads, hd] contiguous, strides over images "
                         f"and tokens multiples of 4 and 16-byte aligned data; got strides "
                         f"{qkv.stride()}")
    if b * heads > GRID_Y_LIMIT or n > N_LIMIT:
        raise ValueError(f"dino_attention takes at most {GRID_Y_LIMIT} images x heads of "
                         f"{N_LIMIT} tokens, got {b} x {heads} of {n}")
    out = torch.empty((b, n, heads * hd), dtype=torch.float32, device=qkv.device)
    parts = torch.empty(scratch_bytes(b, n, heads, hd), dtype=torch.uint8, device=qkv.device)
    LIB.launch("dino_attention", "rcf_dino_attention", qkv.device, qkv.data_ptr(), out.data_ptr(),
               parts.data_ptr(), b, n, heads, hd, sb, sn)
    return out
