"""The warp and splat kernels: CUDA build, ctypes binding, wrappers.

Four hand-written CUDA kernels (``csrc/warp.cu``) replace the TPU kernels
of ``rcf_tpu/ops/pallas/warp_pallas.py``:

* ``warp_fwd``  <- ``_warp_fwd_kernel``: bilinear sample of ``img``
  [B,H,W,C] at absolute f32 coordinates ``cx``, ``cy`` [B,H,W] with
  ``grid_sample(align_corners=True, padding_mode="zeros")`` semantics
  (out-of-image taps weigh 0; "border" is the caller clamping first);
* ``warp_bwd``  <- ``_warp_bwd_kernel_nodimg``: ``dcx``, ``dcy`` from the
  output cotangent, forward recomputed, derivative 0 at exact-integer
  coordinates (the TPU kernel's ``_dhat``); no image cotangent;
* ``warp_bwd_dimg`` <- ``_warp_bwd_kernel``: ``warp_bwd``'s ``dcx``, ``dcy``
  plus the image cotangent ``dimg``, an f32 overlap-add of ``g`` times the
  bilinear weights into the source taps, returned in the image's dtype;
* ``splat``     <- ``_splat_kernel``: forward bilinear splat of ones at
  ``(tx, ty)`` into an f32 density, out-of-range corners dropped.

The two overlap-adds accumulate each block's taps in a window of shared
memory and add it to device memory once; a tap outside the window goes
straight to device memory (``warp.cu``). A test build counts the taps of
each branch (``LIB.patched(COUNT_TAPS, tag)``, ``tap_counts``).

Beside each kernel is its plain PyTorch version (``*_plain``), the same
function in tensor code. A wrapper takes the plain version only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.
Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel.

Every kernel offsets inside one [H, W, C] plane in 32 bits and puts the
batch in the launch grid's z: each wrapper raises, on every device, for a
plane of more than 2^31 - 1 elements or a shape the grid cannot hold.

Build: ``LIB``, a ``cuda_build.Library``, compiles ``csrc/warp.cu`` for
``sm_90a`` into a shared library with a plain C interface, under
``rcf_tpu_torch/build/``, named by a hash of the sources and flags, at the
first launch. No PyTorch headers, no ninja: a few seconds.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import CSRC_DIR

SOURCES = ("warp.cu",)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIB = cuda_build.Library(
    "librcf_warp", SOURCES,
    {**dict.fromkeys(("rcf_warp_fwd_f32", "rcf_warp_fwd_bf16"),
                     [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P]),
     **dict.fromkeys(("rcf_warp_bwd_f32", "rcf_warp_bwd_bf16"),
                     [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P]),
     **dict.fromkeys(("rcf_warp_bwd_dimg_f32", "rcf_warp_bwd_dimg_bf16"),
                     [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P]),
     "rcf_splat": [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
     "rcf_tap_counts": [_P, _I32]},
    ("warp_fwd", "warp_bwd", "warp_bwd_dimg", "splat"))
LAUNCHES = LIB.launches
reset_launch_counts = LIB.reset

# The test build's change to warp.cu: count the taps of each overlap-add branch.
COUNT_TAPS = (("constexpr bool kCountTaps = false;", "constexpr bool kCountTaps = true;"),)


def tap_counts(lib: ctypes.CDLL, reset: bool = True) -> tuple[int, int]:
    """(taps added in the shared window, taps added straight to device memory)
    since the last reset, from a library built with ``COUNT_TAPS``; a release
    build reads (0, 0). Call after the launches have finished."""
    out = (ctypes.c_ulonglong * 2)()
    err = lib.rcf_tap_counts(ctypes.cast(out, ctypes.c_void_p), int(reset))
    if err != 0:
        raise RuntimeError(f"rcf_tap_counts failed: cudaError {err}")
    return int(out[0]), int(out[1])


def _check_warp(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> None:
    if img.dim() != 4 or img.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"img must be [B,H,W,C] float32/bfloat16, got {tuple(img.shape)} {img.dtype}")
    if cx.shape != img.shape[:3] or cy.shape != img.shape[:3]:
        raise ValueError(f"cx/cy must be {tuple(img.shape[:3])}, got {tuple(cx.shape)}, {tuple(cy.shape)}")
    if cx.dtype != torch.float32 or cy.dtype != torch.float32:
        raise ValueError("cx/cy must be float32")


# The kernels index inside one plane with 32-bit offsets, and launch one block
# per tile of TILE_ROWS rows, with the batch in the grid's z: the grid's y and z
# stop at GRID_YZ_LIMIT.
PLANE_LIMIT = 2**31 - 1
GRID_YZ_LIMIT = 65535
TILE_ROWS = 8  # warp.cu's kTY
SPLAT_TILE_ROWS = 32  # kTY * kSplatShape.pixels


def _check_launch(name: str, b: int, h: int, plane: int, tile_rows: int = TILE_ROWS) -> None:
    """b planes of h rows in tiles of ``tile_rows``, the largest plane (in or out) of
    ``plane`` elements."""
    if plane > PLANE_LIMIT:
        raise ValueError(f"{name}: a plane of {plane} elements does not fit the kernel's 32-bit "
                         f"offsets (at most {PLANE_LIMIT})")
    if b > GRID_YZ_LIMIT or -(-h // tile_rows) > GRID_YZ_LIMIT:
        raise ValueError(f"{name}: B = {b} planes of H = {h} rows exceed the kernel's launch "
                         f"grid (at most {GRID_YZ_LIMIT} planes and "
                         f"{GRID_YZ_LIMIT * tile_rows} rows)")


def _check_grid(name: str, img: torch.Tensor) -> None:
    b, h, w, c = img.shape
    _check_launch(name, b, h, h * w * c)


def _suffix(img: torch.Tensor) -> str:
    """The entry points' suffix of the image's dtype."""
    return "f32" if img.dtype == torch.float32 else "bf16"


# ---------------------------------------------------------------- plain versions

def _taps(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Tap offsets, validity and fractions of a bilinear sample at (x, y)."""
    xf, yf = torch.floor(x), torch.floor(y)
    ax, ay = x - xf, y - yf
    vx0 = (xf >= 0) & (xf <= w - 1)
    vx1 = (xf >= -1) & (xf <= w - 2)
    vy0 = (yf >= 0) & (yf <= h - 1)
    vy1 = (yf >= -1) & (yf <= h - 2)
    xi = torch.where(vx0 | vx1, xf, torch.zeros_like(xf)).long()
    yi = torch.where(vy0 | vy1, yf, torch.zeros_like(yf)).long()
    o00 = yi * w + xi
    offs = (o00, o00 + 1, o00 + w, o00 + w + 1)
    valid = (vy0 & vx0, vy0 & vx1, vy1 & vx0, vy1 & vx1)
    return offs, valid, ax, ay


def _gather4(img: torch.Tensor, offs, valid):
    """The four tap values [B,H,W,C] f32 each, 0 where the tap is outside."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    vals = []
    for off, ok in zip(offs, valid):
        idx = off.clamp(0, h * w - 1).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(b, h, w, c).float()
        vals.append(torch.where(ok[..., None], v, torch.zeros_like(v)))
    return vals


def warp_fwd_plain(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[1:3]
    offs, valid, ax, ay = _taps(cx, cy, h, w)
    v00, v01, v10, v11 = _gather4(img, offs, valid)
    ax, ay = ax[..., None], ay[..., None]
    top = v00 * (1 - ax) + v01 * ax
    bot = v10 * (1 - ax) + v11 * ax
    return (top * (1 - ay) + bot * ay).to(img.dtype)


def warp_bwd_plain(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                   g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h, w = img.shape[1:3]
    offs, valid, ax, ay = _taps(cx, cy, h, w)
    v00, v01, v10, v11 = _gather4(img, offs, valid)
    gf = g.float()
    axe, aye = ax[..., None], ay[..., None]
    sx = (gf * ((1 - aye) * (v01 - v00) + aye * (v11 - v10))).sum(-1)
    sy = (gf * ((1 - axe) * (v10 - v00) + axe * (v11 - v01))).sum(-1)
    zero = torch.zeros_like(sx)
    return torch.where(ax == 0, zero, sx), torch.where(ay == 0, zero, sy)


def warp_bwd_dimg_plain(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                        g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, h, w, c = img.shape
    offs, valid, ax, ay = _taps(cx, cy, h, w)
    gf = g.float().reshape(b, h * w, c)
    weights = ((1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax)
    dimg = torch.zeros(b, h * w, c, dtype=torch.float32, device=img.device)
    for off, ok, wt in zip(offs, valid, weights):
        idx = off.clamp(0, h * w - 1).reshape(b, -1, 1).expand(-1, -1, c)
        wt = torch.where(ok, wt, torch.zeros_like(wt)).reshape(b, -1, 1)
        dimg.scatter_add_(1, idx, gf * wt)
    dcx, dcy = warp_bwd_plain(img, cx, cy, g)
    return dimg.reshape(b, h, w, c).to(img.dtype), dcx, dcy


def splat_plain(tx: torch.Tensor, ty: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = tx.shape[0]
    offs, valid, ax, ay = _taps(tx, ty, h, w)
    weights = ((1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax)
    out = torch.zeros(b, h * w, dtype=torch.float32, device=tx.device)
    for off, ok, wt in zip(offs, valid, weights):
        out.scatter_add_(1, off.clamp(0, h * w - 1).reshape(b, -1),
                         torch.where(ok, wt, torch.zeros_like(wt)).reshape(b, -1))
    return out.reshape(b, h, w)


# ---------------------------------------------------------------- wrappers

def warp_fwd(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [B,H,W,C] at absolute cx, cy [B,H,W] -> [B,H,W,C]."""
    _check_warp(img, cx, cy)
    _check_grid("warp_fwd", img)
    if cuda_build.check_device("warp_fwd", img, cx, cy) == "cpu":
        return warp_fwd_plain(img, cx, cy)
    img, cx, cy = img.contiguous(), cx.contiguous(), cy.contiguous()
    out = torch.empty_like(img)
    b, h, w, c = img.shape
    LIB.launch("warp_fwd", f"rcf_warp_fwd_{_suffix(img)}", img.device, img.data_ptr(),
               cx.data_ptr(), cy.data_ptr(), out.data_ptr(), b * h * w, h, w, c)
    return out


def warp_bwd(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
             g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """d(sum g * warp_fwd(img, cx, cy)) / d(cx, cy), each [B,H,W] f32."""
    _check_warp(img, cx, cy)
    _check_grid("warp_bwd", img)
    if g.shape != img.shape:
        raise ValueError(f"g must be {tuple(img.shape)}, got {tuple(g.shape)}")
    g = g.to(img.dtype)
    if cuda_build.check_device("warp_bwd", img, cx, cy, g) == "cpu":
        return warp_bwd_plain(img, cx, cy, g)
    img, cx, cy, g = img.contiguous(), cx.contiguous(), cy.contiguous(), g.contiguous()
    dcx = torch.empty_like(cx)
    dcy = torch.empty_like(cy)
    b, h, w, c = img.shape
    LIB.launch("warp_bwd", f"rcf_warp_bwd_{_suffix(img)}", img.device, img.data_ptr(),
               cx.data_ptr(), cy.data_ptr(), g.data_ptr(), dcx.data_ptr(), dcy.data_ptr(),
               b * h * w, h, w, c)
    return dcx, dcy


def warp_bwd_dimg(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """d(sum g * warp_fwd(img, cx, cy)) / d(img, cx, cy): dimg in img's dtype, dcx, dcy f32."""
    _check_warp(img, cx, cy)
    _check_grid("warp_bwd_dimg", img)
    if g.shape != img.shape:
        raise ValueError(f"g must be {tuple(img.shape)}, got {tuple(g.shape)}")
    g = g.to(img.dtype)
    if cuda_build.check_device("warp_bwd_dimg", img, cx, cy, g) == "cpu":
        return warp_bwd_dimg_plain(img, cx, cy, g)
    img, cx, cy, g = img.contiguous(), cx.contiguous(), cy.contiguous(), g.contiguous()
    # The kernel overlap-adds into dimg with f32 atomics: it must start at zero.
    dimg = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    dcx = torch.empty_like(cx)
    dcy = torch.empty_like(cy)
    b, h, w, c = img.shape
    LIB.launch("warp_bwd_dimg", f"rcf_warp_bwd_dimg_{_suffix(img)}", img.device,
               img.data_ptr(), cx.data_ptr(), cy.data_ptr(), g.data_ptr(), dimg.data_ptr(),
               dcx.data_ptr(), dcy.data_ptr(), b * h * w, h, w, c)
    return dimg.to(img.dtype), dcx, dcy


def splat(tx: torch.Tensor, ty: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Splat ones at (tx, ty) [B,Hs,Ws] f32 into a density [B,h,w] f32."""
    if tx.dim() != 3 or tx.shape != ty.shape:
        raise ValueError(f"tx/ty must be one [B,H,W] shape, got {tuple(tx.shape)}, {tuple(ty.shape)}")
    if tx.dtype != torch.float32 or ty.dtype != torch.float32:
        raise ValueError("tx/ty must be float32")
    b, sh, sw = tx.shape
    _check_launch("splat", b, sh, max(sh * sw, h * w), SPLAT_TILE_ROWS)
    if cuda_build.check_device("splat", tx, ty) == "cpu":
        return splat_plain(tx, ty, h, w)
    tx, ty = tx.contiguous(), ty.contiguous()
    # The kernel overlap-adds into the density: it must start at zero.
    out = torch.zeros(b, h, w, dtype=torch.float32, device=tx.device)
    LIB.launch("splat", "rcf_splat", tx.device, tx.data_ptr(), ty.data_ptr(), out.data_ptr(),
               b * sh * sw, sh, sw, h, w)
    return out


class _Warp(torch.autograd.Function):
    """warp_fwd; its backward is warp_bwd_dimg where the image needs a gradient,
    else warp_bwd (the TPU package's ``need_dimg``, decided from the graph)."""

    @staticmethod
    def forward(ctx, img, cx, cy):
        ctx.save_for_backward(img, cx, cy)
        return warp_fwd(img, cx, cy)

    @staticmethod
    def backward(ctx, g):
        img, cx, cy = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            return warp_bwd_dimg(img, cx, cy, g)
        return (None, *warp_bwd(img, cx, cy, g))


def warp(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """warp_fwd, differentiable in (cx, cy), and in img where img requires a gradient."""
    return _Warp.apply(img, cx, cy)
