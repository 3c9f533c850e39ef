#!/usr/bin/env python3
"""How far faults planted in the port move chip_smoke.py's card-vs-CPU checks.

    python3 tools/smoke_fault_check.py

chip_smoke's reference check holds the AMD forward and a flownet weight
gradient, the unFlow loss and its flow gradient (with either occlusion
mask), and the bf16 AMD forward on the card against the port's plain CPU
path (small inputs, TF32 off); its image-gradient check holds the flow
warp of the bidirectional occlusion mask and its gradients at the level-0
shape. This script computes the CPU sides once, then the card sides sound
and with one fault at a time planted at run time (CUDA tensors only, so
the CPU side stays plain):

* ``warp_bwd_swap``: dcx and dcy exchanged;
* ``warp_bwd_no_dhat``: the one-sided derivative where a coordinate is an
  exact integer (the clamped border) instead of the TPU kernel's 0;
* ``warp_fwd_shift``: samples taken half a pixel to the right;
* ``splat_mirror``: each splat corner given its horizontal neighbour's weight;
* ``dimg_mirror``: warp_bwd_dimg's image cotangent scattered to the
  horizontally mirrored taps;
* ``dimg_drop_corner``: warp_bwd_dimg's image cotangent without its
  (y0+1, x0+1) tap;
* ``grid_bf16``: PWC-Lite's feature warps sampling a bf16 map on a bf16
  grid, in bf16 (the grid cast that the port had before it kept f32).

Prints each case's readings beside chip_smoke's limits and which of them
catch it. Then faults in the CUDA source itself, each built from a changed
copy of ``csrc/`` under the gitignored ``rcf_tpu_torch/build/`` (the
repository's sources stay as they are):

* ``tail_dropped``: warp_fwd and warp_bwd leave out the pixels of a row past
  its last multiple of 4 (the last pixel of a 77-wide row), which the
  level-0 shape (640 wide) never shows; it prints chip_smoke's level-0 and
  ragged-shape kernel comparisons for it;
* ``direct_dropped``: the overlap-adds (splat, warp_bwd_dimg) drop every tap
  outside the block's shared-memory window instead of adding it to device
  memory;
* ``flush_tail_dropped``: the overlap-adds' flush leaves out the scalar quad
  at the tail of each window row;

for these two it prints the worst error of each of chip_smoke's
overlap-add comparisons (level 0, and ``check_overlap_add``'s sets) and
which catch it. Last, one JSON line. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# The thread-placement test of warp_fwd/warp_bwd, and the fault planted in it.
TAIL_FAULT = ("return x < w && y < h;", "return x < (w & ~3) && y < h;")
# The overlap-adds' device-memory branch for taps outside the window, and the
# scalar quads at the tail of each window row in the flush.
OVERLAP_FAULTS = {
    "direct_dropped": ("      for (int ch = 0; ch < cc; ++ch) atomicAdd(d + ch, val(ch) * wt[k]);\n", ""),
    "flush_tail_dropped": ("    if (q >= m && q + 4 <= m + width) {",
                           "    if (q + 4 > m + width) continue;\n    if (q >= m) {"),
}


def tail_fault(torch, cs, wk) -> dict:
    """chip_smoke's level-0 and ragged warp comparisons with the tail fault built in."""
    faulty = wk.load_library(wk.build_patched([TAIL_FAULT], "fault_tail"))
    sound, wk._lib = wk._load(), faulty
    try:
        gen = torch.Generator(device="cuda").manual_seed(1)
        img, cx, cy = cs.level0_inputs(torch, torch.float32, gen)
        g = torch.randn_like(img)
        level0 = {"warp_fwd": cs.max_err(wk.warp_fwd(img, cx, cy), wk.warp_fwd_plain(img, cx, cy)),
                  "warp_bwd": max(cs.max_err(a, b) for a, b in zip(
                      wk.warp_bwd(img, cx, cy, g), wk.warp_bwd_plain(img, cx, cy, g)))}
        try:
            cs.check_warp_ragged(torch, wk, gen)
            ragged = None
        except RuntimeError as e:
            ragged = str(e)
    finally:
        wk._lib = sound
    return {"level0_max_abs_err": level0, "ragged_caught": ragged}


def overlap_fault(torch, cs, wk, name: str, count_lib) -> dict:
    """chip_smoke's overlap-add comparisons with one of OVERLAP_FAULTS built in:
    the level-0 splat and warp_bwd_dimg (``check_warp_bwd_dimg``), then every set
    of ``check_overlap_add``. Returns {comparison: worst error} and the caught ones."""
    faulty = wk.load_library(wk.build_patched([OVERLAP_FAULTS[name]], f"fault_{name}"))
    sound, wk._lib = wk._load(), faulty
    worst, caught = {}, set()
    try:
        gen = torch.Generator(device="cuda").manual_seed(1)
        try:
            cs.check_warp_bwd_dimg(torch, wk, gen)
        except RuntimeError:
            caught.add("warp_bwd_dimg level0")
        _, tx, ty = cs.level0_inputs(torch, torch.float32, gen, b=2 * cs.B)
        e = cs.max_err(wk.splat(tx, ty, cs.H, cs.W), wk.splat_plain(tx, ty, cs.H, cs.W))
        worst["splat level0"] = e
        if not e <= cs.TOL[("splat", "float32")]:
            caught.add("splat level0")
        for r in cs.check_overlap_add(torch, wk, gen, count_lib):
            key = f"{r['kernel']} {r['set'].split(' ')[0]}"
            worst[key] = max(worst.get(key, 0.0), r["err"])
            if not r["err"] <= r["tol"]:
                caught.add(key)
    finally:
        wk._lib = sound
    return {"max_abs_err": worst, "caught_by": sorted(caught)}


def main() -> int:
    import torch

    import chip_smoke as cs
    from rcf_tpu_torch.ops import warp as warp_ops
    from rcf_tpu_torch.ops import warp_kernels as wk

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    fwd, bwd, splat = wk.warp_fwd, wk.warp_bwd, wk.splat
    bwd_dimg, grid_sample = wk.warp_bwd_dimg, warp_ops._grid_sample_nhwc

    def bwd_swap(img, cx, cy, g):
        dcx, dcy = bwd(img, cx, cy, g)
        return (dcy, dcx) if img.is_cuda else (dcx, dcy)

    def bwd_no_dhat(img, cx, cy, g):
        dcx, dcy = bwd(img, cx, cy, g)
        if not img.is_cuda:
            return dcx, dcy
        offs, valid, ax, ay = wk._taps(cx, cy, *img.shape[1:3])
        v00, v01, v10, v11 = wk._gather4(img, offs, valid)
        gf, axe, aye = g.float(), ax[..., None], ay[..., None]
        sx = (gf * ((1 - aye) * (v01 - v00) + aye * (v11 - v10))).sum(-1)
        sy = (gf * ((1 - axe) * (v10 - v00) + axe * (v11 - v01))).sum(-1)
        return torch.where(ax == 0, sx, dcx), torch.where(ay == 0, sy, dcy)

    def fwd_shift(img, cx, cy):
        return fwd(img, cx + 0.5, cy) if img.is_cuda else fwd(img, cx, cy)

    def splat_mirror(tx, ty, h, w):
        if tx.is_cuda:
            fl = torch.floor(tx)
            tx = torch.where(tx > fl, 2 * fl + 1 - tx, tx)
        return splat(tx, ty, h, w)

    def dimg_mirror(img, cx, cy, g):
        dimg, dcx, dcy = bwd_dimg(img, cx, cy, g)
        if img.is_cuda:
            fl = torch.floor(cx)
            dimg = bwd_dimg(img, torch.where(cx > fl, 2 * fl + 1 - cx, cx), cy, g)[0]
        return dimg, dcx, dcy

    def dimg_drop_corner(img, cx, cy, g):
        dimg, dcx, dcy = bwd_dimg(img, cx, cy, g)
        if not img.is_cuda:
            return dimg, dcx, dcy
        b, h, w, c = img.shape
        offs, valid, ax, ay = wk._taps(cx, cy, h, w)
        w11 = torch.where(valid[3], ay * ax, torch.zeros_like(ax)).reshape(b, -1, 1)
        idx = offs[3].clamp(0, h * w - 1).reshape(b, -1, 1).expand(-1, -1, c)
        corner = torch.zeros(b, h * w, c, device=img.device).scatter_add_(
            1, idx, g.float().reshape(b, -1, c) * w11)
        return (dimg.float() - corner.reshape(img.shape)).to(img.dtype), dcx, dcy

    def grid_bf16(img, x, y, pad):
        if not img.is_cuda:
            return grid_sample(img, x, y, pad)
        h, w = img.shape[1:3]
        grid = torch.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0], dim=-1)
        out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                            padding_mode=pad, align_corners=True)
        return out.permute(0, 2, 3, 1)

    faults = {"sound": {}, "warp_bwd_swap": {"warp_bwd": bwd_swap},
              "warp_bwd_no_dhat": {"warp_bwd": bwd_no_dhat},
              "warp_fwd_shift": {"warp_fwd": fwd_shift}, "splat_mirror": {"splat": splat_mirror},
              "dimg_mirror": {"warp_bwd_dimg": dimg_mirror},
              "dimg_drop_corner": {"warp_bwd_dimg": dimg_drop_corner},
              "grid_bf16": {"_grid_sample_nhwc": grid_bf16}}
    originals = {(wk, "warp_fwd"): fwd, (wk, "warp_bwd"): bwd, (wk, "splat"): splat,
                 (wk, "warp_bwd_dimg"): bwd_dimg, (warp_ops, "splat"): splat,
                 (warp_ops, "_grid_sample_nhwc"): grid_sample}
    cpu = cs.reference_forward(torch, "cpu")
    cpu_img = cs.image_grad_readings(torch, "cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {smi}; limits {cs.REF_LIMITS} {cs.IMG_LIMITS}")
    out = {}
    for case, patch in faults.items():
        for name, fn in patch.items():
            setattr(warp_ops if name == "_grid_sample_nhwc" else wk, name, fn)
            if name == "splat":
                warp_ops.splat = fn
        try:
            errs = cs.reference_errors(cpu, cs.reference_forward(torch, "cuda"))
            img_errs = cs.image_grad_errors(cpu_img, cs.image_grad_readings(torch, "cuda"))
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
        caught = cs.reference_failures(errs) + cs.image_grad_failures(img_errs)
        out[case] = {**errs, **img_errs, "caught_by": caught}
        print(f"{case:17s} " + "  ".join(f"{k} {v:.3e}" for k, v in {**errs, **img_errs}.items())
              + f"  caught by {caught or 'nothing'}", flush=True)
    tail = tail_fault(torch, cs, wk)
    print(f"tail_dropped      level-0 max_abs_err {tail['level0_max_abs_err']} (tol "
          f"{cs.TOL[('warp_fwd', 'float32')]}, {cs.TOL[('warp_bwd', 'float32')]}); ragged check: "
          + (tail["ragged_caught"] or "not caught"), flush=True)
    count_lib = wk.load_library(wk.build_patched(wk.COUNT_TAPS, "count_taps"))
    overlap = {}
    for name in OVERLAP_FAULTS:
        overlap[name] = r = overlap_fault(torch, cs, wk, name, count_lib)
        print(f"{name:17s} " + "  ".join(f"{k} {v:.3e}" for k, v in r["max_abs_err"].items())
              + f"  caught by {r['caught_by'] or 'nothing'}", flush=True)
    print(json.dumps({"device": smi, "cases": out, "tail_dropped": tail, **overlap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
