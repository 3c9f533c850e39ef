#!/usr/bin/env python3
"""How far faults planted in the kernels move chip_smoke.py's reference check.

    python3 tools/smoke_fault_check.py

The reference check holds the AMD forward and a flownet weight gradient,
and the unFlow loss and its flow gradient, on the card against the port's
plain CPU path (small inputs, TF32 off). This script computes the CPU side
once, then the card side sound and with one fault at a time planted in a
kernel wrapper (CUDA tensors only, so the CPU side stays plain):

* ``warp_bwd_swap``: dcx and dcy exchanged;
* ``warp_bwd_no_dhat``: the one-sided derivative where a coordinate is an
  exact integer (the clamped border) instead of the TPU kernel's 0;
* ``warp_fwd_shift``: samples taken half a pixel to the right;
* ``splat_mirror``: each splat corner given its horizontal neighbour's weight.

Prints each case's readings beside chip_smoke's limits and which of them
catch it, then one JSON line. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from rcf_tpu_torch.ops import warp as warp_ops
    from rcf_tpu_torch.ops import warp_kernels as wk

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    fwd, bwd, splat = wk.warp_fwd, wk.warp_bwd, wk.splat

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

    faults = {"sound": {}, "warp_bwd_swap": {"warp_bwd": bwd_swap},
              "warp_bwd_no_dhat": {"warp_bwd": bwd_no_dhat},
              "warp_fwd_shift": {"warp_fwd": fwd_shift}, "splat_mirror": {"splat": splat_mirror}}
    cpu = cs.reference_forward(torch, "cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {smi}; limits {cs.REF_LIMITS}")
    out = {}
    for case, patch in faults.items():
        for name, fn in patch.items():
            setattr(wk, name, fn)
            if name == "splat":
                warp_ops.splat = fn
        try:
            errs = cs.reference_errors(cpu, cs.reference_forward(torch, "cuda"))
        finally:
            wk.warp_fwd, wk.warp_bwd, wk.splat = fwd, bwd, splat
            warp_ops.splat = splat
        out[case] = {**errs, "caught_by": cs.reference_failures(errs)}
        print(f"{case:17s} " + "  ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"  caught by {out[case]['caught_by'] or 'nothing'}")
    print(json.dumps({"device": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
