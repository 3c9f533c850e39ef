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
which catch it.

Then the stage-1 RCF step's card-vs-CPU check (``chip_smoke.rcf_reference_*``:
the DAVIS step's losses, mask probabilities, two weight gradients and the
EMA's increment, the affine WLS alone, the bf16 SegTrackv2 step's losses and
probabilities), sound and with one fault at a time planted at run time on
the card's side:

* ``quirk_true_log``: the entropy's ``quirk_log`` (a log-softmax of the
  probabilities, the reference's quirk) replaced by a true log;
* ``residual_bn_running``: the residual head's BN on running statistics
  (the model's ``train()`` puts it in eval mode) instead of batch statistics;
* ``ema_before_adam``: the train step moves the EMA before the Adam update;
* ``affine_solve_bf16``: the affine WLS solved on bf16-rounded systems,
  its result rounded to bf16, instead of in f32;
* ``softmax_f32``: the mask softmax computed in f32 and rounded to bf16 at
  the end, where JAX's bf16 softmax rounds step by step;
* ``stv2_in_f32``: the bf16 SegTrackv2 model run in f32 on the card (its
  probabilities f32), the fault a bf16 check that the convolutions' noise
  swamps would miss.

Then the stage-2.1 card-vs-CPU check (``chip_smoke.rcf_crf_reference_*``:
the CRF of each recipe on identical inputs, the DAVIS stage-2.1 step's
losses, gradient, EMA and EMA statistics, the SegTrackv2 step's losses),
sound and with one fault at a time planted at run time on the card's side:

* ``ema_train_mode``: the EMA copies left in training mode for the target
  (batch statistics, their running statistics moved);
* ``sxy_unscaled``: the spatial widths not scaled by the grid ratio;
* ``batch_wide_freeze``: with ``stable_exit``, every image run to the
  batch's last exit instead of frozen at its own;
* ``tf32_logits``: the filter's logits from a TF32 matrix product.

Last, two faults built into ``crf.cu`` (``crf_kernels.build_patched``, in
the gitignored ``rcf_tpu_torch/build/``), each read by chip_smoke's
``crf_kernel`` comparisons (``crf_kernel_readings``: kernel against the
plain version and against float64 on its five sets, ``CRF_TOL``) and by the
stage-2.1 card-vs-CPU check:

* ``lo_products_dropped``: the dot without its hi.lo and lo.hi products, a
  single TF32 dot;
* ``key_tail_dropped``: the keys of the last, partial key stage treated as
  padding (weight 0), which an N that is a multiple of the stage never shows.

Last, one JSON line. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def rcf_faults(torch, cs) -> dict:
    """chip_smoke's stage-1 readings, sound and with each planted fault."""
    import rcf_tpu_torch.train as train_pkg
    from rcf_tpu_torch.losses import common_fate, regularizers
    from rcf_tpu_torch.models.rcf import RCFModel
    import rcf_tpu_torch.models as models_pkg
    from rcf_tpu_torch.models import rcf as rcf_mod
    from rcf_tpu_torch.nn.layers import BatchNorm2d
    from rcf_tpu_torch.train.state import ema_update

    quirk_log, solve, rcf_train = regularizers.quirk_log, common_fate.solve, RCFModel.train
    softmax, build_model = rcf_mod.softmax, models_pkg.build_model

    def true_log(p, dim=-1):
        return torch.log(p) if p.is_cuda else quirk_log(p, dim)

    def residual_bn_running(self, mode=True):
        rcf_train(self, mode)
        if next(self.parameters()).is_cuda:
            for m in self.decode_head3.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def ema_before_adam():
        def train_step(state, batch, generator=None):
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            losses, _ = state.model(**batch, generator=generator)
            losses["loss"].backward()
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.step)
            if state.ema_m is not None:
                ema_update(state.model, state.ema_m)
            state.optimizer.step()
            state.step += 1
            return {k: v.detach() for k, v in losses.items()}
        return train_step

    def solve_bf16(a, b):
        if not a.is_cuda:
            return solve(a, b)
        return solve(a.bfloat16().float(), b.bfloat16().float()).bfloat16().float()

    def softmax_f32(x, dim=-1):
        return torch.softmax(x.float(), dim).to(x.dtype) if x.is_cuda else softmax(x, dim)

    def build_f32_on_card(model_kwargs, device="cuda", seed=0, dtype=torch.float32):
        return build_model(model_kwargs, device=device, seed=seed,
                           dtype=torch.float32 if torch.device(device).type == "cuda" else dtype)

    faults = {"sound": [],
              "quirk_true_log": [(regularizers, "quirk_log", true_log)],
              "residual_bn_running": [(RCFModel, "train", residual_bn_running)],
              "ema_before_adam": [(train_pkg, "make_train_step", ema_before_adam)],
              "affine_solve_bf16": [(common_fate, "solve", solve_bf16)],
              "softmax_f32": [(rcf_mod, "softmax", softmax_f32)],
              "stv2_in_f32": [(models_pkg, "build_model", build_f32_on_card)]}
    cpu = cs.rcf_reference_readings(torch, "cpu")
    out = {}
    for case, patches in faults.items():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            errs = cs.rcf_reference_errors(cpu, cs.rcf_reference_readings(torch, "cuda"))
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        caught = cs.rcf_reference_failures(errs)
        out[case] = {**errs, "caught_by": caught}
        print(f"rcf {case:19s} " + "  ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"  caught by {caught or 'nothing'}", flush=True)
    return out


# The split dot's two correction products, and the test that marks a stage's
# key as real, in crf.cu.
CRF_KERNEL_FAULTS = {
    "lo_products_dropped": [
        ("#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_lo[m], bh0, bh1);\n", ""),
        ("#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bl0, bl1);\n", "")],
    "key_tail_dropped": [("    const bool real = j0 + r < n;",
                          "    const bool real = j0 + r < n / kKeys * kKeys;")],
}


def crf_kernel_faults(torch, cs, cpu: dict) -> dict:
    """chip_smoke's crf_kernel comparisons and stage-2.1 check (``cpu``: its CPU
    readings) with each of CRF_KERNEL_FAULTS built into crf.cu."""
    from rcf_tpu_torch.ops import crf as crf_ops
    from rcf_tpu_torch.ops import crf_kernels as ck

    out = {}
    for name, reps in CRF_KERNEL_FAULTS.items():
        faulty = ck.load_library(ck.build_patched(reps, f"fault_{name}"))
        sound, ck._lib = ck._load(), faulty
        try:
            kernel = cs.crf_kernel_readings(torch, ck, crf_ops)
            errs = cs.rcf_crf_reference_errors(cpu, cs.rcf_crf_reference_readings(torch, "cuda"))
        finally:
            ck._lib = sound
        caught = cs.crf_kernel_failures(kernel) + cs.rcf_crf_reference_failures(errs)
        out[name] = {"crf_kernel": kernel, "rcf_crf": errs, "caught_by": caught}
        print(f"{name:19s} crf_kernel (to plain, to float64): "
              + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b, _) in kernel.items())
              + "; stage 2.1: " + "  ".join(
                  f"{k} {v if isinstance(v, (int, list)) else format(v, '.3e')}"
                  for k, v in errs.items() if k in cs.RCF_CRF_REF_LIMITS)
              + f"  caught by {caught or 'nothing'}", flush=True)
    return out


def rcf_crf_faults(torch, cs, cpu: dict) -> dict:
    """chip_smoke's stage-2.1 readings (``cpu``: the CPU's), sound and with each
    planted fault."""
    from rcf_tpu_torch.ops import crf as crf_ops
    from rcf_tpu_torch.train import step as step_mod

    eval_mode, xy_features = step_mod._eval_mode, crf_ops.xy_features
    mean_field, crf_filter = crf_ops.mean_field, crf_ops.crf_filter

    def ema_train_mode(*modules):
        on_card = next(modules[0].parameters()).is_cuda
        return contextlib.nullcontext() if on_card else eval_mode(*modules)

    def sxy_unscaled(h, w, sxy, xy_scale=(1.0, 1.0), device="cpu"):
        on_card = torch.device(device).type == "cuda"
        return xy_features(h, w, sxy, (1.0, 1.0) if on_card else xy_scale, device)

    def batch_wide_freeze(rgb, masks, params, xy_scale=(1.0, 1.0), chunk=1024):
        q1, iters = mean_field(rgb, masks, params, xy_scale, chunk)
        if not (masks.is_cuda and params.stable_exit):
            return q1, iters
        n = int(iters.max())
        fixed = dataclasses.replace(params, stable_exit=False, refine_iters=n)
        return mean_field(rgb, masks, fixed, xy_scale, chunk)[0], torch.full_like(iters, n)

    def tf32_logits(feat, values, chunk=1024):
        if not feat.is_cuda:
            return crf_filter(feat, values, chunk)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            sq = (feat * feat).sum(-1) * 0.5
            out = []
            for c in range(0, feat.shape[1], chunk):
                w = torch.exp(feat[:, c:c + chunk] @ feat.transpose(1, 2) - sq[:, None, :]
                              - sq[:, c:c + chunk, None])
                out.append((w * values[:, None, :]).sum(-1) / w.sum(-1))
            return torch.cat(out, dim=1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    faults = {"sound": [],
              "ema_train_mode": [(step_mod, "_eval_mode", ema_train_mode)],
              "sxy_unscaled": [(crf_ops, "xy_features", sxy_unscaled)],
              "batch_wide_freeze": [(crf_ops, "mean_field", batch_wide_freeze)],
              "tf32_logits": [(crf_ops, "crf_filter", tf32_logits)]}
    out = {}
    for case, patches in faults.items():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            errs = cs.rcf_crf_reference_errors(cpu, cs.rcf_crf_reference_readings(torch, "cuda"))
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        caught = cs.rcf_crf_reference_failures(errs)
        out[case] = {**errs, "caught_by": caught}
        print(f"crf {case:17s} " + "  ".join(
            f"{k} {v if isinstance(v, (int, list)) else format(v, '.3e')}"
            for k, v in errs.items() if k in cs.RCF_CRF_REF_LIMITS or k.endswith("_iters"))
            + f"  caught by {caught or 'nothing'}", flush=True)
    return out


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
    print(f"stage-1 limits {cs.RCF_REF_LIMITS}", flush=True)
    rcf = rcf_faults(torch, cs)
    print(f"stage-2.1 limits {cs.RCF_CRF_REF_LIMITS}", flush=True)
    crf_cpu = cs.rcf_crf_reference_readings(torch, "cpu")
    crf = rcf_crf_faults(torch, cs, crf_cpu)
    print(f"crf_kernel limits {cs.CRF_TOL}", flush=True)
    crf_kernel = crf_kernel_faults(torch, cs, crf_cpu)
    print(json.dumps({"device": smi, "cases": out, "tail_dropped": tail, **overlap,
                      "rcf": rcf, "rcf_crf": crf, "crf_kernel": crf_kernel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
