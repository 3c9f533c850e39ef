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
catch it. Then the kernels' card tests (``chip_smoke.CARD_TESTS``), run in
this process (``pytest.main``), sound and with faults in the CUDA source
itself, each built from a changed copy of ``csrc/`` under the gitignored
``rcf_tpu_torch/build/`` (``Library.patched``; the repository's sources stay
as they are); for each it prints the card cases that fail:

* ``tail_dropped``: warp_fwd and warp_bwd leave out the pixels of a row past
  its last multiple of 4 (the last pixel of a 77-wide row), which the
  level-0 shape (640 wide) never shows;
* ``direct_dropped``: the overlap-adds (splat, warp_bwd_dimg) drop every tap
  outside the block's shared-memory window instead of adding it to device
  memory;
* ``flush_tail_dropped``: the overlap-adds' flush leaves out the scalar quad
  at the tail of each window row.

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

Last, three faults built into ``crf.cu`` (``crf_kernels.LIB.patched``), each
run through the crf_filter card tests (``tests/test_torch_crf_card.py``)
and the stage-2.1 card-vs-CPU check:

* ``lo_products_dropped``: the dot without its hi.lo and lo.hi products, a
  single TF32 dot;
* ``key_tail_dropped``: the keys of the last, partial key tile treated as
  padding (weight 0), which an N that is a multiple of the tile never shows;
* ``columns_dropped``: the tile pairs off the diagonal add their weights to
  their rows only (each unordered pair then counts for one of its pixels).

Then two faults built into ``linear.cu`` (``LINEAR_KERNEL_FAULTS``,
``linear_kernels.LIB.patched``), each run through the dino_linear card tests
(``tests/test_torch_dino_linear.py``):

* ``linear_lo_dropped``: the products without their hi.lo and lo.hi terms,
  a single TF32 product;
* ``linear_tail_dropped``: the rows of the last, ragged row tile not stored,
  which an M that is a multiple of 128 never shows.

``python3 tools/smoke_fault_check.py linear`` runs that part alone, with
the sound build's cases first.

Then chip_smoke's data_parallel hold (``chip_smoke.dp_ranks``: two gloo
ranks on the card, each its own process, against one process with the
whole batch; ``DP_LIMITS``), sound and with each fault planted in both ranks:

* ``per_rank_bn``: the cross-rank BatchNorm on the rank's own rows (no
  all-reduce of its statistics, nor of its backward's sums);
* ``ratio_per_rank``: unFlow's occlusion ratio as the rank's own ratio of
  means (``dist.global_ratio`` replaced by ``num / den``);
* ``ratio_no_den``: ``dist.global_ratio`` without its denominator's
  gradient term (the value unchanged). The recipes' occlusion masks are
  comparisons, with no gradient, so no hold on the card can see this one;
  ``tests/test_torch_parallel.py`` holds the term with a denominator that
  has a gradient.

Beside them it prints the hold's noise control (world 1 against world 1
with ``DP_NOISE`` on the frames) for each case.

``python3 tools/smoke_fault_check.py data_parallel`` runs that part alone
(~2 min on an H100).

Last, one JSON line. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# The thread-placement test of warp_fwd/warp_bwd, and the fault planted in it.
TAIL_FAULT = ("return x < w && y < h;", "return x < (w & ~3) && y < h;")
# The overlap-adds' device-memory branch for taps outside the window, and the
# scalar quads at the tail of each window row in the flush.
OVERLAP_FAULTS = {
    "direct_dropped": ("      for (int ch = 0; ch < cc; ++ch) atomicAdd(d + ch, val(ch) * wt[k]);\n", ""),
    "flush_tail_dropped": ("    if (q >= m && q + 4 <= m + width) {",
                           "    if (q + 4 > m + width) continue;\n    if (q >= m) {"),
}


class CardOutcomes:
    """A pytest plugin that keeps the cases that passed and those that failed."""

    def __init__(self):
        self.passed, self.failed = [], []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed.append(report.nodeid.split("::", 1)[1])
        elif report.passed and report.when == "call":
            self.passed.append(report.nodeid)


def card_cases(files) -> dict:
    """The card tests of ``files``, in this process, on the libraries in use:
    {"passed": count, "failed": [case, ...]}."""
    import pytest

    outcomes = CardOutcomes()
    pytest.main(["--noconftest", "-m", "cuda", "-q", "-p", "no:cacheprovider",
                 *(os.path.join(REPO, f) for f in files)], plugins=[outcomes])
    return {"passed": len(outcomes.passed), "failed": outcomes.failed}


def print_cases(name: str, cases: dict) -> None:
    print(f"{name:19s} card cases: {cases['passed']} passed, {len(cases['failed'])} failed"
          + (f": {', '.join(cases['failed'])}" if cases["failed"] else ""), flush=True)


def warp_kernel_faults() -> dict:
    """The warp card tests with the tail fault and each of OVERLAP_FAULTS built in."""
    from rcf_tpu_torch.ops import warp_kernels as wk

    out = {}
    for name, rep in {"tail_dropped": TAIL_FAULT, **OVERLAP_FAULTS}.items():
        with wk.LIB.patched([rep], f"fault_{name}"):
            out[name] = card_cases(["tests/test_torch_warp_card.py"])
        print_cases(name, out[name])
    return out


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


# The split dot's two correction products, the test that marks a tile's key
# as real, and the column sums of the pairs off the diagonal, in crf.cu.
CRF_KERNEL_FAULTS = {
    "lo_products_dropped": [
        ("#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_lo[m], bh0, bh1);\n", ""),
        ("#pragma unroll\n    for (int m = 0; m < kTiles; ++m) mma_tf32(acc[m], a_hi[m], bl0, bl1);\n", "")],
    "key_tail_dropped": [("      const bool real = j0 + r < n;",
                          "      const bool real = j0 + r < n / kTile * kTile;")],
    "columns_dropped": [("        key_loop(std::true_type{});", "        key_loop(std::false_type{});"),
                        ("      if (J != I) flush_columns(b, J * kTile);\n", "")],
}


def crf_kernel_faults(torch, cs, cpu: dict) -> dict:
    """The crf_filter card tests and chip_smoke's stage-2.1 check (``cpu``: its
    CPU readings) with each of CRF_KERNEL_FAULTS built into crf.cu."""
    from rcf_tpu_torch.ops import crf_kernels as ck

    out = {}
    for name, reps in CRF_KERNEL_FAULTS.items():
        with ck.LIB.patched(reps, f"fault_{name}"):
            cases = card_cases(["tests/test_torch_crf_card.py"])
            errs = cs.rcf_crf_reference_errors(cpu, cs.rcf_crf_reference_readings(torch, "cuda"))
        caught = cs.rcf_crf_reference_failures(errs)
        out[name] = {"card_cases": cases, "rcf_crf": errs, "caught_by": caught}
        print_cases(name, cases)
        print(f"{name:19s} stage 2.1: " + "  ".join(
            f"{k} {v if isinstance(v, (int, list)) else format(v, '.3e')}"
            for k, v in errs.items() if k in cs.RCF_CRF_REF_LIMITS)
            + f"  caught by {caught or 'nothing'}", flush=True)
    return out


# The split product's two correction terms, and the test that keeps the rows
# past M from being stored, in linear.cu.
LINEAR_KERNEL_FAULTS = {
    "linear_lo_dropped": [("  wgmma(d, al, bh, add);\n  wgmma(d, ah, bl, 1);\n  wgmma(d, ah, bh, 1);\n",
                           "  wgmma(d, ah, bh, add);\n")],
    "linear_tail_dropped": [("        if (r >= m) continue;", "        if (r >= m / kRows * kRows) continue;")],
}


def linear_kernel_faults() -> dict:
    """The dino_linear card tests with each of LINEAR_KERNEL_FAULTS built into linear.cu."""
    from rcf_tpu_torch.ops import linear_kernels as lk

    out = {}
    for name, reps in LINEAR_KERNEL_FAULTS.items():
        with lk.LIB.patched(reps, f"fault_{name}"):
            out[name] = card_cases(["tests/test_torch_dino_linear.py"])
        print_cases(name, out[name])
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


DP_FAULTS = ("per_rank_bn", "ratio_per_rank", "ratio_no_den")


def plant_dp_fault(name: str) -> None:
    """In this rank's process, one of ``DP_FAULTS``."""
    import types

    import torch

    from rcf_tpu_torch.nn import layers
    from rcf_tpu_torch.parallel import dist

    def ratio_no_den(num, den):
        g = torch.stack([num.detach().float(), den.detach().float()])
        dist.all_reduce_mean_([g])
        n, d = g[0], g[1]
        return (n / d + (num - num.detach()) / d).to(torch.result_type(num, den))

    if name == "per_rank_bn":
        layers.dist = types.SimpleNamespace(world=dist.world, all_reduce_sum=lambda x: x)
    elif name == "ratio_per_rank":
        dist.global_ratio = lambda num, den: num / den
    elif name == "ratio_no_den":
        dist.global_ratio = ratio_no_den
    else:
        raise ValueError(name)


def dp_fault_command(name: str):
    def command(rank: int, work: str) -> list:
        return [sys.executable, os.path.abspath(__file__), "--dp-rank", name, str(rank), work]
    return command


def data_parallel_faults(torch, cs) -> dict:
    """chip_smoke's data_parallel hold (two gloo ranks on the card against one
    process), sound and with each of ``DP_FAULTS`` planted in both ranks."""
    out = {}
    for case in ("sound",) + DP_FAULTS:
        command = cs.dp_rank_command if case == "sound" else dp_fault_command(case)
        readings, _ = cs.dp_ranks(torch, command)
        out[case] = {name: readings["hold"][name] for name in readings["hold"]}
        if case == "sound":
            out["noise"] = readings["noise"]
            for name, noise in readings["noise"].items():
                print(f"{'noise':14s} {name:9s} " + "  ".join(
                    f"{k} {noise[k]:.3e}" for k in cs.DP_LIMITS[name]), flush=True)
        for name, ranks in out[case].items():
            lims = cs.DP_LIMITS[name]
            worst = {k: max(r[k] for r in ranks) for k in lims}
            caught = [k for k, v in worst.items() if v > lims[k]]
            print(f"{case:14s} {name:9s} " + "  ".join(f"{k} {v:.3e}" for k, v in worst.items())
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
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of data_parallel_faults, the fault planted
        plant_dp_fault(sys.argv[2])
        return cs.dp_rank_main(torch, int(sys.argv[3]), sys.argv[4])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if sys.argv[1:] == ["linear"]:
        sound = card_cases(["tests/test_torch_dino_linear.py"])
        print_cases("sound", sound)
        print(json.dumps({"device": smi, "linear": {"sound": sound, **linear_kernel_faults()}}))
        return 0
    if sys.argv[1:] == ["data_parallel"]:
        print(f"device {smi}; data_parallel limits {cs.DP_LIMITS}", flush=True)
        print(json.dumps({"device": smi, "data_parallel": data_parallel_faults(torch, cs)}))
        return 0
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
    card = {"sound": card_cases(cs.CARD_TESTS)}
    print_cases("sound", card["sound"])
    card.update(warp_kernel_faults())
    print(f"stage-1 limits {cs.RCF_REF_LIMITS}", flush=True)
    rcf = rcf_faults(torch, cs)
    print(f"stage-2.1 limits {cs.RCF_CRF_REF_LIMITS}", flush=True)
    crf_cpu = cs.rcf_crf_reference_readings(torch, "cpu")
    crf = rcf_crf_faults(torch, cs, crf_cpu)
    crf_kernel = crf_kernel_faults(torch, cs, crf_cpu)
    linear_kernel = linear_kernel_faults()
    print(f"data_parallel limits {cs.DP_LIMITS}", flush=True)
    dp = data_parallel_faults(torch, cs)
    print(json.dumps({"device": smi, "cases": out, "card": card,
                      "rcf": rcf, "rcf_crf": crf, "crf_kernel": crf_kernel,
                      "linear_kernel": linear_kernel,
                      "data_parallel": dp}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
