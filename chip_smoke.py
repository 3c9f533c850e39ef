#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed:

1. build      - compile ``rcf_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) into
                ``rcf_tpu_torch/build/``, and, beside it (one nvcc each, side
                by side), a test build that counts the taps of each branch of
                the overlap-adds (``warp_kernels.COUNT_TAPS``);
2. kernels    - each kernel against its plain PyTorch version on the card, at
                the AMD level-0 shapes (B=8, 384x640), images in f32 and bf16;
                warp_fwd and warp_bwd also at ragged shapes (B=3, H in {1,
                13}, W in {1, 3, 77}, C in 1..5, pad "border" and "zeros",
                f32 and bf16) at the same tolerances: threads past the edge, each
                compiled channel count, the generic instance, the batch
                boundary; splat and warp_bwd_dimg also on every set of
                ``check_overlap_add`` (the level-0 i.i.d. and smooth flows,
                gentle smooth flows whose taps all stay in their block's
                shared-memory window, far flows that leave it and the image,
                and the ragged shapes, with densities of other shapes than
                the source), at the same tolerances, with the taps of each
                branch (window, device memory) counted by the test build on
                the same inputs: the far set must reach the device-memory
                branch, the gentle smooth set only the window; then
                (``crf_kernel``) crf_filter against its plain version with
                TF32 matmuls on, on the DAVIS grid (16 x 96^2, D=5), i.i.d.
                features, a ragged N (3 x 97 x 61), D=2 and the SegTrackv2
                grid (16 x 128^2), each at its limit (``CRF_TOL``), which
                also holds the kernel's distance to a float64 filter;
3. step       - three AMD training steps (ResNet-50 OS8 + FCN mask head +
                PWC-Lite + unFlow loss, Adam) at batch 8 pairs of 384^2
                frames, flow_size 384x640, random weights from a seed, in f32
                (TF32 convolutions); the launch counts of the step's kernels
                (warp_fwd, warp_bwd, splat) must rise and the losses be finite;
4. step_bf16  - the same three steps with the compute dtype bf16 (the
                recipe's ``tpu.compute_dtype: bfloat16``; f32 parameters, Adam
                state and losses), with the same checks;
5. image_grad - the gradient of a seeded scalar of ``flow_warp(flow21,
                flow12, pad="zeros")`` (the flow warp of
                ``occu_mask_bidirection``) in both flows at the level-0 shape,
                which launches warp_bwd_dimg, and the bidirectional occlusion
                mask, on the card against the port's CPU path;
6. reference  - the AMD forward and a weight gradient at a small input; the
                unFlow loss and its flow gradient on seeded flows, with the
                backward-density and with the bidirectional occlusion masks;
                and the bf16 AMD forward; on the card against the port's plain
                CPU path (which the tests hold to the JAX package), TF32 off;
7. rcf_step   - three RCF stage-1 training steps of the DAVIS recipe
                (``configs/rcf/rcf_stage1.yaml``: ResNet-50 OS8, the mask head
                2304->256 with the fused conv0, the residual head 4096->256,
                the flow-aggregation head, 96^2 masks, Adam, the EMA on) at
                batch 8 pairs of 384^2 frames and flows, random weights from
                seed 0, f32 (TF32 convolutions); fails on a non-finite loss,
                parameter or statistic, or an EMA tensor that did not move;
                the step ms and the peak memory;
8. rcf_step_bf16 - the same for the SegTrackv2 recipe
                (``configs/rcf_stv2/rcf_stage1.yaml``) in bf16: the affine WLS,
                compactness on channel 0, 48^2 masks from stage 4 only;
9. rcf_step_crf, rcf_step_crf_bf16 - three stage-2.1 steps of the DAVIS
                recipe (``configs/rcf/rcf_stage2.1.yaml``: the CRF target of
                the EMA's masks on a 96^2 grid, the MAP-stability exit, f32)
                and of the SegTrackv2 recipe (128^2, a fixed 50 iterations,
                bf16) on frames with flat colour regions (``crf_frames``),
                object channel 0 set: step ms, peak memory, mean-field
                iterations, host syncs and crf_filter launches per step;
10. rcf_reference - one DAVIS stage-1 step at full width on 2 pairs of 128^2
                frames on the card against the port's CPU path, TF32 off: the
                losses, the mask probabilities, the weight gradients of
                ``decode_head2.conv_seg`` and ``flow_feat_after_agg[0]``, the
                EMA's increment, and ``demean_affine_flow`` alone; then one
                SegTrackv2 step in bf16 at the same size: its losses
                (``loss_compactness`` among them), probabilities and mask
                logits; each beside its limit (``RCF_REF_LIMITS``);
11. rcf_crf_reference - the stage-2.1 CRF of each recipe on identical inputs
                (MAP, q1, each image's iterations) and one stage-2.1 step of
                each recipe on the card against the CPU (``RCF_CRF_REF_LIMITS``);
12. timing    - each kernel, its plain version and a PyTorch library call at
                the level-0 shape on i.i.d. flows (N(0, 5^2) per pixel), with
                CUDA events. ``ms``, ``library_ms``, ``plain_ms``: a loop of
                20 eager calls on one input set (the readings of earlier
                versions of this script), which is how the step calls them,
                and which counts the host's time to issue a call where that
                is longer than the call. ``ms_device``,
                ``library_ms_device``: device time alone, on inputs the L2
                does not hold (the calls replayed from a CUDA graph, round
                robin over input sets of more than twice the L2 in all). For
                every kernel also ``ms_smooth``, ``library_ms_smooth``:
                device time, as ``ms_device``, on smooth flows (per map
                N(0, 8^2) drawn at (H/4, W/4) and bilinearly upsampled x4, as
                the step's flows are predicted at a quarter of the
                resolution); and a ``warp_timing`` line with warp_fwd and
                warp_bwd and their library calls, device time, at the step's
                four level shapes (384x640, 192x320, 96x160, 48x80; B=8, C=3)
                on both flow kinds in f32, and at level 0 in bf16 (the library
                on bf16 NCHW with a bf16 grid), and warp_bwd_dimg at level 0
                in bf16 (C=2) on both flow kinds, each with its bound (the
                splat's and warp_bwd_dimg's without their buffer's zero fill);
                crf_filter on the DAVIS and (keys ``*_stv2``) SegTrackv2
                grids beside its bound (an ex2 and two FP32 instructions a
                pair; the ex2 unit binds) and
                ``scaled_dot_product_attention`` computing the same filter.

Prints a ``{"kernels": [...]}`` line, a line with the AMD, stage-1 and
stage-2.1 step times (f32 and bf16), the peak memory, the stage-2.1 mean
field's iterations and syncs, the reference readings and the phase
seconds, the card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then not 0 and no result line is
printed. Without a CUDA device, or without the package beside it, it exits
with an error at once.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 2**20       # H100 SXM L2

B, H, W, C = 8, 384, 640, 3  # AMD level 0: 8 pairs, flow_size 384x640, RGB
STEPS = 3

# Kernel vs plain version on the card (same inputs, f32 arithmetic in both):
TOL = {
    # f32 output, same 4-tap arithmetic; contraction (FMA) order may differ.
    ("warp_fwd", "float32"): 1e-5,
    # bf16 output: both round one f32 value; at most one bf16 ulp (2^-7 at 1.0) apart.
    ("warp_fwd", "bfloat16"): 1e-2,
    # f32 sums over 3 channels of products of O(1) terms.
    ("warp_bwd", "float32"): 1e-4,
    ("warp_bwd", "bfloat16"): 1e-4,
    # dimg: f32 atomics in a run-dependent order, |g| < 1, a few taps per pixel;
    # dcx, dcy as warp_bwd (flow-valued C=2 maps reach |img| ~ 10: 1e-4 still).
    ("warp_bwd_dimg", "float32"): 1e-4,
    # bf16 dimg: both round an f32 sum (equal to ~1e-6) to bf16, so they are at
    # most one bf16 ulp apart: 2^-4 for |dimg| < 16. dcx, dcy stay f32 (1e-4).
    ("warp_bwd_dimg", "bfloat16"): 2.0**-4,
    # f32 atomics in an order that changes from run to run; densities O(1).
    ("splat", "float32"): 1e-4,
}
# Card vs CPU (TF32 off), each reading beside its limit:
# - the AMD forward's loss relative to its scale and the mask probabilities
#   (an occlusion pixel flipping moves the loss ~1e-5);
# - a flownet weight gradient over its largest entry: cuDNN and the CPU sum
#   the convolutions' backward in other orders (sound runs read 2.2e-3), which
#   hides some faults in the kernels;
# - the unFlow loss alone, on the same flows on both sides, and its gradient
#   in the flows over its largest entry: only the kernels and f32 sums differ.
#   Sound runs read 4.8e-7 and 1.1e-5; each fault that
#   tools/smoke_fault_check.py plants in a kernel reads 1.2e-3 or more on
#   the gradient (the smallest: the TPU kernel's zero derivative at exact
#   integers dropped), and the limit sits between.
# - the same unFlow loss with the bidirectional occlusion masks
#   (occ_from_back=False), loss and flow gradient: sound runs read 0 and
#   9.8e-7 on an H100; the planted warp faults read 2.9e-2 or more on the
#   gradient (the dropped `_dhat` rule the least);
# - the bf16 AMD forward (no backward) at flow_size 384x640: its loss, and
#   the finest forward flow over its largest entry. cuDNN and the CPU round
#   bf16 convolutions at other places, so these read bf16 noise: 1.4e-5 and
#   1.6e-2 in sound runs. The loss limit catches the forward shift (1.2e-3)
#   and the mirrored splat (1.4e-4); the flow limit only gross faults;
# - a bf16 feature map (C=32) warped as PWC-Lite's finest level warps it
#   (96x160): max abs error of the f32 result. Sound, f32 grids on both
#   sides: ~1e-6; a bf16 grid is off by up to 0.3 px here.
# tools/smoke_fault_check.py prints every reading for each planted fault.
REF_LIMITS = {"loss_rel": 1e-3, "probs_err": 1e-3, "grad_rel": 1e-2,
              "unflow_rel": 1e-4, "unflow_grad_rel": 1e-4,
              "bidir_rel": 1e-4, "bidir_grad_rel": 1e-4,
              "bf16_loss_rel": 1e-4, "bf16_flow_rel": 5e-2, "feat_warp_err": 1e-4}
# Image-gradient phase, card vs CPU: the scalar, and its gradients in the
# warped flow (the image cotangent, warp_bwd_dimg's dimg) and in the sampling
# flow (dcx, dcy), each over its largest entry; f32 sums in another order.
# Sound runs read 3.8e-8, 1.7e-7 and 1.2e-7 on an H100; dimg scattered to the
# mirrored taps reads 1.77 on dimg, dimg without one corner 0.80, the forward
# shift 5.0e-2 on the scalar.
IMG_LIMITS = {"value_rel": 1e-5, "dimg_rel": 1e-5, "dflow_rel": 1e-4}
STEP_KERNELS = ("warp_fwd", "warp_bwd", "splat")

REPLACES = {
    "warp_fwd": "rcf_tpu/ops/pallas/warp_pallas.py:124",
    "warp_bwd": "rcf_tpu/ops/pallas/warp_pallas.py:220",
    "splat": "rcf_tpu/ops/pallas/warp_pallas.py:266",
    "warp_bwd_dimg": "rcf_tpu/ops/pallas/warp_pallas.py:160",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def amd_model_kwargs(dropout: float = 0.1, flow_size=(H, W)) -> dict:
    """configs/amd/amd.yaml's model_kwargs (full width, ResNet-50)."""
    return {
        "w_seg": 1.0, "mask_layer": 5, "flow_size": tuple(flow_size),
        "backbone2": {"type": "ResNet", "depth": 50, "num_stages": 4,
                      "out_indices": [0, 1, 2, 3], "strides": [1, 2, 1, 1],
                      "dilations": [1, 1, 1, 2], "contract_dilation": False},
        "decode_head2": {"type": "FCNHead", "in_channels": 2048, "in_index": 3,
                         "channels": 256, "num_convs": 2, "dilation": 6,
                         "dropout_ratio": dropout, "num_classes": 5,
                         "concat_input": False},
    }


# configs/amd/amd.yaml's optimizer and schedule (100 steps per epoch).
TRAIN_CFG = {"optimizer": "adam", "learning_rate": 1e-4, "weight_decay": 1e-6, "epochs": 8,
             "lr_scheduler_kwargs": {"power": 0.9, "min_lr": 1e-6}}
STEPS_PER_EPOCH = 100

# The RCF stage-1 recipes as resolved from their YAMLs (this machine's twin
# with the card has no yaml; tests/test_torch_rcf_step.py holds these equal
# to configs/rcf/rcf_stage1.yaml and configs/rcf_stv2/rcf_stage1.yaml).
_RCF_DAVIS_KWARGS = {
    "w_seg": 1.0, "w_sharpen": 0, "w_entropy": 0.05, "separate_residual": True,
    "mask_layer": 4, "align_corners": False, "mask_size": [96, 96],
    "backbone2": {"type": "ResNet", "depth": 50, "num_stages": 4, "out_indices": [0, 1, 2, 3],
                  "strides": [1, 2, 1, 1], "dilations": [1, 1, 2, 4], "contract_dilation": True,
                  "norm_cfg": {"type": "SyncBN", "requires_grad": True}, "norm_eval": False,
                  "style": "pytorch"},
    "decode_head": {"type": "FlowAggregationHeadWithResidual", "mask_layer": 4,
                    "flow_feat_before_agg_kernel_size": 3, "num_flow_feat_channels": 64,
                    "mask_size": [96, 96], "norm_flow": False, "clamp_flow_t": 20.0,
                    "free_residual": True, "free_residual_with_affine": False,
                    "outlier_robust_loss": False, "eps": 0.01, "q": 0.4,
                    "allow_residual_resize": True, "residual_adjustment_scale": 10.0,
                    "pred_div_coeff": 10.0},
    "decode_head2": {"type": "FCNHead", "input_transform": "resize_concat",
                     "in_channels": [256, 2048], "in_index": [0, 3], "channels": 256,
                     "num_convs": 2, "dilation": 6, "dropout_ratio": 0.1, "num_classes": 4,
                     "concat_input": False, "align_corners": False},
    "decode_head3": {"type": "FCNHead", "in_channels": 4096, "in_index": -1, "channels": 256,
                     "num_convs": 2, "dilation": 6, "dropout_ratio": 0.1, "num_classes": 16,
                     "concat_input": False, "align_corners": False},
}


def _stv2_kwargs() -> dict:
    """configs/rcf_stv2/rcf_stage1.yaml: DAVIS's model with its overrides."""
    kw = copy.deepcopy(_RCF_DAVIS_KWARGS)
    kw.update(mask_size=[48, 48], allow_mask_resize=False, w_compactness=1.0,
              compactness_head={"type": "CompactnessHead", "compact_channel": 0})
    kw["decode_head"].update(mask_size=[48, 48], free_residual=False,
                             free_residual_with_affine=True, allow_residual_resize=False)
    kw["decode_head2"].update(input_transform=None, in_channels=2048, in_index=3)
    return kw


_RCF_TRAIN = {"optimizer": "adam", "learning_rate": 1e-4,
              "lr_scheduler_kwargs": {"power": 0.9, "min_lr": 1e-6}}
RCF_RECIPES = {
    "rcf": {"model_kwargs": _RCF_DAVIS_KWARGS, "compute_dtype": "float32",
            "train": dict(_RCF_TRAIN, weight_decay=1e-4, epochs=200)},
    "rcf_stv2": {"model_kwargs": _stv2_kwargs(), "compute_dtype": "bfloat16",
                 "train": dict(_RCF_TRAIN, weight_decay=1e-6, epochs=20)},
}


def _stage2_1(recipe: str, crf_head: dict, train: dict, **over) -> dict:
    """configs/<recipe>/rcf_stage2.1.yaml: the stage-1 model with the EMA and the
    CRF target (its model_kwargs' overrides ``over`` and ``crf_head``), and the
    stage-1 optimizer with ``train``'s changes."""
    kw = copy.deepcopy(RCF_RECIPES[recipe]["model_kwargs"])
    kw.update(w_entropy=0, w_crf=10.0, crf_use_ema=True, ema_m=0.999, crf_pos_weight=2.0,
              crf_neg_weight=1.0, crf_head={"type": "CRFHead", **crf_head}, **over)
    kw["backbone2"]["create_ema"] = kw["decode_head2"]["create_ema"] = True
    return {"model_kwargs": kw, "compute_dtype": RCF_RECIPES[recipe]["compute_dtype"],
            "train": dict(RCF_RECIPES[recipe]["train"], **train)}


# The stage-2.1 recipes (DAVIS: the CRF on a 96^2 grid with the MAP-stability
# exit; SegTrackv2: 128^2, a fixed 50 iterations, bf16), held equal to their
# YAMLs by tests/test_torch_rcf_stage2_1.py.
RCF_CRF_RECIPES = {
    "rcf": _stage2_1("rcf", {"resolution": [96, 96], "stable_exit": True},
                     {"learning_rate": 1e-5, "epochs": 20}),
    "rcf_stv2": _stage2_1("rcf_stv2", {"resolution": [128, 128]},
                          {"learning_rate": 1e-5, "weight_decay": 5e-6},
                          w_compactness=0, compactness_head=None),
}


def rcf_model_kwargs(recipe: str, dropout: float | None = None, mask_size=None) -> dict:
    """A stage-1 recipe's model_kwargs with the EMA on; optionally the heads'
    dropout and the masks' size (both heads) replaced."""
    kw = copy.deepcopy(RCF_RECIPES[recipe]["model_kwargs"])
    kw["backbone2"]["create_ema"] = True
    kw["decode_head2"]["create_ema"] = True
    if dropout is not None:
        kw["decode_head2"]["dropout_ratio"] = kw["decode_head3"]["dropout_ratio"] = dropout
    if mask_size is not None:
        kw["mask_size"] = kw["decode_head"]["mask_size"] = list(mask_size)
    return kw


def rcf_train_cfg(recipe: str, **kw) -> dict:
    return dict(RCF_RECIPES[recipe]["train"], model_kwargs=rcf_model_kwargs(recipe, **kw))


def level0_inputs(torch, dtype, gen, scale=5.0, b=B, h=H, w=W, c=C, smooth=False,
                  smooth_scale=8.0):
    """img [b,h,w,c] in [0,1), non-integer absolute coords cx, cy [b,h,w] f32.

    The flow is i.i.d. N(0, scale^2) per pixel, or, with ``smooth``,
    N(0, smooth_scale^2) drawn at (h/4, w/4) and bilinearly upsampled x4, as
    the step's flows are predicted at a quarter of the resolution and upsampled.
    """
    import torch.nn.functional as F

    dev = "cuda"
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rms(a) -> float:
    return float(a.double().square().mean().sqrt())


def rel_max(a, b) -> float:
    """max |a - b| over max |b|: an error against the quantity's own scale."""
    return float((a - b).abs().max() / b.abs().max())


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_sets(n_bytes: int) -> int:
    """Input sets of ``n_bytes`` each that a round robin needs so that a set's
    lines have left the L2 (more than twice its size passes) before its next call."""
    return 1 + math.ceil(2 * L2_BYTES / n_bytes)


def graph_ms(torch, fns, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call on inputs the L2 does not hold: ``fns`` are the
    same call on ``cold_sets`` input sets, captured round robin in one CUDA
    graph (``iters`` calls or one per set, whichever is more) and replayed
    ``reps`` times back to back, CUDA events around the replays.

    Unlike ``cuda_ms`` it leaves out the host's time to issue each call (the
    Python wrapper, the dispatcher), which a fast kernel does not hide.
    """
    n = max(iters, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    return ms


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, wk, count_lib) -> dict:
    """Each kernel vs its plain version at the level-0 shapes, then the
    overlap-adds on every branch (``check_overlap_add``); returns the level-0
    f32 max errors."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        img, cx, cy = level0_inputs(torch, dtype, gen)
        cxb, cyb = cx.clamp(0, W - 1), cy.clamp(0, H - 1)
        _, cxz, cyz = level0_inputs(torch, dtype, gen, scale=9.0)
        e_fwd = 0.0
        for x, y in ((cxb, cyb), (cxz, cyz)):  # border (pre-clamped) and zeros
            out = wk.warp_fwd(img, x, y)
            torch.cuda.synchronize()
            e_fwd = max(e_fwd, max_err(out, wk.warp_fwd_plain(img, x, y)))
        g = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        dcx, dcy = wk.warp_bwd(img, cxb, cyb, g)
        torch.cuda.synchronize()
        pcx, pcy = wk.warp_bwd_plain(img, cxb, cyb, g)
        e_bwd = max(max_err(dcx, pcx), max_err(dcy, pcy))
        log(f"kernel warp_fwd {dn}: max_abs_err {e_fwd:.3e} (tol {TOL[('warp_fwd', dn)]})")
        log(f"kernel warp_bwd {dn}: max_abs_err {e_bwd:.3e} (tol {TOL[('warp_bwd', dn)]})")
        if not (e_fwd <= TOL[("warp_fwd", dn)] and e_bwd <= TOL[("warp_bwd", dn)]):
            raise RuntimeError(f"warp kernels disagree with their plain versions in {dn}")
        if dtype == torch.float32:
            errs["warp_fwd"], errs["warp_bwd"] = e_fwd, e_bwd
    check_warp_ragged(torch, wk, gen)
    errs["warp_bwd_dimg"] = check_warp_bwd_dimg(torch, wk, gen)
    # The splat sees both flow directions batched: 2B maps.
    _, tx, ty = level0_inputs(torch, torch.float32, gen, b=2 * B)
    dens = wk.splat(tx, ty, H, W)
    torch.cuda.synchronize()
    e_splat = max_err(dens, wk.splat_plain(tx, ty, H, W))
    log(f"kernel splat float32: max_abs_err {e_splat:.3e} (tol {TOL[('splat', 'float32')]})")
    if not e_splat <= TOL[("splat", "float32")]:
        raise RuntimeError("splat kernel disagrees with its plain version")
    errs["splat"] = e_splat
    failed = [f"{r['kernel']} {r['set']} {r['case']}: {r['err']:.3e} (tol {r['tol']})"
              for r in check_overlap_add(torch, wk, gen, count_lib) if not r["err"] <= r["tol"]]
    if failed:
        raise RuntimeError("the overlap-add kernels disagree with their plain versions: "
                           + "; ".join(failed[:10]))
    return errs


RAGGED_B, RAGGED_H, RAGGED_W, RAGGED_C = 3, (1, 13), (1, 3, 77), (1, 2, 3, 4, 5)


def check_warp_ragged(torch, wk, gen) -> None:
    """warp_fwd and warp_bwd vs their plain versions at ragged shapes, at the
    level-0 tolerances: widths and heights that are no multiple of the 32 x 8
    tile (threads past the image return), each compiled channel count (1-4)
    and the generic instance (5), three planes (the batch boundary), f32 and
    bf16, pad "border" (coordinates clamped) and "zeros" (unclamped, taps
    leave the image)."""
    worst, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for h in RAGGED_H:
            for w in RAGGED_W:
                for c in RAGGED_C:
                    img, cx, cy = level0_inputs(torch, dtype, gen, scale=2.0, b=RAGGED_B, h=h,
                                                w=w, c=c)
                    g = torch.randn(RAGGED_B, h, w, c, generator=gen, device="cuda").to(dtype)
                    for pad, (x, y) in (("zeros", (cx, cy)),
                                        ("border", (cx.clamp(0, w - 1), cy.clamp(0, h - 1)))):
                        out = wk.warp_fwd(img, x, y)
                        dcx, dcy = wk.warp_bwd(img, x, y, g)
                        torch.cuda.synchronize()
                        pcx, pcy = wk.warp_bwd_plain(img, x, y, g)
                        e = {"warp_fwd": max_err(out, wk.warp_fwd_plain(img, x, y)),
                             "warp_bwd": max(max_err(dcx, pcx), max_err(dcy, pcy))}
                        for k, v in e.items():
                            worst[(k, dn)] = max(worst.get((k, dn), 0.0), v)
                            if not v <= TOL[(k, dn)]:
                                failed.append(f"{k} {dn} {RAGGED_B}x{h}x{w}x{c} {pad}: {v:.3e}")
    log("kernel ragged (B=3, H in {1,13}, W in {1,3,77}, C in 1..5, both pads): max_abs_err "
        + ", ".join(f"{k} {dn} {v:.3e} (tol {TOL[(k, dn)]})" for (k, dn), v in worst.items()))
    if failed:
        raise RuntimeError("warp kernels disagree with their plain versions at ragged shapes: "
                           + "; ".join(failed[:10]))


def check_warp_bwd_dimg(torch, wk, gen) -> float:
    """warp_bwd_dimg vs its plain version: C=2 (a flow, as the system calls it)
    and C=3, f32 and bf16, pad="zeros" (coordinates unclamped, some outside)
    and "border" (clamped). Returns the largest f32 error."""
    err_f32 = 0.0
    for c in (2, 3):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            fl = torch.randn(B, H, W, 2, generator=gen, device="cuda") * 5.0
            img = (fl * 2.0 if c == 2 else torch.rand(B, H, W, 3, generator=gen, device="cuda"))
            img = img.to(dtype)
            _, cx, cy = level0_inputs(torch, dtype, gen, scale=9.0)
            g = (torch.rand(B, H, W, c, generator=gen, device="cuda") * 2 - 1).to(dtype)
            for pad, (x, y) in (("zeros", (cx, cy)),
                                ("border", (cx.clamp(0, W - 1), cy.clamp(0, H - 1)))):
                ours = wk.warp_bwd_dimg(img, x, y, g)
                torch.cuda.synchronize()
                plain = wk.warp_bwd_dimg_plain(img, x, y, g)
                e = [max_err(a, b_) for a, b_ in zip(ours, plain)]
                log(f"kernel warp_bwd_dimg C={c} {dn} {pad}: max_abs_err dimg {e[0]:.3e} "
                    f"(tol {TOL[('warp_bwd_dimg', dn)]}), dcx {e[1]:.3e}, dcy {e[2]:.3e} "
                    f"(tol {TOL[('warp_bwd', 'float32')]})")
                if not (e[0] <= TOL[("warp_bwd_dimg", dn)]
                        and max(e[1:]) <= TOL[("warp_bwd", "float32")]):
                    raise RuntimeError(f"warp_bwd_dimg disagrees with its plain version "
                                       f"(C={c}, {dn}, {pad})")
                if dtype == torch.float32:
                    err_f32 = max(err_f32, *e)
    return err_f32


def far_coords(torch, gen, b=B, h=H, w=W):
    """Coordinates of i.i.d. N(0, 40^2) flows, one pixel in ten moved 10^6 px
    left or right and another one in ten up or down: many taps land outside a
    block's window (the device-memory branch) or outside the image."""
    _, x, y = level0_inputs(torch, torch.float32, gen, scale=40.0, b=b, h=h, w=w, c=1)
    for t in (x, y):
        far = torch.rand(t.shape, generator=gen, device="cuda") < 0.1
        sign = torch.randint(0, 2, t.shape, generator=gen, device="cuda") * 2.0 - 1.0
        t.copy_(torch.where(far, t + 1e6 * sign, t))
    return x, y


def overlap_add_sets(torch, gen):
    """The sets of ``check_overlap_add``: name -> (b, h, w, make() -> (cx, cy)).

    ``iid``: the level-0 timing flows (i.i.d. N(0, 5^2)); ``smooth``: gentle
    smooth flows (N(0, 2^2) at a quarter of the resolution, upsampled), whose
    taps all fall in their block's window; ``smooth8``: the timing's smooth
    flows (N(0, 8^2)); ``far``: ``far_coords``; ``ragged``: B=3, H in {1, 13},
    W in {1, 3, 77}, i.i.d. N(0, 2^2) (tiles past the edge, rows that are no
    multiple of 4 floats, so each row's head and tail quads)."""
    def level0(**kw):
        return lambda b=B, h=H, w=W: level0_inputs(torch, torch.float32, gen, b=b, h=h, w=w,
                                                   c=1, **kw)[1:]

    sets = {"iid": (B, H, W, level0()), "smooth": (B, H, W, level0(smooth=True, smooth_scale=2.0)),
            "smooth8": (B, H, W, level0(smooth=True)),
            "far": (B, H, W, lambda b=B, h=H, w=W: far_coords(torch, gen, b, h, w))}
    for h in RAGGED_H:
        for w in RAGGED_W:
            sets[f"ragged {RAGGED_B}x{h}x{w}"] = (RAGGED_B, h, w, level0(scale=2.0))
    return sets


def check_overlap_add(torch, wk, gen, count_lib) -> list:
    """splat and warp_bwd_dimg against their plain versions on every set of
    ``overlap_add_sets``, at the level-0 tolerances: warp_bwd_dimg at C = 2, 3
    (C = 1..5 on the ragged sets: every compiled channel count and the generic
    instance), f32 and bf16, pad "zeros" and, where few taps pile up on the
    image's edge (``iid``, ``smooth``, ragged), "border"; the splat over 2B maps
    (B on the ragged sets) into the source shape and, on the ragged sets, into
    (h + 5, 2w + 1) and (h/2, w/3) as well. The taps of each branch come from
    ``count_lib``, the test build (``wk.COUNT_TAPS``), on the same inputs: the
    ``far`` set must reach the device-memory branch of both kernels, the
    ``smooth`` set the window alone. Returns one row per comparison."""
    release = wk._lib
    rows, branches = [], {}

    def count(kernel, name, fn):
        wk._lib = count_lib
        try:
            wk.tap_counts(count_lib)
            fn()
            torch.cuda.synchronize()
            got = wk.tap_counts(count_lib)
        finally:
            wk._lib = release
        old = branches.get((kernel, name), (0, 0))
        branches[(kernel, name)] = (old[0] + got[0], old[1] + got[1])

    for name, (b, h, w, make) in overlap_add_sets(torch, gen).items():
        ragged = name.startswith("ragged")
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            for c in (RAGGED_C if ragged else (2, 3)):
                cx, cy = make(b=b, h=h, w=w)
                img = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 5).to(dtype)
                g = (torch.rand(b, h, w, c, generator=gen, device="cuda") * 2 - 1).to(dtype)
                pads = [("zeros", (cx, cy))]
                if name in ("iid", "smooth") or ragged:
                    # Clamped far-out coordinates pile up on the edge: the "far" and
                    # "smooth8" sums there pass 16, where one bf16 ulp is above TOL.
                    pads.append(("border", (cx.clamp(0, w - 1), cy.clamp(0, h - 1))))
                for pad, (x, y) in pads:
                    ours = wk.warp_bwd_dimg(img, x, y, g)
                    torch.cuda.synchronize()
                    e = [max_err(a, p) for a, p in zip(ours, wk.warp_bwd_dimg_plain(img, x, y, g))]
                    case = f"C={c} {dn} {pad}"
                    rows.append({"kernel": "warp_bwd_dimg", "set": name, "case": case,
                                 "err": e[0], "tol": TOL[("warp_bwd_dimg", dn)]})
                    rows.append({"kernel": "warp_bwd_dimg dcx/dcy", "set": name, "case": case,
                                 "err": max(e[1:]), "tol": TOL[("warp_bwd", "float32")]})
                    count("warp_bwd_dimg", name, lambda: wk.warp_bwd_dimg(img, x, y, g))
        maps = b if ragged else 2 * B
        tx, ty = make(b=maps, h=h, w=w)
        outs = ((h, w), (h + 5, 2 * w + 1), (max(h // 2, 1), max(w // 3, 1))) if ragged else ((h, w),)
        for oh, ow in outs:
            dens = wk.splat(tx, ty, oh, ow)
            torch.cuda.synchronize()
            rows.append({"kernel": "splat", "set": name, "case": f"out {oh}x{ow}",
                         "err": max_err(dens, wk.splat_plain(tx, ty, oh, ow)),
                         "tol": TOL[("splat", "float32")]})
            count("splat", name, lambda: wk.splat(tx, ty, oh, ow))
    worst = {}
    for r in rows:
        key = (r["kernel"], r["set"].split(" ")[0], r["case"].split(" ")[1]
               if r["kernel"].startswith("warp") else "float32")
        worst[key] = max(worst.get(key, 0.0), r["err"])
    log("kernel overlap-add sets, max_abs_err: " + ", ".join(
        f"{k} {s} {dn} {v:.3e}" for (k, s, dn), v in worst.items()))
    log("kernel overlap-add taps (shared window / device memory), test build: " + ", ".join(
        f"{k} {s} {n[0]}/{n[1]}" for (k, s), n in branches.items()))
    for k in ("splat", "warp_bwd_dimg"):
        if branches[(k, "far")][1] == 0:
            raise RuntimeError(f"{k}: the far set reached no device-memory tap")
        if branches[(k, "smooth")][1] != 0 or branches[(k, "smooth")][0] == 0:
            raise RuntimeError(f"{k}: the smooth set left the shared window")
    return rows


def phase_step(torch, wk, dtype) -> tuple[dict, float]:
    """Three AMD training steps at full width in ``dtype``; returns (launch counts, step ms)."""
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.train import create_train_state, make_train_step

    model = build_amd_model(amd_model_kwargs(), device="cuda", seed=0, dtype=dtype)
    state = create_train_state(TRAIN_CFG, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step()
    gen = torch.Generator(device="cuda").manual_seed(0)
    imgs = torch.randn(B, 2, H, H, 3, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.reset_launch_counts()
    times = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        losses = step(state, {"imgs": imgs}, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in losses.items()}
        log(f"step {i} ({str(dtype).split('.')[1]}): {times[-1]:.1f} ms, losses {vals}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite loss at step {i}: {vals}")
    counts = dict(wk.LAUNCHES)
    log(f"launches over {STEPS} steps: {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k in STEP_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the step: {missing}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise RuntimeError("non-finite parameters after the steps")
    return counts, sum(times[1:]) / len(times[1:])


def image_grad_readings(torch, dev: str) -> dict:
    """The flow warp of ``occu_mask_bidirection`` at the level-0 shape on ``dev``.

    flow12 is smooth (a few pixels), flow21 its negative plus noise, so the
    forward-backward check passes in places and fails in others. Returns, on
    the CPU, a seeded scalar of ``flow_warp(flow21, flow12, pad="zeros")``,
    its gradients in flow21 (the image cotangent) and in flow12, the warped
    flow and the bidirectional occlusion mask.
    """
    from rcf_tpu_torch.ops.warp import flow_warp, occu_mask_bidirection

    gen = torch.Generator().manual_seed(5)
    ys = torch.arange(H, dtype=torch.float32)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32)[None, :, None]
    phase = torch.rand(B, 1, 1, 2, generator=gen) * 2 * math.pi
    flow12 = 4.0 * torch.sin(ys / 23.0 + xs / 31.0 + phase)
    flow21 = -flow12 + torch.randn(B, H, W, 2, generator=gen) * 0.6
    wgt = torch.rand(B, H, W, 2, generator=gen) - 0.5
    f12, f21 = (f.to(dev).requires_grad_() for f in (flow12, flow21))
    warped = flow_warp(f21, f12, pad="zeros")
    value = (warped.double() * wgt.to(dev).double()).sum()  # f64: no summation-order noise
    d21, d12 = torch.autograd.grad(value, (f21, f12))
    mask = occu_mask_bidirection(f12.detach(), f21.detach())
    return {"value": value.item(), "dimg": d21.cpu(), "dflow": d12.cpu(),
            "warped": warped.detach().cpu(), "flow12": flow12, "mask": mask.cpu()}


def image_grad_errors(cpu: dict, cuda: dict) -> dict:
    """The card's readings against the CPU's, keyed as ``IMG_LIMITS``, and the
    bidirectional mask: pixels that differ, and pixels whose check is clear of
    its threshold by more than 1e-4 on the CPU (only those must agree)."""
    f12, fw = cpu["flow12"], cpu["warped"]
    lhs = ((f12 + fw) ** 2).sum(-1)
    rhs = 0.01 * ((f12**2).sum(-1) + (fw**2).sum(-1)) + 0.5
    clear = (lhs - rhs).abs() > 1e-4
    return {"value_rel": abs(cuda["value"] - cpu["value"]) / abs(cpu["value"]),
            "dimg_rel": rel_max(cuda["dimg"], cpu["dimg"]),
            "dflow_rel": rel_max(cuda["dflow"], cpu["dflow"]),
            "mask_clear_share": float(clear.float().mean()),
            "mask_clear_differ": int((cuda["mask"] != cpu["mask"])[clear].sum())}


def image_grad_failures(errs: dict) -> list:
    failed = [k for k, lim in IMG_LIMITS.items() if not errs[k] <= lim]
    if errs["mask_clear_differ"] != 0 or not errs["mask_clear_share"] > 0.99:
        failed.append("mask")
    return failed


def phase_image_grad(torch, wk) -> int:
    """The image-gradient path on the card against the CPU; returns warp_bwd_dimg's launches."""
    cpu = image_grad_readings(torch, "cpu")
    wk.reset_launch_counts()
    cuda = image_grad_readings(torch, "cuda")
    torch.cuda.synchronize()
    counts = dict(wk.LAUNCHES)
    errs = image_grad_errors(cpu, cuda)
    log(f"image_grad: launches {counts}; occluded share {float(cpu['mask'].mean()):.3f}; "
        + ", ".join(f"{k} {v:.2e}" + (f" (tol {IMG_LIMITS[k]})" if k in IMG_LIMITS else "")
                    for k, v in errs.items()))
    if counts["warp_bwd_dimg"] == 0 or counts["warp_fwd"] == 0:
        raise RuntimeError(f"the image-gradient path launched no warp_bwd_dimg/warp_fwd: {counts}")
    failed = image_grad_failures(errs)
    if failed:
        raise RuntimeError(f"the image-gradient path disagrees with the CPU: {failed}")
    return counts["warp_bwd_dimg"]


def reference_forward(torch, dev: str) -> dict:
    """The reference computations on one device, TF32 off, returned on the CPU.

    ``model``: the AMD forward and backward (train mode, no dropout) at a small
    input: the loss, the mask probabilities and a flownet weight gradient.
    ``unflow``: the AMD recipe's unFlow loss on seeded random flows (5 levels
    from 128x192, a few pixels long, so that taps leave the frame) and its
    gradient in the flows; ``bidir`` the same with ``occ_from_back=False``.
    ``model_bf16``: the bf16 AMD forward (train mode, no dropout, no backward)
    at the same small input and flow_size 384x640: the loss and the finest
    forward flow. ``feat_warp``: a seeded bf16 feature map warped by a seeded
    flow at PWC-Lite's finest level (96x160, C=32).
    """
    import dataclasses

    from rcf_tpu_torch.losses import unflow_loss
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.models.amd.amd_model import _FLOW_CFG
    from rcf_tpu_torch.ops.warp import flow_warp

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(3)
        kw = amd_model_kwargs(dropout=0.0, flow_size=(128, 192))
        imgs = torch.randn(2, 2, 64, 64, 3, generator=gen)
        model = build_amd_model(kw, device=dev, seed=0)
        losses, probs = model(imgs.to(dev))
        losses["loss"].backward()
        grad = model.flownet.conv_1x1[4][0].weight.grad
        out = {"model": (losses["loss"].item(), probs.detach().cpu(), grad.cpu())}

        im1, im2 = (torch.rand(2, 128, 192, 3, generator=gen).to(dev) for _ in range(2))
        flows = [(torch.randn(2, 128 >> i, 192 >> i, 4, generator=gen) * (4.0 / 2**i))
                 .to(dev).requires_grad_() for i in range(5)]
        scored = [f for f, w in zip(flows, _FLOW_CFG.w_scales) if w > 0]
        bidir = dataclasses.replace(_FLOW_CFG, occ_from_back=False)
        for key, cfg in (("unflow", _FLOW_CFG), ("bidir", bidir)):
            loss = unflow_loss(flows, im1, im2, cfg)[0]
            grads = torch.autograd.grad(loss, scored)
            out[key] = (loss.item(), torch.cat([g.flatten() for g in grads]).cpu())

        model = build_amd_model(amd_model_kwargs(dropout=0.0), device=dev, seed=0,
                                dtype=torch.bfloat16)
        flows_out = {}
        hook = model.flownet.register_forward_hook(lambda m, i, o: flows_out.update(o))
        with torch.no_grad():
            losses, _ = model(imgs.to(dev))
        hook.remove()
        out["model_bf16"] = (losses["loss"].item(), flows_out["flows_fw"][0].float().cpu())

        feat = torch.rand(2, 96, 160, 32, generator=gen).bfloat16()
        fl = torch.randn(2, 96, 160, 2, generator=gen) * 3.0
        out["feat_warp"] = flow_warp(feat.to(dev), fl.to(dev)).cpu()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def reference_errors(cpu: dict, cuda: dict) -> dict:
    """The card's readings against the CPU's, keyed as ``REF_LIMITS``."""
    def rel(a: float, b: float) -> float:
        return abs(a - b) / abs(b) if math.isfinite(a) else math.inf

    (lc, pc, gc), (lg, pg, gg) = cpu["model"], cuda["model"]
    (uc, uhc), (ug, uhg) = cpu["unflow"], cuda["unflow"]
    (bc, bhc), (bg, bhg) = cpu["bidir"], cuda["bidir"]
    (mc, fc), (mg, fg) = cpu["model_bf16"], cuda["model_bf16"]
    return {"loss_rel": rel(lg, lc), "probs_err": float((pg - pc).abs().max()),
            "grad_rel": rel_max(gg, gc), "unflow_rel": rel(ug, uc),
            "unflow_grad_rel": rel_max(uhg, uhc), "bidir_rel": rel(bg, bc),
            "bidir_grad_rel": rel_max(bhg, bhc), "bf16_loss_rel": rel(mg, mc),
            "bf16_flow_rel": rel_max(fg, fc),
            "feat_warp_err": max_err(cuda["feat_warp"], cpu["feat_warp"])}


def reference_failures(errs: dict) -> list:
    """The readings above their limits (a NaN reading fails too)."""
    return [k for k, lim in REF_LIMITS.items() if not errs[k] <= lim]


def phase_reference(torch) -> None:
    """The AMD forward, the unFlow loss and their gradients on the card against the CPU path."""
    cpu, cuda = reference_forward(torch, "cpu"), reference_forward(torch, "cuda")
    errs = reference_errors(cpu, cuda)
    log(f"reference: AMD loss cuda {cuda['model'][0]:.6f} cpu {cpu['model'][0]:.6f}; unFlow loss "
        f"cuda {cuda['unflow'][0]:.6f} cpu {cpu['unflow'][0]:.6f}; bidirectional "
        f"cuda {cuda['bidir'][0]:.6f} cpu {cpu['bidir'][0]:.6f}; bf16 AMD loss "
        f"cuda {cuda['model_bf16'][0]:.6f} cpu {cpu['model_bf16'][0]:.6f}; "
        + ", ".join(f"{k} {v:.2e} (tol {REF_LIMITS[k]})" for k, v in errs.items()))
    failed = reference_failures(errs)
    if failed:
        raise RuntimeError(f"the card disagrees with the CPU path: {failed}")


def rcf_batch(torch, gen, b: int, hw: int, dev: str) -> dict:
    """A stage-1 batch: b pairs of hw^2 frames (N(0, 1), as normalized frames)
    and their forward and backward flows at hw^2 (N(0, 5^2) px)."""
    return {"imgs": torch.randn(b, 2, hw, hw, 3, generator=gen, device=dev),
            "gt_fw_flows": torch.randn(b, 1, hw, hw, 2, generator=gen, device=dev) * 5.0,
            "gt_bw_flows": torch.randn(b, 1, hw, hw, 2, generator=gen, device=dev) * 5.0}


def crf_frames(torch, gen, n: int, hw: int, dev: str, block: int = 32):
    """n normalized frames [n, hw, hw, 3] with flat colour regions and edges:
    N(0, 1) colours on blocks of block^2 pixels, plus N(0, 0.05^2) (about 3
    uint8 levels) of noise. The mean field runs several iterations on such
    content (1-16 measured on the card); on i.i.d. noise frames it stops
    after one or two."""
    cells = -(-hw // block)
    c = torch.randn(n, cells, cells, 3, generator=gen, device=dev)
    x = c.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :hw, :hw]
    return x + 0.05 * torch.randn(n, hw, hw, 3, generator=gen, device=dev)


def rcf_crf_batch(torch, gen, b: int, hw: int, dev: str) -> dict:
    """A stage-2.1 batch: ``rcf_batch`` with ``crf_frames`` as the frames, and the
    object channel 0 set (the YAMLs' ``object_channel: 0``)."""
    batch = rcf_batch(torch, gen, b, hw, dev)
    batch["imgs"] = crf_frames(torch, gen, 2 * b, hw, dev).reshape(b, 2, hw, hw, 3)
    return dict(batch, object_channel=0, object_channel_set=True)


def phase_rcf_step(torch, wk, recipe: str, crf: bool = False) -> dict:
    """Three training steps of ``recipe`` at full width (EMA on), batch 8 pairs
    of 384^2 frames and flows, in the recipe's compute dtype: stage 1, or with
    ``crf`` stage 2.1, the CRF target made from the EMA each step. Returns the
    step ms (mean of steps 2-3), the peak memory and the kernels' launches
    (stage 1 runs none of them); for stage 2.1 also the mean field's
    iterations and host syncs and crf_filter's launches per step, failing if
    crf_filter never launched."""
    from rcf_tpu_torch.models import build_model
    from rcf_tpu_torch.ops import crf as crf_ops
    from rcf_tpu_torch.ops import crf_kernels as ck
    from rcf_tpu_torch.train import create_train_state, make_train_step, maybe_crf_fn

    recipes = RCF_CRF_RECIPES if crf else RCF_RECIPES
    dtype = (torch.bfloat16 if recipes[recipe]["compute_dtype"] == "bfloat16" else torch.float32)
    cfg = (dict(recipes[recipe]["train"], model_kwargs=recipes[recipe]["model_kwargs"]) if crf
           else rcf_train_cfg(recipe))
    model = build_model(cfg["model_kwargs"], device="cuda", seed=0, dtype=dtype)
    state = create_train_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(crf_fn=maybe_crf_fn(model))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = (rcf_crf_batch if crf else rcf_batch)(torch, gen, B, H, "cuda")
    ema0 = {k: t.clone() for k, t in model.state_dict().items() if "_ema." in k}
    name = f"{recipe} stage {'2.1' if crf else '1'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.reset_launch_counts()
    ck.reset_launch_counts()
    crf_ops.reset_stats()
    times = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        losses = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in losses.items()}
        log(f"{name} step {i} ({str(dtype).split('.')[1]}): {times[-1]:.1f} ms, losses {vals}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"{name}: non-finite loss at step {i}: {vals}")
        if crf and "loss_crf" not in vals:
            raise RuntimeError(f"{name}: no loss_crf at step {i}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(wk.LAUNCHES)
    out = {"step_ms": sum(times[1:]) / len(times[1:]), "peak_gib": peak, "launches": counts}
    counts.update(ck.LAUNCHES)
    if crf:
        out.update(iterations_per_step=crf_ops.STATS["iterations"] / STEPS,
                   host_syncs_per_step=crf_ops.STATS["host_syncs"] / STEPS,
                   crf_filter_per_step=counts["crf_filter"] / STEPS)
        if counts["crf_filter"] == 0:
            raise RuntimeError(f"{name}: crf_filter never launched")
    sd = model.state_dict()
    if not all(torch.isfinite(t).all() for t in sd.values() if t.is_floating_point()):
        raise RuntimeError(f"{name}: non-finite parameters or statistics after the steps")
    # An EMA entry moves by (1 - ema_m) times its gap to the weights: at stage
    # 2.1's learning rate (1e-5) a BN scale of ~1 moves by ~1e-8, under half an
    # f32 ulp. A tensor must move where that increment passes one ulp somewhere.
    eps, m = torch.finfo(torch.float32).eps, cfg["model_kwargs"].get("ema_m", 0.999)
    due = {k for k, t in ema0.items() if t.is_floating_point() and bool(
        ((1 - m) * (sd[k.replace("_ema.", ".")] - t).abs() > eps * t.abs()).any())}
    still = [k for k in due if torch.equal(sd[k], ema0[k])]
    if still or not due:
        raise RuntimeError(f"{name}: the EMA did not move in {len(still)} of {len(due)} tensors "
                           f"due to move: {still[:5]}")
    log(f"{name}: {len(due)} of {len(ema0)} EMA tensors due to move moved; kernel launches "
        f"{counts}; peak memory "
        f"{peak:.2f} GiB" + (f"; per step {out['iterations_per_step']:.1f} mean-field "
                             f"iterations, {out['host_syncs_per_step']:.1f} host syncs"
                             if crf else ""))
    return out


# Stage-1 card-vs-CPU check (TF32 off), the DAVIS recipe's full-width model
# with the EMA on, no dropout, at 2 pairs of 128^2 frames (32^2 masks): one
# training step on each device from the same weights and batch. Readings:
# - every loss of the step, relative (``loss_rel``: the worst key);
# - the step's mask probabilities, max abs error;
# - the weight gradients of ``decode_head2.conv_seg`` and of the flow head's
#   ``flow_feat_after_agg[0]``, each over its largest entry;
# - the EMA's increment in ``decode_head2_ema.conv_seg`` (weight and bias),
#   L2 error over its L2 norm (an Adam update is ~lr * sign(g): where a
#   gradient is float noise the sign may flip, so not the largest entry);
# - ``demean_affine_flow`` alone on 16 seeded soft masks and smooth flows at
#   48^2 (the STv2 recipe's masks), over its largest entry;
# - one step of the SegTrackv2 recipe's model in bf16 (input_transform null,
#   the affine WLS in the flow head, compactness on channel 0, 16^2 masks)
#   on the same batch: every loss, relative (``stv2_loss_rel``: the worst
#   key); the bf16 probabilities, max abs error (``stv2_probs_err``); and the
#   mask head's logits, RMS error over the RMS gap between the CPU's bf16
#   and f32 logits of the same step (``stv2_logit_ratio``): a card that ran
#   this model in f32 reads about 1, whatever the limits on the rest.
# Sound readings on an H100 (first run): 8.6e-8, 1.2e-5, 3.8e-5, 4.3e-7,
# 6.6e-9, 1.2e-6; each limit sits 8-15000x above its reading. The STv2 bf16
# readings: 1.1e-3 (loss_compactness), 3.9e-2 and 0.61 (the card's and the
# CPU's bf16 convolutions round apart over 50 layers, 0.61 of bf16's own
# gap), with limits 4.4x, 1.3x and 1.3x above them; the same model run in
# f32 on the card reads 6.7e-4, 7.1e-2 and 1.00.
# tools/smoke_fault_check.py prints these readings for each planted fault.
RCF_REF_HW = 128
RCF_REF_LIMITS = {"loss_rel": 1e-5, "probs_err": 1e-4, "seg_grad_rel": 1e-3,
                  "agg_grad_rel": 1e-4, "ema_rel": 1e-4, "affine_rel": 1e-4,
                  "stv2_loss_rel": 5e-3, "stv2_probs_err": 5e-2, "stv2_logit_ratio": 0.8}


def rcf_step_readings(torch, dev: str, recipe: str, gen, dtype=None) -> tuple[dict, object]:
    """One training step of ``recipe``'s full-width model (EMA on, no dropout,
    masks scaled with the frames) on 2 pairs of RCF_REF_HW^2 frames drawn from
    ``gen``, in ``dtype`` (default: the recipe's compute dtype): the losses, the
    mask head's logits, the probabilities and the EMA's increment in
    ``decode_head2_ema.conv_seg`` on the CPU, and the model."""
    from rcf_tpu_torch.models import build_model
    from rcf_tpu_torch.train import create_train_state, make_train_step

    hw = RCF_REF_HW
    m = RCF_RECIPES[recipe]["model_kwargs"]["mask_size"][0] * hw // H
    if dtype is None:
        dtype = (torch.bfloat16 if RCF_RECIPES[recipe]["compute_dtype"] == "bfloat16"
                 else torch.float32)
    cfg = rcf_train_cfg(recipe, dropout=0.0, mask_size=(m, m))
    model = build_model(cfg["model_kwargs"], device=dev, seed=0, dtype=dtype)
    state = create_train_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    batch = {k: v.to(dev) for k, v in rcf_batch(torch, gen, 2, hw, "cpu").items()}
    out = {}
    hooks = [model.register_forward_hook(
                 lambda mod, i, o: out.update(probs=o[1].detach().float().cpu())),
             model.decode_head2.register_forward_hook(
                 lambda mod, i, o: out.update(logits=o.detach().float().cpu()))]
    seg = model.decode_head2_ema.conv_seg
    ema0 = torch.cat([seg.weight.flatten(), seg.bias]).clone()
    losses = make_train_step()(state, batch)
    for h in hooks:
        h.remove()
    out["losses"] = {k: v.item() for k, v in losses.items()}
    out["ema_inc"] = (torch.cat([seg.weight.flatten(), seg.bias]) - ema0).cpu()
    return out, model


def rcf_reference_readings(torch, dev: str) -> dict:
    """The stage-1 readings above on one device, TF32 off, returned on the CPU."""
    from rcf_tpu_torch.losses.common_fate import demean_affine_flow

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(6)
        out, model = rcf_step_readings(torch, dev, "rcf", gen)
        out["seg_grad"] = model.decode_head2.conv_seg.weight.grad.cpu()
        out["agg_grad"] = model.decode_head.flow_feat_after_agg[0].weight.grad.cpu()
        del model

        n, m = 2 * B, 48
        masks = torch.softmax(torch.randn(n, m, m, 4, generator=gen) * 2.0, dim=-1)
        ys = torch.arange(m, dtype=torch.float32)[:, None, None] / m
        xs = torch.arange(m, dtype=torch.float32)[None, :, None] / m
        coef = torch.randn(n, 1, 1, 3, 2, generator=gen) * 6.0
        flow = coef[..., 0, :] * ys + coef[..., 1, :] * xs + coef[..., 2, :]
        flow = flow + torch.randn(n, m, m, 2, generator=gen) * 0.5
        out["affine"] = demean_affine_flow(masks.to(dev), flow.to(dev)).cpu()

        out["stv2"], _ = rcf_step_readings(torch, dev, "rcf_stv2",
                                           torch.Generator().manual_seed(6))
        if dev == "cpu":  # the size of bf16's own deviation, for stv2_logit_ratio
            f32, _ = rcf_step_readings(torch, dev, "rcf_stv2", torch.Generator().manual_seed(6),
                                       dtype=torch.float32)
            out["stv2"]["logits_f32"] = f32["logits"]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _loss_rels(cpu: dict, cuda: dict) -> dict:
    return {k: abs(cuda["losses"][k] - v) / abs(v) for k, v in cpu["losses"].items()}


def _worst(rels: dict) -> float:
    return max(rels.values()) if all(map(math.isfinite, rels.values())) else math.inf


def rcf_reference_errors(cpu: dict, cuda: dict) -> dict:
    """The card's stage-1 readings against the CPU's, keyed as ``RCF_REF_LIMITS``
    (and each loss's own relative error, ``rel_<key>`` and ``stv2_rel_<key>``)."""
    rels, rels16 = _loss_rels(cpu, cuda), _loss_rels(cpu["stv2"], cuda["stv2"])
    inc_c, inc_g = cpu["ema_inc"].double(), cuda["ema_inc"].double()
    return {"loss_rel": _worst(rels),
            "probs_err": max_err(cuda["probs"], cpu["probs"]),
            "seg_grad_rel": rel_max(cuda["seg_grad"], cpu["seg_grad"]),
            "agg_grad_rel": rel_max(cuda["agg_grad"], cpu["agg_grad"]),
            "ema_rel": float((inc_g - inc_c).norm() / inc_c.norm()),
            "affine_rel": rel_max(cuda["affine"], cpu["affine"]),
            "stv2_loss_rel": _worst(rels16),
            "stv2_probs_err": max_err(cuda["stv2"]["probs"], cpu["stv2"]["probs"]),
            "stv2_logit_ratio": rms(cuda["stv2"]["logits"] - cpu["stv2"]["logits"])
            / rms(cpu["stv2"]["logits_f32"] - cpu["stv2"]["logits"]),
            **{f"rel_{k}": v for k, v in rels.items()},
            **{f"stv2_rel_{k}": v for k, v in rels16.items()}}


def rcf_reference_failures(errs: dict) -> list:
    return [k for k, lim in RCF_REF_LIMITS.items() if not errs[k] <= lim]


def phase_rcf_reference(torch) -> dict:
    """The stage-1 step on the card against the port's CPU path."""
    cpu, cuda = rcf_reference_readings(torch, "cpu"), rcf_reference_readings(torch, "cuda")
    errs = rcf_reference_errors(cpu, cuda)
    log(f"rcf_reference: losses cuda {cuda['losses']} cpu {cpu['losses']}; STv2 bf16 losses "
        f"cuda {cuda['stv2']['losses']} cpu {cpu['stv2']['losses']}; "
        + ", ".join(f"{k} {v:.2e}" + (f" (tol {RCF_REF_LIMITS[k]})" if k in RCF_REF_LIMITS else "")
                    for k, v in errs.items()))
    failed = rcf_reference_failures(errs)
    if failed:
        raise RuntimeError(f"the stage-1 step on the card disagrees with the CPU: {failed}")
    return errs


# crf_filter against its plain version on the card, with TF32 matmuls and
# convolutions switched on (neither side may depend on the switch), each set
# with its limit on the max abs error (the filtered values lie in [0, 1]).
# Each logit cancels half-norms of ~1e3 (srgb 5), so both sides carry ~1e-4
# of f32 rounding in it; on the structured sets each side reads <= 3.6e-5
# from a float64 filter, <= 5.0e-5 from the other (first chip run, an H100
# 80GB HBM3 at 700 W);
# the i.i.d. set, whose pixels have few near neighbours, reads up to 1.4e-4
# from float64 on the CPU. The kernel's split-TF32 logits of centred
# features read <= 1.5e-5 from float64 on the structured sets and 3.6e-5 on
# the i.i.d. one, 1.4e-4 from the plain version there (an H100 80GB HBM3 at
# 700 W).
# The same limit holds each set's distance, kernel to a float64 filter.
CRF_TOL = {"davis": 2e-4, "iid": 1e-3, "ragged": 2e-4, "d2": 2e-4, "stv2": 2e-4}
# The filter's least work by the card's units, whatever the route: one ex2 a
# pair on the multi-function unit (16 per SM and clock, against 128 FP32
# lanes doing two flops each) and two FP32 instructions a pair for the sums
# (num's FMA, den's add). The dot can run on the tensor cores, another unit
# (a K = 8 dot in split TF32, 48 flops a pair at 495 TFLOP/s), under both.
EX2_PER_S = F32_FLOPS / 16
FP32_INST_PER_S = F32_FLOPS / 2
CRF_REPLACES = "rcf_tpu/ops/crf.py:98"  # _normalized_filter: XLA code, not a TPU kernel


def crf_bound(b: int, n: int, d: int) -> tuple[float, str, str]:
    """The least time of one crf_filter call on b images of n pixels: bytes (the
    features, values and output once) or operations (n^2 pairs an image,
    whatever the data: the larger of their ex2 and their two FP32 instructions
    each), and the unit that binds."""
    pairs = b * n * n
    t_ex2, t_fp32 = pairs / EX2_PER_S * 1e3, pairs * 2 / FP32_INST_PER_S * 1e3
    t_bytes = b * n * (d + 2) * 4 / HBM_BYTES_PER_S * 1e3
    if t_bytes >= max(t_ex2, t_fp32):
        return t_bytes, "bytes", "device memory"
    return max(t_ex2, t_fp32), "operations", "ex2" if t_ex2 >= t_fp32 else "fp32"


def crf_features(torch, crf_ops, gen, b: int, h: int, w: int, scale: float):
    """Appearance features [b, h*w, 5] of ``crf_frames`` (blocks of 8 pixels on
    the grid, as 32 on the 384^2 frames) at the recipes' sxy 60 and srgb 5,
    with the grid's ``xy_scale``; features of i.i.d. colours where ``h`` is 0."""
    rgb = crf_ops.unnormalize_to_uint8(crf_frames(torch, gen, b, max(h, w), "cuda", block=8))
    return crf_ops.pixel_features(rgb[:, :h, :w].contiguous(), 60.0, 5.0, (scale, scale))


def crf_filter_sets(torch, crf_ops, gen) -> dict:
    """name -> (feat, values) of the kernel phase: the DAVIS grid (16 images of
    96^2, xy_scale 1/4), i.i.d. features at its scales (x, y in [0, 96/15),
    colours / 5 in [0, 51)), a ragged N (3 images of 97 x 61), D = 2 (xy
    features at sxy 3 on 96^2) and the SegTrackv2 grid (16 of 128^2, 1/3)."""
    n = 96 * 96
    iid = torch.cat([torch.rand(16, n, 2, generator=gen, device="cuda") * (96 / 15),
                     torch.rand(16, n, 3, generator=gen, device="cuda") * 51.0], dim=-1)
    feats = {"davis": crf_features(torch, crf_ops, gen, 16, 96, 96, 0.25), "iid": iid,
             "ragged": crf_features(torch, crf_ops, gen, 3, 97, 61, 0.25),
             "d2": crf_ops.xy_features(96, 96, 3.0, device="cuda").expand(16, -1, -1).contiguous(),
             "stv2": crf_features(torch, crf_ops, gen, 16, 128, 128, 1 / 3)}
    return {k: (f, torch.rand(f.shape[:2], generator=gen, device="cuda")) for k, f in feats.items()}


def crf_filter_f64(torch, feat, values, chunk: int = 512):
    """The filter in float64 (exp of exact-enough logits): the accuracy yardstick."""
    f, v = feat.double(), values.double()
    sq = (f * f).sum(-1) * 0.5
    out = []
    for c in range(0, f.shape[1], chunk):
        w = torch.exp(f[:, c:c + chunk] @ f.transpose(1, 2) - sq[:, None, :]
                      - sq[:, c:c + chunk, None])
        out.append((w * v[:, None, :]).sum(-1) / w.sum(-1))
    return torch.cat(out, dim=1).float()


def crf_kernel_readings(torch, ck, crf_ops) -> dict:
    """name -> (kernel to plain, kernel to float64, plain to float64): the max abs
    errors of crf_filter on every set of ``crf_filter_sets``, TF32 on."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        gen = torch.Generator(device="cuda").manual_seed(4)
        out = {}
        for name, (feat, vals) in crf_filter_sets(torch, crf_ops, gen).items():
            got = ck.crf_filter(feat, vals)
            torch.cuda.synchronize()
            plain = ck.crf_filter_plain(feat, vals)
            exact = crf_filter_f64(torch, feat, vals)
            out[name] = (max_err(got, plain), max_err(got, exact), max_err(plain, exact))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def crf_kernel_failures(readings: dict) -> list:
    """The sets whose kernel is farther than ``CRF_TOL`` from the plain version
    or from float64 (the latter marked ``(float64)``)."""
    failed = []
    for name, (to_plain, to_f64, _) in readings.items():
        if not to_plain <= CRF_TOL[name]:
            failed.append(name)
        if not to_f64 <= CRF_TOL[name]:
            failed.append(f"{name} (float64)")
    return failed


def phase_crf_kernel(torch, ck, crf_ops) -> dict:
    """crf_filter against crf_filter_plain and against a float64 filter on every
    set of ``crf_filter_sets``, TF32 on, each at the set's ``CRF_TOL``; the plain
    version's distance to float64 is logged. Returns the errors to the plain."""
    readings = crf_kernel_readings(torch, ck, crf_ops)
    for name, (to_plain, to_f64, plain_f64) in readings.items():
        log(f"kernel crf_filter {name}: max_abs_err {to_plain:.3e} (tol {CRF_TOL[name]}); from "
            f"float64: kernel {to_f64:.3e} (tol {CRF_TOL[name]}), plain {plain_f64:.3e}")
    failed = crf_kernel_failures(readings)
    if failed:
        raise RuntimeError(f"crf_filter disagrees with its plain version or float64 on {failed}")
    return {name: r[0] for name, r in readings.items()}


def crf_sdpa(torch, feat, values):
    """The library yardstick: ``F.scaled_dot_product_attention`` computing the
    same filter, the half-norm folded into one extra feature (q = [f, 1],
    k = [f, -|f|^2/2], v = [values], head dim padded to 8, ``scale=1.0``, f32).
    The port never calls it."""
    import torch.nn.functional as F

    b, n, d = feat.shape
    q, k, v = (feat.new_zeros(b, 1, n, 8) for _ in range(3))
    q[..., :d], q[..., d] = feat[:, None], 1.0
    k[..., :d], k[..., d] = feat[:, None], -0.5 * (feat * feat).sum(-1)[:, None]
    v[..., 0] = values[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)[:, 0, :, 0]


def traced_kernels(torch, fn) -> list:
    """The CUDA kernels one call of ``fn`` runs, by device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0]
    evts.sort(key=lambda e: -getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)))
    return [e.key for e in evts]


def crf_timing(torch, ck, crf_ops, launches: dict, err: float) -> dict:
    """The crf_filter row: at the DAVIS grid (16 x 96^2, D = 5) and, keys with
    ``_stv2``, the SegTrackv2 grid (16 x 128^2): ``ms``, ``plain_ms``,
    ``library_ms`` an eager loop on one input set, ``ms_device``,
    ``library_ms_device`` device time on ``cold_sets`` input sets (the L2 holds
    none), the bound, and the yardstick's kernels and error."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    row = {"name": "crf_filter", "route": "cuda", "source": "rcf_tpu_torch/csrc/crf.cu",
           "replaces": CRF_REPLACES, "replaces_kind": "XLA code, not a TPU kernel",
           "launches": sum(launches.values()), "launches_per_step": launches,
           "max_abs_err": err}
    for suffix, hw, scale in (("", 96, 0.25), ("_stv2", 128, 1 / 3)):
        def make():
            f = crf_features(torch, crf_ops, gen, 16, hw, hw, scale)
            return f, torch.rand(f.shape[:2], generator=gen, device="cuda")
        feat, vals = make()
        lib = crf_sdpa(torch, feat, vals)
        res = {"ms": cuda_ms(torch, lambda: ck.crf_filter(feat, vals)),
               "plain_ms": cuda_ms(torch, lambda: ck.crf_filter_plain(feat, vals), iters=2,
                                   warmup=1),
               "library_ms": cuda_ms(torch, lib)}
        sets = [(feat, vals)] + [make() for _ in range(cold_sets(nbytes(feat, vals, vals)) - 1)]
        res["ms_device"] = graph_ms(torch, [lambda f=f, v=v: ck.crf_filter(f, v) for f, v in sets])
        res["library_ms_device"] = graph_ms(torch, [crf_sdpa(torch, f, v) for f, v in sets])
        del sets
        res["bound_ms"], res["bound_by"], res["bound_unit"] = crf_bound(16, hw * hw, 5)
        res["library_max_abs_err"] = max_err(lib(), ck.crf_filter_plain(feat, vals))
        res["library_kernels"] = traced_kernels(torch, lib)[:3]
        log(f"timing crf_filter 16x{hw}^2 D=5: {res['ms']:.4f} ms, device {res['ms_device']:.4f} "
            f"ms (bound {res['bound_ms']:.4f} ms by {res['bound_by']}, {res['bound_unit']}, "
            f"{res['bound_ms'] / res['ms_device']:.0%} of it); plain {res['plain_ms']:.2f} ms; "
            f"library {res['library_ms']:.4f} ms, device {res['library_ms_device']:.4f} ms, "
            f"max_abs_err {res['library_max_abs_err']:.2e}, kernels {res['library_kernels']}")
        row.update({k + suffix: v for k, v in res.items()})
    return row


# Stage-2.1 card-vs-CPU check, TF32 off, in the manner of the stage-1 one:
# - the CRF on identical inputs, each recipe's settings (DAVIS: f32 masks,
#   the MAP-stability exit; SegTrackv2: bf16 masks, a fixed 50 iterations)
#   with the grid scaled with the frames as the masks are (96 and 128 on 384^2
#   frames: 32 and 43 on 128^2), on 4 seeded ``crf_frames`` of 128^2 and soft
#   masks, image 0 a clean two-colour split that stops at once: the share of
#   the grid's MAP that differs (``*_map_differ``), q1's max abs error and
#   the largest difference in an image's iterations;
# - one DAVIS stage-2.1 step at full width (f32, EMA on, no dropout, 32^2
#   masks and CRF grid) on 2 pairs of 128^2 ``crf_frames`` and flows, each
#   side making its own target: every loss, relative (``crf_loss_rel``: the
#   worst key, ``loss_crf`` among them), the gradient of
#   ``decode_head2.conv_seg`` over its largest entry, the EMA's increment in
#   ``decode_head2_ema.conv_seg`` and in the EMA copies' BN running
#   statistics, each L2 error over L2 norm, and the target pixels that differ;
# - one SegTrackv2 stage-2.1 step in bf16 on the same batch (16^2 masks, 43^2
#   grid): every loss, relative (bf16's looser reading: the tight check of
#   this recipe is its CRF on identical inputs above).
# Sound readings on an H100 80GB HBM3 at 700 W (first run, limits beside):
# DAVIS CRF MAP 0 (1e-3), q1 1.8e-3 (2e-2: where q1 sits near 0.5 an
# iteration multiplies a difference by up to scomp * 2 * q(1-q) = 2.5, and
# the filter's f32 noise is ~3e-5), iterations [1, 4, 5, 8] on both (1);
# SegTrackv2 CRF MAP 0, q1 1.8e-5, iterations 50 (0); the DAVIS step's
# losses 1.6e-7 (1e-4), gradient 6.8e-6 (1e-3), EMA 3.9e-9 (1e-4), EMA
# statistics 1.9e-5 (1e-3), its targets equal; the SegTrackv2 step's
# losses 1.8e-2 (5e-2): the card's and the CPU's bf16 EMA masks round apart
# (stage 1's probabilities read 3.9e-2), and 0.4% of its target pixels fall
# on the other side of the MAP threshold, which moves loss_crf.
# tools/smoke_fault_check.py prints these readings for each planted fault.
RCF_CRF_REF_LIMITS = {"rcf_map_differ": 1e-3, "rcf_q1_err": 2e-2, "rcf_iters_diff": 1,
                      "rcf_stv2_map_differ": 1e-3, "rcf_stv2_q1_err": 2e-2,
                      "rcf_stv2_iters_diff": 0, "crf_loss_rel": 1e-4, "crf_seg_grad_rel": 1e-3,
                      "crf_ema_rel": 1e-4, "crf_ema_stats_rel": 1e-3,
                      "crf_stv2_loss_rel": 5e-2}


def crf_ref_head(recipe: str) -> dict:
    """The recipe's crf_head with its grid scaled from 384^2 to RCF_REF_HW^2 frames."""
    head = dict(RCF_CRF_RECIPES[recipe]["model_kwargs"]["crf_head"])
    head["resolution"] = [round(r * RCF_REF_HW / H) for r in head["resolution"]]
    return head


def crf_ref_inputs(torch):
    """4 normalized ``crf_frames`` of RCF_REF_HW^2 and soft masks (a smooth random
    field through a sigmoid, plus N(0, 0.1^2), in [0, 1]), on the CPU; image 0
    is a two-colour split with its mask on one side."""
    import torch.nn.functional as F

    hw = RCF_REF_HW
    gen = torch.Generator().manual_seed(8)
    imgs = crf_frames(torch, gen, 4, hw, "cpu", block=16)
    field = F.interpolate(torch.randn(4, 1, 8, 8, generator=gen), size=(hw, hw),
                          mode="bilinear", align_corners=False)[:, 0]
    masks = torch.sigmoid(3.0 * field) + 0.1 * torch.randn(4, hw, hw, generator=gen)
    imgs[0, :, : hw // 2] = torch.tensor([1.5, -1.0, -1.0])
    imgs[0, :, hw // 2:] = torch.tensor([-1.0, -1.0, 1.5])
    masks[0] = torch.where(torch.arange(hw) < hw // 2, 0.9, 0.05)
    return imgs, masks.clamp(0.0, 1.0)


def crf_ref_readings(torch, dev: str, recipe: str) -> dict:
    """The recipe's CRF (``crf_ref_head``) on ``crf_ref_inputs`` on one device, its
    masks in the recipe's dtype: q1 and the iterations, on the CPU."""
    from rcf_tpu_torch.ops.crf import make_crf_fn

    dtype = torch.bfloat16 if RCF_CRF_RECIPES[recipe]["compute_dtype"] == "bfloat16" else None
    imgs, masks = crf_ref_inputs(torch)
    q1, iters = make_crf_fn(**crf_ref_head(recipe)).soft(imgs.to(dev), masks.to(dev, dtype))
    return {"q1": q1.cpu(), "iters": iters.cpu()}


def rcf_crf_step_readings(torch, dev: str, recipe: str) -> dict:
    """One stage-2.1 step of ``recipe``'s full-width model (EMA on, no dropout,
    masks and CRF grid scaled with the frames) on 2 pairs of RCF_REF_HW^2 frames
    and flows, in the recipe's dtype: the losses, the CRF target, the gradient
    of ``decode_head2.conv_seg`` and the EMA's increments, on the CPU."""
    from rcf_tpu_torch.models import build_model
    from rcf_tpu_torch.train import create_train_state, make_train_step, maybe_crf_fn

    rec, hw = RCF_CRF_RECIPES[recipe], RCF_REF_HW
    kw = copy.deepcopy(rec["model_kwargs"])
    m = kw["mask_size"][0] * hw // H
    kw["mask_size"] = kw["decode_head"]["mask_size"] = [m, m]
    kw["decode_head2"]["dropout_ratio"] = kw["decode_head3"]["dropout_ratio"] = 0.0
    kw["crf_head"] = {"type": "CRFHead", **crf_ref_head(recipe)}
    dtype = torch.bfloat16 if rec["compute_dtype"] == "bfloat16" else torch.float32
    model = build_model(kw, device=dev, seed=0, dtype=dtype)
    state = create_train_state(dict(rec["train"], model_kwargs=kw), model,
                               steps_per_epoch=STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(9)
    batch = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in rcf_crf_batch(torch, gen, 2, hw, "cpu").items()}
    seg = model.decode_head2_ema.conv_seg
    stats = [t for k, t in model.state_dict().items() if "_ema." in k and "running" in k]
    w0 = torch.cat([seg.weight.flatten(), seg.bias]).clone()
    s0 = torch.cat([t.flatten() for t in stats]).clone()
    crf_fn, out = maybe_crf_fn(model), {}

    def recorded(imgs, masks):
        target = crf_fn(imgs, masks)
        out["target"] = target.cpu()
        return target

    losses = make_train_step(crf_fn=recorded)(state, batch)
    out.update(losses={k: v.item() for k, v in losses.items()},
               seg_grad=model.decode_head2.conv_seg.weight.grad.float().cpu(),
               ema_inc=(torch.cat([seg.weight.flatten(), seg.bias]) - w0).cpu(),
               ema_stats_inc=(torch.cat([t.flatten() for t in stats]) - s0).cpu())
    return out


def rcf_crf_reference_readings(torch, dev: str) -> dict:
    """The stage-2.1 readings above on one device, TF32 off, on the CPU."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {f"crf_{r}": crf_ref_readings(torch, dev, r) for r in RCF_CRF_RECIPES}
        out["step"] = rcf_crf_step_readings(torch, dev, "rcf")
        out["step_stv2"] = rcf_crf_step_readings(torch, dev, "rcf_stv2")
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def rcf_crf_reference_errors(cpu: dict, cuda: dict) -> dict:
    """The card's stage-2.1 readings against the CPU's, keyed as ``RCF_CRF_REF_LIMITS``
    (and each loss's own, ``crf_rel_<key>``, ``crf_stv2_rel_<key>``)."""
    errs = {}
    for r in RCF_CRF_RECIPES:
        c, g = cpu[f"crf_{r}"], cuda[f"crf_{r}"]
        errs[f"{r}_map_differ"] = float(((c["q1"] > 0.5) != (g["q1"] > 0.5)).float().mean())
        errs[f"{r}_q1_err"] = max_err(g["q1"], c["q1"])
        errs[f"{r}_iters_diff"] = int((g["iters"] - c["iters"]).abs().max())
        errs[f"{r}_iters"] = g["iters"].tolist()
    c, g = cpu["step"], cuda["step"]
    rels, rels16 = _loss_rels(c, g), _loss_rels(cpu["step_stv2"], cuda["step_stv2"])
    errs.update(crf_loss_rel=_worst(rels), crf_seg_grad_rel=rel_max(g["seg_grad"], c["seg_grad"]),
                crf_ema_rel=_rel_l2(g["ema_inc"], c["ema_inc"]),
                crf_ema_stats_rel=_rel_l2(g["ema_stats_inc"], c["ema_stats_inc"]),
                crf_stv2_loss_rel=_worst(rels16),
                crf_target_differ=int(((g["target"] - c["target"]).abs() > 1e-6).sum()),
                crf_stv2_target_differ=int(((cuda["step_stv2"]["target"]
                                             - cpu["step_stv2"]["target"]).abs() > 1e-6).sum()),
                **{f"crf_rel_{k}": v for k, v in rels.items()},
                **{f"crf_stv2_rel_{k}": v for k, v in rels16.items()})
    return errs


def rcf_crf_reference_failures(errs: dict) -> list:
    return [k for k, lim in RCF_CRF_REF_LIMITS.items() if not errs[k] <= lim]


def phase_rcf_crf_reference(torch) -> dict:
    """The stage-2.1 CRF and step on the card against the port's CPU path."""
    cpu, cuda = rcf_crf_reference_readings(torch, "cpu"), rcf_crf_reference_readings(torch, "cuda")
    errs = rcf_crf_reference_errors(cpu, cuda)
    log(f"rcf_crf_reference: losses cuda {cuda['step']['losses']} cpu {cpu['step']['losses']}; "
        f"STv2 bf16 cuda {cuda['step_stv2']['losses']} cpu {cpu['step_stv2']['losses']}; "
        + ", ".join(f"{k} {v if isinstance(v, (int, list)) else format(v, '.2e')}"
                    + (f" (tol {RCF_CRF_REF_LIMITS[k]})" if k in RCF_CRF_REF_LIMITS else "")
                    for k, v in errs.items()))
    failed = rcf_crf_reference_failures(errs)
    if failed:
        raise RuntimeError(f"stage 2.1 on the card disagrees with the CPU: {failed}")
    return errs


def warp_calls(torch, wk, img, cx, cy, g) -> dict:
    """name -> (kernel call, library call, bytes, operations) for warp_fwd and warp_bwd.

    The library yardsticks: ``F.grid_sample`` and its backward for the grid
    alone (dgrid = (dcx, dcy) times (W-1)/2, (H-1)/2) on the same image
    (NCHW) and grid. The grid takes the image's dtype (grid_sample asks for
    one dtype), so in bf16 the library reads a bf16 grid where the kernels
    read f32 coordinates.
    """
    import torch.nn.functional as F

    h, w, c = img.shape[1:]
    n_px = img.shape[0] * h * w
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([cx * (2.0 / (w - 1)) - 1.0, cy * (2.0 / (h - 1)) - 1.0],
                       dim=-1).to(img.dtype)
    return {
        "warp_fwd": (lambda: wk.warp_fwd(img, cx, cy),
                     lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True),
                     nbytes(img, cx, cy, img), n_px * (10 + 9 * c)),
        "warp_bwd": (lambda: wk.warp_bwd(img, cx, cy, g),
                     lambda: torch.ops.aten.grid_sampler_2d_backward(
                         g_nchw, img_nchw, grid, 0, 0, True, [False, True]),
                     nbytes(img, cx, cy, g, cx, cy), n_px * (12 + 14 * c)),
    }


def warp_set(torch, wk, gen, dtype, h, w, smooth: bool) -> dict:
    """warp_calls on one fresh input set (B=8, C=3, border coordinates)."""
    img, cx, cy = level0_inputs(torch, dtype, gen, h=h, w=w, smooth=smooth)
    cx, cy = cx.clamp(0, w - 1), cy.clamp(0, h - 1)
    g = torch.randn(B, h, w, C, generator=gen, device="cuda").to(dtype)
    return warp_calls(torch, wk, img, cx, cy, g)


LEVELS = ((384, 640), (192, 320), (96, 160), (48, 80))  # the step's warp shapes


def time_warps(torch, wk, gen, dtype, h, w, smooth: bool) -> dict:
    """warp_fwd and warp_bwd against their library calls, device time on
    ``cold_sets`` input sets: name -> {"ms_device", "library_ms_device", "bound_ms"}."""
    sets = [warp_set(torch, wk, gen, dtype, h, w, smooth)]
    sets += [warp_set(torch, wk, gen, dtype, h, w, smooth)
             for _ in range(cold_sets(sets[0]["warp_fwd"][2]) - 1)]
    return {name: {"ms_device": graph_ms(torch, [s[name][0] for s in sets]),
                   "library_ms_device": graph_ms(torch, [s[name][1] for s in sets]),
                   "bound_ms": bound(*sets[0][name][2:])[0]}
            for name in sets[0]}


def time_cold(torch, make, smooth: bool) -> dict:
    """A level0_specs entry's kernel and library call, device time on
    ``cold_sets`` input sets: {"ms_device", "library_ms_device", "bound_ms"}."""
    first = make(smooth)
    sets = [first] + [make(smooth) for _ in range(cold_sets(first[3]) - 1)]
    res = {"ms_device": graph_ms(torch, [s_[0] for s_ in sets]),
           "library_ms_device": graph_ms(torch, [s_[2] for s_ in sets]),
           "bound_ms": bound(*first[3:])[0]}
    del sets
    return res


def phase_warp_timing(torch, wk) -> dict:
    """The device readings beyond the level-0 rows: warp_fwd and warp_bwd at
    the step's four level shapes on both flow kinds (f32), and at level 0 in
    bf16; warp_bwd_dimg at level 0 in bf16 on both flow kinds. Returns the
    level-0 f32 smooth readings of the warps by name."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    sets = [("float32", hw, kind) for hw in LEVELS for kind in ("iid", "smooth")]
    sets += [("bfloat16", LEVELS[0], kind) for kind in ("iid", "smooth")]
    readings = []
    for dn, (h, w), kind in sets:
        res = time_warps(torch, wk, gen, getattr(torch, dn), h, w, kind == "smooth")
        if dn == "bfloat16":
            dimg = level0_specs(torch, wk, gen, torch.bfloat16)["warp_bwd_dimg"]
            res["warp_bwd_dimg"] = time_cold(torch, dimg, kind == "smooth")
        for name, r in res.items():
            readings.append({"name": name, "dtype": dn, "h": h, "w": w, "flow": kind, **r})
            ms, lib = r["ms_device"], r["library_ms_device"]
            log(f"timing {name} {dn} {B}x{h}x{w}x{2 if name == 'warp_bwd_dimg' else C} {kind}: "
                f"device {ms:.4f} ms, library {lib:.4f} ms ({lib / ms:.2f}x), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / ms:.0%} of it)")
    print(json.dumps({"warp_timing": readings}), flush=True)
    return {r["name"]: r for r in readings
            if r["dtype"] == "float32" and (r["h"], r["w"]) == LEVELS[0] and r["flow"] == "smooth"
            and r["name"] != "warp_bwd_dimg"}


def level0_specs(torch, wk, gen, dtype=None) -> dict:
    """name -> make(smooth=False): a fresh level-0 input set for the kernel, on
    i.i.d. or smooth flows, returning its (kernel call, plain call, library
    call, bytes, operations). The library yardsticks: warp_calls' for the
    warps; ``index_add_`` of the splat's precomputed corner weights; for
    warp_bwd_dimg, where the system calls it (a flow, C=2, pad="zeros",
    coordinates unclamped), the backward of ``grid_sample`` with both the image
    and the grid gradient (on a grid of the image's dtype). ``dtype``: the
    warp_bwd_dimg image's, f32 by default."""
    n_px = B * H * W
    dtype = dtype or torch.float32

    def warp(name):
        def make(smooth=False):
            img, cx, cy = level0_inputs(torch, torch.float32, gen, smooth=smooth)
            cx, cy = cx.clamp(0, W - 1), cy.clamp(0, H - 1)
            g = torch.randn(B, H, W, C, generator=gen, device="cuda")
            kern, lib, n_bytes, flops = warp_calls(torch, wk, img, cx, cy, g)[name]
            plain = ((lambda: wk.warp_fwd_plain(img, cx, cy)) if name == "warp_fwd"
                     else (lambda: wk.warp_bwd_plain(img, cx, cy, g)))
            return kern, plain, lib, n_bytes, flops
        return make

    def splat(smooth=False):
        _, tx, ty = level0_inputs(torch, torch.float32, gen, b=2 * B, smooth=smooth)
        offs, valid, ax, ay = wk._taps(tx, ty, H, W)
        wts = ((1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax)
        base = (torch.arange(2 * B, device="cuda") * H * W)[:, None, None]
        idx = torch.cat([(o.clamp(0, H * W - 1) + base).flatten() for o in offs])
        val = torch.cat([torch.where(v, w_, torch.zeros_like(w_)).flatten()
                         for v, w_ in zip(valid, wts)])
        dens = torch.zeros(2 * B * H * W, device="cuda")
        return (lambda: wk.splat(tx, ty, H, W), lambda: wk.splat_plain(tx, ty, H, W),
                lambda: dens.zero_().index_add_(0, idx, val),
                nbytes(tx, ty) + 2 * B * H * W * 4, 2 * n_px * 20)

    def dimg(smooth=False):
        fl = (torch.randn(B, H, W, 2, generator=gen, device="cuda") * 5.0).to(dtype)
        _, zx, zy = level0_inputs(torch, torch.float32, gen, smooth=smooth)
        g2 = torch.randn(B, H, W, 2, generator=gen, device="cuda").to(dtype)
        fl_nchw = fl.permute(0, 3, 1, 2).contiguous()
        g2_nchw = g2.permute(0, 3, 1, 2).contiguous()
        zgrid = torch.stack([zx * (2.0 / (W - 1)) - 1.0, zy * (2.0 / (H - 1)) - 1.0],
                            dim=-1).to(dtype)
        return (lambda: wk.warp_bwd_dimg(fl, zx, zy, g2),
                lambda: wk.warp_bwd_dimg_plain(fl, zx, zy, g2),
                lambda: torch.ops.aten.grid_sampler_2d_backward(g2_nchw, fl_nchw, zgrid, 0, 0,
                                                                True, [True, True]),
                nbytes(fl, zx, zy, g2, fl, zx, zy), n_px * (12 + 22 * 2))

    return {"warp_fwd": warp("warp_fwd"), "warp_bwd": warp("warp_bwd"), "splat": splat,
            "warp_bwd_dimg": dimg}


def phase_timing(torch, wk, counts: dict, errs: dict) -> list:
    """The ``kernels`` rows at the level-0 shape, i.i.d. flows. ``ms``,
    ``library_ms`` and ``plain_ms``: an eager loop of calls on one input set
    (``cuda_ms``), as earlier versions of this script read them. ``ms_device``, ``library_ms_device``:
    device time on cold inputs (``graph_ms``). ``ms_smooth``,
    ``library_ms_smooth``: device time on smooth flows (the warps' from
    ``phase_warp_timing``)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, make in level0_specs(torch, wk, gen).items():
        kern, plain, lib, n_bytes, flops = make()
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=5)
        lib_ms = cuda_ms(torch, lib)
        sets = [(kern, lib)] + [make()[0:3:2] for _ in range(cold_sets(n_bytes) - 1)]
        ms_dev = graph_ms(torch, [k for k, _ in sets])
        lib_dev = graph_ms(torch, [l_ for _, l_ in sets])
        del sets
        smooth = time_cold(torch, make, True) if name in ("splat", "warp_bwd_dimg") else None
        b_ms, b_by = bound(n_bytes, flops)
        rows.append({
            "name": name, "route": "cuda", "source": "rcf_tpu_torch/csrc/warp.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "ms_device": ms_dev, "library_ms_device": lib_dev,
        })
        if smooth:
            rows[-1].update(ms_smooth=smooth["ms_device"],
                            library_ms_smooth=smooth["library_ms_device"])
        log(f"timing {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms); device, cold inputs "
            f"{ms_dev:.4f} ms, library {lib_dev:.4f} ms"
            + (f"; smooth flows {smooth['ms_device']:.4f} ms, library "
               f"{smooth['library_ms_device']:.4f} ms" if smooth else ""))
    warp_smooth = phase_warp_timing(torch, wk)
    for row in rows:
        if row["name"] in warp_smooth:
            r = warp_smooth[row["name"]]
            row.update(ms_smooth=r["ms_device"], library_ms_smooth=r["library_ms_device"])
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from rcf_tpu_torch.ops import crf as crf_ops
        from rcf_tpu_torch.ops import crf_kernels as ck
        from rcf_tpu_torch.ops import cuda_build
        from rcf_tpu_torch.ops import warp_kernels as wk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    phases = {}
    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # The release libraries and the test build that counts the overlap-add's
    # branches, one nvcc each, side by side.
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        count_so = pool.submit(wk.build_patched, wk.COUNT_TAPS, "count_taps")
        crf_so = pool.submit(ck.build)
        so = wk.build()
        count_lib = wk.load_library(count_so.result())
        crf_so = crf_so.result()
    phases["build"] = time.perf_counter() - t0
    log(f"build: {phases['build']:.1f} s -> {so}, {crf_so}")
    for r in wk.ptxas_report(so):
        log(f"  ptxas: {r['kernel']} {r['dtype']} C={r['c']}: {r.get('registers')} registers, "
            f"spill {r.get('spill_stores')}/{r.get('spill_loads')} bytes (stores/loads), "
            f"{r.get('smem')} bytes shared memory")
    for r in cuda_build.ptxas_entries(crf_so):
        log(f"  ptxas: {r['entry']}: {r.get('registers')} registers, spill "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes, {r.get('smem')} bytes shared")

    t0 = time.perf_counter()
    errs = phase_kernels(torch, wk, count_lib)
    phases["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    errs["crf_filter"] = phase_crf_kernel(torch, ck, crf_ops)["davis"]
    phases["crf_kernel"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, step_ms = phase_step(torch, wk, torch.float32)
    phases["step"] = time.perf_counter() - t0
    log(f"step ms f32 (mean of steps 2-{STEPS}, batch {B}x2, 384^2 frames, TF32 convs): "
        f"{step_ms:.1f}")

    t0 = time.perf_counter()
    counts, step_ms_bf16 = phase_step(torch, wk, torch.bfloat16)
    phases["step_bf16"] = time.perf_counter() - t0
    log(f"step ms bf16 (mean of steps 2-{STEPS}, batch {B}x2, 384^2 frames): {step_ms_bf16:.1f} "
        f"(f32: {step_ms:.1f})")

    t0 = time.perf_counter()
    counts["warp_bwd_dimg"] = phase_image_grad(torch, wk)
    phases["image_grad"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    phase_reference(torch)
    phases["reference"] = time.perf_counter() - t0

    rcf = {}
    for recipe, phase, crf in (("rcf", "rcf_step", False), ("rcf_stv2", "rcf_step_bf16", False),
                               ("rcf", "rcf_step_crf", True),
                               ("rcf_stv2", "rcf_step_crf_bf16", True)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rcf[phase] = phase_rcf_step(torch, wk, recipe, crf=crf)
        phases[phase] = time.perf_counter() - t0
        log(f"{phase} ({recipe} stage {'2.1' if crf else '1'}, "
            f"{RCF_RECIPES[recipe]['compute_dtype']}, mean of steps 2-{STEPS}, batch {B}x2, "
            f"384^2 frames and flows): {rcf[phase]['step_ms']:.1f} ms, peak "
            f"{rcf[phase]['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rcf_errs = phase_rcf_reference(torch)
    phases["rcf_reference"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    crf_errs = phase_rcf_crf_reference(torch)
    phases["rcf_crf_reference"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = phase_timing(torch, wk, counts, errs)
    crf_launches = {p: rcf[p]["launches"]["crf_filter"] for p in ("rcf_step_crf",
                                                                 "rcf_step_crf_bf16")}
    rows.append(crf_timing(torch, ck, crf_ops, crf_launches, errs["crf_filter"]))
    phases["timing"] = time.perf_counter() - t0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    phases["total"] = time.perf_counter() - t_all
    stage2_1 = {p: {k: rcf[p][k] for k in ("step_ms", "peak_gib", "iterations_per_step",
                                           "host_syncs_per_step", "crf_filter_per_step")}
                for p in ("rcf_step_crf", "rcf_step_crf_bf16")}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"step_ms": step_ms, "step_ms_bf16": step_ms_bf16,
                      "rcf_step_ms": rcf["rcf_step"]["step_ms"],
                      "rcf_step_ms_bf16": rcf["rcf_step_bf16"]["step_ms"],
                      "rcf_peak_gib": rcf["rcf_step"]["peak_gib"],
                      "rcf_peak_gib_bf16": rcf["rcf_step_bf16"]["peak_gib"],
                      "stage2_1": stage2_1, "rcf_reference": rcf_errs,
                      "rcf_crf_reference": crf_errs, "phases_s": phases}), flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
