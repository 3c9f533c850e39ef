#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --data-parallel-cards N   # N >= 2 cards: data_parallel on NCCL

Phases, each timed:

1. kernels    - the kernels' card tests, in a subprocess, first:
                ``python -m pytest --noconftest -m cuda`` on ``CARD_TESTS``
                (each kernel against its plain version or float64 on the
                card; ``tests/test_torch_warp_card.py``,
                ``tests/test_torch_crf_card.py``,
                ``tests/test_torch_dino_attention.py``,
                ``tests/test_torch_dino_linear.py``); a failed case stops
                the script;
2. build      - the kernel libraries (``LIB`` of ``warp_kernels``,
                ``crf_kernels``, ``attention_kernels``, ``linear_kernels``;
                the card tests built
                them into ``rcf_tpu_torch/build/``) and the compiler's report
                of each instance: registers, spills, shared memory;
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
                ``scaled_dot_product_attention`` computing the same filter;
                dino_attention at one block's call of the DINO cell (8 x 6 x
                6,421 tokens of 64) and at head dim 32 (8 x 12 x 1,591) beside
                its TF32 bound, its plain version and f32 SDPA; dino_linear
                at the cell's four linears (M = 8 x 6,421) beside its TF32
                and split-TF32 bounds, its plain version (F.linear, F.gelu,
                +) and cuBLAS's f32 GEMM alone.

13. train_cli - the trainer through its entry point, ``rcf_tpu_torch.cli.main``,
                in process: a synthetic set in the DAVIS layout written by the
                port's own encoders (4 sequences x 12 frames, 480x854, JPEG
                q95, PNG masks, .npy flows; tools/make_synthetic_davis.py's
                easy sequences) under ``rcf_tpu_torch/build/smoke_train/``;
                ``--print-config`` of configs/rcf/rcf_stage1.yaml in a
                subprocess (no yaml here) against the tree loaded in process;
                stage 1 of the DAVIS recipe at full width and batch (16 pairs
                of 384^2 crops, 2 epochs, validation each epoch, the election
                after epoch 2, no DenseCL init), and its step outside the loop
                at the same batch (``bare_step_ms``); stage 2.1 from stage 1's
                ``last`` (weights only: the restored state read where the loop
                restores it and held bit for bit against the saved file, the
                EMA expanded), 1 epoch on the elected channel, crf_filter
                launched; ``restore_checkpoint(last)`` against the trained
                state, bit for bit; ``--test`` on stage 2.1's ``last`` with the
                export (frames x channels masks); 1 AMD epoch (warp_fwd,
                warp_bwd, splat launched) and its test. Readings from each
                run's ``metrics.jsonl``: step device and host ms through the
                loop (steps 2+), loader wait a step, frames/s, eval frames/s, checkpoint save
                ms and size, stage 1's peak memory, decode ms a frame and
                train-transform ms a pair.
14. stage2_pipeline - the README pipeline after stage 2.1 through the port's
                entry points, on a second synthetic set (2 x 9 frames,
                480x854) under ``rcf_tpu_torch/build/smoke_train/pipeline/``
                and a seeded random ViT-S/8 saved in the official DINO layout:
                stage 1's export (``rcf_export_trainval.yaml --test``), the MAA
                election (``grouping.maa.main``; the channel in range),
                stage 2.1's EMA export, the semantic constraints over every
                frame (native lattice), stage 2.2 at full width and its
                16-pair batch through ``cli.main`` (``pl_masks`` in every step,
                ``loss_pl`` finite) and its bare step, ``rcf_eval.yaml --test``
                with export, CRF-PP native over every frame and on the card
                (``--engine device``, the full grid, one frame: ``crf_filter``
                must launch), DAVIS J&F (``eval.davis.main``, its CSV) and the
                FBMS59 evaluator on a copy in that layout; then the holds
                (``STAGE2_LIMITS``): ``crf_filter`` at B=1, N=409,920 against
                plain rows (and its ms beside the 40.1 ms bound, and f32
                SDPA), DINO keys and the affinity card against CPU,
                ``ncut_refine`` card against CPU, ``refine_frame`` card
                against CPU with the native engine (480x854) and the
                attention engine (48x86), and the DAVIS J/F in torch on the
                card against numpy; the timings of each stage, DINO, NCut, a
                native pass, the attention engine's frame and the evaluator.
15. data_parallel - the port's ranks (``rcf_tpu_torch/parallel``): (a) two
                ranks on the one card, each its own process
                (``--data-parallel-rank``), on gloo passed explicitly (NCCL
                refuses two ranks on one card), against this process with the
                whole batch, TF32 off, f32, dropout on: one step of the DAVIS
                stage-1 recipe and of its stage 2.1 (CRF on) at full width, 2
                pairs of 128^2 a rank, and of the AMD recipe at flow_size 64x64;
                the losses, the averaged gradients, the BN running statistics
                and the EMA against each case's ``DP_LIMITS``, beside a noise
                control (world 1 against world 1 with 1e-7 of noise on the
                frames), each rank's state equal to rank 0's, crf_filter and
                the warps launched on both ranks; (b) the same two ranks run 3
                steps of the DAVIS stage-1 recipe at its batch (8 pairs of
                384^2 a rank) from rank 0's weights: step ms (step 2), peak
                memory, gradient bytes and the collectives' share of step 3,
                timed with the card synchronized around each (one card
                through host memory: not a multi-card figure), every
                rank's whole state against rank 0's, then save ``last`` at
                world 2; (c) ``cli.main`` with ``RCF_DIST=1`` on NCCL at world
                1 resumes that ``last`` and runs epoch 1 of the synthetic set
                of ``train_cli``.

Prints a ``{"kernels": [...]}`` line, a line with the AMD, stage-1 and
stage-2.1 step times (f32 and bf16), the peak memory, the stage-2.1 mean
field's iterations and syncs, the reference readings and the phase
seconds, a ``{"train_cli": ...}`` line, a ``{"stage2_pipeline": ...}`` line,
a ``{"data_parallel": ...}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then not 0 and no result line is
printed.

``--data-parallel-cards N`` runs the data_parallel phase alone on N >= 2
cards, one rank a card on NCCL, at 2 ranks and at N: (a) and (b) as above
(at N ranks, 16 / N pairs a rank in (b), the recipe's batch), and (c) as
a launcher runs it, one ``python -m rcf_tpu_torch.cli`` a rank; it prints
a ``{"data_parallel_cards": ...}`` line, every card's name and power limit
and the same last line. Without a CUDA device, or without the package beside it, it exits
with an error at once.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
import kernel_sets as ks  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 2**20       # H100 SXM L2

B, H, W, C = ks.B, ks.H, ks.W, ks.C  # AMD level 0: 8 pairs, flow_size 384x640, RGB
STEPS = 3
# The kernels' card tests, which run first, in a subprocess.
CARD_TESTS = ("tests/test_torch_warp_card.py", "tests/test_torch_crf_card.py",
              "tests/test_torch_dino_attention.py", "tests/test_torch_dino_linear.py")

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


def phase_kernels() -> None:
    """The kernels' card tests (``CARD_TESTS``) in a subprocess; raises if one fails."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
           "-p", "no:cacheprovider", *CARD_TESTS]
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True)
    log(proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "kernels: no output")
    if proc.returncode != 0:
        raise RuntimeError("the kernels' card tests failed:\n" + proc.stdout[-6000:]
                           + proc.stderr[-2000:])


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


def rcf_crf_batch(torch, gen, b: int, hw: int, dev: str) -> dict:
    """A stage-2.1 batch: ``rcf_batch`` with ``crf_frames`` as the frames, and the
    object channel 0 set (the YAMLs' ``object_channel: 0``)."""
    batch = rcf_batch(torch, gen, b, hw, dev)
    batch["imgs"] = ks.crf_frames(gen, 2 * b, hw).reshape(b, 2, hw, hw, 3)
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


LINEAR_REPLACES = "rcf_tpu/nn/dino_vit.py (Attention and Mlp: dense layers, GELU, residual adds)"


def linear_timing(torch, lk) -> dict:
    """The dino_linear row: the DINO cell's four linears (``kernel_sets.LINEAR_SETS``
    qkv, proj, fc1, fc2 at M = 8 x 6,421), each key suffixed by the set's name:
    ``ms``, ``plain_ms`` (F.linear, F.gelu, +), ``library_ms`` (F.linear alone,
    cuBLAS's f32 GEMM, the yardstick the port no longer calls) an eager loop on
    one input set; ``ms_device``, ``library_ms_device`` device time on
    ``cold_sets`` input sets. The bound: the products' FLOPs at the dense TF32
    rate; ``split_bound_ms`` three times it."""
    import torch.nn.functional as F

    from rcf_tpu_torch.utils.precision import full_f32

    row = {"name": "dino_linear", "route": "cuda", "source": "rcf_tpu_torch/csrc/linear.cu",
           "replaces": LINEAR_REPLACES, "replaces_kind": "XLA code, not a TPU kernel",
           "products": "wgmma.mma_async m64n128k8 tf32, three a product (split TF32)"}
    for name in ("qkv", "proj", "fc1", "fc2"):
        m, k, n, _, _ = ks.LINEAR_SETS[name]
        sets = [ks.linear_inputs(name, "cuda")]
        sets += [{key: (val.roll(i + 1, 0) if torch.is_tensor(val) and val.dim() == 2
                        and val.shape[0] == m else val) for key, val in sets[0].items()}
                 for i in range(cold_sets(nbytes(sets[0]["x"])) - 1)]
        a = sets[0]
        with torch.no_grad(), full_f32():
            res = {"ms": cuda_ms(torch, lambda: lk.dino_linear(**a)),
                   "plain_ms": cuda_ms(torch, lambda: lk.dino_linear_plain(**a)),
                   "library_ms": cuda_ms(torch, lambda: F.linear(a["x"], a["weight"], a["bias"]))}
            res["ms_device"] = graph_ms(torch, [lambda b=b: lk.dino_linear(**b) for b in sets])
            res["library_ms_device"] = graph_ms(
                torch, [lambda b=b: F.linear(b["x"], b["weight"], b["bias"]) for b in sets])
            res["library_kernels"] = traced_kernels(
                torch, lambda: F.linear(a["x"], a["weight"], a["bias"]))[:3]
            res["kernels"] = traced_kernels(torch, lambda: lk.dino_linear(**a))
        del sets, a
        res["bound_ms"] = 2.0 * m * k * n / TF32_FLOPS * 1e3
        res["split_bound_ms"] = 3 * res["bound_ms"]
        log(f"timing dino_linear {name} {m}x{k}->{n}: {res['ms']:.4f} ms, device "
            f"{res['ms_device']:.4f} ms (TF32 bound {res['bound_ms']:.4f} ms, "
            f"{res['bound_ms'] / res['ms_device']:.1%} of it; split {res['split_bound_ms']:.4f} ms, "
            f"{res['split_bound_ms'] / res['ms_device']:.1%}); plain {res['plain_ms']:.4f} ms; "
            f"library {res['library_ms']:.4f} ms, device {res['library_ms_device']:.4f} ms, "
            f"kernels {res['library_kernels']}; ours {res['kernels']}")
        row.update({f"{key}_{name}": v for key, v in res.items()})
    return row


def crf_timing(torch, ck, launches: dict) -> dict:
    """The crf_filter row: at the DAVIS grid (16 x 96^2, D = 5) and, keys with
    ``_stv2``, the SegTrackv2 grid (16 x 128^2): ``ms``, ``plain_ms``,
    ``library_ms`` an eager loop on one input set, ``ms_device``,
    ``library_ms_device`` device time on ``cold_sets`` input sets (the L2 holds
    none), the bound, and the yardstick's kernels and error."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    row = {"name": "crf_filter", "route": "cuda", "source": "rcf_tpu_torch/csrc/crf.cu",
           "replaces": CRF_REPLACES, "replaces_kind": "XLA code, not a TPU kernel",
           "launches": sum(launches.values()), "launches_per_step": launches}
    for suffix, hw, scale in (("", 96, 0.25), ("_stv2", 128, 1 / 3)):
        def make():
            f = ks.crf_features(gen, 16, hw, hw, scale)
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


ATTN_REPLACES = "rcf_tpu/nn/dino_vit.py (Attention: product, softmax, product)"
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor rate
ATTN_CELL = (8, 6421, 6, 64)  # one block's call in dino_vits8_f32.ncut_frames
ATTN_MOCO = (8, 1591, 12, 32)  # moco_vit_small/16 at 480 x 856, 8 frames


def attention_timing(torch, ak) -> dict:
    """The dino_attention row: one block's call of the DINO cell (``ATTN_CELL``)
    and, keys with ``_moco``, ``ATTN_MOCO``: ``ms``, ``plain_ms``, ``library_ms``
    an eager loop on one input set; ``ms_device``, ``library_ms_device`` device
    time on ``cold_sets`` input sets. The bound: the products' FLOPs at the dense
    TF32 rate; ``split_bound_ms`` three times it (three TF32 products an f32
    one). The library: f32 ``scaled_dot_product_attention`` on q, k, v made
    contiguous beforehand, a yardstick the port never calls."""
    import torch.nn.functional as F

    from rcf_tpu_torch.utils.precision import full_f32

    row = {"name": "dino_attention", "route": "cuda", "source": "rcf_tpu_torch/csrc/attention.cu",
           "replaces": ATTN_REPLACES, "replaces_kind": "XLA code, not a TPU kernel",
           "products": "wgmma.mma_async m64n32k8 / m64n{hd}k8 tf32, three a product (split TF32)"}
    for suffix, (b, n, heads, hd) in (("", ATTN_CELL), ("_moco", ATTN_MOCO)):
        sets = [ks.attention_qkv(b, n, heads, hd, seed=12, device="cuda")]
        sets += [ks.attention_qkv(b, n, heads, hd, seed=13 + i, device="cuda")
                 for i in range(cold_sets(nbytes(sets[0])) - 1)]
        libs = []
        for qkv in sets:
            q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
            libs.append(lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v))
        qkv = sets[0]
        with torch.no_grad(), full_f32():
            res = {"ms": cuda_ms(torch, lambda: ak.dino_attention(qkv)),
                   "plain_ms": cuda_ms(torch, lambda: ak.dino_attention_plain(qkv), iters=2,
                                       warmup=1),
                   "library_ms": cuda_ms(torch, libs[0])}
            res["ms_device"] = graph_ms(torch, [lambda x=x: ak.dino_attention(x) for x in sets])
            res["library_ms_device"] = graph_ms(torch, libs)
            res["library_kernels"] = traced_kernels(torch, libs[0])[:3]
            res["kernels"] = traced_kernels(torch, lambda: ak.dino_attention(qkv))
        del sets, libs
        res["bound_ms"] = 4.0 * n * n * hd * b * heads / TF32_FLOPS * 1e3
        res["split_bound_ms"] = 3 * res["bound_ms"]
        log(f"timing dino_attention {b}x{n}x{heads}x{hd}: {res['ms']:.4f} ms, device "
            f"{res['ms_device']:.4f} ms (TF32 bound {res['bound_ms']:.4f} ms, "
            f"{res['bound_ms'] / res['ms_device']:.1%} of it; split {res['split_bound_ms']:.4f} "
            f"ms); plain {res['plain_ms']:.2f} ms; library {res['library_ms']:.4f} ms, device "
            f"{res['library_ms_device']:.4f} ms, kernels {res['library_kernels']}; "
            f"ours {res['kernels']}")
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
    imgs = ks.crf_frames(gen, 4, hw, block=16)
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
    img, cx, cy = ks.level0_inputs(dtype, gen, h=h, w=w, smooth=smooth)
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
            img, cx, cy = ks.level0_inputs(torch.float32, gen, smooth=smooth)
            cx, cy = cx.clamp(0, W - 1), cy.clamp(0, H - 1)
            g = torch.randn(B, H, W, C, generator=gen, device="cuda")
            kern, lib, n_bytes, flops = warp_calls(torch, wk, img, cx, cy, g)[name]
            plain = ((lambda: wk.warp_fwd_plain(img, cx, cy)) if name == "warp_fwd"
                     else (lambda: wk.warp_bwd_plain(img, cx, cy, g)))
            return kern, plain, lib, n_bytes, flops
        return make

    def splat(smooth=False):
        _, tx, ty = ks.level0_inputs(torch.float32, gen, b=2 * B, smooth=smooth)
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
        _, zx, zy = ks.level0_inputs(torch.float32, gen, smooth=smooth)
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


def phase_timing(torch, wk, counts: dict) -> list:
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
            "replaces": REPLACES[name], "launches": counts[name], "ms": ms, "plain_ms": plain_ms,
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


# ---------------------------------------------------------------------------
# train_cli: the trainer through its entry point (``rcf_tpu_torch.cli``) on a
# synthetic set in the DAVIS layout, written by the port itself.
# ---------------------------------------------------------------------------

TRAIN_DIR = "rcf_tpu_torch/build/smoke_train"
TRAIN_SEQS, TRAIN_FRAMES, TRAIN_HW = 4, 12, (480, 854)
STAGE1_EPOCHS = 2
MASK_CHANNELS = 4  # configs/rcf: mask_layer


def _texture(rng, h: int, w: int, base):
    """Smooth coloured noise around a base colour (make_synthetic_davis._texture)."""
    import numpy as np

    from rcf_tpu_torch.data.transforms import imresize

    noise = rng.standard_normal((h // 8 + 2, w // 8 + 2, 3))
    small = ((noise - noise.min()) / (np.ptp(noise) + 1e-9) * 255).astype(np.uint8)
    img = imresize(small, (h, w), "bilinear").astype(np.float32)
    return np.clip(0.6 * img + 0.4 * base[None, None], 0, 255)


def write_synthetic_davis(root: str, seed: int = 0, seqs: int = TRAIN_SEQS,
                          frames: int = TRAIN_FRAMES) -> None:
    """tools/make_synthetic_davis.py's easy sequences (a textured square moving
    at a constant velocity over a drifting textured background, piecewise
    constant flows), written with the port's own encoders: JPEG q95 4:2:0
    frames, PNG masks, .npy forward/backward flows, trainval.txt / val.txt;
    ``seqs`` sequences of ``frames`` frames."""
    import os

    import numpy as np

    from rcf_tpu_torch.data.image_io import write_jpeg, write_png

    h, w = TRAIN_HW
    rng = np.random.default_rng(seed)
    lines = []
    for s in range(seqs):
        seq = f"synth{s:02d}"
        dirs = {k: os.path.join(root, k, "480p", seq) for k in
                ("JPEGImages", "Annotations", "Flows_NewCT", "BackwardFlows_NewCT")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        bg = _texture(rng, h, w, rng.uniform(40, 120, 3))
        size = int(rng.integers(min(h, w) // 5, min(h, w) // 3))
        fg = _texture(rng, size, size, rng.uniform(150, 240, 3))
        v_obj, v_bg = rng.uniform(-6, 6, 2), rng.uniform(-1.5, 1.5, 2)
        pos0 = np.array([rng.uniform(0, h - size), rng.uniform(0, w - size)])
        span = np.array([h - size, w - size], np.float64)
        prev = None
        for t in range(frames):
            pos = np.abs(((pos0 + v_obj * t) % (2 * span)) - span)
            y, x = int(round(pos[0])), int(round(pos[1]))
            img = np.roll(bg, (int(v_bg[0] * t), int(v_bg[1] * t)), axis=(0, 1)).copy()
            img[y:y + size, x:x + size] = fg
            mask = np.zeros((h, w), np.uint8)
            mask[y:y + size, x:x + size] = 255
            write_jpeg(os.path.join(dirs["JPEGImages"], f"{t:05d}.jpg"), img.astype(np.uint8),
                       quality=95)
            write_png(os.path.join(dirs["Annotations"], f"{t:05d}.png"), mask)
            if prev is not None:
                p_mask, p_yx = prev
                d = (np.array([y, x]) - p_yx).astype(np.float32)
                fw = np.empty((h, w, 2), np.float32)
                fw[...] = (v_bg[1], v_bg[0])
                fw[p_mask > 0] = (d[1], d[0])
                bw = np.empty((h, w, 2), np.float32)
                bw[...] = (-v_bg[1], -v_bg[0])
                bw[mask > 0] = (-d[1], -d[0])
                np.save(os.path.join(dirs["Flows_NewCT"], f"{t:05d}.npy"), fw)
                np.save(os.path.join(dirs["BackwardFlows_NewCT"], f"{t:05d}.npy"), bw)
            prev = (mask, np.array([y, x]))
        lines.append(f"JPEGImages/480p/{seq}/ " + " ".join(f"{t:05d}.jpg" for t in range(frames)))
    for split in ("trainval.txt", "val.txt"):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(lines) + "\n")


def _records(ckpt_dir: str) -> list:
    import os

    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def loop_readings(ckpt_dir: str) -> dict:
    """Readings of one CLI run from its metrics.jsonl: the train steps' device
    time (steps 2+: CUDA events around the step), host time (from the batch in
    hand to the step's return) and the loader's wait before each; frames/s
    over the epochs' train time (each epoch's cold first batch included, so at
    a few steps an epoch it mostly reads start-up) and over the steps after
    each epoch's first (the steady rate: the wall time between successive
    step records, each written after its loss read); the evaluations'
    frames/s and the checkpoints' save time. Every step's losses are logged
    (``loss_log_interval 1``)."""
    recs = _records(ckpt_dir)
    steps = [r for r in recs if "train_loss" in r]
    later = [r for r in steps if r["step"] >= 2] or steps
    epochs = [r for r in recs if "train_epoch_s" in r]
    out = {"steps": len(steps)}
    if steps:
        out.update(step_ms=1e3 * sum(r["step_device_s"] for r in later) / len(later),
                   step_host_ms=1e3 * sum(r["step_host_s"] for r in later) / len(later),
                   loader_wait_ms=1e3 * sum(r["loader_wait_s"] for r in later) / len(later),
                   first_step_ms=1e3 * steps[0]["step_device_s"],
                   first_loader_wait_ms=1e3 * steps[0]["loader_wait_s"],
                   losses={k: [r[k] for r in steps] for k in steps[0] if k.startswith("train_")})
    if epochs:
        out["train_frames_per_s"] = (sum(r["train_frames"] for r in epochs)
                                     / sum(r["train_epoch_s"] for r in epochs))
        out["epoch_s"] = [r["train_epoch_s"] for r in epochs]
        frames_per_step = sum(r["train_frames"] for r in epochs) / len(steps)
        steady = [(a, b) for a, b in zip(steps, steps[1:]) if a["epoch"] == b["epoch"]]
        if steady:
            out["steady_steps"] = len(steady)
            out["steady_frames_per_s"] = frames_per_step * len(steady) / sum(
                b["ts"] - a["ts"] for a, b in steady)
    for name in ("val_miou", "test_miou"):
        evals = [r for r in recs if f"{name}_frames" in r]
        if evals:
            out[f"{name}_frames_per_s"] = (sum(r[f"{name}_frames"] for r in evals)
                                           / sum(r[f"{name}_s"] for r in evals))
    saves = [r["checkpoint_s"] for r in recs if "checkpoint_s" in r]
    if saves:
        out["checkpoint_ms"] = [1e3 * s for s in saves]
    out["val_miou"] = [r["val_miou"] for r in recs if "val_miou" in r]
    return out


def _nonfinite_losses(readings: dict) -> list:
    return [(k, v) for k, vals in readings.get("losses", {}).items() for v in vals
            if not math.isfinite(v)]


def data_timing(root: str, pairs: int = 8, decodes: int = 20) -> dict:
    """Host ms to decode one 480x854 JPEG frame and to augment one pair
    (TrainTransform of the DAVIS recipe, one thread, the frames decoded before)."""
    import os

    import numpy as np

    from rcf_tpu_torch.data import TrainTransform, VideoDataset
    from rcf_tpu_torch.data.image_io import read_image

    frame = os.path.join(root, "JPEGImages", "480p", "synth00", "00001.jpg")
    read_image(frame)
    t0 = time.perf_counter()
    for _ in range(decodes):
        read_image(frame)
    decode_ms = (time.perf_counter() - t0) * 1e3 / decodes
    ds = VideoDataset(root, "trainval.txt", training=True, frame_num=2, load_flow=True,
                      flow_suffix="_NewCT")
    tf = TrainTransform(strong_aug=True)
    samples = [ds[i % len(ds)] for i in range(pairs)]
    t0 = time.perf_counter()
    for i, s in enumerate(samples):
        tf(s, np.random.default_rng((0, 0, i)))
    return {"decode_ms": decode_ms,
            "transform_ms_per_pair": (time.perf_counter() - t0) * 1e3 / pairs}


def bare_step_ms(torch, state, pairs: int, steps: int = STEPS, pl: bool = False) -> float:
    """Mean ms of steps 2+ of the stage-1 train step on ``state`` at ``pairs``
    pairs of 384^2 frames and flows made on the card (``rcf_batch``), with no
    loader running: the loop's step without its host-side company. ``pl``:
    with binary pseudo-labels of the frames and object channel 0 set (the
    stage-2.2 step)."""
    from rcf_tpu_torch.train import make_train_step

    step = make_train_step()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = rcf_batch(torch, gen, pairs, 384, "cuda")
    if pl:
        batch.update(object_channel=0, object_channel_set=True, pl_masks=(
            torch.rand(pairs, 2, 384, 384, generator=gen, device="cuda") > 0.5).float())
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses = step(state, batch, generator=gen)
        float(losses["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times[1:]) / len(times[1:])


def print_config_tree(recipe: str) -> dict:
    """``python -m rcf_tpu_torch.cli <recipe> --print-config`` in a subprocess
    (this machine has no yaml); its printed tree, the log lines dropped."""
    import re

    from rcf_tpu_torch import yaml_subset

    proc = subprocess.run([sys.executable, "-m", "rcf_tpu_torch.cli", recipe, "--print-config"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"--print-config exited {proc.returncode}: {proc.stderr[-2000:]}")
    text = "\n".join(line for line in proc.stdout.splitlines()
                     if not re.match(r"^\d{4}-\d\d-\d\d .* - rcf_tpu_torch - ", line))
    return yaml_subset.load(text, f"{recipe} --print-config")


def train_cli_readings(torch, wk, ck) -> tuple[dict, list]:
    """The trainer through ``rcf_tpu_torch.cli.main``, in process (the launch
    counters stay readable): stage 1 of the DAVIS recipe at full width and
    batch (16 pairs of 384^2 crops; 48 pairs wrap to 3 steps an epoch), 2
    epochs with validation and the election after epoch 2; stage 2.1 from its
    ``last`` (weights only, the EMA expanded) for 1 epoch on the elected
    channel; ``--test`` on stage 2.1's ``last`` with export; 1 epoch of the
    AMD recipe. Returns the readings and the failed checks."""
    import os
    import shutil

    from rcf_tpu_torch import cli
    from rcf_tpu_torch.config import load_config
    from rcf_tpu_torch.train import create_train_state
    from rcf_tpu_torch.train import loop as train_loop
    from rcf_tpu_torch.train.checkpoint import read_checkpoint, restore_checkpoint
    from rcf_tpu_torch.models import build_from_config
    from rcf_tpu_torch.train.state import compute_dtype

    root = os.path.abspath(TRAIN_DIR)
    shutil.rmtree(root, ignore_errors=True)
    out, failures = {}, []
    t0 = time.perf_counter()
    write_synthetic_davis(root)
    out["write_s"] = time.perf_counter() - t0
    out.update(data_timing(root))
    log(f"train_cli: synthetic set ({TRAIN_SEQS} x {TRAIN_FRAMES} frames, "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}) written in "
        f"{out['write_s']:.1f} s; decode {out['decode_ms']:.2f} ms a frame, train transform "
        f"{out['transform_ms_per_pair']:.1f} ms a pair")

    recipe = "configs/rcf/rcf_stage1.yaml"
    if print_config_tree(recipe) != load_config(recipe).to_dict():
        failures.append("--print-config's tree differs from the one loaded in process")

    dirs = {k: os.path.join(root, k) for k in ("stage1", "stage2_1", "amd")}
    common = ["data_path", root, "loss_log_interval", "1"]

    # Stage 1.
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = cli.main([recipe, "--no-test", "--opts", *common, "checkpoints_dir", dirs["stage1"],
                      "pretrained_model", "null", "epochs", str(STAGE1_EPOCHS)])
    torch.cuda.synchronize()
    out["stage1_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["stage1_s"] = time.perf_counter() - t0
    batch = int(load_config(recipe).global_batch_size)
    # The same step outside the loop, at the recipe's batch, no loader running.
    out["stage1_bare_step_ms"] = bare_step_ms(torch, state, batch)
    del state
    s1 = loop_readings(dirs["stage1"])
    out["stage1"] = s1
    oc_path = os.path.join(dirs["stage1"], "object_channel.json")
    if not os.path.isfile(oc_path):
        failures.append("stage 1: no object_channel.json")
        channel = 0
    else:
        with open(oc_path) as f:
            channel = int(json.load(f)["object_channel"])
    entries = os.listdir(dirs["stage1"])
    if "last" not in entries or sum(e.startswith("ckpt_") for e in entries) != 2:
        failures.append(f"stage 1: expected last and two ckpt_*, found {sorted(entries)}")
    expected = -(-TRAIN_SEQS * TRAIN_FRAMES // batch) * STAGE1_EPOCHS  # wrap-padded to whole batches
    if s1["steps"] != expected:
        failures.append(f"stage 1: {s1['steps']} logged steps, expected {expected}")
    if len(s1["val_miou"]) != STAGE1_EPOCHS or not all(map(math.isfinite, s1["val_miou"])):
        failures.append(f"stage 1: val_miou {s1['val_miou']}")
    last1 = os.path.join(dirs["stage1"], "last")
    out["checkpoint_mib"] = sum(os.path.getsize(os.path.join(last1, f))
                                for f in os.listdir(last1)) / 2**20

    # Stage 2.1 from stage 1's last; the first state read where the loop restores it.
    first = {}
    restore = train_loop.restore_checkpoint

    def spy(path, st, weights_only=False):
        st = restore(path, st, weights_only=weights_only)
        first.update(path=path, weights_only=weights_only,
                     sd={k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()})
        return st

    train_loop.restore_checkpoint = spy
    wk.reset_launch_counts()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state = cli.main(["configs/rcf/rcf_stage2.1.yaml", "--no-test", "--opts", *common,
                          "checkpoints_dir", dirs["stage2_1"], "pretrained_model", last1,
                          "epochs", "1", "object_channel", str(channel)])
    finally:
        train_loop.restore_checkpoint = restore
    out["stage2_1_s"] = time.perf_counter() - t0
    launches_2_1 = {**wk.LAUNCHES, **ck.LAUNCHES}
    out["stage2_1"] = loop_readings(dirs["stage2_1"])
    out["stage2_1"]["launches"] = launches_2_1
    if launches_2_1["crf_filter"] == 0:
        failures.append("stage 2.1: crf_filter was never launched")
    saved1 = {k[len("model."):]: v for k, v in read_checkpoint(last1)["state_dict"].items()}
    if not first or first["path"] != last1 or not first["weights_only"]:
        failures.append(f"stage 2.1 did not restore stage 1's last weights-only: "
                        f"{ {k: first.get(k) for k in ('path', 'weights_only')} }")
    else:
        differ = [k for k, v in saved1.items() if not torch.equal(first["sd"][k], v)]
        not_expanded = [k for k in first["sd"] if "_ema." in k and not torch.equal(
            first["sd"][k], saved1[k.replace("_ema.", ".", 1)])]
        if differ or not_expanded:
            failures.append(f"stage 2.1's first state is not stage 1's last: {differ[:3]} differ,"
                            f" EMA not expanded in {not_expanded[:3]}")
    # restore_checkpoint(last) gives back the saved parameters bit for bit.
    last21 = os.path.join(dirs["stage2_1"], "last")
    cfg21 = load_config("configs/rcf/rcf_stage2.1.yaml")
    fresh = create_train_state(cfg21.to_dict(), build_from_config(
        cfg21, device="cuda", seed=1, dtype=compute_dtype(cfg21.to_dict())), 1)
    fresh = restore_checkpoint(last21, fresh)
    bad = [k for k, v in state.model.state_dict().items()
           if not torch.equal(fresh.model.state_dict()[k], v)]
    if bad or fresh.step != state.step:
        failures.append(f"restore_checkpoint(last) differs from the trained state: {bad[:3]}, "
                        f"step {fresh.step} vs {state.step}")
    del state, fresh, first

    # --test on stage 2.1's last, with export.
    t0 = time.perf_counter()
    result = cli.main(["configs/rcf/rcf_stage2.1.yaml", "--test", "--test-override-pretrained",
                       last21, "--test-override-object-channel", str(channel), "--opts",
                       *common, "eval_export", "true"])
    out["test_s"] = time.perf_counter() - t0
    out["test_miou"] = result.miou
    out["test"] = loop_readings(dirs["stage2_1"])
    export = os.path.join(dirs["stage2_1"], "saved_eval_export")
    n_export = sum(len(files) for _, _, files in os.walk(export))
    out["exported"] = n_export
    if not math.isfinite(result.miou):
        failures.append(f"test_miou {result.miou}")
    n_masks = TRAIN_SEQS * TRAIN_FRAMES * MASK_CHANNELS
    if n_export != n_masks:
        failures.append(f"exported {n_export} masks, expected {n_masks}")

    # One AMD epoch (its final test included).
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(["configs/amd/amd.yaml", "--opts", *common, "test_data_path", root,
                       "train_dataset_kwargs.split", "trainval.txt", "checkpoints_dir",
                       dirs["amd"], "epochs", "1"])
    out["amd_s"] = time.perf_counter() - t0
    out["amd"] = loop_readings(dirs["amd"])
    out["amd"]["launches"] = dict(wk.LAUNCHES)
    out["amd_test_miou"] = result.miou
    missing = [k for k in STEP_KERNELS if wk.LAUNCHES[k] == 0]
    if missing:
        failures.append(f"AMD: {missing} never launched")
    if not math.isfinite(result.miou):
        failures.append(f"AMD test_miou {result.miou}")

    for stage in ("stage1", "stage2_1", "amd"):
        bad = _nonfinite_losses(out[stage])
        if bad:
            failures.append(f"{stage}: non-finite losses {bad[:3]}")
        log(f"train_cli {stage}: step {out[stage].get('step_ms', float('nan')):.1f} ms device, "
            f"{out[stage].get('step_host_ms', float('nan')):.1f} ms host (steps 2+), "
            f"loader wait {out[stage].get('loader_wait_ms', float('nan')):.1f} ms a step, "
            f"{out[stage].get('train_frames_per_s', float('nan')):.1f} frames/s over the epochs, "
            f"{out[stage].get('steady_frames_per_s', float('nan')):.1f} steady "
            f"({out[stage].get('steady_steps', 0)} steps after each epoch's first), "
            f"{out[stage].get('val_miou_frames_per_s', float('nan')):.1f} val frames/s")
    log(f"train_cli: stage 1 bare step {out['stage1_bare_step_ms']:.1f} ms "
        f"({2e3 * batch / out['stage1_bare_step_ms']:.1f} frames/s; the same step, batch "
        f"and card, no loader); peak "
        f"{out['stage1_peak_gib']:.2f} GiB, checkpoint "
        f"{out['checkpoint_mib']:.0f} MiB saved in {out['stage1'].get('checkpoint_ms')} ms; "
        f"test mIoU {out['test_miou']:.4f} ({out['test'].get('test_miou_frames_per_s', 0):.1f} "
        f"frames/s, {n_export} masks exported); launches stage 2.1 {launches_2_1}, "
        f"AMD {out['amd']['launches']}")
    return out, failures


def phase_train_cli(torch, wk, ck) -> dict:
    """``train_cli_readings`` on the card; raises on any failed check."""
    out, failures = train_cli_readings(torch, wk, ck)
    if failures:
        raise RuntimeError("train_cli: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# stage2_pipeline: the README pipeline after stage 2.1 through the port's entry
# points (stage-1 export -> MAA -> stage-2.1 EMA export -> semantic constraints
# -> stage 2.2 -> eval export -> CRF post-processing -> DAVIS J&F, and the
# SegTrackv2/FBMS59 evaluator), on a smaller synthetic set, then the holds.
# ---------------------------------------------------------------------------

PIPE_SEQS, PIPE_FRAMES = 2, 9  # 18 frames: the 16-pair stage-2.2 batch wraps to 2 steps
CRF_480P = (480, 854)  # the tools' mean-field grid: N = 409,920
CRF_ROWS = 4096  # query rows held against a plain computation over all keys
# Limits of the stage-2 holds (card against the stated reference), set before
# the first card run:
# - crf_rows_480p: the kernel's rows against plain f32 rows at N = 409,920
#   (``kernel_sets.CRF_TOL``'s structured-set limit; the same features' scales as training);
# - dino_rel: ViT-S/8 last-layer keys at 480x856, card against the port on the
#   CPU, max |diff| over max |CPU| (TF32 off; twelve layers of f32 sums in
#   another order);
# - affinity_flips: share of the 6420^2 thresholded affinity entries that differ
#   between the card's keys and the CPU's (a product within the keys' error of
#   tau flips);
# - ncut_cells: share of the 60x107 refined grid whose card value is more than
#   1e-3 from the CPU's (or not finite) on identical colour features and the
#   frame's soft annotation (Adam's first step is g/|g|: a gradient near 0 may
#   change sign);
# - refine_*: share of a frame's pseudo-label pixels that differ, card against
#   CPU: the native engine at 480x854 on the soft annotation (colour
#   features) and on the export's mask (ViT keys) (the CRF's uint8 unary
#   levels can move a pixel where the NCut grid moves), the attention engine
#   on a 48x86 frame with colour features (the CPU's plain filter at 480x854
#   is out of reach);
# - davis_jf: per-frame J and F of the DAVIS evaluator in torch on the card
#   against numpy and scipy on the host, on the pipeline's masks and on each
#   annotation against the next frame's (integer counts: exact).
STAGE2_LIMITS = {"crf_rows_480p": 2e-4, "dino_rel": 1e-3, "affinity_flips": 1e-4,
                 "ncut_cells": 1e-3, "refine_native_differ": 5e-3,
                 "refine_attention_differ": 5e-3, "davis_jf": 1e-12}


def write_dino_checkpoint(path: str) -> str:
    """A ViT-S/8 (patch 8, 384 wide, depth 12, 6 heads, position grid 28) with
    PyTorch's default initialization from seed 0, saved in the official DINO
    key layout (``dino_deitsmall8_300ep_pretrain.pth``'s)."""
    import torch

    from rcf_tpu_torch.nn.dino_vit import vit_small

    torch.manual_seed(0)
    torch.save(vit_small(patch_size=8).state_dict(), path)
    return path


def crf_rows(torch, feat, values, rows, dtype, chunk: int = 256):
    """The normalized filter at the query ``rows`` of one image over all its keys,
    in ``dtype``, from explicit per-dimension products (no TF32)."""
    f, v = feat[0].to(dtype), values[0].to(dtype)
    sq = (f * f).sum(-1) * 0.5
    out = []
    for c in range(0, len(rows), chunk):
        q = rows[c:c + chunk]
        dots = f[q, None, 0] * f[None, :, 0]
        for k in range(1, f.shape[1]):
            dots = dots + f[q, None, k] * f[None, :, k]
        w = torch.exp(dots - sq[None, :] - sq[q, None])
        out.append((w * v[None, :]).sum(-1) / w.sum(-1))
    return torch.cat(out)


def crf_480p_readings(torch, ck, crf_ops, rgb_u8, mask) -> dict:
    """crf_filter at the tools' grid (B = 1, 480x854, D = 5: a pipeline frame's
    features at sxy 60, srgb 5, the first pass's q1 as values): CRF_ROWS seeded
    rows against plain f32 and float64 rows; device ms beside the ex2 bound;
    f32 SDPA (memory-efficient attention) as the yardstick."""
    feat = crf_ops.pixel_features(rgb_u8[None], 60.0, 5.0)
    unary = crf_ops.mask_to_unary(mask[None], 0.7).reshape(1, -1, 2)
    vals = torch.sigmoid(unary[..., 0] - unary[..., 1]).contiguous()
    n = feat.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = torch.randperm(n, generator=gen, device="cuda")[:CRF_ROWS]
    got = ck.crf_filter(feat, vals)[0, rows]
    plain, exact = crf_rows(torch, feat, vals, rows, torch.float32), crf_rows(
        torch, feat, vals, rows, torch.float64)
    out = {"n": n, "max_abs_err": max_err(got, plain), "max_abs_err_f64": max_err(got, exact.float()),
           "plain_err_f64": max_err(plain, exact.float())}
    out["ms"] = cuda_ms(torch, lambda: ck.crf_filter(feat, vals), iters=5, warmup=1)
    out["bound_ms"], out["bound_by"], out["bound_unit"] = crf_bound(1, n, 5)
    lib = crf_sdpa(torch, feat, vals)
    out["library_ms"] = cuda_ms(torch, lib, iters=2, warmup=1)
    out["library_max_abs_err"] = max_err(lib()[0, rows], plain)
    return out


def jf_numpy(fg, gt) -> tuple:
    """J and boundary F of one frame in numpy and scipy (davis2017/metrics.py):
    the disk dilation by ``scipy.ndimage.binary_dilation`` (outside pixels 0)."""
    import numpy as np
    from scipy.ndimage import binary_dilation

    from rcf_tpu_torch.eval.davis import _disk

    union = np.sum(fg | gt)
    j = 1.0 if union == 0 else np.sum(fg & gt) / union

    def bmap(seg):
        e, s_, se = (np.zeros_like(seg) for _ in range(3))
        e[:, :-1], s_[:-1, :], se[:-1, :-1] = seg[:, 1:], seg[1:, :], seg[1:, 1:]
        b = (seg ^ e) | (seg ^ s_) | (seg ^ se)
        b[-1, :], b[:, -1] = seg[-1, :] ^ e[-1, :], seg[:, -1] ^ s_[:, -1]
        b[-1, -1] = False
        return b

    radius = math.ceil(0.008 * np.linalg.norm(fg.shape))
    fb, gb = bmap(fg), bmap(gt)
    fd = binary_dilation(fb, structure=_disk(radius).astype(bool))
    gd = binary_dilation(gb, structure=_disk(radius).astype(bool))
    n_fg, n_gt = int(fb.sum()), int(gb.sum())
    if n_fg == 0 or n_gt == 0:
        return float(j), 1.0 if n_fg == n_gt else 0.0
    p, r = np.sum(fb & gd) / float(n_fg), np.sum(gb & fd) / float(n_gt)
    return float(j), 0.0 if p + r == 0 else float(2 * p * r / (p + r))


class FixedFeatures:
    """A ``DinoFeatures`` whose features of the one frame it is given are known
    (the CPU's ViT keys, computed once for the DINO hold)."""

    def __init__(self, dino, feats):
        self.dino, self.feats = dino, feats

    def __call__(self, imgs01):
        return self.feats[None]

    def __getattr__(self, name):
        return getattr(self.dino, name)


def stage2_pipeline_readings(torch, wk, ck, crf_ops) -> tuple[dict, list]:
    """The README pipeline from the stage-1 export to DAVIS J&F through the port's
    entry points, on ``PIPE_SEQS`` x ``PIPE_FRAMES`` synthetic 480x854 frames,
    from ``train_cli``'s stage-1 and stage-2.1 checkpoints, with a seeded random
    ViT-S/8 in the official layout (``write_dino_checkpoint``); the launch
    counts reset before the pipeline and read after it. Then the holds
    (``STAGE2_LIMITS``) and the per-stage timings. Returns the readings and
    the failed checks."""
    import contextlib
    import csv
    import io
    import os
    import shutil

    import numpy as np

    from rcf_tpu_torch import cli
    from rcf_tpu_torch.data.image_io import read_image
    from rcf_tpu_torch.eval import crf_pp, davis, stv2_fbms
    from rcf_tpu_torch.grouping import maa, ncut, semantic_constraints
    from rcf_tpu_torch.grouping.pipeline import DinoFeatures
    from rcf_tpu_torch.ops.crf_native import crf_soft_native
    from rcf_tpu_torch.ops.resize import resize_bilinear
    from rcf_tpu_torch.train import loop as train_loop

    base = os.path.abspath(TRAIN_DIR)
    stage1, stage2_1 = os.path.join(base, "stage1"), os.path.join(base, "stage2_1")
    root = os.path.join(base, "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data_davis")
    stage2_2 = os.path.join(root, "stage2_2")
    out, failures, times = {}, [], {}
    t0 = time.perf_counter()
    write_synthetic_davis(data, seed=1, seqs=PIPE_SEQS, frames=PIPE_FRAMES)
    ckpt = write_dino_checkpoint(os.path.join(root, "dino_vits8_seed0.pth"))
    times["write"] = time.perf_counter() - t0
    seqs = [f"synth{s:02d}" for s in range(PIPE_SEQS)]
    n_frames = PIPE_SEQS * PIPE_FRAMES
    images = os.path.join(data, "JPEGImages", "480p")

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        times[name] = time.perf_counter() - t
        return result

    wk.reset_launch_counts()
    ck.reset_launch_counts()
    # 1. Stage-1 export of every channel.
    timed("export_stage1", cli.main, [
        "configs/rcf/rcf_export_trainval.yaml", "--test", "--test-override-pretrained",
        os.path.join(stage1, "last"), "--opts", "data_path", data])
    # 2. MAA election: the channel is the tool's exit code.
    channel = timed("maa", maa.main, [
        "--pretrain_dir", stage1, "--export-dir-name", "saved_eval_export_trainval",
        "--dataset", "davis", "--data-dir", root, "--seqs", ",".join(seqs),
        "--dino-checkpoint", ckpt, "--first-frames-only"])
    out["maa_channel"] = channel
    if channel not in range(MASK_CHANNELS):
        failures.append(f"MAA elected channel {channel}")
        channel = 0
    # 3. Stage-2.1 EMA export.
    last21 = os.path.join(stage2_1, "last")
    timed("export_stage2_1_ema", cli.main, [
        "configs/rcf/rcf_export_trainval_ema.yaml", "--test", "--test-override-pretrained",
        last21, "--test-override-object-channel", str(channel), "--opts", "data_path", data])
    # 4. Semantic-constraint pseudo-labels, native lattice, every frame.
    timed("semantic_constraints", semantic_constraints.main, [
        "--pretrain_dir", stage2_1, "--object-channel", str(channel), "--dataset", "davis",
        "--data-dir", root, "--dino-checkpoint", ckpt, "--crf-engine", "native"])
    pl_dir = os.path.join(stage2_1, "saved_eval_export_trainval_ema"
                          + semantic_constraints.SAVE_SUFFIX, str(channel))
    n_pl = len(os.listdir(pl_dir))
    if n_pl != n_frames:
        failures.append(f"semantic constraints wrote {n_pl} pseudo-labels, expected {n_frames}")
    # 5. Stage 2.2 at full width and the recipe's batch, pl_root from --opts.
    seen_pl = []
    make_step = train_loop.make_train_step

    def spy(**kw):
        step = make_step(**kw)

        def wrapped(state, batch, generator=None):
            seen_pl.append("pl_masks" in batch)
            return step(state, batch, generator=generator)
        return wrapped

    train_loop.make_train_step = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        state = timed("stage2_2", cli.main, [
            "configs/rcf/rcf_stage2.2.yaml", "--no-test", "--opts", "data_path", data,
            "loss_log_interval", "1", "checkpoints_dir", stage2_2, "pretrained_model", last21,
            "epochs", "1", "object_channel", str(channel), "train_dataset_kwargs.pl_root",
            pl_dir])
    finally:
        train_loop.make_train_step = make_step
    out["stage2_2_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["stage2_2"] = loop_readings(stage2_2)
    pl_losses = out["stage2_2"].get("losses", {}).get("train_loss_pl", [])
    if not seen_pl or not all(seen_pl):
        failures.append(f"stage 2.2: pl_masks reached {sum(seen_pl)} of {len(seen_pl)} steps")
    if not pl_losses or not all(map(math.isfinite, pl_losses)):
        failures.append(f"stage 2.2: loss_pl {pl_losses}")
    bad = _nonfinite_losses(out["stage2_2"])
    if bad:
        failures.append(f"stage 2.2: non-finite losses {bad[:3]}")
    # 6. Final eval and export.
    last22 = os.path.join(stage2_2, "last")
    result = timed("eval_export", cli.main, [
        "configs/rcf/rcf_eval.yaml", "--test", "--test-override-pretrained", last22,
        "--test-override-object-channel", str(channel), "--opts", "data_path", data])
    out["test_miou"] = result.miou
    export = os.path.join(stage2_2, "saved_eval_export", str(channel))
    # 7. CRF post-processing: native over every frame; the device engine at the
    #    full grid on one frame.
    crf_dir = timed("crf_pp_native", crf_pp.run, images, export)
    one = os.path.join(stage2_2, "one_frame", str(channel))
    os.makedirs(one)
    one_name = f"pred_seg_{seqs[0]}_00000_0000000.png"
    shutil.copy(os.path.join(export, one_name), one)
    ck.reset_launch_counts()
    timed("crf_pp_device_frame", crf_pp.main, [
        "--input", images, "--annotation-dir", one, "--engine", "device", "--allow_skip",
        "--batch", "1"])
    out["crf_pp_device_launches"] = ck.LAUNCHES["crf_filter"]
    dev_map = read_image(os.path.join(one + "_crf", one_name), None) > 127
    out["crf_pp_device_vs_native_agree"] = float(
        (dev_map == (read_image(os.path.join(crf_dir, one_name), None) > 127)).mean())
    # 8. DAVIS J&F of the post-processed masks.
    printed = io.StringIO()  # the tool's printed report, kept out of this log
    with contextlib.redirect_stdout(printed):
        timed("davis", davis.main, ["--davis_path", data, "--results_path", crf_dir, "--set",
                                    "val"])
    with open(os.path.join(crf_dir, "global_results-val.csv")) as f:
        rows = list(csv.reader(f))
    out["davis"] = dict(zip(rows[0], map(float, rows[1])))
    if not all(map(math.isfinite, out["davis"].values())):
        failures.append(f"DAVIS summary {out['davis']}")
    # 9. The FBMS59 evaluator on an FBMS59-layout copy (every other frame annotated).
    fbms = os.path.join(root, "data_fbms59")
    lines = []
    for seq in seqs:
        os.makedirs(os.path.join(fbms, "Annotations", seq))
        names = [f"{t:05d}.jpg" for t in range(PIPE_FRAMES)]
        for t in range(0, PIPE_FRAMES, 2):
            shutil.copy(os.path.join(data, "Annotations", "480p", seq, f"{t:05d}.png"),
                        os.path.join(fbms, "Annotations", seq))
        lines.append(f"JPEGImages/{seq}/ " + " ".join(names))
    with open(os.path.join(fbms, "val_all.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    fbms_res = timed("fbms", stv2_fbms.evaluate, "FBMS59", crf_dir, fbms)
    out["fbms"] = {"miou": fbms_res["miou"], "num_frames": fbms_res["num_frames"]}
    if not math.isfinite(fbms_res["miou"]) or fbms_res["num_frames"] != PIPE_SEQS * (
            (PIPE_FRAMES + 1) // 2):
        failures.append(f"FBMS59 evaluator {out['fbms']}")
    out["launches"] = {**wk.LAUNCHES, **ck.LAUNCHES}
    if out["crf_pp_device_launches"] == 0:
        failures.append("crf_pp --engine device: crf_filter was never launched")
    pipeline_s = sum(times.values())

    # The holds, on the first frame of the set: its stage-2.1 export mask, and
    # (where a near-empty export would leave the NCut degenerate) its object's
    # annotation as a soft mask, 0.9 inside and 0.1 outside.
    t_holds = time.perf_counter()
    lim, holds = STAGE2_LIMITS, {}
    img = maa.load_image(images, seqs[0], "00000")
    mask = maa.load_pred_mask(os.path.join(stage2_1, "saved_eval_export_trainval_ema"),
                              channel, seqs[0], "00000", 0)
    ann = read_image(os.path.join(data, "Annotations", "480p", seqs[0], "00000.png"), None)
    soft_gt = np.where(ann > 0, 0.9, 0.1).astype(np.float32)
    rgb = torch.from_numpy(np.clip(img * 255.0, 0, 255).astype(np.uint8)).cuda()
    r = crf_480p_readings(torch, ck, crf_ops, rgb, torch.from_numpy(mask).cuda())
    out["crf_480p"] = r
    holds["crf_rows_480p"] = r["max_abs_err"]
    dino_gpu, dino_cpu = DinoFeatures(ckpt, device="cuda"), DinoFeatures(ckpt, device="cpu")
    feats_gpu = dino_gpu(img[None])[0]
    t = time.perf_counter()
    feats_cpu = dino_cpu(img[None])[0]
    times["hold_dino_cpu"] = time.perf_counter() - t
    holds["dino_rel"] = rel_max(feats_gpu.cpu(), feats_cpu)
    holds["affinity_flips"] = float((ncut.build_affinity(feats_gpu).cpu()
                                     != ncut.build_affinity(feats_cpu)).float().mean())
    # A random ViT's keys all lie within 0.2 of each other in cosine: the
    # affinity is all ones and the NCut flat (the refinement drifts to an
    # empty mask and NaN, as in JAX). The NCut holds take the tools' colour
    # features (no checkpoint), whose affinity separates the object.
    colour_gpu, colour_cpu = DinoFeatures(device="cuda"), DinoFeatures(device="cpu")
    colour = colour_cpu(img[None])[0]
    grid = colour_cpu.mask_to_grid(soft_gt)
    ref_grid = ncut.ncut_refine(colour, grid)
    card_grid = ncut.ncut_refine(colour.cuda(), grid.cuda()).cpu()
    holds["ncut_cells"] = float((~((card_grid - ref_grid).abs() <= 1e-3)).float().mean())
    out["ncut_max_abs"] = max_err(card_grid, ref_grid)
    out["ncut_grid_mean"] = float(ref_grid.mean())
    out["dino_ms"] = cuda_ms(torch, lambda: dino_gpu(img[None]), iters=5, warmup=1)
    out["ncut_ms"] = cuda_ms(torch, lambda: ncut.ncut_refine(feats_gpu, grid.cuda()), iters=5,
                             warmup=1)
    t = time.perf_counter()
    crf_soft_native(np.asarray(rgb.cpu()), mask, crf_scale=0.7)
    out["native_pass_s"] = time.perf_counter() - t
    # refine_frame on the card and on the CPU side by side (the lattice
    # releases the GIL), on the soft annotation with colour features; and the
    # card's pseudo-label of the export (ViT keys) against the CPU's.
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(semantic_constraints.refine_frame, d, img, m, None,
                            crf_engine="native")
                for d, m in ((colour_gpu, soft_gt), (colour_cpu, soft_gt),
                             (FixedFeatures(dino_cpu, feats_cpu), mask))]
        card_gt_pl, cpu_gt_pl, cpu_pl = (j.result() for j in jobs)
    card_pl = read_image(os.path.join(pl_dir, f"pred_seg_{seqs[0]}_00000_0000000.png"), None)
    holds["refine_native_differ"] = max(
        float(((cpu_pl * 255.0).astype(np.uint8) != card_pl).mean()),
        float((card_gt_pl != cpu_gt_pl).mean()))
    out["refine_gt_fg_share"] = float((card_gt_pl > 0.5).mean())
    small = resize_bilinear(torch.from_numpy(img), (48, 86)).numpy()
    small_mask = resize_bilinear(torch.from_numpy(soft_gt)[..., None], (48, 86))[..., 0].numpy()
    ck.reset_launch_counts()
    att_gpu = semantic_constraints.refine_frame(colour_gpu, small, small_mask, None,
                                                crf_engine="attention")
    small_launches = ck.LAUNCHES["crf_filter"]
    att_cpu = semantic_constraints.refine_frame(colour_cpu, small, small_mask, None,
                                                crf_engine="attention")
    holds["refine_attention_differ"] = float((att_gpu != att_cpu).mean())
    ck.reset_launch_counts()
    t = time.perf_counter()
    att_full = semantic_constraints.refine_frame(dino_gpu, img, mask, None,
                                                 crf_engine="attention")
    out["attention_frame_s"] = time.perf_counter() - t
    out["attention_launches"] = {"frame_48x86": small_launches, "frame_480p": ck.LAUNCHES["crf_filter"]}
    out["attention_vs_native_agree"] = float(((att_full > 0.5) == (card_pl > 127)).mean())
    if not small_launches or not ck.LAUNCHES["crf_filter"]:
        failures.append(f"attention engine: crf_filter launches {out['attention_launches']}")
    # J and F of the pipeline's masks, and of each annotation against the
    # next frame's (the object moved: both far from 0 and 1).
    jf = []
    for seq in seqs:
        ids = [f"{t:05d}" for t in range(PIPE_FRAMES)]
        gt = davis.read_gt_masks(data, seq, ids, False)[0]
        pred = davis.read_result_masks(crf_dir, seq, ids, 0, (gt.shape[-1], gt.shape[-2]))[0]
        for p, g in ((pred, gt), (gt[1:], gt[:-1])):
            ref = np.array([jf_numpy(a, b) for a, b in zip(p, g)])
            jf.append(np.abs(davis.jaccard(g, p) - ref[:, 0]).max())
            jf.append(np.abs(davis.boundary_f_frames(p, g) - ref[:, 1]).max())
            out.setdefault("davis_jf_ref_means", []).append(ref.mean(0).tolist())
    holds["davis_jf"] = float(max(jf))
    t = time.perf_counter()
    davis.evaluate(data, crf_dir, "val")
    out["davis_frames_per_s"] = n_frames / (time.perf_counter() - t)
    times["holds"] = time.perf_counter() - t_holds
    for name, value in holds.items():
        log(f"stage2 hold {name}: {value:.3e} (limit {lim[name]:.0e})")
        if not value <= lim[name]:
            failures.append(f"{name} {value:.3e} > {lim[name]:.0e}")
    out["holds"], out["limits"], out["stage_s"] = holds, dict(lim), times
    out["pipeline_s"] = pipeline_s
    # The stage-2.2 step outside the loop, at the recipe's batch of 16 pairs.
    out["stage2_2_bare_step_ms"] = bare_step_ms(torch, state, 16, pl=True)
    del state
    total = sum(times.values())
    log("stage2_pipeline: " + ", ".join(f"{k} {v:.1f} s ({v / total:.0%})" for k, v in
                                        times.items()) + f"; {total:.1f} s in all")
    s22 = out["stage2_2"]
    log(f"stage2_pipeline: MAA channel {channel}; {n_pl} pseudo-labels; stage 2.2 step "
        f"{s22.get('step_ms', float('nan')):.1f} ms of device time through the loop (steps 2+), "
        f"{s22.get('steady_frames_per_s', float('nan')):.1f} frames/s steady, bare step "
        f"{out['stage2_2_bare_step_ms']:.1f} ms, peak {out['stage2_2_peak_gib']:.2f} GiB, "
        f"loss_pl {pl_losses}; test mIoU {out['test_miou']:.4f}; DAVIS {out['davis']}; "
        f"FBMS59 {out['fbms']}; crf_pp device {out['crf_pp_device_launches']} launches, "
        f"agrees with native on {out['crf_pp_device_vs_native_agree']:.4f} of the frame")
    log(f"stage2_pipeline: crf_filter at B=1 N={r['n']} D=5: {r['ms']:.2f} ms (bound "
        f"{r['bound_ms']:.2f} ms by {r['bound_unit']}, {r['bound_ms'] / r['ms']:.0%} of it), "
        f"rows vs plain {r['max_abs_err']:.2e}, vs float64 {r['max_abs_err_f64']:.2e} (plain "
        f"{r['plain_err_f64']:.2e}); SDPA f32 {r['library_ms']:.1f} ms; NCut card vs CPU max "
        f"{out['ncut_max_abs']:.2e} (grid mean {out['ncut_grid_mean']:.3f}); refine_frame on the "
        f"soft annotation: foreground {out['refine_gt_fg_share']:.3f}; J/F reference means "
        f"{out['davis_jf_ref_means']}; DINO "
        f"{out['dino_ms']:.1f} ms a frame (CPU {times['hold_dino_cpu']:.1f} s), NCut "
        f"{out['ncut_ms']:.1f} ms, native lattice {out['native_pass_s']:.2f} s a pass (host), "
        f"attention engine {out['attention_frame_s']:.2f} s a frame "
        f"({out['attention_launches']} launches; agrees with native on "
        f"{out['attention_vs_native_agree']:.4f}); DAVIS evaluator "
        f"{out['davis_frames_per_s']:.1f} frames/s")
    out["davis_printed"] = printed.getvalue().strip().splitlines()[:2]
    return out, failures


def phase_stage2_pipeline(torch, wk, ck, crf_ops) -> dict:
    """``stage2_pipeline_readings`` on the card; raises on any failed check."""
    out, failures = stage2_pipeline_readings(torch, wk, ck, crf_ops)
    if failures:
        raise RuntimeError("stage2_pipeline: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# data_parallel: the port's ranks (rcf_tpu_torch/parallel) on the one card.
# Two ranks, each its own process (``chip_smoke.py --data-parallel-rank``),
# on gloo with ``backend="gloo"`` passed explicitly (NCCL refuses two ranks
# on one card), against one process with the whole batch; then three steps
# of the DAVIS recipe at its full batch over the two ranks; then the
# launcher path of ``cli.main`` on NCCL at world 1, resuming the two ranks'
# checkpoint. Two ranks on one card share its time and memory and exchange
# through host memory: no reading here is a multi-card figure.
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_DEVICE = "cuda"
DP_DIR = "rcf_tpu_torch/build/smoke_dp"
DP_HW = 128        # the hold's frames: 2 pairs of 128^2 a rank (stage 1, stage 2.1)
DP_AMD_HW = 64     # the AMD hold: 2 pairs of 64^2 a rank, flow_size 64x64
DP_PAIRS = 16      # (b): the DAVIS recipe's global batch, split over the ranks
DP_TIMEOUT_S = 420.0
DP_CARDS_WAIT_S = 180.0  # ``--data-parallel-cards``: the wait for a world's ranks
DP_NOISE = 1e-7    # the noise control: world 1 with each frame value scaled by 1 + 1e-7 N(0, 1)
# The hold, world N against world 1 on the card, TF32 off, f32, dropout on
# (drawn for the whole batch): every loss, relative (``loss_rel``: the worst
# key); the averaged gradients, the largest difference over every tensor over
# the largest |g| (``grad_rel``) and the L2 of the difference over the L2 of
# the gradients (``grad_l2``); the BN running statistics, the EMA's among them,
# each tensor's largest difference over its largest entry (``stats_rel``); the
# fraction of the EMA's parameters whose increment differs from world 1's by
# more than 0.1 of an increment (lr (1 - ema_m)) (``ema_off``).
# These models' gradients are not smooth everywhere (ReLU, |x|, max-pool and
# bilinear taps), and Adam's first update is lr * sign(g): a change of
# summation order moves the gradients and the EMA as far as float noise on the
# inputs does. The noise control, world 1 against world 1 with ``DP_NOISE`` on
# the frames, reads that floor on the card in every run. Each case's limits sit
# between its floor and what the planted faults read (``python3
# tools/smoke_fault_check.py data_parallel``; H100, 2 gloo ranks): noise / sound
# split / per-rank BN, grad_l2 stage 1 7.5e-3 / 7.3e-3 / 0.46, stage 2.1
# 1.1e-2 / 1.05e-2 / 0.92, AMD 9.0e-4 / 1.1e-3 / 7.0e-2; AMD's grad_rel 4.0e-5
# / 5.9e-5, and 1.7e-3 with each rank's own occlusion ratio, which its grad_l2
# (2.0e-3) does not separate from the floor; statistics under 5.3e-6 sound,
# 0.5-2.3 with per-rank BN; the EMA 7.3e-3 / 3.1e-3 (stage 1 / 2.1) sound,
# 0.36-0.44 with per-rank BN; the losses under 2e-7 sound.
DP_LIMITS = {
    "stage1": {"loss_rel": 1e-5, "grad_rel": 5e-3, "grad_l2": 2e-2, "stats_rel": 5e-5,
               "ema_off": 2e-2},
    "stage2_1": {"loss_rel": 1e-5, "grad_rel": 1e-2, "grad_l2": 3e-2, "stats_rel": 5e-5,
                 "ema_off": 1e-2},
    "amd": {"loss_rel": 1e-5, "grad_rel": 5e-3, "grad_l2": 1e-2, "stats_rel": 1e-4,
            "ema_off": 1e-2},
    "unflow": {"loss_rel": 1e-5, "grad_rel": 1e-4},
}
DP_UNFLOW_SIZES = ((64, 96), (32, 48), (16, 24), (8, 12), (4, 6))  # finest first


def dp_cases(torch, world: int = DP_WORLD) -> dict:
    """The hold's three steps, made on the CPU from seeds: the DAVIS stage-1
    recipe at full width (EMA on, masks scaled with the frames), its stage 2.1
    (the CRF on a grid scaled with the frames, object channel 0), and the AMD
    recipe at flow_size 64x64; each batch 2 pairs a rank."""
    gen = torch.Generator().manual_seed(11)
    m = RCF_RECIPES["rcf"]["model_kwargs"]["mask_size"][0] * DP_HW // H
    s1 = rcf_train_cfg("rcf", mask_size=(m, m))
    crf = copy.deepcopy(RCF_CRF_RECIPES["rcf"])
    crf_kw = crf["model_kwargs"]
    crf_kw["mask_size"] = crf_kw["decode_head"]["mask_size"] = [m, m]
    grid = crf_kw["crf_head"]["resolution"][0] * DP_HW // H
    crf_kw["crf_head"]["resolution"] = [grid, grid]
    n = 2 * world
    return {
        "stage1": {"amd": False, "cfg": s1, "batch": rcf_batch(torch, gen, n, DP_HW, "cpu")},
        "stage2_1": {"amd": False, "cfg": dict(crf["train"], model_kwargs=crf_kw),
                     "batch": rcf_crf_batch(torch, gen, n, DP_HW, "cpu")},
        "amd": {"amd": True,
                "cfg": dict(TRAIN_CFG, model_kwargs=amd_model_kwargs(
                    flow_size=(DP_AMD_HW, DP_AMD_HW))),
                "batch": {"imgs": torch.randn(n, 2, DP_AMD_HW, DP_AMD_HW, 3, generator=gen)}},
    }


def _noisy(torch, x):
    """``x`` with every value scaled by 1 + DP_NOISE N(0, 1) (seeded)."""
    return x * (1.0 + DP_NOISE * torch.randn(x.shape, generator=torch.Generator().manual_seed(12)))


def dp_noisy(torch, case: dict) -> dict:
    """``case`` with noise on its frames (``_noisy``)."""
    return dict(case, batch=dict(case["batch"], imgs=_noisy(torch, case["batch"]["imgs"])))


def dp_unflow_inputs(torch, world: int = DP_WORLD) -> dict:
    """The occlusion-ratio hold's inputs, 2 pairs a rank: a flow pyramid
    (``DP_UNFLOW_SIZES``) of N(0, 3^2) px flows, large enough that the
    occlusion masks, and so the ranks' own ratios, differ; frames U(0, 1)."""
    gen = torch.Generator().manual_seed(13)
    n = 2 * world
    flows = [torch.randn(n, h, w, 4, generator=gen) * 3.0 for h, w in DP_UNFLOW_SIZES]
    h, w = DP_UNFLOW_SIZES[0]
    im1, im2 = (torch.rand(n, h, w, 3, generator=gen) for _ in range(2))
    return {"flows": flows, "im1": im1, "im2": im2}


def dp_unflow(torch, inp: dict, dev: str) -> dict:
    """The AMD recipe's unFlow loss (backward-density occlusion: the warps and
    the splat) on this rank's rows, and its gradient in the finest flow over
    the world (the rank's share of the whole batch's), on the CPU."""
    from rcf_tpu_torch.losses.unflow import UnFlowLossCfg, unflow_loss
    from rcf_tpu_torch.parallel import dist

    w, r = dist.world(), dist.rank()
    flows = [f[r::w].to(dev).requires_grad_(True) for f in inp["flows"]]
    loss = unflow_loss(flows, inp["im1"][r::w].to(dev), inp["im2"][r::w].to(dev),
                       UnFlowLossCfg())[0]
    loss.backward()
    return {"loss": loss.item(), "dflow0": flows[0].grad.cpu() / w}


def dp_unflow_readings(ours: dict, ref: dict, rank: int, world: int) -> dict:
    """A rank's occlusion-ratio hold against world 1, keyed as ``DP_LIMITS``:
    the loss, relative, and the gradient of its rows over the largest |g|."""
    g = ref["dflow0"]
    return {"loss_rel": abs(ours["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_rel": float((ours["dflow0"] - g[rank::world]).abs().max() / g.abs().max())}


def dp_step(torch, case: dict, dev: str) -> dict:
    """One train step of a hold case on this rank's rows (every row at world 1),
    TF32 off: the losses, the averaged gradients, the BN running statistics and
    the EMA after it, on the CPU, and the kernels' launches in the step."""
    from rcf_tpu_torch.models import build_model
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.ops import crf_kernels as ck
    from rcf_tpu_torch.ops import warp_kernels as wk
    from rcf_tpu_torch.parallel import dist
    from rcf_tpu_torch.train import create_train_state, make_train_step, maybe_crf_fn, step_seed

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        build = build_amd_model if case["amd"] else build_model
        model = build(case["cfg"]["model_kwargs"], device=dev, seed=0)
        state = create_train_state(case["cfg"], model, steps_per_epoch=STEPS_PER_EPOCH)
        grads: dict = {}
        adam = state.optimizer.step

        def read_grads(*args, **kwargs):
            grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                          if p.grad is not None})
            return adam(*args, **kwargs)

        state.optimizer.step = read_grads
        w, r = dist.world(), dist.rank()
        batch = {k: v[r::w].to(dev) if isinstance(v, torch.Tensor) else v
                 for k, v in case["batch"].items()}
        gen = torch.Generator(device=dev).manual_seed(step_seed(0, 0))
        step = make_train_step(crf_fn=maybe_crf_fn(model))
        ema0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                if "_ema." in k}
        wk.reset_launch_counts()
        ck.reset_launch_counts()
        losses = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        launches = {**wk.LAUNCHES, **ck.LAUNCHES}
        sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        return {"losses": {k: v.item() for k, v in losses.items()}, "grads": grads,
                "stats": {k: v for k, v in sd.items() if "running" in k},
                "ema_inc": {k: v - ema0[k] for k, v in sd.items()
                            if "_ema." in k and "running" not in k},
                "ema_step": state.schedule(0) * (1.0 - (state.ema_m or 0.0)),
                "launches": launches, "state": sd}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _tensor_rel(ours: dict, ref: dict) -> float:
    """The worst tensor's largest difference over its largest entry."""
    worst = 0.0
    for k, t in ref.items():
        scale = float(t.abs().max())
        if scale > 0:
            worst = max(worst, float((ours[k] - t).abs().max()) / scale)
    return worst


def dp_readings(ours: dict, ref: dict) -> dict:
    """A rank's hold against world 1, keyed as ``DP_LIMITS``."""
    g, gr = ours["grads"], ref["grads"]
    gmax = max(float(t.abs().max()) for t in gr.values())
    diff2 = sum(float((g[k] - t).double().pow(2).sum()) for k, t in gr.items())
    norm2 = sum(float(t.double().pow(2).sum()) for t in gr.values())
    inc, inc_ref = ours["ema_inc"], ref["ema_inc"]
    off = sum(int(((inc[k] - t).abs() > 0.1 * ref["ema_step"]).sum()) for k, t in inc_ref.items())
    return {
        "loss_rel": max(abs(ours["losses"][k] - v) / abs(v) for k, v in ref["losses"].items()),
        "grad_rel": max(float((g[k] - t).abs().max()) for k, t in gr.items()) / gmax,
        "grad_l2": math.sqrt(diff2 / norm2),
        "stats_rel": _tensor_rel(ours["stats"], ref["stats"]),
        "ema_off": off / max(sum(t.numel() for t in inc_ref.values()), 1),
    }


def _state_flat(torch, state, dev):
    """The train state as one f32 vector: the model's parameters and buffers, the
    optimizer's tensors (moments and step counts) and the step."""
    opt = [v for g in state.optimizer.param_groups for p in g["params"]
           for _, v in sorted(state.optimizer.state.get(p, {}).items())
           if isinstance(v, torch.Tensor)]
    parts = [t.detach().float().flatten().to(dev) for t in [*state.model.state_dict().values(),
                                                            *opt]]
    return torch.cat(parts + [torch.tensor([float(state.step)], device=dev)]), len(opt)


def dp_full_width(torch, dev: str, ckpt_dir: str, pairs: int) -> dict:
    """Three steps of the DAVIS stage-1 recipe (its YAML's model, no EMA) at its
    global batch, ``pairs`` pairs of 384^2 frames and flows a rank, from rank
    0's weights: step 2 timed as it runs, step 3 with the card synchronized
    around each collective to time them (which stalls the host's launches, so
    step 3 reads slower). Then every rank's whole state (optimizer included)
    against rank 0's, ``broadcast_state`` once more (it must move nothing),
    and ``last`` saved through ``train/checkpoint.py``."""
    import torch.distributed as tdist

    from rcf_tpu_torch.models import build_model
    from rcf_tpu_torch.parallel import dist
    from rcf_tpu_torch.train import create_train_state, make_train_step, step_seed
    from rcf_tpu_torch.train.checkpoint import save_checkpoint

    cfg = dict(RCF_RECIPES["rcf"]["train"], model_kwargs=RCF_RECIPES["rcf"]["model_kwargs"])
    model = build_model(cfg["model_kwargs"], device=dev, seed=dist.rank())
    state = create_train_state(cfg, model, steps_per_epoch=3)
    dist.broadcast_state(state)  # every rank starts from rank 0's weights
    gen = torch.Generator(device=dev).manual_seed(100 + dist.rank())
    batch = rcf_batch(torch, gen, pairs, H, dev)
    step = make_train_step()
    spent, calls = [0.0], [0]
    all_reduce = tdist.all_reduce

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return all_reduce(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            calls[0] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(STEPS):
        gen.manual_seed(step_seed(0, i))
        if i == STEPS - 1:
            tdist.all_reduce = timed
        try:
            t0 = time.perf_counter()
            losses = step(state, batch, generator=gen)
            vals = {k: v.item() for k, v in losses.items()}
            times.append((time.perf_counter() - t0) * 1e3)
        finally:
            tdist.all_reduce = all_reduce
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"data_parallel full width: non-finite loss {vals}")
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters() if p.requires_grad)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flat, n_opt = _state_flat(torch, state, dev)
    theirs = flat.clone()
    dist.broadcast_([theirs])
    dist.broadcast_state(state)
    again, _ = _state_flat(torch, state, dev)
    save_checkpoint(ckpt_dir, "last", state)
    return {"step_ms": sum(times[1:-1]) / len(times[1:-1]), "step_ms_all": times,
            "state_vs_rank0": float((flat - theirs).abs().max()),
            "rebroadcast_moved": float((again - flat).abs().max()), "optimizer_tensors": n_opt,
            "step_ms_synchronized": times[-1], "all_reduce_share": spent[0] * 1e3 / times[-1],
            "all_reduces_per_step": calls[0], "peak_gib": peak, "pairs": pairs,
            "grad_bytes": grad_bytes, "losses": vals, "step": state.step}


def dp_rank_main(torch, rank: int, work: str) -> int:
    """One rank of the data_parallel phase (a child process of the phase): its
    world, backend and cards are in ``<work>/inputs.pt``."""
    import os

    from rcf_tpu_torch.parallel import dist

    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    world = inp["world"]
    os.environ.update(RCF_DIST="1", RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if inp["cards"] > 1 else 0))
    dev = str(dist.init_distributed(device=DP_DEVICE, backend=inp["backend"],
                                    init_method=f"file://{os.path.abspath(work)}/rendezvous",
                                    timeout_s=DP_TIMEOUT_S))
    try:
        out = {}
        for name, case in inp["cases"].items():
            mine = dp_step(torch, case, dev)
            # Every rank's state must be rank 0's, bit for bit.
            flat = torch.cat([t.float().flatten() for t in mine["state"].values()]).to(dev)
            theirs = flat.clone()
            dist.broadcast_([theirs])
            out[name] = {**dp_readings(mine, inp["ref"][name]),
                         "launches": mine["launches"], "losses": mine["losses"],
                         "state_vs_rank0": float((flat - theirs).abs().max())}
            del mine, flat, theirs
            torch.cuda.empty_cache()
        out["unflow"] = dp_unflow_readings(dp_unflow(torch, inp["unflow"], dev),
                                           inp["ref_unflow"], rank, world)
        out["full_width"] = dp_full_width(torch, dev, os.path.join(work, "ckpt"),
                                          DP_PAIRS // world)
        with open(os.path.join(work, f"out_{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.shutdown()
    return 0


def dp_rank_command(rank: int, work: str) -> list:
    return [sys.executable, __file__, "--data-parallel-rank", str(rank), work]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(commands: list, logs: list, env=None, wait_s: float = DP_TIMEOUT_S) -> list:
    """Start one process a command (output to its log) and wait for all of them
    within ``wait_s``; kill what is left. Returns the exit codes."""
    t0 = time.perf_counter()
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              env=None if env is None else env[i])
             for i, (c, f) in enumerate(zip(commands, files))]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, wait_s - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return [p.returncode for p in procs]


def _tails(logs: list) -> list:
    return [open(p).read()[-2000:] for p in logs]


def dp_ranks(torch, rank_command=dp_rank_command, world: int = DP_WORLD, backend: str = "gloo",
             cards: int = 1, wait_s: float = DP_TIMEOUT_S) -> tuple[dict, list]:
    """(a) the hold and (b) the full-width steps over ``world`` ranks, on gloo on
    the one card or one card a rank (``cards`` > 1), the ranks started by
    ``rank_command(rank, work_dir)``; the noise control beside the hold.
    Returns the readings and the failed checks."""
    import os
    import shutil

    work = os.path.abspath(DP_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "ckpt"))
    failures = []
    t0 = time.perf_counter()
    cases = dp_cases(torch, world)
    ref, noise = {}, {}
    for name, case in cases.items():
        r = dp_step(torch, case, DP_DEVICE)
        ref[name] = {k: r[k] for k in ("losses", "grads", "stats", "ema_inc", "ema_step")}
        noise[name] = dp_readings(dp_step(torch, dp_noisy(torch, case), DP_DEVICE), ref[name])
        torch.cuda.empty_cache()
    unflow = dp_unflow_inputs(torch, world)
    ref_unflow = dp_unflow(torch, unflow, DP_DEVICE)
    noisy = dict(unflow, im1=_noisy(torch, unflow["im1"]))
    noise["unflow"] = dp_unflow_readings(dp_unflow(torch, noisy, DP_DEVICE), ref_unflow, 0, 1)
    torch.save({"cases": cases, "ref": ref, "unflow": unflow, "ref_unflow": ref_unflow,
                "world": world, "backend": backend, "cards": cards},
               os.path.join(work, "inputs.pt"))
    del ref
    out = {"world": world, "backend": backend, "cards": cards, "noise": noise,
           "world1_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    logs = [os.path.join(work, f"rank{r}.log") for r in range(world)]
    rcs = _run_ranks([rank_command(r, work) for r in range(world)], logs, wait_s=wait_s)
    out["ranks_s"] = time.perf_counter() - t0
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"data_parallel: ranks exited {rcs}: {_tails(logs)}")
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"out_{r}.json")) as f:
            ranks.append(json.load(f))
    out["hold"] = {name: [rk[name] for rk in ranks] for name in (*cases, "unflow")}
    for name, readings in out["hold"].items():
        lims = DP_LIMITS[name]
        for r, reading in enumerate(readings):
            over = [k for k, lim in lims.items() if reading[k] > lim]
            if over:
                failures.append(f"{name} rank {r}: {over} over {lims}: "
                                f"{ {k: reading[k] for k in lims} }")
            if reading.get("state_vs_rank0", 0.0) != 0.0:
                failures.append(f"{name} rank {r}: state differs from rank 0's by "
                                f"{reading['state_vs_rank0']}")
    for r in range(world):
        if out["hold"]["stage2_1"][r]["launches"]["crf_filter"] == 0:
            failures.append(f"stage2_1 rank {r}: crf_filter never launched")
        if any(out["hold"]["amd"][r]["launches"][k] == 0 for k in STEP_KERNELS):
            failures.append(f"amd rank {r}: a warp kernel never launched: "
                            f"{out['hold']['amd'][r]['launches']}")
    out["full_width"] = [rk["full_width"] for rk in ranks]
    for r, fw in enumerate(out["full_width"]):
        if fw["state_vs_rank0"] != 0.0 or fw["rebroadcast_moved"] != 0.0:
            failures.append(f"full width rank {r}: the state differs from rank 0's after "
                            f"{STEPS} steps ({fw['state_vs_rank0']}) or moved when broadcast "
                            f"again ({fw['rebroadcast_moved']})")
        if fw["optimizer_tensors"] == 0:
            failures.append(f"full width rank {r}: no optimizer state after {STEPS} steps")
    return out, failures


def _launcher_args(ckpt: str) -> list:
    import os

    return ["configs/rcf/rcf_stage1.yaml", "--no-test", "--opts", "data_path",
            os.path.abspath(TRAIN_DIR), "checkpoints_dir", ckpt, "pretrained_model", "null",
            "epochs", "2", "loss_log_interval", "1"]


def _launcher_failures(ckpt: str, world: int) -> tuple[list, list]:
    """The logged steps, and what is wrong: not resumed at step 3 for epoch 1,
    or a rank's heartbeat file missing."""
    import os

    steps = [r["step"] for r in _records(ckpt) if "step" in r]
    failures = []
    if steps != [4, 5, 6]:
        failures.append(f"launcher: did not resume at step 3 and run epoch 1: logged {steps}")
    beats = [".heartbeat"] + [f".heartbeat.h{i}" for i in range(1, world)]
    missing = [b for b in beats if not os.path.isfile(os.path.join(ckpt, b))]
    if missing:
        failures.append(f"launcher: heartbeat files missing: {missing}")
    return steps, failures


def dp_launcher(torch) -> tuple[dict, list]:
    """(c) ``cli.main`` with ``RCF_DIST=1`` on NCCL at world 1, resuming the
    ``last`` that (b) saved at world 2, for epoch 1 of ``train_cli``'s set."""
    import os

    import torch.distributed as tdist

    from rcf_tpu_torch import cli

    ckpt = os.path.join(os.path.abspath(DP_DIR), "ckpt")
    env = {"RCF_DIST": "1", "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        state = cli.main(_launcher_args(ckpt))
    finally:
        for k in env:
            os.environ.pop(k, None)
    steps, failures = _launcher_failures(ckpt, 1)
    out = {"launcher_s": time.perf_counter() - t0, "step": state.step, "logged_steps": steps,
           "group_left": not tdist.is_initialized()}
    if state.step != 6:
        failures.append(f"launcher: ended at step {state.step}, not 6")
    if not out["group_left"]:
        failures.append("launcher: the process group was not left at exit")
    return out, failures


def dp_launcher_ranks(world: int, wait_s: float = DP_TIMEOUT_S) -> tuple[dict, list]:
    """(c) over ``world`` cards: one ``python -m rcf_tpu_torch.cli`` a rank with
    ``RCF_DIST=1`` and the variables a launcher sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), on NCCL, resuming the
    ``last`` that (b) saved at this world, for epoch 1 of ``train_cli``'s set."""
    import os

    work = os.path.abspath(DP_DIR)
    ckpt = os.path.join(work, "ckpt")
    port = str(_free_port())
    envs = [dict(os.environ, RCF_DIST="1", RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for r in range(world)]
    logs = [os.path.join(work, f"launcher{r}.log") for r in range(world)]
    t0 = time.perf_counter()
    rcs = _run_ranks([[sys.executable, "-m", "rcf_tpu_torch.cli", *_launcher_args(ckpt)]] * world,
                     logs, envs, wait_s)
    out = {"launcher_s": time.perf_counter() - t0, "rcs": rcs}
    if any(rc != 0 for rc in rcs):
        return out, [f"launcher: ranks exited {rcs}: {_tails(logs)}"]
    out["logged_steps"], failures = _launcher_failures(ckpt, world)
    return out, failures


def log_data_parallel(out: dict) -> None:
    """The hold's readings beside their limits and the noise control, and (b)."""
    world, cards = out["world"], out["cards"]
    for name, readings in out["hold"].items():
        lims = DP_LIMITS[name]
        log(f"data_parallel noise control {name} (world 1 against world 1 with {DP_NOISE:g} "
            f"of noise on the frames): " + ", ".join(f"{k} {out['noise'][name][k]:.3e}"
                                                     for k in lims))
        for r, reading in enumerate(readings):
            log(f"data_parallel hold {name} world {world} rank {r}: " + ", ".join(
                f"{k} {reading[k]:.3e} (limit {lim:g})" for k, lim in lims.items())
                + f"; launches {reading.get('launches', 'not counted')}")
    where = (f"{world} gloo ranks on one card through host memory, not a multi-card figure"
             if cards == 1 else f"{world} {out['backend']} ranks, one card each")
    for r, fw in enumerate(out["full_width"]):
        log(f"data_parallel full width rank {r} ({where}; DAVIS stage 1, {fw['pairs']} pairs of "
            f"384^2 a rank, TF32 convs): step {fw['step_ms']:.1f} ms (steps 2-{STEPS - 1}), peak "
            f"{fw['peak_gib']:.2f} GiB, gradients {fw['grad_bytes'] / 2**20:.1f} MiB a step, "
            f"{fw['all_reduces_per_step']} all-reduces a step, collectives "
            f"{100 * fw['all_reduce_share']:.1f}% of step {STEPS} "
            f"({fw['step_ms_synchronized']:.1f} ms with the card synchronized around each)")


def phase_data_parallel(torch) -> dict:
    """``dp_ranks`` and ``dp_launcher`` on the card; raises on any failed check."""
    out, failures = dp_ranks(torch)
    out["launcher"], more = dp_launcher(torch)
    failures += more
    log_data_parallel(out)
    if failures:
        raise RuntimeError("data_parallel: " + "; ".join(failures))
    return out


def data_parallel_cards_main(torch, wk, ck, cards: int) -> int:
    """``--data-parallel-cards N``: the data_parallel phase on NCCL, one card a
    rank, at 2 ranks and at N: (a) and (b) as in the one-card run, and (c) as
    a launcher runs it, one ``python -m rcf_tpu_torch.cli`` a rank."""
    import os
    import shutil

    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: {cards} cards asked for, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(wk.LIB.build), pool.submit(ck.LIB.build)]
        sos = [b.result() for b in builds]
    log(f"build: {time.perf_counter() - t0:.1f} s -> {sos}")
    root = os.path.abspath(TRAIN_DIR)
    shutil.rmtree(root, ignore_errors=True)
    write_synthetic_davis(root)
    out, failures = {}, []
    for world in sorted({2, cards}):
        t0 = time.perf_counter()
        readings, fails = dp_ranks(torch, world=world, backend="nccl", cards=world,
                                   wait_s=DP_CARDS_WAIT_S)
        readings["launcher"], more = dp_launcher_ranks(world, DP_CARDS_WAIT_S)
        readings["phase_s"] = time.perf_counter() - t0
        log_data_parallel(readings)
        log(f"data_parallel launcher world {world}: {readings['launcher']}")
        failures += [f"world {world}: {f}" for f in fails + more]
        out[world] = readings
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if failures:
        raise RuntimeError("data_parallel: " + "; ".join(failures))
    print(json.dumps({"data_parallel_cards": out}), flush=True)
    print(smi.replace("\n", "; "), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from rcf_tpu_torch.ops import attention_kernels as ak
        from rcf_tpu_torch.ops import crf as crf_ops
        from rcf_tpu_torch.ops import crf_kernels as ck
        from rcf_tpu_torch.ops import linear_kernels as lk
        from rcf_tpu_torch.ops import warp_kernels as wk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        return dp_rank_main(torch, int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--data-parallel-cards"]:
        return data_parallel_cards_main(torch, wk, ck, int(sys.argv[2]))

    phases = {}
    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    phase_kernels()
    phases["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for lib in (wk.LIB, ck.LIB, ak.LIB, lk.LIB):
        for r in lib.ptxas():
            log(f"  ptxas: {r['entry']}: {r.get('registers')} registers, spill "
                f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes, {r.get('smem')} bytes shared")
    phases["build"] = time.perf_counter() - t0

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
    rows = phase_timing(torch, wk, counts)
    crf_launches = {p: rcf[p]["launches"]["crf_filter"] for p in ("rcf_step_crf",
                                                                 "rcf_step_crf_bf16")}
    torch.cuda.empty_cache()
    rows.append(attention_timing(torch, ak))
    torch.cuda.empty_cache()
    rows.append(linear_timing(torch, lk))
    rows.append(crf_timing(torch, ck, crf_launches))
    phases["timing"] = time.perf_counter() - t0

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_cli = phase_train_cli(torch, wk, ck)
    phases["train_cli"] = time.perf_counter() - t0

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stage2 = phase_stage2_pipeline(torch, wk, ck, crf_ops)
    phases["stage2_pipeline"] = time.perf_counter() - t0
    r480 = stage2["crf_480p"]
    rows[-1].update({"launches_stage2_pipeline": stage2["crf_pp_device_launches"],
                     "ms_480p": r480["ms"], "bound_ms_480p": r480["bound_ms"],
                     "bound_by_480p": r480["bound_by"], "library_ms_480p": r480["library_ms"],
                     "max_abs_err_480p": r480["max_abs_err"]})

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data_parallel = phase_data_parallel(torch)
    phases["data_parallel"] = time.perf_counter() - t0

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
    print(json.dumps({"train_cli": train_cli}), flush=True)
    print(json.dumps({"stage2_pipeline": stage2}), flush=True)
    print(json.dumps({"data_parallel": data_parallel}), flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
