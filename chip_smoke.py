#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed:

1. build     - compile ``rcf_tpu_torch/csrc/*.cu`` with nvcc (sm_90a) into
               ``rcf_tpu_torch/build/``;
2. kernels   - each kernel against its plain PyTorch version on the card, at
               the AMD level-0 shapes (B=8, 384x640), images in f32 and bf16;
3. step      - three AMD training steps (ResNet-50 OS8 + FCN mask head +
               PWC-Lite + unFlow loss, Adam) at batch 8 pairs of 384^2
               frames, flow_size 384x640, random weights from a seed; every
               kernel's launch count must rise and the losses be finite;
4. reference - the AMD forward and a weight gradient at a small input, and
               the unFlow loss and its flow gradient on seeded flows, on the
               card against the port's plain CPU path (which the tests hold
               to the JAX package), TF32 off;
5. timing    - each kernel, its plain version and a PyTorch library call at
               the level-0 shape, with CUDA events.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, the
phase seconds, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises: the exit code is then not 0 and no result line is
printed. Without a CUDA device, or without the package beside it, it exits
with an error at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 rate outside the tensor cores

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
REF_LIMITS = {"loss_rel": 1e-3, "probs_err": 1e-3, "grad_rel": 1e-2,
              "unflow_rel": 1e-4, "unflow_grad_rel": 1e-4}

REPLACES = {
    "warp_fwd": "rcf_tpu/ops/pallas/warp_pallas.py:124",
    "warp_bwd": "rcf_tpu/ops/pallas/warp_pallas.py:220",
    "splat": "rcf_tpu/ops/pallas/warp_pallas.py:266",
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


def level0_inputs(torch, dtype, gen, scale=5.0, b=B):
    """img [b,H,W,C] in [0,1), non-integer absolute coords cx, cy [b,H,W] f32."""
    dev = "cuda"
    img = torch.rand(b, H, W, C, generator=gen, device=dev).to(dtype)
    fl = torch.randn(b, H, W, 2, generator=gen, device=dev) * scale
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    return img, xs + fl[..., 0], ys + fl[..., 1]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, wk) -> dict:
    """Each kernel vs its plain version at the level-0 shapes; returns f32 max errors."""
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
    # The splat sees both flow directions batched: 2B maps.
    _, tx, ty = level0_inputs(torch, torch.float32, gen, b=2 * B)
    dens = wk.splat(tx, ty, H, W)
    torch.cuda.synchronize()
    e_splat = max_err(dens, wk.splat_plain(tx, ty, H, W))
    log(f"kernel splat float32: max_abs_err {e_splat:.3e} (tol {TOL[('splat', 'float32')]})")
    if not e_splat <= TOL[("splat", "float32")]:
        raise RuntimeError("splat kernel disagrees with its plain version")
    errs["splat"] = e_splat
    return errs


def phase_step(torch, wk) -> tuple[dict, float]:
    """Three AMD training steps at full width; returns (launch counts, step ms)."""
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.train import create_train_state, make_train_step

    model = build_amd_model(amd_model_kwargs(), device="cuda", seed=0)
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
        log(f"step {i}: {times[-1]:.1f} ms, losses {vals}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite loss at step {i}: {vals}")
    counts = dict(wk.LAUNCHES)
    log(f"launches over {STEPS} steps: {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise RuntimeError("non-finite parameters after the steps")
    return counts, sum(times[1:]) / len(times[1:])


def reference_forward(torch, dev: str) -> dict:
    """The reference computations on one device, TF32 off, returned on the CPU.

    ``model``: the AMD forward and backward (train mode, no dropout) at a small
    input: the loss, the mask probabilities and a flownet weight gradient.
    ``unflow``: the AMD recipe's unFlow loss on seeded random flows (5 levels
    from 128x192, a few pixels long, so that taps leave the frame) and its
    gradient in the flows.
    """
    from rcf_tpu_torch.losses import unflow_loss
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.models.amd.amd_model import _FLOW_CFG

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
        loss = unflow_loss(flows, im1, im2, _FLOW_CFG)[0]
        scored = [f for f, w in zip(flows, _FLOW_CFG.w_scales) if w > 0]
        grads = torch.autograd.grad(loss, scored)
        out["unflow"] = (loss.item(), torch.cat([g.flatten() for g in grads]).cpu())
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def reference_errors(cpu: dict, cuda: dict) -> dict:
    """The card's readings against the CPU's, keyed as ``REF_LIMITS``."""
    def rel(a: float, b: float) -> float:
        return abs(a - b) / abs(b) if math.isfinite(a) else math.inf

    def rel_max(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    (lc, pc, gc), (lg, pg, gg) = cpu["model"], cuda["model"]
    (uc, uhc), (ug, uhg) = cpu["unflow"], cuda["unflow"]
    return {"loss_rel": rel(lg, lc), "probs_err": float((pg - pc).abs().max()),
            "grad_rel": rel_max(gg, gc), "unflow_rel": rel(ug, uc),
            "unflow_grad_rel": rel_max(uhg, uhc)}


def reference_failures(errs: dict) -> list:
    """The readings above their limits (a NaN reading fails too)."""
    return [k for k, lim in REF_LIMITS.items() if not errs[k] <= lim]


def phase_reference(torch) -> None:
    """The AMD forward, the unFlow loss and their gradients on the card against the CPU path."""
    cpu, cuda = reference_forward(torch, "cpu"), reference_forward(torch, "cuda")
    errs = reference_errors(cpu, cuda)
    log(f"reference: AMD loss cuda {cuda['model'][0]:.6f} cpu {cpu['model'][0]:.6f}; unFlow loss "
        f"cuda {cuda['unflow'][0]:.6f} cpu {cpu['unflow'][0]:.6f}; "
        + ", ".join(f"{k} {v:.2e} (tol {REF_LIMITS[k]})" for k, v in errs.items()))
    failed = reference_failures(errs)
    if failed:
        raise RuntimeError(f"the card disagrees with the CPU path: {failed}")


def phase_timing(torch, wk, counts: dict, errs: dict) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    img, cx, cy = level0_inputs(torch, torch.float32, gen)
    cx, cy = cx.clamp(0, W - 1), cy.clamp(0, H - 1)
    g = torch.randn(B, H, W, C, generator=gen, device="cuda")
    _, tx, ty = level0_inputs(torch, torch.float32, gen, b=2 * B)
    n_px = B * H * W

    # Library yardsticks: grid_sample and its backward for the grid alone
    # (dgrid = (dcx, dcy) times (W-1)/2, (H-1)/2) on the same image (NCHW) and
    # grid; index_add_ of the splat's precomputed corner weights.
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([cx * (2.0 / (W - 1)) - 1.0, cy * (2.0 / (H - 1)) - 1.0], dim=-1)
    offs, valid, ax, ay = wk._taps(tx, ty, H, W)
    wts = ((1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax)
    base = (torch.arange(2 * B, device="cuda") * H * W)[:, None, None]
    idx = torch.cat([(o.clamp(0, H * W - 1) + base).flatten() for o in offs])
    val = torch.cat([torch.where(v, w_, torch.zeros_like(w_)).flatten()
                     for v, w_ in zip(valid, wts)])
    dens = torch.zeros(2 * B * H * W, device="cuda")

    rows = []
    specs = [
        ("warp_fwd", lambda: wk.warp_fwd(img, cx, cy), lambda: wk.warp_fwd_plain(img, cx, cy),
         lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                               align_corners=True),
         nbytes(img, cx, cy, img), n_px * (10 + 9 * C)),
        ("warp_bwd", lambda: wk.warp_bwd(img, cx, cy, g),
         lambda: wk.warp_bwd_plain(img, cx, cy, g),
         lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, True,
                                                         [False, True]),
         nbytes(img, cx, cy, g, cx, cy), n_px * (12 + 14 * C)),
        ("splat", lambda: wk.splat(tx, ty, H, W), lambda: wk.splat_plain(tx, ty, H, W),
         lambda: dens.zero_().index_add_(0, idx, val),
         nbytes(tx, ty) + 2 * B * H * W * 4, 2 * n_px * 20),
    ]
    for name, kern, plain, lib, n_bytes, flops in specs:
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=5)
        lib_ms = cuda_ms(torch, lib) if lib is not None else None
        b_ms, b_by = bound(n_bytes, flops)
        rows.append({
            "name": name, "route": "cuda", "source": "rcf_tpu_torch/csrc/warp.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
        log(f"timing {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, plain "
            f"{plain_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from rcf_tpu_torch.ops import warp_kernels as wk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    phases = {}
    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    so = wk.build()
    phases["build"] = time.perf_counter() - t0
    log(f"build: {phases['build']:.1f} s -> {so}")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    t0 = time.perf_counter()
    errs = phase_kernels(torch, wk)
    phases["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    counts, step_ms = phase_step(torch, wk)
    phases["step"] = time.perf_counter() - t0
    log(f"step ms (mean of steps 2-{STEPS}, batch {B}x2, 384^2 frames, TF32 convs): {step_ms:.1f}")

    t0 = time.perf_counter()
    phase_reference(torch)
    phases["reference"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = phase_timing(torch, wk, counts, errs)
    phases["timing"] = time.perf_counter() - t0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    phases["total"] = time.perf_counter() - t_all
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"step_ms": step_ms, "phases_s": phases}), flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
