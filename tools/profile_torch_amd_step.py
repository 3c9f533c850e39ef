#!/usr/bin/env python3
"""Where the port's AMD training step spends its time on one NVIDIA GPU.

    python3 tools/profile_torch_amd_step.py [--dtype float32|bfloat16] [--steps 2] [--top 25]

Runs the AMD recipe as ``chip_smoke.py`` sets it up (``configs/amd/amd.yaml``:
ResNet-50 OS8, FCN head, PWC-Lite, unFlow loss, Adam) at batch 8 pairs of
384^2 frames and flow_size 384x640 from seed 0, with the compute dtype
``--dtype`` (f32 convolutions run in TF32, cuDNN's default), warms up 3
steps, then traces ``--steps``
steps with ``torch.profiler``. Prints the step time (host clock,
synchronized), the device busy share (sum of kernel times over the traced
wall time; kernels run on one stream, so they do not overlap), the device
time by group (convolutions and matmuls, the port's CUDA kernels, the
rest), and the ``--top`` kernels by device time, then one JSON line with
the same numbers. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OURS = ("warp_fwd_kernel", "warp_bwd_kernel", "warp_bwd_dimg_kernel", "splat_kernel")
# Convolution and matmul kernels by name ("conv" but not "convert").
GEMM = re.compile(r"gemm|xmma|cutlass|wgrad|dgrad|fprop|winograd|conv(?!ert)")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    if any(k in name for k in OURS):
        return "port_kernels"
    return "gemm_conv" if GEMM.search(name) else "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, H, STEPS_PER_EPOCH, TRAIN_CFG, amd_model_kwargs
    from rcf_tpu_torch.models.amd import build_amd_model
    from rcf_tpu_torch.train import create_train_state, make_train_step

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    model = build_amd_model(amd_model_kwargs(), device="cuda", seed=0, dtype=dtype)
    state = create_train_state(TRAIN_CFG, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"imgs": torch.randn(B, 2, H, H, 3, generator=gen, device="cuda")}
    for _ in range(3):
        step(state, batch, generator=gen)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    step_ms = wall_ms / args.steps

    # Device-side events only; a user annotation (Adam's step) spans kernels
    # that are counted on their own.
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3
    groups = {"gemm_conv": 0.0, "port_kernels": 0.0, "other": 0.0}
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / args.steps
    top = sorted(kernels, key=_device_us, reverse=True)[: args.top]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {smi}; {args.dtype}; {args.steps} traced steps; {len(kernels)} kernel names "
          f"traced")
    print(f"step {step_ms:.2f} ms (host clock); device kernel time {total_ms / args.steps:.2f} ms "
          f"per step; busy share {total_ms / wall_ms:.3f}")
    print("per step by group (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))
    for e in top:
        print(f"{_device_us(e) / 1e3 / args.steps:9.3f} ms/step {e.count // args.steps:6d} "
              f"calls/step  {_group(e.key):12s} {e.key[:100]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "dtype": args.dtype, "step_ms": step_ms,
        "device_ms_per_step": total_ms / args.steps, "busy_share": total_ms / wall_ms,
        "groups_ms_per_step": groups,
        "top": [{"name": e.key, "ms_per_step": _device_us(e) / 1e3 / args.steps,
                 "calls_per_step": e.count // args.steps} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
