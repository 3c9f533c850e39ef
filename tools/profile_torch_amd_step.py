#!/usr/bin/env python3
"""Where the port's AMD or RCF training step spends its time on one NVIDIA GPU.

    python3 tools/profile_torch_amd_step.py [--model amd|rcf_stage1|rcf_stage2_1]
        [--dtype float32|bfloat16] [--steps 2] [--top 25] [--fused-ab ROUNDS]
        [--sync-every K]

``--model amd`` runs the AMD recipe as ``chip_smoke.py`` sets it up
(``configs/amd/amd.yaml``: ResNet-50 OS8, FCN head, PWC-Lite, unFlow loss,
Adam) at batch 8 pairs of 384^2 frames and flow_size 384x640.
``--model rcf_stage1`` runs the RCF stage-1 step with the EMA on, as
``chip_smoke.py``'s stage-1 phases do: the DAVIS recipe
(``configs/rcf/rcf_stage1.yaml``) with ``--dtype float32``, the SegTrackv2
recipe (``configs/rcf_stv2/rcf_stage1.yaml``) with ``--dtype bfloat16``, at
batch 8 pairs of 384^2 frames and ground-truth flows. Both from seed 0, in
the compute dtype ``--dtype`` (f32 convolutions run in TF32, cuDNN's
default). ``--model rcf_stage2_1`` runs the stage-2.1 step as
``chip_smoke.py``'s ``rcf_step_crf`` phases do (the CRF target from the
EMA each step; ``configs/rcf/rcf_stage2.1.yaml`` with ``--dtype float32``,
``configs/rcf_stv2/rcf_stage2.1.yaml`` with ``--dtype bfloat16``; frames
with flat colour regions, object channel 0 set); it also prints the mean
field's iterations and host syncs per step, and ``crf_filter``'s device
time and share; ``--sync-every K`` reads the stable exit's "all done" flag
every K iterations in place of ``ops/crf.py``'s ``SYNC_EVERY``. It warms
up 3 steps, then:

* runs one step with ``torch.cuda.set_sync_debug_mode("warn")`` and prints
  each operation that synchronized the host with the card (its Python
  source line and message), and how many;
* traces ``--steps`` steps with ``torch.profiler``.

Prints the step time (host clock, synchronized), the device busy share
(sum of kernel times over the traced wall time; kernels run on one stream,
so they do not overlap), the host-to-device copies and stream or device
synchronizations per traced step, the device time by group (convolutions
and matmuls, the port's warp kernels, ``crf_filter``, the rest), and the ``--top`` kernels
by device time, then one JSON line with the same numbers. Needs a CUDA
device; imports no JAX.

``--fused-ab ROUNDS`` (``--model rcf_stage1 --dtype float32``: the DAVIS
mask head is the one whose conv0 goes through ``ops/fused_resize_conv.py``)
times the step with that fused conv0 on and off instead, in turns (on, off,
off, on per round, ``--steps`` steps each, after two warm-up steps of each
path), and prints each path's step times, their mean and its peak memory
over its warm-up steps as one JSON line.
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
CRF = "crf_filter_kernel"
# Convolution and matmul kernels by name ("conv" but not "convert"; nvjet is
# cuBLAS's Hopper matmul).
GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|wgrad|dgrad|fprop|winograd|conv(?!ert)")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    if CRF in name:
        return "crf_filter"
    if any(k in name for k in OURS):
        return "port_kernels"
    return "gemm_conv" if GEMM.search(name) else "other"


def _setup(torch, model_name: str, dtype):
    """(state, step, batch, generator) of the model's recipe at full width on the card."""
    import chip_smoke as cs
    from rcf_tpu_torch.train import create_train_state, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    if model_name == "amd":
        from rcf_tpu_torch.models.amd import build_amd_model

        model = build_amd_model(cs.amd_model_kwargs(), device="cuda", seed=0, dtype=dtype)
        cfg = cs.TRAIN_CFG
        batch = {"imgs": torch.randn(cs.B, 2, cs.H, cs.H, 3, generator=gen, device="cuda")}
    else:
        from rcf_tpu_torch.models import build_model
        from rcf_tpu_torch.train import maybe_crf_fn

        recipe = "rcf" if dtype == torch.float32 else "rcf_stv2"
        if model_name == "rcf_stage2_1":
            rec = cs.RCF_CRF_RECIPES[recipe]
            cfg = dict(rec["train"], model_kwargs=rec["model_kwargs"])
            batch = cs.rcf_crf_batch(torch, gen, cs.B, cs.H, "cuda")
        else:
            cfg = cs.rcf_train_cfg(recipe)
            batch = cs.rcf_batch(torch, gen, cs.B, cs.H, "cuda")
        model = build_model(cfg["model_kwargs"], device="cuda", seed=0, dtype=dtype)
        state = create_train_state(cfg, model, steps_per_epoch=cs.STEPS_PER_EPOCH)
        return state, make_train_step(crf_fn=maybe_crf_fn(model)), batch, gen
    state = create_train_state(cfg, model, steps_per_epoch=cs.STEPS_PER_EPOCH)
    return state, make_train_step(), batch, gen


def _fused_ab(torch, state, step, batch, gen, rounds: int, steps: int) -> dict:
    """Step ms and peak memory of the DAVIS step with the mask head's fused
    conv0 on and off (``FCNHead.fast``), timed in turns."""
    head = state.model.decode_head2
    ms, peak = {"fused": [], "plain": []}, {}
    for path in ms:  # warm each path: cuDNN picks its algorithms on the first call
        head.fast = path == "fused"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    for _ in range(rounds):
        for path in ("fused", "plain", "plain", "fused"):
            head.fast = path == "fused"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch, generator=gen)
            torch.cuda.synchronize()
            ms[path].append((time.perf_counter() - t0) * 1e3 / steps)
    head.fast = True
    return {"step_ms": ms, "mean_ms": {k: sum(v) / len(v) for k, v in ms.items()},
            "peak_gib": peak}


def _sync_sources(torch, step, state, batch, gen) -> list:
    """[(source line, message)] of each synchronizing operation in one step."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, batch, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [(f"{os.path.relpath(w.filename)}:{w.lineno}", str(w.message).splitlines()[0])
            for w in caught if "called a synchronizing" in str(w.message)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("amd", "rcf_stage1", "rcf_stage2_1"), default="amd")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--fused-ab", type=int, default=0, metavar="ROUNDS")
    ap.add_argument("--sync-every", type=int, default=0, metavar="K")
    args = ap.parse_args()
    if args.fused_ab and (args.model, args.dtype) != ("rcf_stage1", "float32"):
        ap.error("--fused-ab times the DAVIS recipe: --model rcf_stage1 --dtype float32")

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    from rcf_tpu_torch.ops import crf as crf_ops

    if args.sync_every:
        crf_ops.SYNC_EVERY = args.sync_every
    state, step, batch, gen = _setup(torch, args.model, dtype)
    for _ in range(3):
        step(state, batch, generator=gen)
    torch.cuda.synchronize()
    if args.fused_ab:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        ab = _fused_ab(torch, state, step, batch, gen, args.fused_ab, args.steps)
        print(f"device {smi}; rcf_stage1 float32; mask head conv0 fused / plain: "
              f"{ab['mean_ms']['fused']:.2f} / {ab['mean_ms']['plain']:.2f} ms a step, peak "
              f"{ab['peak_gib']['fused']:.2f} / {ab['peak_gib']['plain']:.2f} GiB")
        print(json.dumps({"device": torch.cuda.get_device_name(0), "fused_ab": ab}))
        return 0
    syncs = _sync_sources(torch, step, state, batch, gen)

    crf_ops.reset_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, batch, generator=gen)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    mean_field = {k: v / args.steps for k, v in crf_ops.STATS.items()}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with record_function("train_step"):
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
    groups = {"gemm_conv": 0.0, "port_kernels": 0.0, "crf_filter": 0.0, "other": 0.0}
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / args.steps
    top = sorted(kernels, key=_device_us, reverse=True)[: args.top]
    # Copies and host waits issued inside the steps (not the window's final
    # synchronize): runtime calls within a "train_step" range.
    events = prof.events()
    steps = [e.time_range for e in events if e.name == "train_step"]

    def in_step(e):
        return any(r.start <= e.time_range.start <= r.end for r in steps)

    h2d = sum("Memcpy HtoD" in e.name for e in events) / args.steps  # device-side copies
    sync_names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
    step_syncs = [e for e in events if e.name in sync_names and in_step(e)]
    sync_calls = len(step_syncs) / args.steps

    def caller(e):  # the innermost operator around a runtime call
        while e.cpu_parent is not None and e.cpu_parent.name.startswith("cuda"):
            e = e.cpu_parent
        return e.cpu_parent.name if e.cpu_parent is not None else "(no operator)"

    sync_callers = sorted({f"{e.name} in {caller(e)}" for e in step_syncs})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {smi}; {args.model}; {args.dtype}; {args.steps} traced steps; "
          f"{len(kernels)} kernel names traced")
    print(f"step {untraced_ms:.2f} ms untraced, {step_ms:.2f} ms traced (host clock); device "
          f"kernel time {total_ms / args.steps:.2f} ms per step; busy share "
          f"{total_ms / wall_ms:.3f}")
    print(f"per traced step: {h2d:g} host-to-device copies, {sync_calls:g} stream/device "
          f"synchronizations; one untraced step: {len(syncs)} synchronizing operations")
    for src, msg in syncs:
        print(f"  sync at {src}: {msg}")
    for c in sync_callers:
        print(f"  traced sync: {c}")
    print("per step by group (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))
    if args.model == "rcf_stage2_1":
        print(f"mean field per untraced step: {mean_field['iterations']:g} iterations, "
              f"{mean_field['host_syncs']:g} host syncs (flag read every "
              f"{crf_ops.SYNC_EVERY}); crf_filter "
              f"{groups['crf_filter']:.2f} ms, {groups['crf_filter'] * args.steps / total_ms:.3f} "
              f"of the device time")
    for e in top:
        print(f"{_device_us(e) / 1e3 / args.steps:9.3f} ms/step {e.count // args.steps:6d} "
              f"calls/step  {_group(e.key):12s} {e.key[:100]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model, "dtype": args.dtype,
        "step_ms_untraced": untraced_ms, "step_ms": step_ms, "h2d_copies_per_step": h2d,
        "syncs_per_step": sync_calls, "sync_sources": syncs, "sync_callers": sync_callers,
        "device_ms_per_step": total_ms / args.steps, "busy_share": total_ms / wall_ms,
        "groups_ms_per_step": groups, "mean_field_per_step": mean_field,
        "sync_every": crf_ops.SYNC_EVERY,
        "crf_filter_share": groups["crf_filter"] * args.steps / total_ms,
        "top": [{"name": e.key, "ms_per_step": _device_us(e) / 1e3 / args.steps,
                 "calls_per_step": e.count // args.steps} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
