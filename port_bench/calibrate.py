"""Readings that the output check's limits are set from, on the chip at a
cell's own size (the benchmark's own runs do not run these).

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,13 [--control] [--faults half_batch,sound] [--crf sound,crf_iters_fifth]

``--control``: the plain reference in the program's place, computed in the
precision below the configuration's (``bf16`` for the float32 recipe, whose
convolutions run in TF32; ``fp8`` for the bfloat16 one), against the
reference in float32: the control's reading of each number.
``--faults``: the program's three checked steps with a fault planted (the
runner's ``FAULTS``; ``sound``: no fault), through the whole
run at a one-second window.
``--crf``: ``crf_target.step1`` alone, from the program's first step with
the fault planted (``sound``: none): the share of the CRF's answer that
differs from the reference's on the same frames and masks.
One JSON line a reading.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CONTROL = {"float32": "bf16", "bfloat16": "fp8"}


def control_numbers(wl: dict, cfg: dict, seed: int, device: str = "cuda") -> dict:
    import torch

    from harness import compare, spec, weights

    runner = spec.module("runners", wl["runner"])
    ref = spec.module("reference", cfg["reference"])
    dev = torch.device(device)
    stage = spec.stage(wl["config"], wl["stage"])
    kw, train = stage["model_kwargs"], stage["train"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pspec, bspec = ref.specs(kw)
    params, buffers = weights.make(pspec, bspec, seed, dev)
    feed = spec.module("feeds", wl["traffic"]["feed"]).make(wl, cfg, stage, seed, dev)
    batches = [feed.to_device(feed.next_host()) for _ in range(runner.CHECKED_STEPS)]
    feed.close()
    ema = [n for n, _, _ in bspec if "_ema." in n and not n.endswith(("running_mean", "running_var"))]
    exact = runner.reference_readings(ref, kw, train, params, buffers, batches, seed, ema)
    low = runner.reference_readings(ref, kw, train, params, buffers, batches, seed, ema,
                                    precision=CONTROL[cfg["compute_dtype"]])
    return compare.training_numbers(low, exact)


def crf_numbers(wl: dict, cfg: dict, seed: int, fault: str | None, device: str = "cuda") -> dict:
    """``crf_target.step1`` of the program's first step (``fault`` planted)."""
    import gc

    import torch

    from harness import spec
    from rcf_tpu_torch.train.state import create_train_state

    runner = spec.module("runners", wl["runner"])
    dev = torch.device(device)
    stage = spec.stage(wl["config"], wl["stage"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32_convolutions"])
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, _, _, model, step, caught = runner.build(cfg, stage, seed, dev, fault)
    feed = spec.module("feeds", wl["traffic"]["feed"]).make(wl, cfg, stage, seed, dev)
    state = create_train_state(dict(stage["train"], model_kwargs=stage["model_kwargs"]), model,
                               feed.steps_per_epoch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ref.step_seed(seed, 0))
    step(state, feed.to_device(feed.next_host()), generator=gen)
    feed.close()
    del state, model, step, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    answer = runner.crf_answer(ref, caught[0], stage["model_kwargs"].get("crf_head") or {}, dev)
    return {"crf_target.step1": float((caught[0][2] - answer).abs().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--crf", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    from harness import spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    wl, cfg = spec.workload(args.workload), spec.config(cell["config"])
    runner = spec.module("runners", wl["runner"])

    def emit(seed, reading, numbers):
        print(json.dumps({"workload": args.workload, "seed": seed, "reading": reading, "numbers": numbers}),
              flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control:
            emit(seed, "control", control_numbers(wl, cfg, seed))
        for fault in filter(None, args.faults.split(",")):
            result = runner.run(bench, cell, wl, cfg, seed, 1.0, False, fault=None if fault == "sound" else fault)
            emit(seed, fault, result["readings"])
        for fault in filter(None, args.crf.split(",")):
            emit(seed, fault, crf_numbers(wl, cfg, seed, None if fault == "sound" else fault))
    return 0


if __name__ == "__main__":
    sys.exit(main())
