"""What every runner shares: the measured window, the traced steps, the
metrics by name and the result line.

The window runs steps for ``--seconds`` of the host clock and ends with
``torch.cuda.synchronize()``; a CUDA event recorded after each step gives
the gaps between step completions, read after the window, so that no step
is synchronised. With ``--trace 1`` the window runs as well, then
``traced`` runs its two profiler passes (``harness/trace.py``).
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from . import compare, spec, trace as tracing


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def to(tensors: dict, device) -> dict:
    return {k: (v.to(device) if hasattr(v, "to") else v) for k, v in tensors.items()}


def percentile(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def window(next_batch, run_step, seconds: float, cuda: bool) -> dict:
    """Steps for ``seconds``: ``next_batch() -> batch``, ``run_step(batch) -> loss``.
    Returns the steps, the window's seconds, the gaps between step completions
    (ms), the non-finite losses and the window's memory peak (bytes)."""
    import torch

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    events, losses = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(run_step(next_batch()))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    gaps = ([start.elapsed_time(events[0])] + [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            if events else [])
    return {"steps": len(losses), "seconds": window_s, "gaps_ms": gaps,
            "failed": int(sum(not math.isfinite(float(v)) for v in losses)),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def traced(next_batch, run_step, steps: int, cuda: bool, trace_dir: str, name: str,
           after_device_pass=None) -> dict:
    """The device pass (CUDA activity alone) and the labelled pass (CPU and CUDA,
    with the harness's spans), ``steps`` steps each; ``after_device_pass()`` is
    called between them (to read the program's counters over the device pass).
    Returns the device pass's reduction (``trace.reduce``) with the labelled
    pass's ``idle_gaps``."""
    import torch

    os.makedirs(trace_dir, exist_ok=True)
    acts = torch.profiler.ProfilerActivity
    out = {}
    for labelled in (False, True):
        activities = ([acts.CPU] if labelled or not cuda else []) + ([acts.CUDA] if cuda else [])
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("bench.window"):
                for _ in range(steps):
                    with torch.profiler.record_function("bench.next_batch"):
                        batch = next_batch()
                    with torch.profiler.record_function("bench.step"):
                        run_step(batch)
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(trace_dir, f"port_bench_trace_{name}_{int(labelled)}.json")
        prof.export_chrome_trace(path)
        tr = tracing.load(path)
        os.remove(path)
        if labelled:
            out["idle_gaps"] = tracing.idle_gaps(tr)
        else:
            out.update(tracing.reduce(tr))
            if after_device_pass is not None:
                after_device_pass()
    return out


def end_to_end(bench: dict, cell: dict, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics_of(bench, "end_to_end", cell["name"])}


def per_layer(bench: dict, cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader; one that finds nothing is left out."""
    out = {}
    for m in spec.metrics_of(bench, "per_layer", cell["name"]):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(numbers: dict, limits: dict, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: dict | None) -> dict:
    """The result: ``correct`` from the numbers against their limits (each printed
    on standard error, last, and under the result's last key)."""
    ok, table = compare.judge(numbers, limits)
    log("readings not compared: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items() if k not in table))
    for name, row in table.items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = numbers
    result["checks"] = table
    return result
