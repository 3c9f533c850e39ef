#!/usr/bin/env python3
"""Device time of the port's named spans (``rcf.*``, ``rcf_tpu_torch/train/metrics.py``)
in a ``torch.profiler`` trace, and the idle gaps labelled by them.

    python3 tools/span_breakdown.py --trace <chrome_trace.json> [--steps N]
    python3 tools/span_breakdown.py --workload <cell> --seed <n> [--seconds S]
    python3 tools/span_breakdown.py --cost

``--trace`` reads a Chrome trace taken with the CPU and CUDA activities
(``tpu.profile_dir``'s ``StepProfiler`` writes one); ``--steps`` defaults to
the number of ``rcf.step`` spans in it. ``--workload`` runs one cell of
``port_bench`` as ``port_bench/run.py --trace 1`` does (its result line
first) and reads the traced run's labelled pass (CPU and CUDA activities,
the harness's ``bench.*`` spans), and its device pass for ``crf_filter``'s
time. Needs a CUDA device for ``--workload``; imports no JAX. ``--cost``
times one span's enter and exit, less an empty ``with``, with no profiler
running and under a CPU-activity profiler, on the host it runs on.

A kernel, copy or fill belongs to every span whose interval, on any
thread, holds the runtime call that launched it (the same ``correlation``
id), so that the backward's launches from the autograd engine's thread
fall in ``rcf.step.backward``. Spans in the loader's threads
(``rcf.data.*``) are host spans: device work that another thread launches
meanwhile falls in them too. An idle gap is labelled
``bench.step / <innermost rcf span> / <innermost host operator>`` (``label``).

Prints one JSON line: the device ms a step of each span (``span_ms``), and
of each ``rcf`` span by kernel group (``span_group_ms``); the share of
``bench.step``'s device time (or, in a trace without it, ``rcf.step``'s)
that ``rcf.step``'s children cover (``coverage``); the calls that make the
host wait for the card, a step, by label (``host_syncs``); the longest idle
gaps with their labels; and in ``--workload`` mode the labelled pass's wall ms
a step and ``crf_filter``'s device ms a step in the device pass.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "port_bench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

# The trace's reading and the spans' device time are the benchmark's own.
from harness.spans import captured, load, span_ms  # noqa: E402,F401
from harness.spans import holds as _holds, owned as _owned  # noqa: E402

SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")
STEP_CHILDREN = ("rcf.step.crf_target", "rcf.step.forward", "rcf.step.backward",
                 "rcf.step.update")


def span_group_ms(tr: dict) -> dict:
    """``span_ms`` of each ``rcf.*`` span split by kernel group
    (``port_bench/harness/trace.py::group``; copies and fills as ``copy``)."""
    from harness import trace as harness_trace

    out: dict = {}
    for d, names in _owned(tr):
        group = harness_trace.group(d["name"]) if d["cat"] == "kernel" else "copy"
        for name in names:
            if name.startswith("rcf."):
                row = out.setdefault(name, {})
                row[group] = row.get(group, 0.0) + d["dur"] * 1e-3
    return out


def label(tr: dict, t: float) -> str:
    """``<bench span> / <innermost rcf span> / <innermost host operator>`` at ``t``:
    ``bench.window`` outside every other harness span, no ``rcf`` part outside
    every ``rcf`` span, ``no host op`` where no operator holds ``t``. Where
    ``t`` falls between the innermost span's children, its part reads
    ``<span> after <the child that ended last>``."""
    spans = [s["name"] for s in tr["spans"] if _holds(s, t) and s["name"] != "bench.window"]
    parts = [spans[0] if spans else "bench.window"]
    rcf = [s for s in tr["rcf"] if _holds(s, t)]
    if rcf:
        inner = min(rcf, key=lambda s: s["dur"])
        done = [s for s in tr["rcf"] if s["tid"] == inner["tid"] and s["ts"] >= inner["ts"]
                and s is not inner and s["ts"] + s["dur"] < t]
        after = max(done, key=lambda s: s["ts"] + s["dur"]) if done else None
        parts.append(inner["name"] + (f" after {after['name']}" if after else ""))
    ops = [h for h in tr["host"] if _holds(h, t) and not h["name"].startswith("rcf.")]
    parts.append(min(ops, key=lambda h: h["dur"])["name"] if ops else "no host op")
    return " / ".join(parts)


def idle_gaps(tr: dict, n: int = 10) -> list:
    """The ``n`` longest gaps with no device work in the traced window, as
    [label, seconds] (``port_bench/harness/trace.py``'s window and gaps)."""
    from harness import trace as harness_trace

    t0, t1 = harness_trace._window(tr)
    gaps, prev = [], t0
    for a, b in harness_trace._busy(tr, t0, t1) + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    return [[label(tr, (a + b) / 2), (b - a) * 1e-6] for a, b in longest]


def host_syncs(tr: dict) -> dict:
    """The calls that make the host wait for the card (``SYNC_CALLS``), counted
    by their ``label``."""
    out: dict = {}
    for h in tr["host"]:
        if h["name"] in SYNC_CALLS:
            key = label(tr, h["ts"] + h["dur"] / 2)
            out[key] = out.get(key, 0) + 1
    return out


def breakdown(tr: dict, steps: int) -> dict:
    ms = span_ms(tr)
    whole = ms.get("bench.step", ms.get("rcf.step", 0.0))
    children = sum(ms.get(name, 0.0) for name in STEP_CHILDREN)
    return {"steps": steps,
            "span_ms": {k: v / steps for k, v in sorted(ms.items())},
            "span_group_ms": {k: {g: v / steps for g, v in sorted(row.items())}
                              for k, row in sorted(span_group_ms(tr).items())},
            "coverage": children / whole if whole > 0 else None,
            "host_syncs": {k: v / steps for k, v in sorted(host_syncs(tr).items())},
            "idle_gaps": idle_gaps(tr)}


def cell_breakdown(got: dict, steps: int) -> dict:
    """``breakdown`` of a cell's labelled pass, with its wall ms a step and the
    device pass's ``crf_filter`` ms a step."""
    from harness import trace as harness_trace

    tr = got["trace"]
    out = breakdown(tr, steps)
    win = [s for s in tr["spans"] if s["name"] == "bench.window"]
    out["labelled_wall_ms_per_step"] = win[0]["dur"] * 1e-3 / steps if win else None
    out["crf_filter_ms_per_step"] = harness_trace.kernel_ms(got["kernels"], ("crf_filter",)) / steps
    return out


def span_cost_us(n: int = 200_000) -> dict:
    """Host us of one ``record_function`` enter and exit over that of an empty
    ``nullcontext``: with no profiler running (``n`` calls), and under a
    profiler with the CPU activity (``n / 10`` calls)."""
    import time

    import torch

    def per_call(make, calls: int) -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            with make():
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    def span():
        return torch.profiler.record_function("rcf.step")

    off = per_call(span, n) - per_call(contextlib.nullcontext, n)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = per_call(span, n // 10) - per_call(contextlib.nullcontext, n // 10)
    return {"span_us_off": off, "span_us_on": on, "calls": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace")
    src.add_argument("--workload")
    src.add_argument("--cost", action="store_true")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    if args.cost:
        print(json.dumps(span_cost_us()))
        return 0
    if args.trace:
        tr = load(args.trace)
        steps = args.steps or sum(s["name"] == "rcf.step" for s in tr["rcf"]) or 1
        print(json.dumps(breakdown(tr, steps)))
        return 0
    import run as bench_run
    from harness import spec

    with captured() as got:
        rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                             "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    steps = int(spec.workload(args.workload)["trace_steps"])
    print(json.dumps(dict(cell_breakdown(got, steps), workload=args.workload)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
