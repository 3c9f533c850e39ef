"""Profiler traces of the traced steps, reduced to what the metrics read.

Two passes over the same number of steady steps (``harness/core.py::traced``):

* the device pass, ``torch.profiler`` with the CUDA activity alone, so that
  the profiler adds no host time per operator: its device work (kernels,
  copies, fills) gives the busy time (the union of device intervals over
  all streams), the traced window (from the pass's first event to its last
  device event), the kernels that the per-layer metrics group and count,
  and the top device operations;
* the labelled pass, CPU and CUDA activities with the harness's own
  ``bench.*`` spans: only the longest idle gaps of ``breakdown``, each
  labelled by the span and the innermost host operator around it.

The grouping by kernel name is a copy of
``tools/profile_torch_amd_step.py::_group`` (``GEMM``, ``CRF``), with the
NCCL kernels as a group of their own.
"""

from __future__ import annotations

import json
import re

CRF = "crf_filter_kernel"
NCCL = "nccl"
# Convolution and matmul kernels by name ("conv" but not "convert"; nvjet is
# cuBLAS's Hopper matmul).
GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|wgrad|dgrad|fprop|winograd|conv(?!ert)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def group(kernel_name: str) -> str:
    name = kernel_name.lower()
    if CRF in name:
        return "crf_filter"
    if NCCL in name:
        return "nccl"
    return "gemm_conv" if GEMM.search(name) else "other"


def load(path: str) -> dict:
    """The trace's device events, harness spans and host events (times in us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        row = {"name": e.get("name", ""), "ts": float(e["ts"]), "dur": float(e["dur"]), "cat": cat}
        if cat in DEVICE_CATS:
            device.append(row)
        elif cat == "user_annotation" and row["name"].startswith("bench."):
            spans.append(row)
        elif cat in HOST_CATS:
            host.append(row)
    return {"device": device, "spans": spans, "host": host}


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _window(tr: dict) -> tuple[float, float]:
    """The ``bench.window`` span where the pass has one, else its first event;
    to the last device event where that ends later."""
    win = [s for s in tr["spans"] if s["name"] == "bench.window"]
    if win:
        t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        every = tr["device"] + tr["host"]
        if not every:
            raise RuntimeError("the trace holds no event")
        t0 = min(e["ts"] for e in every)
        t1 = max(e["ts"] + e["dur"] for e in every)
    t1 = max([t1] + [e["ts"] + e["dur"] for e in tr["device"] if e["ts"] >= t0])
    return t0, t1


def _busy(tr: dict, t0: float, t1: float) -> list[tuple[float, float]]:
    return union([(e["ts"], e["ts"] + e["dur"]) for e in tr["device"] if t0 <= e["ts"] <= t1])


def reduce(tr: dict) -> dict:
    """The device pass: busy and window seconds, kernels and the top device operations."""
    t0, t1 = _window(tr)
    dev = [e for e in tr["device"] if t0 <= e["ts"] <= t1]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in _busy(tr, t0, t1)) * 1e-6,
        "kernels": [e for e in dev if e["cat"] == "kernel"],
        "top_ops": sorted(([n, d * 1e-6] for n, d in by_name.items()), key=lambda r: -r[1])[:10],
    }


def idle_gaps(tr: dict, n: int = 10) -> list:
    """The labelled pass: the ``n`` longest gaps with no device work, as [label, seconds]."""
    t0, t1 = _window(tr)
    gaps, prev = [], t0
    for a, b in _busy(tr, t0, t1) + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    return [[_host_label(tr, (a + b) / 2), (b - a) * 1e-6] for a, b in longest]


def _host_label(tr: dict, t: float) -> str:
    """The harness span around ``t`` and the innermost host operator there."""
    span = [s for s in tr["spans"] if s["ts"] <= t <= s["ts"] + s["dur"] and s["name"] != "bench.window"]
    ops = [h for h in tr["host"] if h["ts"] <= t <= h["ts"] + h["dur"]]
    inner = min(ops, key=lambda h: h["dur"])["name"] if ops else "no host op"
    outer = span[0]["name"] if span else "bench.window"
    return f"{outer} / {inner}"


def kernel_ms(kernels: list[dict], groups: tuple[str, ...]) -> float:
    return sum(k["dur"] for k in kernels if group(k["name"]) in groups) * 1e-3
