"""Device time of the program's named spans (``rcf.*``) in a profiler trace.

A kernel, copy or fill belongs to every span whose interval, on any thread,
holds the runtime call that launched it (the same ``correlation`` id), so
that launches from the autograd engine's thread fall in the span that ran
the backward. The labelled pass of ``core.traced`` (CPU and CUDA
activities) is such a trace; ``captured()`` keeps it, which ``core.traced``
otherwise reduces and deletes. ``tools/span_breakdown.py`` reads its traces
with these functions.
"""

from __future__ import annotations

import contextlib
import json

from . import trace as harness_trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function") + RUNTIME_CATS


def load(path: str) -> dict:
    """The trace's device events, ``bench.*`` spans and host events as
    ``harness/trace.py::load`` keeps them (``rcf.*`` spans among the host
    events there), and besides: the ``rcf.*`` spans, each device event's and
    runtime call's ``correlation`` and each host event's thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tr: dict = {"device": [], "spans": [], "host": [], "rcf": [], "launch": {}}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        row = {"name": name, "ts": float(e["ts"]), "dur": float(e["dur"]), "cat": cat,
               "tid": e.get("tid"), "correlation": (e.get("args") or {}).get("correlation")}
        if cat in DEVICE_CATS:
            tr["device"].append(row)
        elif cat == "user_annotation" and name.startswith("bench."):
            tr["spans"].append(row)
        elif cat in HOST_CATS:
            tr["host"].append(row)
            if cat == "user_annotation" and name.startswith("rcf."):
                tr["rcf"].append(row)
            if cat in RUNTIME_CATS and row["correlation"] is not None:
                tr["launch"][row["correlation"]] = row
    return tr


def holds(span: dict, t: float) -> bool:
    return span["ts"] <= t <= span["ts"] + span["dur"]


def owned(tr: dict):
    """Each device event with the names of the spans that hold the runtime call
    that launched it (none where the trace has no such call)."""
    spans = tr["rcf"] + tr["spans"]
    for d in tr["device"]:
        call = tr["launch"].get(d["correlation"])
        yield d, ({s["name"] for s in spans if holds(s, call["ts"])} if call else set())


def span_ms(tr: dict) -> dict:
    """Inclusive device ms of each ``rcf.*`` and ``bench.*`` span name over the
    trace: each device event counted once in every span (of any thread) whose
    interval holds the runtime call that launched it; a device event with no
    runtime call in the trace counts in none."""
    out = {s["name"]: 0.0 for s in tr["rcf"] + tr["spans"]}
    for d, names in owned(tr):
        for name in names:
            out[name] += d["dur"] * 1e-3
    return out


@contextlib.contextmanager
def captured():
    """Inside the block, ``core.traced``'s passes are kept: yields a dict that
    gets the labelled pass's ``trace`` (this module's ``load``) and the device
    pass's ``kernels`` (``harness/trace.py::reduce``)."""
    got: dict = {}
    load0, reduce0 = harness_trace.load, harness_trace.reduce

    def load_both(path):
        if path.endswith("_1.json"):
            got["trace"] = load(path)
        return load0(path)

    def reduce_kept(tr):
        out = reduce0(tr)
        got["kernels"] = out["kernels"]
        return out

    harness_trace.load, harness_trace.reduce = load_both, reduce_kept
    try:
        yield got
    finally:
        harness_trace.load, harness_trace.reduce = load0, reduce0
