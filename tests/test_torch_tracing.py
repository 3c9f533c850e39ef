"""The port's named spans, its counters and its per-step records, on the CPU.

* the ``rcf.*`` span names in ``rcf_tpu_torch/`` are exactly the catalogue
  of ``train/metrics.py``, and none sits in a model module;
* a profiled stage-2.1 train step (the reduced model, the DAVIS recipe's
  stable exit) gives the step's spans once a step, nested as the catalogue
  says, the mean field once a call and its flag read once a host sync;
* ``tools/span_breakdown.py`` on a hand-made Chrome trace: nested spans, a
  kernel launched from a second thread, one launched outside every
  ``rcf`` span; ``port_bench``'s own reduction reads the same trace as before;
* ``loop.run`` writes one record a step, the losses on the logged steps
  only, and ``MetricsLogger`` resolves a step's device time at its flush.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from rcf_tpu_torch.config import Config
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.ops import crf as crf_ops
from rcf_tpu_torch.parallel import dist
from rcf_tpu_torch.train import create_train_state, loop, make_train_step, maybe_crf_fn
from rcf_tpu_torch.train.metrics import DIST_SPANS, SPANS, MetricsLogger
from test_torch_rcf_stage2_1 import tiny_crf_kwargs
from test_torch_rcf_step import _batch, _train_cfg
from test_torch_train_loop import _tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "rcf_tpu_torch")
sys.path.insert(0, os.path.join(REPO, "port_bench"))

from harness import trace as harness_trace  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "span_breakdown", os.path.join(REPO, "tools", "span_breakdown.py"))
span_breakdown = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(span_breakdown)

STEP_KEYS = {"ts", "step", "epoch", "loader_wait_s", "step_host_s", "step_device_s"} | {
    f"crf_{k}" for k in crf_ops.STATS} | {f"dist_{k}" for k in dist.STATS}
# Each step span and the span it sits in (stage 2.1 with the EMA, one rank).
STEP_PARENTS = {"rcf.step.crf_target": "rcf.step", "rcf.crf_target.ema_forward":
                "rcf.step.crf_target", "rcf.crf.prepare": "rcf.step.crf_target",
                "rcf.crf.mean_field": "rcf.step.crf_target", "rcf.step.forward": "rcf.step",
                "rcf.step.backward": "rcf.step", "rcf.step.update": "rcf.step",
                "rcf.step.grad_allreduce": "rcf.step.update",
                "rcf.step.optimizer": "rcf.step.update", "rcf.step.ema_update": "rcf.step.update"}


def _sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    yield os.path.relpath(path, PACKAGE), fh.read()


# ---------------------------------------------------------------------------
# The catalogue
# ---------------------------------------------------------------------------


def test_span_names_in_the_package_are_the_catalogue():
    used, calls = set(), 0
    for rel, text in _sources():
        found = re.findall(r'record_function\(\s*"([^"]+)"', text)
        used |= set(found)
        calls += len(re.findall(r"record_function\(", text))
        assert len(re.findall(r"record_function\(", text)) == len(found), rel  # literal names
        if rel.startswith(("nn" + os.sep, "models" + os.sep)):
            assert "record_function" not in text, rel
    assert used == set(SPANS) and len(SPANS) == len(set(SPANS))
    assert all(name.startswith("rcf.") for name in SPANS)
    assert set(DIST_SPANS) <= set(SPANS) and calls >= len(SPANS)
    with open(os.path.join(PACKAGE, "train", "metrics.py")) as f:
        doc = f.read()
    # Every name but the collectives' appears in the docstring's table.
    assert all(f"``{name}``" in doc for name in SPANS if name not in DIST_SPANS)


# ---------------------------------------------------------------------------
# A profiled stage-2.1 step
# ---------------------------------------------------------------------------


def _profiled_steps(tmp_path, steps: int = 2):
    torch.manual_seed(0)
    cfg = _train_cfg(tiny_crf_kwargs("davis"))
    model = build_model(cfg["model_kwargs"], device="cpu", seed=3)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    crf_fn = maybe_crf_fn(model)
    assert crf_fn.params.stable_exit
    step = make_train_step(crf_fn=crf_fn)
    batch = dict({k: torch.from_numpy(v) for k, v in _batch(5).items()}, object_channel=0,
                 object_channel_set=True)
    crf_ops.reset_stats()
    dist.reset_stats()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(state, batch)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return span_breakdown.load(path), dict(crf_ops.STATS), dict(dist.STATS)


def _inside(a: dict, b: dict) -> bool:
    return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"] and a["tid"] == b["tid"]


def test_profiled_step_spans_nest_as_catalogued(tmp_path):
    steps = 2
    tr, crf_stats, dist_stats = _profiled_steps(tmp_path, steps)
    by_name: dict = {}
    for s in tr["rcf"]:
        by_name.setdefault(s["name"], []).append(s)
    assert len(by_name["rcf.step"]) == steps
    for name, parent in STEP_PARENTS.items():
        assert len(by_name[name]) == steps, name
        assert all(any(_inside(s, p) for p in by_name[parent]) for s in by_name[name]), name
    assert crf_stats["host_syncs"] >= 1
    assert len(by_name.get("rcf.crf.flag_read", [])) == crf_stats["host_syncs"]
    assert all(any(_inside(s, m) for m in by_name["rcf.crf.mean_field"])
               for s in by_name["rcf.crf.flag_read"])
    # One rank: no collective is issued, so no rcf.dist span and no count.
    assert not any(name.startswith("rcf.dist.") for name in by_name)
    assert set(dist_stats.values()) == {0}
    assert set(by_name) == set(STEP_PARENTS) | {"rcf.step", "rcf.crf.flag_read"}


def test_fixed_count_mean_field_is_one_span_and_no_flag_read(tmp_path):
    params = crf_ops.CRFParams(refine_iters=6)
    rgb = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8)
    masks = torch.rand(2, 8, 8)
    crf_ops.reset_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        crf_ops.mean_field(rgb, masks, params)
    names = [e.name for e in prof.events() if e.name.startswith("rcf.")]
    assert names == ["rcf.crf.mean_field"] and crf_ops.STATS["iterations"] == 6


def test_collectives_count_nothing_at_one_rank():
    dist.reset_stats()
    x = torch.ones(3)
    dist.all_reduce_mean_([x])
    dist.all_reduce_sum(x)
    dist.all_reduce_max(x)
    dist.mean_losses({"loss": x.sum()})
    dist.broadcast_([x])
    dist.gather_rows(x[None], 1)
    dist.barrier()
    assert set(dist.STATS.values()) == {0}
    assert set(dist.STATS) == {f"{kind}_{what}" for kind in ("all_reduce", "broadcast", "gather")
                               for what in ("calls", "bytes")}


# ---------------------------------------------------------------------------
# tools/span_breakdown.py on a hand-made trace
# ---------------------------------------------------------------------------


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _hand_made(path) -> None:
    """A window with one step: ``rcf.step`` holds ``forward`` (a kernel launched
    from the main thread) and ``backward`` (a kernel launched from a second
    thread, the autograd engine's); a third kernel is launched after ``rcf.step``
    inside ``bench.step`` (and a stream synchronisation), a fourth after
    ``bench.step``; a fifth has no runtime call in the trace."""
    events = [
        _x("bench.window", "user_annotation", 0, 2000),
        _x("bench.step", "user_annotation", 100, 1300),
        _x("rcf.step", "user_annotation", 110, 1000),
        _x("rcf.step.forward", "user_annotation", 120, 380),
        _x("aten::conv", "cpu_op", 130, 60),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 10, corr=1),
        _x("rcf.step.backward", "user_annotation", 500, 450),
        _x("autograd::engine", "cpu_op", 510, 480, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 520, 10, tid=2, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1200, 10, corr=3),
        _x("cudaStreamSynchronize", "cuda_runtime", 1300, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 1500, 10, corr=4),
        _x("kern_a", "kernel", 200, 50, tid=7, corr=1),
        _x("kern_b", "kernel", 600, 100, tid=7, corr=2),
        _x("kern_c", "kernel", 1250, 20, tid=7, corr=3),
        _x("kern_d", "kernel", 1550, 30, tid=7, corr=4),
        _x("kern_e", "kernel", 1700, 40, tid=7, corr=99),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_span_ms_attributes_each_launch_to_the_spans_that_hold_it(tmp_path):
    path = str(tmp_path / "hand.json")
    _hand_made(path)
    tr = span_breakdown.load(path)
    ms = span_breakdown.span_ms(tr)
    assert ms == pytest.approx({"bench.window": 0.2, "bench.step": 0.17, "rcf.step": 0.15,
                                "rcf.step.forward": 0.05, "rcf.step.backward": 0.1})
    out = span_breakdown.breakdown(tr, steps=1)
    assert out["coverage"] == pytest.approx(0.15 / 0.17)
    assert out["host_syncs"] == {"bench.step / cudaStreamSynchronize": 1.0}
    groups = {(k, g): v for k, row in out["span_group_ms"].items() for g, v in row.items()}
    assert groups == pytest.approx({("rcf.step", "other"): 0.15,
                                    ("rcf.step.forward", "other"): 0.05,
                                    ("rcf.step.backward", "other"): 0.1})
    # port_bench's own reduction reads the trace as before.
    before = harness_trace.load(path)
    old_red, new_red = harness_trace.reduce(before), harness_trace.reduce(tr)
    for key in ("window_s", "busy_s", "top_ops"):
        assert new_red[key] == old_red[key], key
    assert [(k["name"], k["ts"], k["dur"]) for k in new_red["kernels"]] == [
        (k["name"], k["ts"], k["dur"]) for k in old_red["kernels"]]
    old, new = harness_trace.idle_gaps(before), span_breakdown.idle_gaps(tr)
    assert [g[1] for g in new] == pytest.approx([g[1] for g in old])
    labels = {round(g[1] * 1e6): g[0] for g in new}
    assert labels == {550: "bench.step / rcf.step after rcf.step.backward / autograd::engine",
                      350: "bench.step / rcf.step.forward / no host op",          # 250-600
                      280: "bench.window / no host op",                           # 1270-1550
                      260: "bench.window / no host op",                           # 1740-2000
                      200: "bench.step / no host op",                             # 0-200
                      120: "bench.window / no host op"}                           # 1580-1700
    # The harness's label is the new one without its rcf part, where an
    # operator is innermost; where none is, the harness names the rcf span.
    for (old_label, _), (new_label, _) in zip(old, new):
        o, n = old_label.split(" / "), new_label.split(" / ")
        assert o[0] == n[0]
        assert o[-1] == n[-1] or (o[-1].startswith("rcf.") and n[-1] == "no host op")


# ---------------------------------------------------------------------------
# metrics.jsonl, a record a step
# ---------------------------------------------------------------------------


def test_loop_writes_one_record_a_step(davis_like, tmp_path):
    tree = _tree(davis_like, tmp_path / "ckpt")
    tree.update(global_batch_size=2, epochs=1, loss_log_interval=2)
    tree["trainer_kwargs"] = {"check_val_every_n_epoch": 0}
    state = loop.run(Config(tree), no_test=True, device="cpu")
    assert state.step == 4
    records = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    steps = [r for r in records if "step" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    for r in steps:
        losses = {k for k in r if k.startswith("train_")}
        assert set(r) - losses == STEP_KEYS
        assert ("train_loss" in losses) == (r["step"] % 2 == 0) == bool(losses)
        assert r["step_device_s"] is None   # no card
        assert r["step_host_s"] > 0 and r["loader_wait_s"] >= 0
        assert all(r[k] == 0 for k in r if k.startswith(("dist_", "crf_")))
    # The epoch's record follows its steps.
    assert "train_epoch_s" in records[records.index(steps[-1]) + 1]


class _Event:
    def __init__(self, ms: float, log: list):
        self.ms, self.log = ms, log

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms

    def synchronize(self) -> None:
        self.log.append(self.ms)


def test_metrics_logger_resolves_device_time_at_flush(tmp_path):
    synced: list = []
    log = MetricsLogger(str(tmp_path))
    log.step({"step": 1}, (_Event(0.0, synced), _Event(5.0, synced)))
    log.step({"step": 2}, (_Event(5.0, synced), _Event(12.5, synced)))
    assert not os.path.exists(log.path) and synced == []   # nothing written or waited for yet
    log.log(epoch=0, train_epoch_s=1.0)   # a record of its own flushes the steps first
    records = [json.loads(line) for line in open(log.path)]
    assert [r.get("step") for r in records] == [1, 2, None]
    assert [r.get("step_device_s") for r in records[:2]] == pytest.approx([5e-3, 7.5e-3])
    assert synced == [12.5]   # only the last step's end event is waited for
    assert np.isfinite(records[0]["ts"])
    silent = MetricsLogger(None)   # every rank but the first keeps nothing
    silent.step({"step": 1}, None)
    silent.flush()
    assert silent._steps == []
