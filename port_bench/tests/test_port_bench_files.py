"""BENCHMARK.json and the files it names: each found by name, each within the
benchmark's contract (names, units, keys, lengths), and no module of the
benchmark importing the JAX side or what the card's machine lacks."""

from __future__ import annotations

import ast
import json
import os
import re
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness import spec  # noqa: E402

BENCH = spec.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
LINE = re.compile(r"^[^\n\t]{1,200}$")
BANNED = {"jax", "jaxlib", "flax", "rcf_tpu", "yaml", "cv2", "PIL"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"port_bench/configs/{name}.json"
    cfg = spec.config(name)
    assert cfg["name"] == name and cfg["compute_dtype"] in ("float32", "bfloat16")
    assert entry["reduced"] == cfg["reduced"] and len(entry["reduced"]) <= 16
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert any(w["config"] == name for w in BENCH["workloads"])
    ref = spec.module("reference", cfg["reference"])
    for fn in ("specs", "step_seed", "step_flops", "crf_refine"):
        assert callable(getattr(ref, fn))
    for f in os.listdir(os.path.join(BENCH_DIR, "configs", name)):
        stage = spec.stage(name, f[:-len(".json")])
        assert {"recipe", "model_cls", "model_kwargs", "train"} <= set(stage)


@pytest.mark.parametrize("name", CELLS)
def test_workload_loads_by_name(name):
    entry = spec.cell(BENCH, name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    wl = spec.workload(name)
    assert wl["config"] == entry["config"] and wl["why"] == entry["why"]
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and LINE.match(entry["why"])
    spec.stage(wl["config"], wl["stage"])
    runner = spec.module("runners", wl["runner"])
    feeds = spec.module("feeds", wl["traffic"]["feed"])
    assert callable(runner.run) and callable(feeds.make)
    assert set(wl["faults"]) <= set(runner.FAULTS)
    for key in ("grad.median_leaf", "change.median_leaf"):
        assert key in wl["limits"]
    assert any(k.startswith("loss.") for k in wl["limits"])
    assert set(wl["faults"]) >= {"state_unchanged", "half_batch"}


def test_every_file_is_found_by_name():
    """Each workload file is a cell of BENCHMARK.json, each metric file one of its
    per-layer metrics, each stage directory a configuration's; every runner, feed
    and reference loads."""
    names = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(BENCH_DIR, "workloads")))
    assert names == sorted(CELLS)
    metrics = sorted(f[:-len(".py")] for f in os.listdir(os.path.join(BENCH_DIR, "metrics")) if f.endswith(".py"))
    assert metrics == sorted(PER_LAYER)
    dirs = [d for d in os.listdir(os.path.join(BENCH_DIR, "configs"))
            if os.path.isdir(os.path.join(BENCH_DIR, "configs", d))]
    assert sorted(dirs) == sorted(CONFIGS)
    for kind in ("runners", "feeds", "reference"):
        for f in os.listdir(os.path.join(BENCH_DIR, kind)):
            if f.endswith(".py"):
                spec.module(kind, f[:-len(".py")])


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_loads_by_name(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    module = spec.metric_reader(name)
    assert module.MOVES == entry["moves"]
    assert callable(module.read)
    assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert all(c in CELLS for c in entry.get("workloads", CELLS))
    assert LINE.match(entry["layer"])


def test_names_units_and_rules():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + CELLS + CONFIGS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in CELLS:
        assert spec.metrics_of(BENCH, "per_layer", cell), cell
        assert len(spec.metrics_of(BENCH, "end_to_end", cell)) >= 2


def _py_files():
    for base, _, files in os.walk(BENCH_DIR):
        if "cache" in base.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_module_imports_the_jax_side(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    top = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not top & BANNED, (path, top & BANNED)


def test_banned_check_compares_whole_top_level_names():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["rcf_tpu_torch_lookalike"] = sys
        assert "rcf_tpu" not in run.banned_modules()
        sys.modules["rcf_tpu.sub"] = sys
        assert run.banned_modules() == ["rcf_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
