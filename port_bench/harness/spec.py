"""Find a cell's files by the names in ``BENCHMARK.json``.

* ``port_bench/workloads/<cell>.json``: the cell's configuration and recipe
  stage, the runner that drives it, its traffic (the feed by name, batch,
  warm-up and traced steps, data parameters), its faults and the limits of
  its output check;
* ``port_bench/configs/<config>.json``: what the configuration's stages
  share (compute dtype, TF32, global batch) and the plain reference by name;
  ``port_bench/configs/<config>/<stage>.json`` one recipe stage as it is run
  (the model class and its settings, the optimizer's);
* ``port_bench/runners/<name>.py``: how a kind of cell runs, a
  ``run(bench, cell, wl, cfg, seed, seconds, trace, ...) -> result``;
* ``port_bench/feeds/<name>.py``: where a cell's batches come from, a
  ``make(wl, cfg, stage, seed, dev) -> feed``;
* ``port_bench/reference/<name>.py``: a configuration's plain reference;
* ``port_bench/metrics/<metric>.py``: one per-layer metric's reader, a
  ``read(ctx) -> float | None``, and the end-to-end metric it ``MOVES``.

Adding a cell, a stage, a configuration, a runner, a feed, a reference or a
metric adds files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KINDS = ("runners", "feeds", "reference", "metrics")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def workload(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "workloads", f"{_checked(name)}.json"))


def config(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", f"{_checked(name)}.json"))


def stage(config_name: str, stage_name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", _checked(config_name), f"{_checked(stage_name)}.json"))


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


_LOADED: dict = {}


def module(kind: str, name: str):
    """The module of ``port_bench/<kind>/<name>.py`` (kind one of ``KINDS``), loaded once."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; known: {KINDS}")
    if (kind, name) not in _LOADED:
        path = os.path.join(BENCH_DIR, kind, f"{_checked(name)}.py")
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_')}", path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _LOADED[kind, name] = loaded
    return _LOADED[kind, name]


def metric_reader(name: str):
    """The module of ``port_bench/metrics/<name>.py`` (its ``read`` and ``MOVES``)."""
    return module("metrics", name)


def metrics_of(bench: dict, kind: str, cell_name: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]
