"""A whole run of each cell at a tiny size on the CPU, without the look for a
card: the result line's keys, the plain reference against ``rcf_tpu_torch``,
the control and the planted faults against the cells' limits, and a run with
the JAX side and what the card's machine lacks blocked from import."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, ROOT, TESTS_DIR]

from harness import spec  # noqa: E402
from port_bench_tiny import tiny_stage, tiny_workload  # noqa: E402

BENCH = spec.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 17   # wider than 32 signed bits, as the driver's seeds are
FULL_STAGE = spec.stage


@pytest.fixture
def tiny(monkeypatch):
    """Every stage file at its tiny size."""
    monkeypatch.setattr(spec, "stage", lambda config, stage: tiny_stage(FULL_STAGE(config, stage)))


def _tiny(name: str, dtype: str = "float32"):
    cell = spec.cell(BENCH, name)
    cfg = dict(spec.config(cell["config"]), compute_dtype=dtype)
    return cell, tiny_workload(spec.workload(name)), cfg


def _run(name: str, tmp_path, trace: bool = False, fault: str | None = None, seed: int = SEED) -> dict:
    import torch

    torch.set_num_threads(2)
    cell, wl, cfg = _tiny(name)
    runner = spec.module("runners", wl["runner"])
    return runner.run(BENCH, cell, wl, cfg, seed, 0.3, trace, device="cpu", fault=fault,
                      trace_dir=str(tmp_path))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_keys(tmp_path, tiny, trace):
    name = "rcf_stv2_bf16.stage2_1_step"
    result = _run(name, tmp_path, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(result) == keys + ["readings", "checks"]
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in spec.metrics_of(BENCH, kind, name)}
    assert set(result["metrics"]) <= set(allowed)
    if not trace:
        assert set(result["metrics"]) == set(allowed)
    for metric, row in result["metrics"].items():
        assert set(row) == {"value", "unit"} and row["unit"] == allowed[metric]
        assert spec.NAME.match(metric) and spec.UNIT.match(row["unit"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in result["breakdown"].values())
        # The program's counter over the device pass's steps alone.
        assert result["metrics"]["ops_crf.meanfield_iters_per_step"]["value"] == 5
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(tmp_path, tiny, name):
    """Float32 at a tiny size on the CPU: the reference and the port take the
    same three steps to rounding."""
    got = _run(name, tmp_path)["readings"]
    for k in ("loss.step1", "loss.step2", "loss.step3"):
        assert got[k] < 3e-5, (k, got[k])
    # The network at its initial weights amplifies a rounding difference with depth.
    assert got["logits.step1"] < 3e-4
    # A batch norm whose channel is nearly constant over a tiny batch divides by
    # sqrt(eps): there the order of a sum moves the gradient by up to a few 1e-3.
    assert got["grad.median_leaf"] < 1e-3 and got["grad.worst_leaf"] < 0.05
    # Adam moves a weight by about lr whatever its gradient's size, so an element whose
    # gradient is near nought takes either sign on rounding: this gap is wide at a tiny size.
    assert got["change.worst_leaf"] < 0.5
    if "crf_target.step1" in got:
        assert got["crf_target.step1"] < 1e-3


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in spec.workload(c)["faults"]])
def test_a_broken_step_is_not_correct(tmp_path, tiny, name, fault):
    """Each fault the cell can have, planted under a whole run, against the cell's limits."""
    result = _run(name, tmp_path, fault=fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(tiny, name):
    """The reference in the precision below the configuration's, against the
    reference, fails one of the cell's numbers at their limits."""
    import calibrate
    import torch

    torch.set_num_threads(2)
    cell, wl, cfg = _tiny(name, dtype=spec.config(spec.cell(BENCH, name)["config"])["compute_dtype"])
    numbers = calibrate.control_numbers(wl, cfg, SEED, "cpu")
    assert any(v > wl["limits"][k] for k, v in numbers.items() if k in wl["limits"]), numbers


@pytest.mark.parametrize("fault", ["sound", "crf_iters_fifth"])
def test_crf_reading_of_one_step(tiny, fault):
    """``calibrate.py --crf``: the first step's CRF answer against the reference's."""
    import calibrate
    import torch

    torch.set_num_threads(2)
    cell, wl, cfg = _tiny("rcf_stv2_bf16.stage2_1_step")
    got = calibrate.crf_numbers(wl, cfg, SEED, None if fault == "sound" else fault, "cpu")
    assert (got["crf_target.step1"] < 1e-3) == (fault == "sound"), got


def _mean_field_case(seed: int, h: int = 12, w: int = 10):
    import torch

    g = torch.Generator().manual_seed(seed)
    colours = torch.randint(0, 256, (2, 3), generator=g)
    rgb = colours[(torch.arange(w)[None, :] >= w // 2).long().expand(h, w)]
    rgb = torch.clamp(rgb + torch.randint(-6, 7, (h, w, 3), generator=g), 0, 255).to(torch.uint8)
    mask = torch.clamp(0.5 + 0.35 * torch.randn(h, w, generator=g), 0.0, 1.0)
    return rgb, mask


@pytest.mark.parametrize("params", [
    {"refine_iters": 50},
    {"refine_iters": 50, "stable_exit": True},
    {"refine_iters": 7, "scomp_smooth": 3.0, "sxy_smooth": 2.0},
], ids=["fixed", "stable_exit", "smooth"])
def test_reference_mean_field_matches_the_port(params):
    """The reference's mean field against ``rcf_tpu_torch.ops.crf.mean_field`` on the
    CPU: the same MAP and, with ``stable_exit``, the same iterations."""
    import torch

    from rcf_tpu_torch.ops import crf as port

    ref = spec.module("reference", "rcf_plain")
    head = dict(params, sxy=6.0)
    for seed in range(3):
        rgb, mask = _mean_field_case(seed)
        want, ran = ref.crf_map(rgb, mask, head, (1.0, 1.0))
        q1, iters = port.mean_field(rgb[None], mask[None], port.CRFParams(**head))
        np.testing.assert_array_equal((q1[0] > 0.5).float().numpy(), want.numpy())
        assert int(iters[0]) == ran
        if not params.get("stable_exit"):
            assert ran == params["refine_iters"]


def test_a_run_loads_no_jax_side(tmp_path):
    """The whole tiny run with jax, jaxlib, flax, rcf_tpu, yaml, cv2 and PIL blocked."""
    script = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {{"jax", "jaxlib", "flax", "rcf_tpu", "yaml", "cv2", "PIL"}}:
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}, {TESTS_DIR!r}]
        import torch
        torch.set_num_threads(2)
        import run
        from harness import spec
        from port_bench_tiny import tiny_stage, tiny_workload
        full = spec.stage
        spec.stage = lambda config, stage: tiny_stage(full(config, stage))
        bench = spec.benchmark({ROOT!r})
        name = "rcf_stv2_bf16.stage2_1_step"  # the CRF's path imports the most
        cell = spec.cell(bench, name)
        wl = tiny_workload(spec.workload(name))
        cfg = dict(spec.config(cell["config"]), compute_dtype="float32")
        spec.module("runners", wl["runner"]).run(bench, cell, wl, cfg, 5, 0.2, True, device="cpu",
                                                 trace_dir={str(tmp_path)!r})
        assert run.banned_modules() == [], run.banned_modules()
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-3000:]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    """One short run of the cheapest cell at its own size (needs an NVIDIA GPU)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name = "rcf_stv2_bf16.stage1_step"
    cell = spec.cell(BENCH, name)
    wl = spec.workload(name)
    result = spec.module("runners", wl["runner"]).run(BENCH, cell, wl, spec.config(cell["config"]), SEED,
                                                      2.0, False, trace_dir=str(tmp_path))
    assert result["correct"], result["checks"]
