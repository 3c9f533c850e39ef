"""The port stands alone: no JAX, no rcf_tpu, no yaml/cv2/PIL; no silent CPU fallback.

The machine with the card has torch and numpy but none of the JAX
package's dependencies, so every module of ``rcf_tpu_torch``, ``chip_smoke``
and the card tests (with their input sets, ``kernel_sets``) must import
with those blocked.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "cv2", "PIL", "rcf_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Blocker())

    import rcf_tpu_torch
    sys.path.insert(0, "tests")  # the card tests and their input sets
    names = ["chip_smoke", "kernel_sets", "test_torch_crf_card", "test_torch_warp_card",
             "test_torch_dino_attention", "test_torch_dino_linear"] + [m.name for m in pkgutil.walk_packages(
        rcf_tpu_torch.__path__, "rcf_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax_and_its_dependencies():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 60  # every module of the package was imported


_CODEC = _IMPORT_ALL.split("import rcf_tpu_torch")[0] + textwrap.dedent("""
    import numpy as np
    from rcf_tpu_torch.data import image_io

    y, x = np.mgrid[0:37, 0:53]
    img = np.stack([x * 4, y * 6, (x + y) * 2], -1).astype(np.uint8)  # smooth ramps
    assert np.array_equal(image_io.decode_png(image_io.encode_png(img)), img)
    back = image_io.decode_jpeg(image_io.encode_jpeg(img, quality=95))
    assert back.shape == img.shape and np.abs(back.astype(int) - img).mean() < 2
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("codec ok")
""")


def test_codec_builds_and_decodes_without_pil_or_cv2():
    """The image codec (host C++, built at first use) writes and reads a PNG
    and a JPEG with yaml, cv2, PIL and JAX blocked."""
    proc = subprocess.run([sys.executable, "-c", _CODEC], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"


STAGE2_TOOLS = ("grouping.maa", "grouping.semantic_constraints", "eval.crf_pp", "eval.davis",
                "eval.stv2_fbms")

_HELP = _IMPORT_ALL.split("import rcf_tpu_torch")[0] + textwrap.dedent("""
    import contextlib, io, runpy

    for name in TOOLS:
        sys.argv = [name, "--help"]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_module("rcf_tpu_torch." + name, run_name="__main__")
        except SystemExit as exc:
            assert exc.code == 0, (name, exc.code)
        assert out.getvalue().startswith("usage:"), (name, out.getvalue()[:200])
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("help ok")
""")


def test_stage2_tools_answer_help_without_jax_yaml_cv2_or_pil():
    """``python -m rcf_tpu_torch.<tool> --help`` of the five stage-2 entry points
    with jax, yaml, cv2 and PIL blocked."""
    script = f"TOOLS = {STAGE2_TOOLS!r}\n" + _HELP
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"


def test_entry_points_need_a_card_unless_given_cpu(monkeypatch):
    from rcf_tpu_torch.models.amd import build_amd_model

    kwargs = {
        "mask_layer": 5, "flow_size": (64, 64),
        "backbone2": {"depth": 18, "strides": [1, 2, 1, 1], "dilations": [1, 1, 1, 2]},
        "decode_head2": {"in_index": 3, "channels": 8, "num_convs": 1, "num_classes": 5,
                         "concat_input": False},
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_amd_model(kwargs)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_amd_model(kwargs, device="cuda")
    model = build_amd_model(kwargs, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


_PARALLEL = _IMPORT_ALL.split("import rcf_tpu_torch")[0] + textwrap.dedent("""
    import os
    import torch
    from rcf_tpu_torch import parallel
    from rcf_tpu_torch.parallel import dist

    assert (dist.world(), dist.rank(), dist.is_main()) == (1, 0, True)
    t = torch.ones(3)
    dist.all_reduce_mean_([t])            # world 1: no collective, the tensor as it was
    assert torch.equal(t, torch.ones(3)) and dist.gather_rows(t, 3) is t
    parallel.check_mesh_shape([-1]) or parallel.check_mesh_shape([1])
    os.environ.update(RCF_DIST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    torch.cuda.is_available = lambda: False
    try:
        parallel.init_distributed()       # the card by default: no fallback to gloo or the CPU
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("init_distributed ran without a card")
    assert not torch.distributed.is_initialized()
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("parallel ok")
""")


def test_parallel_imports_without_jax_and_refuses_a_missing_card():
    """``rcf_tpu_torch.parallel`` with jax, the JAX package, yaml, cv2 and PIL
    blocked: one process is a world of 1 that issues no collective, and
    ``init_distributed`` on the card (its default) raises without one."""
    proc = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"
