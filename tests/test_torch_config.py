"""The port's config layer against the JAX package's (``rcf_tpu/config.py``).

The port reads YAML with its own reader (``rcf_tpu_torch/yaml_subset.py``:
the machine with the card has no ``yaml``). Every recipe under
``configs/`` must load to the tree ``rcf_tpu.config.load_tree`` gives, the
cases of ``tests/test_config.py`` must hold for both packages alike, and
constructs outside the subset must raise naming the file and the line.
Exact equality throughout (no tolerance: these are parsed values).
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

import rcf_tpu.config as jcfg
import rcf_tpu_torch.config as pcfg
from rcf_tpu_torch import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS)
def test_every_recipe_loads_to_the_jax_tree(path):
    full = os.path.join(REPO, path)
    tree = pcfg.load_tree(full)
    assert tree == jcfg.load_tree(full)
    # The block writer's text reads back to the same tree, by both readers.
    text = yaml_subset.dump(tree)
    assert yaml_subset.load(text) == tree
    assert yaml.safe_load(text) == tree


@pytest.fixture()
def cfg_dir(tmp_path):
    (tmp_path / "base.yaml").write_text(textwrap.dedent("""
        batch_size: 8
        learning_rate: 1.0e-4
        use_flip: true
        object_channel: null
        name: 'base # not a comment'
        model_kwargs:
          w_seg: 1.0
          mask_size: [96, 96]
          backbone2:
            depth: 50  # trailing comment
        """))
    (tmp_path / "child.yaml").write_text(textwrap.dedent("""
        base_config: base.yaml
        batch_size: 2
        model_kwargs:
          w_seg: 0.1
          w_pl: 2.0
        """))
    return tmp_path


def test_inheritance_merges_child_over_base(cfg_dir):
    tree = pcfg.load_tree(str(cfg_dir / "child.yaml"))
    assert tree == jcfg.load_tree(str(cfg_dir / "child.yaml"))
    assert tree["batch_size"] == 2 and tree["learning_rate"] == 1.0e-4
    assert tree["model_kwargs"] == {"w_seg": 0.1, "w_pl": 2.0, "mask_size": [96, 96],
                                    "backbone2": {"depth": 50}}
    assert tree["name"] == "base # not a comment"
    assert "base_config" not in tree


def test_duplicate_keys_rejected(tmp_path):
    p = tmp_path / "dup.yaml"
    p.write_text("a: 1\nb:\n  c: 2\n  c: 3\n")
    for mod in (jcfg, pcfg):
        with pytest.raises(ValueError, match="duplicate"):
            mod.load_tree(str(p))


OPTS = ["batch_size", "16", "use_flip", "false", "model_kwargs.w_seg", "2.5",
        "object_channel", "3", "model_kwargs.mask_size", "[48, 64]", "name", "null"]


def test_typed_overrides(cfg_dir):
    path = str(cfg_dir / "child.yaml")
    ours, theirs = pcfg.load_config(path, opts=OPTS), jcfg.load_config(path, opts=OPTS)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.batch_size == 16 and isinstance(ours.batch_size, int)
    assert ours.use_flip is False and ours.object_channel == 3 and ours.name is None
    assert ours.model_kwargs.mask_size == [48, 64]


def test_override_missing_key_raises(cfg_dir):
    for mod in (jcfg, pcfg):
        with pytest.raises(KeyError):
            mod.load_config(str(cfg_dir / "base.yaml"), opts=["nope", "1"])


def test_apply_overrides_odd_count():
    for mod in (jcfg, pcfg):
        with pytest.raises(ValueError):
            mod.apply_overrides({"a": 1}, ["a"])


def test_lists_replaced_and_config_access():
    assert pcfg.deep_merge({"a": [1, 2, 3], "b": {"c": 1}}, {"a": [4], "b": 2}) == \
        jcfg.deep_merge({"a": [1, 2, 3], "b": {"c": 1}}, {"a": [4], "b": 2})
    cfg = pcfg.Config({"a": {"b": 5}})
    assert cfg.a.b == 5 and cfg["a"]["b"] == 5 and cfg.get("missing", "d") == "d"
    cfg.c = 1
    assert cfg["c"] == 1


SCALARS = ["1e-4", "1.0e-4", "1.0E+4", "3.", ".5", "-.inf", ".NaN", "0x1F", "017", "0b101",
           "1_000", "-0", "+12", "1:30", "yes", "On", "OFF", "True", "~", "null", "", "abc",
           "'it''s'", '"tab\\there"', "[1, [2, 3], {}]", "{a: 1, b: [x, 'y z'], c: null}",
           "[]", "a b c"]


def test_scalars_resolve_as_pyyaml():
    for text in SCALARS:
        ours, theirs = yaml_subset.load(text), yaml.safe_load(text)
        same = ours == theirs or (isinstance(ours, float) and math.isnan(ours)
                                  and math.isnan(theirs))
        assert same and type(ours) is type(theirs), (text, ours, theirs)


@pytest.mark.parametrize("text,needle", [
    ("a:\n  - 1\n  - 2\n", "block sequences"),
    ("a: &anchor 1\nb: *anchor\n", "'&'"),
    ("a: |\n  two\n  lines\n", "'|'"),
    ("a: !!str 1\n", "'!'"),
    ("a: [1,\n  2]\n", "multi-line flow"),
    ("---\na: 1\n", "documents"),
    ("a: 2002-12-14\n", "timestamp"),
])
def test_constructs_outside_the_subset_raise_with_file_and_line(tmp_path, text, needle):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    with pytest.raises(yaml_subset.YamlError, match=needle) as info:
        pcfg.load_tree(str(p))
    assert str(p) in str(info.value) and "line" in str(info.value)


def test_print_config_runs_without_yaml_and_prints_the_jax_tree(tmp_path):
    """``python -m rcf_tpu_torch.cli <recipe> --print-config`` with jax, yaml,
    cv2 and PIL blocked: its output is the tree JAX's ``load_config`` gives."""
    runner = textwrap.dedent("""
        import importlib.abc, runpy, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "cv2", "PIL", "rcf_tpu")
        class Blocker(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
        sys.meta_path.insert(0, Blocker())
        sys.argv = ["rcf_tpu_torch.cli"] + sys.argv[1:]
        runpy.run_module("rcf_tpu_torch.cli", run_name="__main__")
    """)
    opts = ["--opts", "epochs", "2", "data_path", "/data/davis"]
    recipe = "configs/rcf/rcf_stage1.yaml"
    proc = subprocess.run([sys.executable, "-c", runner, recipe, "--print-config", *opts],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = yaml.safe_load(proc.stdout[proc.stdout.index("batch_size:"):])
    expected = jcfg.load_config(os.path.join(REPO, recipe), opts=opts[1:]).to_dict()
    assert json.dumps(printed, sort_keys=True) == json.dumps(expected, sort_keys=True)
