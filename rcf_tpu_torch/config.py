"""Config trees from YAML files (port of ``rcf_tpu/config.py``).

The same contract as the JAX package's loader, read with the port's own
YAML reader (``yaml_subset.py``: the machine with the card has no
``yaml``):

* single-parent inheritance through ``base_config`` (relative to the
  child file's directory), a duplicate key in one mapping an error;
* nested merge, the child winning; a dict over a non-dict (or the reverse)
  replaces; lists are replaced, never merged;
* dotted, typed ``--opts a.b.c value`` overrides, the value coerced to the
  type of the value it replaces (YAML-parsed where that is None, a list or
  a dict); a missing target raises unless ``allow_new``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator, Mapping

from . import yaml_subset


class Config:
    """Attribute/dict hybrid over a nested configuration tree."""

    def __init__(self, tree: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_tree", dict(tree or {}))

    def __getitem__(self, key: str) -> Any:
        value = self._tree[key]
        return Config(value) if isinstance(value, dict) else value

    def __setitem__(self, key: str, value: Any) -> None:
        self._tree[key] = value.to_dict() if isinstance(value, Config) else value

    def __contains__(self, key: str) -> bool:
        return key in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def keys(self):
        return self._tree.keys()

    def items(self):
        for key in self._tree:
            yield key, self[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self[key] if key in self._tree else default

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(f"config has no key {key!r}") from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def to_dict(self) -> dict:
        return copy.deepcopy(self._tree)

    def __repr__(self) -> str:
        return f"Config({self._tree!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._tree == other._tree
        return self._tree == other


def deep_merge(base: dict, child: dict) -> dict:
    """Return a new tree: ``child`` merged over ``base`` (child wins)."""
    merged = dict(base)
    for key, value in child.items():
        if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
            merged[key] = deep_merge(merged[key], value)
        else:
            merged[key] = copy.deepcopy(value)
    return merged


def load_tree(path: str) -> dict:
    """Load a YAML config file, resolving ``base_config`` inheritance."""
    tree = yaml_subset.load_file(path)
    tree = {} if tree is None else tree
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    base_rel = tree.pop("base_config", None)
    if base_rel is None:
        return tree
    base_path = os.path.join(os.path.dirname(path), base_rel)
    return deep_merge(load_tree(base_path), tree)


def _coerce(key: str, raw: str, existing: Any) -> Any:
    """Coerce CLI string ``raw`` to the type of ``existing``."""
    if isinstance(existing, bool):
        lowered = raw.lower()
        if lowered in ("true", "1"):
            return True
        if lowered in ("false", "0"):
            return False
        raise ValueError(f"cannot parse {raw!r} as bool for {key}")
    if isinstance(existing, int) and not isinstance(existing, bool):
        return int(raw)
    if isinstance(existing, float):
        return float(raw)
    if existing is None or isinstance(existing, (list, dict)):
        # YAML-parse so `--opts x null`, `--opts y "[1, 2]"` work.
        return yaml_subset.load(raw, f"--opts {key}")
    if raw in ("null", "~", "None"):
        return None
    return raw


def apply_overrides(tree: dict, opts: list[str], allow_new: bool = False) -> dict:
    """Apply detectron2-style ``KEY VALUE`` pair overrides in place."""
    if len(opts) % 2 != 0:
        raise ValueError(f"--opts expects KEY VALUE pairs, got odd count {len(opts)}")
    for key, raw in zip(opts[::2], opts[1::2]):
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node[part]
        leaf = parts[-1]
        if leaf not in node and not allow_new:
            raise KeyError(f"override target {key!r} does not exist in config")
        node[leaf] = _coerce(key, raw, node.get(leaf))
    return tree


def load_config(path: str, opts: list[str] | None = None, allow_new: bool = False) -> Config:
    """Load a config file with inheritance and CLI overrides applied."""
    tree = load_tree(path)
    if opts:
        apply_overrides(tree, opts, allow_new=allow_new)
    return Config(tree)
