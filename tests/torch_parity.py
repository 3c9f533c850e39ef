"""Helpers shared by the tests that hold ``rcf_tpu_torch`` against ``rcf_tpu``."""

from __future__ import annotations

import jax
import numpy as np
import torch


def init_variables(module, *args, seed=0, **kwargs):
    """Numpy Flax variables of ``module`` for these inputs, drawn with numpy.

    Only the shapes come from JAX (``eval_shape``: nothing is compiled).
    Kernels are he-normal; biases and BN terms are random, so that every
    converted tensor matters and eval mode is not an identity.
    """
    shapes = jax.eval_shape(lambda key, *a: module.init(key, *a, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = sd.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_close(ours, ref, rel, msg=""):
    """max |ours - ref| <= rel * max |ref|: error against the output's own scale."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (msg, ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{msg}: max err {err:.3e} > {rel} * {scale:.3e}"


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))
