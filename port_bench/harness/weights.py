"""The model's weights, made by the benchmark from the seed.

Every drawn leaf comes from one ``torch.randn`` over all of them, on the
device, scaled per leaf: he-normal convolutions (variance 2 / fan_in),
lecun-normal dense layers (1 / fan_in), N(0, 0.01^2) classifiers; BatchNorm
scales 1 and shifts 0, running statistics 0 and 1; the EMA copies equal the
weights they follow. The same tensors go to the program and to the plain
reference.
"""

from __future__ import annotations

import math

import torch


def make(param_specs: list, buffer_specs: list, seed: int, device) -> tuple[dict, dict]:
    """(parameters, buffers) by name, float32 on ``device``, from ``seed``."""
    drawn = [s for s in param_specs if s[2][0] in ("he", "lecun", "normal")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, off = {}, 0
    for name, shape, init in param_specs:
        if init[0] in ("he", "lecun", "normal"):
            n = math.prod(shape)
            std = {"he": lambda: math.sqrt(2.0 / init[1]), "lecun": lambda: math.sqrt(1.0 / init[1]),
                   "normal": lambda: float(init[1])}[init[0]]()
            params[name] = flat[off:off + n].view(shape) * std
            off += n
        else:
            params[name] = _constant(init, shape, device)
    buffers = {}
    for name, shape, init in buffer_specs:
        if "_ema." in name:
            head, rest = name.split(".", 1)
            src = f"{head[:-len('_ema')]}.{rest}"
            buffers[name] = (params[src] if src in params else buffers[src]).clone()
        else:
            buffers[name] = _constant(init, shape, device)
    return params, buffers


def _constant(init: tuple, shape: tuple, device) -> torch.Tensor:
    if init[0] == "zeros":
        return torch.zeros(shape, device=device)
    if init[0] == "ones":
        return torch.ones(shape, device=device)
    raise ValueError(f"unknown init {init!r}")
