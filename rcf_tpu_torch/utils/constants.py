"""Constants made on the host once and kept on the device.

A tensor built from numpy and copied to a card on every call makes a
blocking host-to-device copy each time. ``device_constant`` copies it
once per (builder, arguments, device, dtype) and hands back the same
device tensor after that, as JAX keeps such arrays as compile-time
constants.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=512)
def device_constant(build, args: tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``build(*args)`` (a numpy array) as a ``dtype`` tensor on ``device``, copied once."""
    return torch.from_numpy(np.ascontiguousarray(build(*args))).to(device=device, dtype=dtype)
