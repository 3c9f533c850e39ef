"""Device selection for the port's entry points.

The port runs on an NVIDIA GPU. Entry points take ``device="cuda"`` by
default and raise when no card is visible; only an explicit
``device="cpu"`` runs on the CPU (the tests do, through the kernels'
plain versions). Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises if it asks for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rcf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain CPU path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
