"""The feed ``device_pool``: a small pool of distinct batches made on the card
from the seed at set-up and cycled, so that the loader is bypassed.

The batches follow ``chip_smoke.py::rcf_batch`` and ``crf_frames``: frames
with flat colour regions (N(0, 1) colours on 32^2 blocks plus N(0, 0.05^2)
of noise, as ImageNet-normalised frames) and N(0, flow_std^2) px flows.
Traffic keys: ``pairs``, ``hw``, ``pool``, ``flow_std``, ``steps_per_epoch``
(the learning-rate schedule's epoch, as the recipe's data set gives it).
"""

from __future__ import annotations

import itertools

import torch


def flat_region_frames(gen, n: int, hw: int, device, block: int = 32) -> torch.Tensor:
    cells = -(-hw // block)
    c = torch.randn(n, cells, cells, 3, generator=gen, device=device)
    x = c.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :hw, :hw]
    return x + 0.05 * torch.randn(n, hw, hw, 3, generator=gen, device=device)


def pool(traffic: dict, seed: int, device) -> list[dict]:
    """``pool`` distinct batches of ``pairs`` pairs of ``hw``^2 frames and flows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5DEECE66D)
    b, hw, std = int(traffic["pairs"]), int(traffic["hw"]), float(traffic["flow_std"])
    out = []
    for _ in range(int(traffic["pool"])):
        out.append({
            "imgs": flat_region_frames(gen, 2 * b, hw, device).reshape(b, 2, hw, hw, 3),
            "gt_fw_flows": torch.randn(b, 1, hw, hw, 2, generator=gen, device=device) * std,
            "gt_bw_flows": torch.randn(b, 1, hw, hw, 2, generator=gen, device=device) * std,
        })
    return out


class Feed:
    def __init__(self, wl: dict, stage: dict, seed: int, dev):
        self.object_channel = stage.get("object_channel")
        self.batches = pool(wl["traffic"], seed, dev)
        self.steps_per_epoch = int(wl["traffic"]["steps_per_epoch"])
        self.it = itertools.cycle(self.batches)

    def next_host(self) -> dict:
        return next(self.it)

    def to_device(self, batch: dict) -> dict:
        out = dict(batch)
        out["object_channel"] = 0 if self.object_channel is None else int(self.object_channel)
        out["object_channel_set"] = self.object_channel is not None
        return out

    def close(self) -> None:
        self.it = self.batches = None


def make(wl: dict, cfg: dict, stage: dict, seed: int, dev) -> Feed:
    return Feed(wl, stage, seed, dev)
