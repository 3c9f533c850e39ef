"""Tiny versions of the cells for the CPU tests: the recipes' structure at
small widths, crops and grids (the cells themselves run at full size)."""

from __future__ import annotations

import copy

TINY_HW = 64


def tiny_stage(stage: dict) -> dict:
    stage = copy.deepcopy(stage)
    kw = stage["model_kwargs"]
    kw["backbone2"].update(stem_channels=16, base_channels=8)
    ch = [8 * 2 ** s * 4 for s in range(4)]
    mask = [16, 16] if kw["decode_head2"].get("input_transform") == "resize_concat" else [8, 8]
    kw["mask_size"] = list(mask)
    kw["decode_head"].update(mask_size=list(mask), num_flow_feat_channels=8)
    kw["decode_head2"].update(channels=8)
    kw["decode_head3"].update(channels=8, in_channels=2 * ch[-1])
    if kw.get("crf_head"):
        kw["crf_head"] = dict(kw["crf_head"], resolution=[16, 16], refine_iters=5)
    return stage


def tiny_workload(wl: dict) -> dict:
    wl = copy.deepcopy(wl)
    wl["traffic"].update(pairs=2, hw=TINY_HW, pool=3)
    wl["warmup_steps"] = 1
    wl["trace_steps"] = 2
    return wl

