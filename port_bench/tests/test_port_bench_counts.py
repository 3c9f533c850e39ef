"""The benchmark's counts against hand counts at a tiny size: the model FLOPs
of a step (convolutions, dense layers and the flow head's contractions,
forward and backward) and ``crf_filter``'s least time."""

from __future__ import annotations

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR), os.path.dirname(os.path.abspath(__file__))]

from harness import spec  # noqa: E402
from port_bench_tiny import tiny_stage  # noqa: E402

ref = spec.module("reference", "rcf_plain")


def _conv(n, hw, cin, cout, k):
    return 2 * n * hw * hw * cin * cout * k * k


def hand_count_davis_stage1(kw: dict, pairs: int, hw: int) -> int:
    """Forward and backward FLOPs of the DAVIS stage-1 step by hand: each
    conv's forward once, its weight gradient once, its input gradient once
    unless its input needs none (the stem, the flow embedding's first conv)."""
    n = 2 * pairs
    bb = kw["backbone2"]
    total = 0

    def conv(frames, size, cin, cout, k, input_grad=True):
        nonlocal total
        f = _conv(frames, size, cin, cout, k)
        total += f * (3 if input_grad else 2)

    size = hw // 2
    conv(n, size, 3, bb["stem_channels"], 7, input_grad=False)
    size //= 2
    feats = []
    for name, cin, planes, stride, _, ds in ref._resnet_layout(bb):
        out = size // stride
        conv(n, size, cin, planes, 1)
        conv(n, out, planes, planes, 3)
        conv(n, out, planes, planes * 4, 1)
        if ds:
            conv(n, out, cin, planes * 4, 1)
        size = out
        if name.endswith(".0"):
            feats.append((name, size))
    ch = ref.resnet_channels(bb)
    s0 = hw // 4
    s3 = size
    head = kw["decode_head2"]
    c = head["channels"]
    conv(n, s0, ch[0], c, 3)                 # conv0 over stage 0, at 96^2 in the recipe
    conv(n, s3, ch[3], c, 3)                 # conv0 over stage 3 at its own size
    conv(n, s0, c, c, 3)
    conv(n, s0, c, head["num_classes"], 1)
    res = kw["decode_head3"]
    conv(pairs, s3, 2 * ch[3], res["channels"], 3)
    conv(pairs, s3, res["channels"], res["channels"], 3)
    conv(pairs, s3, res["channels"], res["num_classes"], 1)
    fh = kw["decode_head"]
    m = kw["mask_size"][0]
    f = fh["num_flow_feat_channels"]
    conv(n, m, 2, f, 3, input_grad=False)
    conv(n, m, f, f, 3)
    cm, p = kw["mask_layer"], m * m
    total += 3 * 2 * n * p * f * cm                     # pooling by the masks
    total += 3 * 2 * n * cm * f * f + 3 * 2 * n * cm * f * 2   # the two dense layers
    total += 3 * 2 * n * p * cm * 2                     # painting through the masks
    total += 3 * 2 * n * p * 2 * cm                     # the residual's gate
    return total


def test_step_flops_matches_a_hand_count():
    kw = tiny_stage(spec.stage("rcf_davis_f32", "stage1"))["model_kwargs"]
    assert ref.step_flops(kw, 2, 64) == hand_count_davis_stage1(kw, 2, 64)


def test_crf_floor_matches_a_hand_count():
    reader = spec.metric_reader("kernels.crf_filter_roofline_pct")
    exps_per_s = 132 * 1.98e9 * (16 + 128)
    assert reader.least_seconds(32, 128 * 128) == pytest.approx(32 * (128 * 128) ** 2 / exps_per_s)
    # A tiny image is bound by its bytes: features, values and output once each.
    assert reader.least_seconds(1, 4) == pytest.approx(4 * 7 * 4 / 3.35e12)
    ctx = {"kernels": [{"name": "crf_filter_kernel<5>", "dur": 1000.0}], "crf_iters": 50,
           "crf_grid": (128, 128), "crf_images": 32, "trace_steps": 1}
    assert reader.read(ctx) == pytest.approx(100 * 50 * 32 * 128 ** 4 / exps_per_s / 1e-3)


def test_mfu_reads_the_peak_of_the_compute_dtype():
    reader = spec.metric_reader("device.mfu_pct")
    ctx = {"window_steps": 4, "window_seconds": 2.0, "flops_per_step": 989e12 / 4, "compute_dtype": "bfloat16",
           "chips": 1}
    assert reader.read(ctx) == pytest.approx(50.0)
    assert reader.read(dict(ctx, compute_dtype="float32", chips=4)) == pytest.approx(50.0 * 989 / 495 / 4)
