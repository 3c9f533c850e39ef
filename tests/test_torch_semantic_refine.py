"""The semantic constraint's device stage, its benchmark cell and the ranks
runner's reference, on the CPU at a small size (a depth-2 ViT-S/8, 64x96
frames, the tool's 10 NCut steps).

* ``semantic_refine`` (a batch of frames through one ViT call, then each
  frame's NCut) against ``port_bench/reference/dino_ncut_plain.py``, which is
  written without the port: keys within 1e-5 relative (the same float32
  operations in another order), the NCut values within 1e-5 relative, the
  refined masks within 1e-4 (the feed's masks settle at 0 and 1 in 10
  Adam steps; 5e-7 over 14 seeded cases);
* ``DinoFeatures(model=...)`` gives the reference's keys;
* the tool's per-frame labels do not change when frames go in groups;
* one call's spans and ``grouping.STATS``;
* the readers of the benchmark's new per-layer metrics on a made-up ``ctx``;
* the reference of the ranks runner (``port_bench/runners/
  train_step_ranks.py``: the plain step over the global batch) against
  rank 0 of a two-rank gloo step (``tests/torch_dist_worker.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rcf_tpu_torch.grouping as grouping
from rcf_tpu_torch.grouping import semantic_constraints as sc
from rcf_tpu_torch.grouping.pipeline import DinoFeatures
from rcf_tpu_torch.nn.dino_vit import DinoViT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "port_bench")
sys.path[:0] = [BENCH_DIR, os.path.join(BENCH_DIR, "tests")]

from harness import compare, spec, weights  # noqa: E402

REF = spec.module("reference", "dino_ncut_plain")
FULL = spec.config("dino_vits8_f32")
CFG = dict(FULL, arch=dict(FULL["arch"], depth=2), resize=[64, 96])
HW = (64, 96)
SEED = 2**31 + 11


def _dino(seed: int = SEED) -> tuple[DinoFeatures, dict]:
    a = CFG["arch"]
    w = REF.make_weights(a, seed, "cpu")
    vit = DinoViT(a["patch_size"], a["embed_dim"], a["depth"], a["num_heads"],
                  a["mlp_hidden_dim"] / a["embed_dim"], a["pos_grid"])
    vit.load_state_dict(w, strict=True)
    return DinoFeatures(model=vit, resize_imgs_size=CFG["resize"]), w


def _frames(n: int, seed: int = 3, hw=HW) -> tuple[torch.Tensor, torch.Tensor]:
    feed = spec.module("feeds", "texture_frames")
    noise = spec.workload("dino_vits8_f32.ncut_frames")["traffic"]["noise"]
    return tuple(feed.batch(torch.Generator().manual_seed(seed), n, *hw, "cpu", noise).values())


@pytest.mark.parametrize("b", [1, 3])
def test_semantic_refine_matches_the_plain_reference(b):
    dino, w = _dino()
    imgs, masks = _frames(b)
    got = sc.semantic_refine(dino, imgs, masks)
    want = REF.semantic_refine(w, imgs, masks, CFG)
    assert got.shape == want["refined"].shape == (b, 8, 12)
    np.testing.assert_allclose(got.numpy(), want["refined"].numpy(), atol=1e-4, rtol=0)
    keys = dino(imgs)
    assert float((keys - want["keys"]).norm() / want["keys"].norm()) < 1e-5
    grids = dino.mask_to_grid(masks)
    assert torch.equal(grids, want["grid"])
    for f in range(b):
        for mask, key in ((grids[f], "ncut_before"), (got[f], "ncut_after")):
            value = float(grouping.soft_ncut_value(keys[f], mask, CFG["ncut"]["tau"], CFG["ncut"]["eps"]))
            assert value == pytest.approx(float(want[key][f]), rel=1e-5)


def test_dino_features_with_a_given_model_give_the_reference_keys():
    dino, w = _dino(SEED + 1)
    imgs, _ = _frames(2, seed=4, hw=(60, 90))    # resized to 64x96 on the way in
    want = torch.stack([REF.frame_keys(w, img, CFG["arch"], CFG["resize"]) for img in imgs])
    got = dino(imgs.numpy())
    assert got.shape == (2, 8 * 12 + 1, 384) and dino.grid_hw == (8, 12)
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_grouping_frames_leaves_each_frames_label_unchanged():
    """Four frames in one group (two of one size, two of another) against each
    frame alone, through the attention CRF engine."""
    dino, _ = _dino()
    imgs, masks = _frames(2, seed=5, hw=(16, 24))
    imgs2, masks2 = _frames(2, seed=6, hw=(16, 16))
    frames = [t.numpy() for t in (*imgs, *imgs2)]
    soft = [t.numpy() for t in (*masks, *masks2)]
    grouped = sc.refine_group(dino, frames, soft, None, crf_engine="attention")
    for img, mask, got in zip(frames, soft, grouped):
        alone = sc.refine_frame(dino, img, mask, None, crf_engine="attention")
        assert got.shape == img.shape[:2]
        np.testing.assert_allclose(got, alone, atol=1e-5, rtol=0)


def test_spans_and_counters_of_one_call():
    dino, _ = _dino()
    imgs, masks = _frames(2)
    grouping.reset_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sc.semantic_refine(dino, imgs, masks)
    spans = [e for e in prof.events() if e.name.startswith("rcf.")]
    names = [e.name for e in spans]
    blocks = CFG["arch"]["depth"] - 1     # the last block gives its keys alone
    assert names.count("rcf.dino.forward") == 1 and names.count("rcf.dino.attention") == blocks
    assert names.count("rcf.ncut.affinity") == 1 and names.count("rcf.ncut.refine") == 1
    outer = next(e for e in spans if e.name == "rcf.dino.forward").time_range
    for e in spans:
        if e.name == "rcf.dino.attention":
            assert outer.start <= e.time_range.start and e.time_range.end <= outer.end
    tokens = 8 * 12 + 1
    assert grouping.STATS == {"frames": 2, "tokens": 2 * tokens,
                              "attention_pairs": 2 * CFG["arch"]["num_heads"] * tokens ** 2 * blocks,
                              "ncut_steps": 2 * CFG["ncut"]["steps"]}


def _readers_ctx() -> dict:
    n = REF.tokens(FULL)
    work = REF.attention_work(n, FULL["arch"])
    return {"span_ms": {"rcf.dino.forward": 800.0, "rcf.dino.attention": 440.0, "rcf.ncut.affinity": 40.0,
                        "rcf.ncut.refine": 120.0},
            "span_frames": 16, "attention_work": {k: v * 11 * 16 for k, v in work.items()},
            "window_frames": 480, "window_seconds": 30.0, "flops_per_frame": REF.frame_flops(n, FULL["arch"])}


@pytest.mark.parametrize("name,want", [
    ("grouping.dino_ms_per_frame", 50.0),
    ("grouping.ncut_ms_per_frame", 10.0),
    # 16 frames x 11 blocks of 4 N^2 D = 63.33 GFLOP at 495 TFLOP/s, over 440 ms.
    ("kernels.dino_attention_roofline_pct", 100.0 * 16 * 11 * 63.328114176e9 / 495e12 / 0.440),
    ("grouping.mfu_pct", 100.0 * 984.850162176e9 * 16 / 495e12),
])
def test_new_metric_readers_on_a_made_up_ctx(name, want):
    assert REF.frame_flops(6421, FULL["arch"]) == pytest.approx(984.850162176e9)
    got = spec.metric_reader(name).read(_readers_ctx())
    assert got == pytest.approx(want, rel=1e-9)
    assert spec.metric_reader(name).read({"span_ms": {}, "window_frames": 0}) is None


def test_ranks_reference_over_the_global_batch_is_rank_0s_step(tmp_path):
    """Rank 0 of a two-rank gloo step (``torch_dist_worker.step_case``: each rank
    its pairs ``r::2``, the dropout drawn for the whole batch) against the
    reference that ``runners/train_step_ranks.py`` compares with."""
    from port_bench_tiny import tiny_stage

    stage = tiny_stage(spec.stage("rcf_davis_f32", "stage1"))
    kw, train = stage["model_kwargs"], stage["train"]
    ref = spec.module("reference", "rcf_plain")
    params, buffers = weights.make(*ref.specs(kw), SEED, "cpu")
    batch = spec.module("feeds", "device_pool").pool({"pairs": 4, "hw": 64, "pool": 1, "flow_std": 5.0},
                                                     SEED, "cpu")[0]
    step = {"amd": False, "model_kwargs": kw, "state_dict": {**params, **buffers},
            "cfg": dict(train, model_kwargs=kw), "batch": batch}
    torch.save({"steps": {"dp": step}}, tmp_path / "inputs.pt")
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(tmp_path), str(r), "2"], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    want = spec.module("runners", "train_step").reference_readings(ref, kw, train, params, buffers, [batch], 0, [])
    logs = [p.communicate(timeout=300)[0].decode()[-2000:] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    got = torch.load(tmp_path / "out_0.pt", weights_only=False)["dp"]
    wd = float(train.get("weight_decay", 0.0))
    grad = {n: float((g + wd * params[n]).double().norm()) for n, g in got["grads"].items()}
    assert abs(float(got["losses"]["loss"]) - want["losses"][0]) < 3e-5 * abs(want["losses"][0])
    gaps = compare.leaf_gaps(grad, want["grad"], compare.kept_leaves(want["grad"]))
    assert gaps[len(gaps) // 2] < 1e-3 and gaps[-1] < 0.05, json.dumps(gaps[-3:])
    assert got["collectives"]["all_reduce_calls"] > 0
