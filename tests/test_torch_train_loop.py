"""The port's trainer (``rcf_tpu_torch.train.loop``, ``checkpoint``, ``eval``)
against the JAX package's, on the CPU at the size of ``test_loop_e2e._cfg``.

Limits: IoU counts, election, ``miou`` and ``miou_frame_avg`` equal to
1e-12 (integer counts, the same float64 reductions); a port checkpoint
imported by JAX's ``load_pretrained`` gives mask probabilities within 1e-4
of the port's (f32 convolutions on two backends); JAX's and the port's
``evaluate`` on equal weights give per-sequence IoU within 1e-6 and the
same elected channel; checkpoints restore bit for bit.
"""

from __future__ import annotations

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.data import DataLoader as JaxLoader
from rcf_tpu.data import EvalTransform as JaxEvalTransform
from rcf_tpu.data import VideoDataset as JaxDataset
from rcf_tpu.eval.harness import Evaluator as JaxEvaluator
from rcf_tpu.eval.iou import iou_counts as jax_iou_counts
from rcf_tpu.models import build_from_config as jax_build
from rcf_tpu.ops import resize_bilinear as jax_resize
from rcf_tpu.train import checkpoint as jax_ckpt
from rcf_tpu.train import loop as jax_loop
from rcf_tpu.train.state import create_train_state as jax_train_state
from rcf_tpu_torch import cli
from rcf_tpu_torch.config import Config
from rcf_tpu_torch.convert import rcf_state_from_jax
from rcf_tpu_torch.data import DataLoader, EvalTransform, VideoDataset
from rcf_tpu_torch.eval import Evaluator, iou_counts
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.train import create_train_state
from rcf_tpu_torch.train import loop
from rcf_tpu_torch.train.checkpoint import (TopKKeeper, find_resumable, read_checkpoint,
                                            restore_checkpoint, save_checkpoint)
from test_loop_e2e import _cfg

EVAL_KW = dict(training=False, frame_num=1)


def _tree(davis_like, ckpt_dir, ema=False, dropout=0.0) -> dict:
    tree = _cfg(davis_like, ckpt_dir).to_dict()
    mk = tree["model_kwargs"]
    mk["backbone2"]["create_ema"] = ema
    mk["decode_head2"]["dropout_ratio"] = dropout
    mk["decode_head3"]["dropout_ratio"] = dropout
    return tree


def _state(tree: dict, seed: int = 0):
    model = build_model(tree["model_kwargs"], device="cpu", seed=seed)
    return create_train_state(tree, model, steps_per_epoch=1)


# ---------------------------------------------------------------------------
# IoU and the evaluator
# ---------------------------------------------------------------------------


def _eval_inputs(rng, pos_th: float, b=5, c=4, h=9, w=11, H=18, W=22):
    probs = rng.dirichlet(np.full(c, 0.5), size=(b, h, w)).astype(np.float32)
    ann = (rng.random((b, H, W)) > 0.5).astype(np.uint8) * 255
    ann[rng.random((b, H, W)) < 0.1] = 128
    # Keep every counted pixel at least 1e-4 from the decision: near ones are ignored (128).
    m = np.asarray(jax_resize(jnp.asarray(probs), (H, W), align_corners=True), np.float64)
    if pos_th == -1:
        top2 = np.sort(m, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < 1e-4
    else:
        near = (np.abs(m - pos_th) < 1e-4).any(-1)
    ann[near] = 128
    return probs, ann


def _result_equal(ours, theirs):
    for a, b in ((ours.miou, theirs.miou), (ours.miou_frame_avg, theirs.miou_frame_avg)):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12, (a, b)
    assert ours.per_sequence.keys() == theirs.per_sequence.keys()
    for k, v in theirs.per_sequence.items():
        assert (np.isnan(v) and np.isnan(ours.per_sequence[k])) or \
            abs(ours.per_sequence[k] - v) <= 1e-12
    assert ours.max_channel_freq == theirs.max_channel_freq
    assert ours.elected_channel == theirs.elected_channel


@pytest.mark.parametrize("pos_th,object_channel,nan_seq", [
    (0.35, None, False), (-1.0, None, False), (0.35, 2, True), (-1.0, None, True)])
def test_evaluator_equals_jax(pos_th, object_channel, nan_seq):
    rng = np.random.default_rng(int(10 * abs(pos_th)) + (object_channel or 0) + nan_seq)
    ours = Evaluator(eval_pos_th=pos_th, num_channels=4, object_channel=object_channel)
    theirs = JaxEvaluator(eval_pos_th=pos_th, num_channels=4, object_channel=object_channel)
    for batch in range(3):
        probs, ann = _eval_inputs(rng, pos_th)
        if nan_seq and batch == 2:
            ann[:] = 128  # every pixel ignored: the sequence is all NaN
        names = [f"seq{batch}"] * 3 + [f"seq{batch + 1}"] * 2
        ti, tu = iou_counts(torch.from_numpy(probs), torch.from_numpy(ann), pos_th)
        ji, ju = jax_iou_counts(jnp.asarray(probs), jnp.asarray(ann), pos_th)
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tu.numpy(),
                                                                              np.asarray(ju))
        ours.process_batch(torch.from_numpy(probs), torch.from_numpy(ann), names)
        theirs.process_batch(jnp.asarray(probs), jnp.asarray(ann), names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # nanmean of an all-NaN sequence
        _result_equal(ours.finalize(), theirs.finalize())


# ---------------------------------------------------------------------------
# Checkpoints (the cases of tests/test_checkpoint_resume.py)
# ---------------------------------------------------------------------------


def _params(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()}


def _train_steps(state, n: int):
    """n plain Adam steps on a quadratic of every trainable parameter."""
    for _ in range(n):
        state.optimizer.zero_grad()
        sum((p.float() ** 2).sum() for g in state.optimizer.param_groups
            for p in g["params"]).backward()
        state.optimizer.step()
        state.step += 1
    return state


def test_cross_stage_restore_is_weights_only(davis_like, tmp_path):
    tree = _tree(davis_like, tmp_path)
    prev = _train_steps(_state(tree, seed=1), 3)
    save_checkpoint(str(tmp_path), "last", prev)
    fresh = _state(tree, seed=2)
    restored = restore_checkpoint(str(tmp_path / "last"), fresh, weights_only=True)
    for k, v in prev.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    assert restored.step == 0 and not restored.optimizer.state
    full = restore_checkpoint(str(tmp_path / "last"), _state(tree, seed=2))
    assert full.step == 3 and full.optimizer.state_dict()["state"][0]["step"] == 3


def test_cross_stage_restore_expands_ema_from_main_weights(davis_like, tmp_path):
    prev = _train_steps(_state(_tree(davis_like, tmp_path), seed=1), 2)
    save_checkpoint(str(tmp_path), "last", prev)
    fresh = _state(_tree(davis_like, tmp_path, ema=True), seed=2)
    restored = restore_checkpoint(str(tmp_path / "last"), fresh, weights_only=True)
    sd = restored.model.state_dict()
    for k, v in prev.model.state_dict().items():
        if k.startswith(("backbone2.", "decode_head2.")):
            assert torch.equal(sd[k.replace(".", "_ema.", 1)], v), k
    assert restored.step == 0


def test_last_save_rotates_and_restores_bitwise(davis_like, tmp_path):
    tree = _tree(davis_like, tmp_path, ema=True)
    s1 = _train_steps(_state(tree, seed=1), 1)
    save_checkpoint(str(tmp_path), "last", s1)
    gen1 = _params(s1.model)
    s2 = _train_steps(s1, 1)
    save_checkpoint(str(tmp_path), "last", s2)
    assert os.path.isdir(tmp_path / "last") and os.path.isdir(tmp_path / "last.prev")
    cur = restore_checkpoint(str(tmp_path / "last"), _state(tree, seed=3))
    assert cur.step == 2
    for k, v in s2.model.state_dict().items():
        assert torch.equal(cur.model.state_dict()[k], v), k
    prev = restore_checkpoint(str(tmp_path / "last.prev"), _state(tree, seed=3))
    assert prev.step == 1 and all(torch.equal(prev.model.state_dict()[k], v)
                                  for k, v in gen1.items())
    payload = read_checkpoint(str(tmp_path / "last"))
    assert set(payload) == {"state_dict", "optimizer", "step"}
    assert all(k.startswith("model.") for k in payload["state_dict"])


def test_find_resumable_order_and_stale_tmp(davis_like, tmp_path):
    assert find_resumable(str(tmp_path)) is None
    state = _state(_tree(davis_like, tmp_path))
    for name, expect in (("last.prev", "last.prev"), ("last.tmp", "last.tmp"), ("last", "last")):
        save_checkpoint(str(tmp_path), name, state)
        assert find_resumable(str(tmp_path)).endswith(expect)
    other = tmp_path / "direct"
    other.mkdir()
    (other / "last.tmp").mkdir()
    save_checkpoint(str(other), "last", state)  # a direct `last` clears the stale tmp
    assert not os.path.exists(other / "last.tmp")


def test_topk_keeper_persists_and_drops_stale(davis_like, tmp_path):
    import shutil

    state = _state(_tree(davis_like, tmp_path))
    k1 = TopKKeeper(str(tmp_path), k=2)
    k1.save(state, 0.50, tag="e0")
    k1.save(state, 0.70, tag="e1")
    k2 = TopKKeeper(str(tmp_path), k=2)
    assert sorted(m for m, _ in k2.kept) == [0.50, 0.70]
    k2.save(state, 0.60, tag="e2")
    names = {n for _, n in k2.kept}
    assert any("e1" in n for n in names) and any("e2" in n for n in names)
    assert {e for e in os.listdir(tmp_path) if e.startswith("ckpt_")} == names
    shutil.rmtree(tmp_path / k2.kept[0][1])
    assert len(TopKKeeper(str(tmp_path), k=2).kept) == 1
    assert loop._load_object_channel(str(tmp_path)) is None
    loop._save_object_channel(str(tmp_path), 2, epoch=4)
    assert loop._load_object_channel(str(tmp_path)) == 2


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tiny(davis_like, tmp_path_factory):
    """The JAX package's tiny RCF model (``_cfg``, depth 18) and its variables,
    the mask head's classifier scaled so that the masks are far from uniform."""
    cfg = _cfg(davis_like, tmp_path_factory.mktemp("jax"))
    model = jax_build(cfg)
    hw = (64, 64)
    imgs = jnp.zeros((2, 2, *hw, 3), jnp.float32)
    flows = jnp.zeros((2, 1, *hw, 2), jnp.float32)
    init = jax.jit(lambda r1, r2: model.init({"params": r1, "dropout": r2}, imgs,
                                             gt_fw_flows=flows, gt_bw_flows=flows, train=True))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0),
                                                        jax.random.PRNGKey(1)))
    variables = {k: dict(v) for k, v in variables.items()}
    seg = dict(variables["params"]["decode_head2"]["conv_seg"])
    seg["kernel"] = seg["kernel"] * 40.0
    variables["params"]["decode_head2"] = dict(variables["params"]["decode_head2"], conv_seg=seg)
    return cfg, model, variables


def test_jax_load_pretrained_imports_a_port_checkpoint(davis_like, tmp_path, jax_tiny):
    """A port `last` (EMA included) through JAX's `load_pretrained` (its
    Lightning `model.` branch): the mask probabilities agree within 1e-4."""
    cfg, jmodel, jvars = jax_tiny
    state = _state(_tree(davis_like, tmp_path, ema=True), seed=4)
    with torch.no_grad():  # make the EMA differ from the weights
        for k, v in state.model.state_dict().items():
            if "_ema." in k and v.is_floating_point() and "running_var" not in k:
                v.mul_(0.9)
    save_checkpoint(str(tmp_path), "last", state)
    imported = jax_ckpt.load_pretrained(str(tmp_path / "last" / "checkpoint.pt"), jmodel, jvars)
    x = np.random.default_rng(0).standard_normal((2, 40, 72, 3)).astype(np.float32)
    state.model.eval()
    for use_ema in (False, True):
        if use_ema:
            params = {**imported["params"], **imported["ema_params"]}
            stats = {**imported["batch_stats"], **imported["ema_stats"]}
        else:
            params, stats = imported["params"], imported["batch_stats"]
        theirs = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              method=jmodel.mask_probs)
        with torch.no_grad():
            ours = state.model.mask_probs(torch.from_numpy(x), use_ema=use_ema)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-4)


@pytest.mark.parametrize("pos_th", [0.35, -1.0])
def test_evaluate_equals_jax_on_equal_weights(davis_like, tmp_path, jax_tiny, pos_th):
    cfg, jmodel, jvars = jax_tiny
    jstate = jax_train_state(cfg, jmodel, jvars, 1)
    jloader = JaxLoader(JaxDataset(str(davis_like), "val.txt", **EVAL_KW),
                        JaxEvalTransform(**dict(cfg.test_transform_kwargs)), batch_size=4,
                        shuffle=False, drop_last=False, group_by_shape=True, num_workers=2)
    theirs = jax_loop.evaluate(cfg, jmodel, jstate, jloader, pos_th, None)
    tree = _tree(davis_like, tmp_path)
    state = _state(tree)
    state.model.load_state_dict(rcf_state_from_jax(jvars))
    ploader = DataLoader(VideoDataset(str(davis_like), "val.txt", **EVAL_KW),
                         EvalTransform(**tree["test_transform_kwargs"]), batch_size=4,
                         shuffle=False, drop_last=False, group_by_shape=True, num_workers=2)
    ours = loop.evaluate(state, ploader, pos_th, None, device="cpu")
    assert ours.elected_channel == theirs.elected_channel
    assert ours.max_channel_freq == theirs.max_channel_freq
    assert len(set(theirs.max_channel_freq)) > 1 or pos_th == -1
    for seq, v in theirs.per_sequence.items():
        assert abs(ours.per_sequence[seq] - v) <= 1e-6, (seq, ours.per_sequence[seq], v)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------


def test_run_trains_validates_elects_and_exports(davis_like, tmp_path):
    """The artifacts `test_loop_e2e.test_full_run_trains_validates_elects_and_exports`
    asserts for JAX, from the port's `run` on the CPU."""
    ckpt = tmp_path / "ckpt"
    tree = _tree(davis_like, ckpt)
    tree["tpu"] = {"profile_dir": str(tmp_path / "trace"), "profile_start": 1,
                   "profile_steps": 1, "donate_state": True}
    result = loop.run(Config(tree), device="cpu")
    assert 0.0 <= result.miou <= 1.0 and np.isfinite(result.miou_frame_avg)
    entries = os.listdir(ckpt)
    assert "last" in entries and any(e.startswith("ckpt_") for e in entries)
    assert "object_channel.json" in entries and "config_resolved.yaml" in entries
    assert any(f.endswith("_img_pred_recons.jpg") for f in os.listdir(ckpt / "saved"))
    assert len(os.listdir(ckpt / "saved_eval_test")) > 0
    export_dir = ckpt / "saved_eval_export"
    assert sorted(os.listdir(export_dir)) == ["0", "1", "2", "3"]
    files = sorted(os.listdir(export_dir / "0"))
    assert len(files) == 7 and files[0] == "pred_seg_bear_00000_0000000.png"
    assert os.listdir(tmp_path / "trace") == ["trace_steps1-1.json"]  # torch.profiler, step 1
    records = [json.loads(line) for line in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in records if "train_loss" in r)


def test_resume_continues_at_the_next_epoch(davis_like, tmp_path):
    ckpt = tmp_path / "ckpt"
    tree = _tree(davis_like, ckpt)
    tree["epochs"] = 1
    state1 = loop.run(Config(tree), no_test=True, device="cpu")
    assert state1.step == 1
    tree["epochs"] = 2
    state2 = loop.run(Config(tree), no_test=True, device="cpu")
    assert state2.step == 2
    steps = [json.loads(line).get("step") for line in open(ckpt / "metrics.jsonl")]
    assert [s for s in steps if s is not None] == [1, 2]  # epoch 0 was not run again


@pytest.mark.parametrize("key,value", [("scan_steps", 2), ("fused_optimizer", True),
                                       ("mesh_shape", [2]), ("RCF_DIST", "1")])
def test_what_needs_more_than_one_card_raises(davis_like, tmp_path, monkeypatch, key, value):
    """What does not fit the ranks raises, as it fails in JAX: a mesh_shape other
    than [-1] or the world size, and the multi-process variables set with no
    process group joined. ``scan_steps`` and ``fused_optimizer`` now run
    (tests/test_torch_options.py holds them to JAX)."""
    tree = _tree(davis_like, tmp_path)
    if key == "RCF_DIST":
        monkeypatch.setenv(key, value)
    else:
        tree["tpu"] = {key: value}
    if key in ("scan_steps", "fused_optimizer"):
        loop.check_tpu_keys(Config(tree))
        return
    with pytest.raises((ValueError, RuntimeError), match="mesh_shape|process group"):
        loop.run(Config(tree), device="cpu")


def test_cli_needs_a_card_unless_printing(davis_like, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recipe = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "rcf", "rcf_stage1.yaml")
    opts = ["--opts", "checkpoints_dir", str(tmp_path / "c"), "data_path", str(davis_like)]
    assert cli.main([recipe, "--print-config", *opts]) == 0
    assert "global_batch_size: 16" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([recipe, *opts])
