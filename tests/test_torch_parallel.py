"""The port's data parallel over ranks (``rcf_tpu_torch/parallel``) on the CPU.

Two ranks are real processes on gloo (``tests/torch_dist_worker.py``: torch
and the port only, a ``file://`` rendezvous in the module's own directory,
so xdist's workers never share a port), spawned once for the module; this
process runs the same cases at world 1 and the JAX package's references
while they run. Each rank's global sample ``j * 2 + rank`` is its row ``j``.

Limits:

* world 2 against the port at world 1, the same code and inputs: losses
  rel 1e-5; the averaged gradients, the largest difference over every
  tensor within 1e-5 of the largest |g|; BN running statistics (the EMA's
  too) within 1e-5 of their scale; the parameters after Adam's first step
  at most 1e-3 of them off by more than 0.1 lr, and the EMA's parameters
  by more than 0.1 lr (1 - ema_m) (where a gradient is float noise its
  sign may flip: the single-process tests' rule);
* world 2 against the JAX package's step on the batch sharded over two
  devices (dropout 0, as the single-process tests run it): the limits of
  ``test_torch_rcf_step.py`` (stage 1, stage 2.1) and ``test_torch_step.py``
  (AMD) at their first step;
* the cross-rank BatchNorm against Flax's on the 8-device mesh, on
  ``test_sync_bn.py``'s skewed shards: output and running mean 1e-5,
  running variance and the gradients 1e-4, each relative to its scale;
* the unFlow loss's occlusion ratio: the same value on both ranks, rel
  1e-6 of world 1's, and each rank's flow gradient over the world size
  within 1e-5 of world 1's, relative to its scale; the same for
  ``dist.global_ratio`` with a denominator that has a gradient (both
  gradients).
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import re
import subprocess
import sys
import time
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from rcf_tpu.config import Config as JaxConfig
from rcf_tpu.models import build_model as jax_build_model
from rcf_tpu.models.amd import build_amd_model as jax_build_amd_model
from rcf_tpu.ops.crf import make_crf_fn as jax_make_crf_fn
from rcf_tpu.parallel import create_mesh, replicate, shard_batch
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train import make_train_step as jax_make_train_step
from rcf_tpu.train import loop as jax_loop
from rcf_tpu.utils import watchdog as jax_watchdog
from rcf_tpu_torch.config import Config
from rcf_tpu_torch.convert import torch_state_from_jax
from rcf_tpu_torch.data import DataLoader
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.parallel import dist
from rcf_tpu_torch.train import checkpoint, create_train_state, loop
from rcf_tpu_torch.utils.watchdog import (COMPILE_GRACE_S, DEFAULT_GRACE_S, Heartbeat,
                                          is_stalled, read_heartbeat, supervise)
from test_torch_rcf_stage2_1 import tiny_crf_kwargs
from test_torch_rcf_step import _batch, _state_dict, _train_cfg, tiny_kwargs
from test_torch_step import CFG as AMD_CFG
from test_torch_step import MODEL_KWARGS as AMD_KWARGS
from test_torch_train_loop import _tree
from torch_parity import assert_close, init_variables

import test_torch_rcf_step as rcf_limits
import test_torch_step as amd_limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD = 2
WALL_S = 240.0  # the two ranks together, every case

# The inputs' seed. The step's gradients are not smooth everywhere (|x| in the
# common-fate and photometric losses, bilinear taps crossing a pixel): where an
# input sits within float noise of such a point, any change of summation order
# moves a gradient by up to 1e-3 of max |g|, at world 1 as much as at world 2
# (measured: 1e-7 relative noise on the frames moves world 1's gradients by
# 1e-4 to 2e-3 on several seeds). On seed 4 the three models sit on none:
# world 2 reads 1.8e-7 (stage 1), 2.2e-7 (stage 2.1), 3.7e-6 (AMD) of max |g|.
SEED = 4
REL_LOSS = 1e-5
REL_GRAD = 1e-5
REL_STATS = 1e-5
MAX_OFF = 1e-3
BN_TOL = {"y": 1e-5, "mean": 1e-5, "var": 1e-4, "dx": 1e-4, "dweight": 1e-4, "dbias": 1e-4}


# ---------------------------------------------------------------------------
# Inputs, the two ranks, and what this process computes meanwhile
# ---------------------------------------------------------------------------


def _narrow(kw: dict) -> dict:
    """The single-process tests' reduced model at a quarter of its widths
    (``stem_channels``/``base_channels`` 16: the JAX ResNet's own options), so
    that the ranks' states stay small; the heads' inputs follow the backbone."""
    kw = copy.deepcopy(kw)
    kw["backbone2"].update(stem_channels=16, base_channels=16)
    kw["decode_head2"].pop("in_channels", None)
    return kw


def _with_dropout(kw: dict, ratio: float = 0.1) -> dict:
    kw = copy.deepcopy(kw)
    for head in ("decode_head2", "decode_head3"):
        if head in kw:
            kw[head]["dropout_ratio"] = ratio
    return kw


def _rcf_case(kw_fn, seed: int, extra: dict | None = None) -> dict:
    """Stage-1 or stage-2.1 specs (dropout on for world 1, off for JAX) on JAX's weights."""
    cfg = _train_cfg(_narrow(kw_fn()))
    batch = _batch(seed, b=4)
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    jstate = jax_create_train_state(JaxConfig(cfg), jmodel, variables, steps_per_epoch=1)
    sd = _state_dict(jstate)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spec = {"amd": False, "model_kwargs": cfg["model_kwargs"], "state_dict": sd, "cfg": cfg,
            "batch": tb, "extra": extra or {}}
    drop_cfg = dict(cfg, model_kwargs=_with_dropout(cfg["model_kwargs"]))
    jax_ref = {"jmodel": jmodel, "jstate": jstate, "batch": batch, "amd": False,
               "crf": "crf_head" in cfg["model_kwargs"], "before": sd}
    return {"jax": spec, "drop": dict(spec, model_kwargs=drop_cfg["model_kwargs"],
                                      cfg=drop_cfg)}, jax_ref


def _amd_case(seed: int):
    imgs = np.random.default_rng(seed).standard_normal((4, 2, 64, 64, 3)).astype(np.float32)
    kw = _narrow(AMD_KWARGS)
    jmodel = jax_build_amd_model(kw)
    variables = init_variables(jmodel, jnp.asarray(imgs), train=True)
    jstate = jax_create_train_state(JaxConfig(AMD_CFG), jmodel, variables, steps_per_epoch=1)
    sd = torch_state_from_jax(variables)
    spec = {"amd": True, "model_kwargs": kw, "state_dict": sd, "cfg": AMD_CFG,
            "batch": {"imgs": torch.from_numpy(imgs)}}
    drop = dict(spec, model_kwargs=_with_dropout(kw))
    return {"jax": spec, "drop": drop}, {"jmodel": jmodel, "jstate": jstate, "amd": True,
                                         "batch": {"imgs": imgs}, "crf": False, "before": sd}


def _jax_sharded_step(ref: dict):
    """JAX's step on the global batch sharded over two devices of the CPU mesh."""
    mesh = create_mesh(devices=jax.devices()[:WORLD])
    jmodel = ref["jmodel"]
    crf_fn = jax_make_crf_fn(**jmodel.crf_head_kwargs) if ref["crf"] else None
    step = jax_make_train_step(jmodel, donate=False, crf_fn=crf_fn)
    state, losses = step(replicate(ref["jstate"], mesh), shard_batch(ref["batch"], mesh),
                         jax.random.PRNGKey(0), jnp.zeros((), jnp.int32),
                         object_channel_set=ref["crf"])
    if ref["amd"]:
        after = torch_state_from_jax({"params": state.params, "batch_stats": state.batch_stats})
    else:
        after = _state_dict(state)
    return {k: float(v) for k, v in losses.items()}, after


def _unflow_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    sizes = [(64, 96), (32, 48), (16, 24), (8, 12), (4, 6)]
    flows = [torch.from_numpy((rng.standard_normal((4, h, w, 4)) * 3).astype(np.float32))
             for h, w in sizes]
    im1, im2 = (torch.from_numpy(rng.uniform(0, 1, (4, 64, 96, 3)).astype(np.float32))
                for _ in range(2))
    return flows, im1, im2


def _ratio_inputs(seed: int = 6):
    """Rows whose ranks' means differ (a rank's own ratio is far from the whole
    batch's)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((8, 5)) * np.arange(1, 9)[:, None]
    b = rng.standard_normal((8, 5)) + np.array([2.0, -2.0] * 4)[:, None]
    return tuple(torch.from_numpy(t.astype(np.float32)) for t in (a, b))


def _eval_inputs(seed: int = 9):
    rng = np.random.default_rng(seed)
    batches = []
    for seqs in (["bear", "bear", "cows"], ["dogs", "dogs"]):  # 3 rows: one pad row at world 2
        b = len(seqs)
        batches.append({
            "imgs": torch.from_numpy(rng.standard_normal((b, 1, 64, 64, 3)).astype(np.float32)),
            "ann": torch.from_numpy(((rng.random((b, 32, 32)) > 0.5) * 255).astype(np.uint8)),
            "seq_names": seqs, "paths": [[f"{s}/{i:05d}.jpg"] for i, s in enumerate(seqs)],
            "seq_ids": torch.arange(b, dtype=torch.int32)})
    return batches


def _world1_last(spec: dict, work) -> str:
    """A world-1 checkpoint (one step of ``spec``) for the ranks to restore."""
    model = build_model(spec["model_kwargs"], device="cpu")
    model.load_state_dict(spec["state_dict"])
    state = create_train_state(spec["cfg"], model, steps_per_epoch=1)
    worker_step = worker.make_train_step()
    worker_step(state, spec["batch"], generator=torch.Generator().manual_seed(1))
    ckpt_dir = os.path.join(work, "ckpt_w1")
    os.makedirs(ckpt_dir, exist_ok=True)
    return checkpoint.save_checkpoint(ckpt_dir, "last", state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, davis_like):
    work = str(tmp_path_factory.mktemp("ranks"))
    s1, s1_ref = _rcf_case(tiny_kwargs, SEED)
    crf, crf_ref = _rcf_case(tiny_crf_kwargs, SEED, {"object_channel": 0,
                                                      "object_channel_set": True})
    amd, amd_ref = _amd_case(SEED)
    steps = {f"{name}_{kind}": spec[kind] for name, spec in
             (("stage1", s1), ("stage2_1", crf), ("amd", amd)) for kind in ("drop", "jax")}
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(3.0 * k, 1.0 + 0.2 * k, (2, 4, 4, 8)) for k in range(8)])
    g = rng.standard_normal(x.shape)
    bn_x, bn_g = (torch.from_numpy(a.astype(np.float32)).permute(0, 3, 1, 2).contiguous()
                  for a in (x, g))
    eval_spec = dict(s1["jax"], batches=_eval_inputs())
    ckpt_spec = dict(s1["drop"], world1_last=_world1_last(s1["drop"], work))
    run_tree = _tree(davis_like, os.path.join(work, "run_w2"), dropout=0.1)
    inputs = {"bn_x": bn_x, "bn_g": bn_g, "steps": steps, "unflow": _unflow_inputs(),
              "ratio": _ratio_inputs(),
              "eval": eval_spec, "checkpoint": ckpt_spec, "run": run_tree}
    torch.save(inputs, os.path.join(work, "inputs.pt"))

    procs, logs = [], []
    for r in range(WORLD):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, WORKER, work, str(r), str(WORLD)],
                                      cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        # JAX (compiling in threads: the AMD step alone takes ~1 min) and world 1
        # (the same functions as the ranks), while the ranks run.
        jax_futures = {name: pool.submit(_jax_sharded_step, ref) for name, ref in
                       (("amd", amd_ref), ("stage1", s1_ref), ("stage2_1", crf_ref))}
        world1 = {name: worker.step_case(spec) for name, spec in steps.items()
                  if name.endswith("_drop")}
        world1["bn"] = worker.bn_case(bn_x, bn_g)
        world1["unflow"] = worker.unflow_case(*inputs["unflow"])
        world1["ratio"] = worker.ratio_case(*inputs["ratio"])
        world1["eval"] = worker.eval_case(eval_spec, os.path.join(work, "w1"))
        w1_tree = _tree(davis_like, os.path.join(work, "run_w1"), dropout=0.1)
        world1["run"] = worker.run_case(w1_tree)
        jax_refs = {name: f.result() for name, f in jax_futures.items()}
        jax_befores = {"stage1": s1_ref["before"], "stage2_1": crf_ref["before"],
                       "amd": amd_ref["before"]}
        for p in procs:
            p.wait(timeout=max(1.0, WALL_S - (time.monotonic() - t0)))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    tails = [open(os.path.join(work, f"rank{r}.log")).read()[-3000:] for r in range(WORLD)]
    assert [p.returncode for p in procs] == [0] * WORLD, tails
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return SimpleNamespace(work=work, outs=outs, world1=world1, jax=jax_refs,
                           jax_before=jax_befores, inputs=inputs)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _max_rel(ours: dict, ref: dict) -> float:
    """Largest |ours - ref| over every tensor, over the largest |ref|."""
    err = max(float((ours[k] - ref[k]).abs().max()) for k in ref)
    return err / max(float(ref[k].abs().max()) for k in ref)


def _off_fraction(ours: dict, ref: dict, lr: float, ema: bool = False) -> float:
    """The fraction of parameters (of the EMA's, with ``ema``) off by more than
    0.1 of a step of ``lr``."""
    keys = [k for k in ref if "running" not in k and ("_ema." in k) == ema]
    off = sum(int(((ours[k] - ref[k]).abs() > 0.1 * lr).sum()) for k in keys)
    return off / max(sum(ref[k].numel() for k in keys), 1)


# ---------------------------------------------------------------------------
# The ranks against world 1 and against JAX
# ---------------------------------------------------------------------------


def test_ranks_joined_and_agree(ranks):
    assert [o["rank"] for o in ranks.outs] == [0, 1]
    assert {o["world"] for o in ranks.outs} == {WORLD}
    assert dist.world() == 1 and dist.rank() == 0  # this process joined no group


@pytest.mark.parametrize("key", sorted(BN_TOL))
def test_cross_rank_batchnorm_matches_flax_on_the_mesh(ranks, key):
    """Skewed shards (per-rank statistics would be far off): the ranks' BN
    against Flax's BatchNorm under global-view jit on the 8-device mesh."""
    from flax import linen as fnn

    from rcf_tpu.parallel.mesh import batch_sharding

    x = ranks.inputs["bn_x"].permute(0, 2, 3, 1).numpy()
    g = ranks.inputs["bn_g"].permute(0, 2, 3, 1).numpy()
    net = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mesh = create_mesh()

    @jax.jit
    def fwd(params, stats, xs):
        def loss(p, xx):
            y, new = net.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, new)
        (_, (y, new)), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                    has_aux=True)(params, xs)
        return y, new["batch_stats"], dp, dx

    y, stats, dp, dx = fwd(replicate(variables["params"], mesh),
                           replicate(variables["batch_stats"], mesh),
                           jax.device_put(x, batch_sharding(mesh)))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    ref = {"y": nchw(y), "dx": nchw(dx), "mean": np.asarray(stats["mean"]),
           "var": np.asarray(stats["var"]), "dweight": np.asarray(dp["scale"]),
           "dbias": np.asarray(dp["bias"])}
    outs = [o["bn"] for o in ranks.outs]
    if key in ("y", "dx"):
        ours = torch.cat([o[key] for o in outs]).numpy()
    elif key in ("dweight", "dbias"):  # each rank's own sums; the step's average completes them
        ours = sum(o[key] for o in outs).numpy()
    else:
        assert torch.equal(outs[0][key], outs[1][key])  # the same statistics on every rank
        ours = outs[0][key].numpy()
    assert_close(ours, ref[key], BN_TOL[key], key)
    # Per-rank statistics would miss the global mean by > 1 on these shards.
    assert np.abs(x[:8].mean((0, 1, 2)) - x.mean((0, 1, 2))).max() > 1.0


STEPS = ("stage1", "stage2_1", "amd")


@pytest.mark.parametrize("model", STEPS)
def test_step_at_world_2_matches_world_1(ranks, model):
    """Dropout on (drawn for the whole batch): the losses, the averaged
    gradients, the BN statistics and the EMA after one step, and the parameters."""
    name = f"{model}_drop"
    w1 = ranks.world1[name]
    lr = ranks.inputs["steps"][name]["cfg"]["learning_rate"]
    for out in ranks.outs:
        ours = out[name]
        assert set(ours["losses"]) == set(w1["losses"])
        for k, v in w1["losses"].items():
            np.testing.assert_allclose(float(ours["losses"][k]), float(v), rtol=REL_LOSS,
                                       err_msg=k)
        assert set(ours["grads"]) == set(w1["grads"])
        assert _max_rel(ours["grads"], w1["grads"]) <= REL_GRAD
        for k in (k for k in w1["state"] if "running" in k):
            assert_close(ours["state"][k].numpy(), w1["state"][k].numpy(), REL_STATS, k)
        assert _off_fraction(ours["state"], w1["state"], lr) <= MAX_OFF
        ema_step = lr * (1.0 - ranks.inputs["steps"][name]["model_kwargs"].get("ema_m", 0.999))
        assert _off_fraction(ours["state"], w1["state"], ema_step, ema=True) <= MAX_OFF
    # Every rank keeps the same state.
    a, b = (o[name]["state"] for o in ranks.outs)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("model", ["stage1", "stage2_1"])
def test_step_collectives_counted_from_the_model(ranks, model):
    """An RCF step's collectives at world 2 in ``dist.STATS``: each BatchNorm
    call in training mode all-reduces 2c + 1 floats forward and 2c backward, the
    gradients one f32 buffer of every parameter that has a gradient, the losses
    one of their count; no broadcast, no gather. At world 1 every value is 0."""
    name = f"{model}_drop"
    w1 = ranks.world1[name]
    assert w1["collectives"] and set(w1["collectives"].values()) == {0}
    for out in (o[name] for o in ranks.outs):
        bn = out["bn_channels"]
        assert bn and bn == w1["bn_channels"]
        grad_numel = sum(g.numel() for g in out["grads"].values())
        floats = sum(4 * c + 1 for c in bn) + grad_numel + len(out["losses"])
        assert out["collectives"] == {"all_reduce_calls": 2 * len(bn) + 2,
                                      "all_reduce_bytes": 4 * floats,
                                      "broadcast_calls": 0, "broadcast_bytes": 0,
                                      "gather_calls": 0, "gather_bytes": 0}


@pytest.mark.parametrize("model", STEPS)
def test_step_at_world_2_matches_the_jax_sharded_step(ranks, model):
    """Dropout 0: the losses and the state after one step against JAX's step on
    the same global batch sharded over two devices."""
    jlosses, ref = ranks.jax[model]
    limits = amd_limits if model == "amd" else rcf_limits
    before = ranks.jax_before[model]
    ours = ranks.outs[0][f"{model}_jax"]
    lr = ranks.inputs["steps"][f"{model}_jax"]["cfg"]["learning_rate"]
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(ours["losses"][k]), v, rtol=limits.RTOL_LOSS, err_msg=k)
    state = ours["state"]
    n_off = n_all = 0
    for key, t in ref.items():
        if "running" in key and "_ema." not in key:
            assert_close(state[key].numpy(), t.numpy(), limits.REL_STATS, key)
            continue
        change = t - before[key]
        diff = (state[key] - before[key]) - change if "_ema." in key else state[key] - t
        if float(change.norm()) > 0:
            assert float(diff.norm() / change.norm()) <= limits.MAX_LEAF_REL[0], key
        if "_ema." not in key and "running" not in key:
            n_off += int((diff.abs() > 0.1 * lr).sum())
            n_all += diff.numel()
    assert n_off <= limits.MAX_OFF_FRACTION[0] * n_all


def test_occlusion_ratio_is_the_whole_batch_ratio(ranks):
    """unFlow's sum(mean(l)) / mean(occu): the same value on every rank, the
    whole batch's, and gradients that average to world 1's."""
    w1 = ranks.world1["unflow"]
    dflow = torch.empty_like(w1["dflow0"])
    for r, out in enumerate(ranks.outs):
        np.testing.assert_allclose(float(out["unflow"]["loss"]), float(w1["loss"]), rtol=1e-6)
        dflow[r::WORLD] = out["unflow"]["dflow0"] / WORLD
    assert_close(dflow.numpy(), w1["dflow0"].numpy(), 1e-5, "dflow0")
    # A rank's own ratio would differ: the split matters here.
    mine = worker.unflow_loss([f[0::WORLD] for f in ranks.inputs["unflow"][0]],
                              ranks.inputs["unflow"][1][0::WORLD],
                              ranks.inputs["unflow"][2][0::WORLD])[0]
    assert abs(float(mine) - float(w1["loss"])) > 1e-4 * abs(float(w1["loss"]))


@pytest.mark.parametrize("key", ["value", "da", "db"])
def test_global_ratio_is_the_whole_batch_ratio_with_both_gradients(ranks, key):
    """``dist.global_ratio`` where the denominator has a gradient too (unFlow's
    occlusion mask has none, so the loss alone cannot see its term): the
    value on every rank rel 1e-6 of world 1's, and each rank's gradients over
    the world size, in the numerator's and the denominator's inputs, within
    1e-5 of world 1's, relative to their scale."""
    w1 = ranks.world1["ratio"]
    if key == "value":
        for out in ranks.outs:
            np.testing.assert_allclose(float(out["ratio"]["value"]), float(w1["value"]),
                                       rtol=1e-6)
        a, b = ranks.inputs["ratio"]
        mine = float(worker.ratio_case(a[0::WORLD], b[0::WORLD])["value"])
        assert abs(mine - float(w1["value"])) > 1e-2 * abs(float(w1["value"]))
        return
    grad = torch.empty_like(w1[key])
    for r, out in enumerate(ranks.outs):
        grad[r::WORLD] = out["ratio"][key] / WORLD
    assert_close(grad.numpy(), w1[key].numpy(), 1e-5, key)


# ---------------------------------------------------------------------------
# Eval, checkpoints and the loop at world 2
# ---------------------------------------------------------------------------


def test_eval_at_world_2_same_metrics_one_export_rank0_visualizations(ranks):
    w1 = ranks.world1["eval"]
    outs = [o["eval"] for o in ranks.outs]
    for out in outs:
        assert out["elected"] == w1["elected"]
        assert out["miou"] == pytest.approx(w1["miou"], abs=1e-12)
        assert out["miou_frame_avg"] == pytest.approx(w1["miou_frame_avg"], abs=1e-12)
    written = [set(o["written"]) for o in outs]
    assert not written[0] & written[1]
    assert written[0] | written[1] == set(w1["written"])
    for r, names in enumerate(written):
        assert all(zlib.crc32(n.split("pred_seg_")[1].split("_")[0].encode()) % WORLD == r
                   for n in names)
    assert outs[0]["vis"] == w1["vis"] and len(w1["vis"]) == 2 and outs[1]["vis"] == []


def test_checkpoints_written_by_rank_0_and_resumed_across_worlds(ranks):
    """Rank 0 alone writes; both ranks keep the same top-k; a world-1 ``last``
    restores at world 2 and a world-2 ``last`` at world 1, bit for bit."""
    outs = [o["checkpoint"] for o in ranks.outs]
    assert outs[0]["writes"] == ["last", "ckpt_e0_miou0.5000", "last", "ckpt_e1_miou0.2500",
                                 "last", "ckpt_e2_miou0.7500"]
    assert outs[1]["writes"] == []
    assert outs[0]["kept"] == outs[1]["kept"] == [(0.75, "ckpt_e2_miou0.7500"),
                                                  (0.5, "ckpt_e0_miou0.5000")]
    ckpt_dir = os.path.join(ranks.work, "ckpt_w2")
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_e0_miou0.5000", "ckpt_e2_miou0.7500", "last",
                                            "last.prev", "topk.json"]
    w1_saved = checkpoint.read_checkpoint(ranks.inputs["checkpoint"]["world1_last"])
    for out in outs:
        assert all(torch.equal(out["restored"][k], v)
                   for k, v in ((k[len("model."):], v)
                                for k, v in w1_saved["state_dict"].items()))
    spec = ranks.inputs["checkpoint"]
    model = build_model(spec["model_kwargs"], device="cpu")
    state = checkpoint.restore_checkpoint(os.path.join(ckpt_dir, "last"),
                                          create_train_state(spec["cfg"], model, 1))
    assert state.step == outs[0]["step"] == 2
    assert all(torch.equal(v, outs[0]["saved"][k]) for k, v in model.state_dict().items())


def test_loop_at_world_2_reads_as_world_1(ranks):
    """``loop.run`` (two epochs, validation, election, checkpoints, test with
    export) at world 2 against world 1: the same election, the same logged
    losses in one ``metrics.jsonl`` (rel 1e-5), every file written once, a
    heartbeat file a rank. The mIoUs after training agree to 1e-3: Adam's
    first steps move the weights by lr * sign(g), and where a gradient is
    float noise that sign differs, which flips a few pixels of the masks."""
    w1, outs = ranks.world1["run"], [o["run"] for o in ranks.outs]
    for out in outs:
        assert out["elected"] == w1["elected"]
        assert out["miou"] == pytest.approx(w1["miou"], abs=1e-3)
    d1, d2 = (os.path.join(ranks.work, d) for d in ("run_w1", "run_w2"))
    recs = [[json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
            for d in (d1, d2)]
    assert [sorted(r) for r in recs[0]] == [sorted(r) for r in recs[1]]
    for a, b in zip(*recs):
        for k in a:
            if k.startswith("train_loss") or k in ("object_channel", "train_frames"):
                assert b[k] == pytest.approx(a[k], rel=1e-5, abs=1e-7), k
            elif k in ("val_miou", "val_miou_frame_avg"):
                assert b[k] == pytest.approx(a[k], abs=1e-3), k
    assert os.path.isfile(os.path.join(d2, ".heartbeat"))
    assert os.path.isfile(os.path.join(d2, ".heartbeat.h1"))
    def listing(d):  # the top-k names carry the mIoU's 4 decimals
        return sorted(re.sub(r"miou[0-9.]+", "miou", os.path.relpath(os.path.join(p, f), d))
                      for p, _, fs in os.walk(d) for f in fs
                      if not f.startswith(".heartbeat") and f != "metrics.jsonl")
    assert listing(d2) == listing(d1)


def test_loop_records_count_each_steps_collectives(ranks):
    """Each step's record in ``metrics.jsonl`` holds its collectives: the same
    all-reduces every step at world 2 and none in the step itself at world 1."""
    steps = [[r for r in map(json.loads, open(os.path.join(ranks.work, d, "metrics.jsonl")))
              if "step" in r] for d in ("run_w1", "run_w2")]
    assert steps[0] and len(steps[0]) == len(steps[1])
    assert all(r[k] == 0 for r in steps[0] for k in r if k.startswith("dist_"))
    calls = {r["dist_all_reduce_calls"] for r in steps[1]}
    assert len(calls) == 1 and calls.pop() > 2
    assert all(r["dist_all_reduce_bytes"] > 0 and r["dist_broadcast_calls"] == 0
               and r["dist_gather_calls"] == 0 for r in steps[1])


# ---------------------------------------------------------------------------
# The loader's plan over ranks, and the JAX loader's per-process batch
# ---------------------------------------------------------------------------


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n", [7, 10, 32, 40])
def test_rank_batches_union_is_the_world_1_batch(n):
    """Rank r's row j is row j * world + r of the world-1 batch at every step
    (the padded epoch divides evenly here)."""
    for epoch in range(2):
        one = DataLoader(_Indices(n), None, batch_size=8, shuffle=True, seed=3)
        parts = [DataLoader(_Indices(n), None, batch_size=8 // WORLD, shuffle=True, seed=3,
                            shard_index=r, num_shards=WORLD) for r in range(WORLD)]
        for loader in (one, *parts):
            loader.set_epoch(epoch)
        assert len(one) == len(parts[0]) == len(parts[1])
        for b1, *bs in zip(one.batches_of_indices(), *(p.batches_of_indices() for p in parts)):
            merged = np.empty_like(b1)
            for r, b in enumerate(bs):
                merged[r::WORLD] = b
            np.testing.assert_array_equal(merged, b1)


def test_rank_batch_is_the_global_batch_over_the_world(monkeypatch, davis_like, tmp_path):
    cfg = Config(_tree(davis_like, tmp_path))
    assert loop.rank_batch_size(cfg) == 8
    monkeypatch.setattr(dist, "world", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    loader = loop._build_loaders(cfg, training=True)
    assert (loader.batch_size, loader.shard_index, loader.num_shards) == (4, 1, 2)
    monkeypatch.setattr(dist, "world", lambda: 3)
    with pytest.raises(ValueError, match="does not divide"):
        loop.rank_batch_size(cfg)


def test_jax_multiprocess_loader_gives_each_process_the_global_batch(monkeypatch, davis_like,
                                                                     tmp_path):
    """The deviation the port does not copy: JAX's loader under two processes
    gives each process ``global_batch_size`` rows, so a step sees 2 x 8; the
    port's ranks load 4 each, the recipe's 8 in all."""
    tree = _tree(davis_like, tmp_path)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    jloader = jax_loop._build_loaders(JaxConfig(tree), training=True)
    assert (jloader.batch_size, jloader.num_shards) == (8, 2)
    monkeypatch.setattr(dist, "world", lambda: 2)
    monkeypatch.setattr(dist, "rank", lambda: 1)
    assert loop._build_loaders(Config(tree), training=True).batch_size == 4


@pytest.mark.parametrize("shape,ok", [([-1], True), ([1], True), ([2], False), ([1, 1], False),
                                      ([0], False)])
def test_mesh_shape_must_describe_the_ranks(shape, ok):
    """As JAX's create_mesh: one data axis, -1 or the device count."""
    if ok:
        dist.check_mesh_shape(shape, 1)
        jax_devices = jax.devices()[:1]
        create_mesh(tuple(shape), devices=jax_devices)
        return
    with pytest.raises(ValueError, match="mesh_shape"):
        dist.check_mesh_shape(shape, 1)
    with pytest.raises(Exception):
        create_mesh(tuple(shape), devices=jax.devices()[:1])


def test_init_needs_variables_and_a_card_unless_cpu(monkeypatch):
    for var in ("RCF_COORDINATOR", "RCF_DIST"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RCF_COORDINATOR"):
        dist.init_distributed(device="cpu")
    monkeypatch.setenv("RCF_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("RCF_NUM_PROCESSES", "2")
    monkeypatch.setenv("RCF_PROCESS_ID", "0")
    monkeypatch.setenv("RCF_LOCAL_DEVICE_IDS", "0,1")
    with pytest.raises(ValueError, match="one card a process"):
        dist.init_distributed(device="cpu")
    monkeypatch.setenv("RCF_LOCAL_DEVICE_IDS", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_distributed()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# The watchdog (tests/test_watchdog.py's cases against the port's functions)
# ---------------------------------------------------------------------------


def _child(body: str, *args) -> str:
    return ("import sys, time, threading; sys.path.insert(0, %r); "
            "from rcf_tpu_torch.utils.watchdog import Heartbeat; " % REPO) + body % args


def test_heartbeat_roundtrip(tmp_path):
    hb = Heartbeat(str(tmp_path))
    hb.beat()
    t, grace = read_heartbeat(hb.path, not_before=0.0)
    assert grace == DEFAULT_GRACE_S and abs(t - time.time()) < 5.0
    hb.beat(COMPILE_GRACE_S)
    assert read_heartbeat(hb.path, not_before=0.0)[1] == COMPILE_GRACE_S


def test_heartbeat_disabled_is_noop(tmp_path):
    Heartbeat(None).beat()
    hb = Heartbeat(str(tmp_path), enabled=False)
    hb.beat()
    assert not os.path.exists(hb.path)


def test_missing_or_stale_file_gets_startup_grace(tmp_path):
    path = str(tmp_path / ".heartbeat")
    start = time.time()
    assert read_heartbeat(path, not_before=start) == (start, COMPILE_GRACE_S)
    assert not is_stalled(path, start, now=start + COMPILE_GRACE_S - 1)
    assert is_stalled(path, start, now=start + COMPILE_GRACE_S + 1)
    Heartbeat(str(tmp_path)).beat(grace=1.0)
    later = time.time() + 60.0
    assert read_heartbeat(path, not_before=later) == (later, COMPILE_GRACE_S)


def test_corrupt_file_degrades_to_startup_grace(tmp_path):
    path = str(tmp_path / ".heartbeat")
    with open(path, "w") as f:
        f.write("not-a-number")
    assert read_heartbeat(path, os.path.getmtime(path) - 1.0)[1] == COMPILE_GRACE_S


def test_fresh_beat_with_default_grace(tmp_path):
    hb = Heartbeat(str(tmp_path))
    start = time.time() - 10.0
    hb.beat()
    assert not is_stalled(hb.path, start)
    hb.beat(grace=0.0)
    time.sleep(0.05)
    assert is_stalled(hb.path, start)


def test_supervise_healthy_child_passes_through_rc(tmp_path):
    rc, stalled = supervise([sys.executable, "-c", "raise SystemExit(7)"],
                            str(tmp_path / ".heartbeat"), str(tmp_path / "log"), poll_s=0.1)
    assert (rc, stalled) == (7, False)


def test_supervise_kills_stalled_child(tmp_path):
    child = _child("hb = Heartbeat(%r); hb.beat(grace=0.5); print('beaten', flush=True); "
                   "time.sleep(600)", str(tmp_path))
    t0 = time.time()
    rc, stalled = supervise([sys.executable, "-c", child], str(tmp_path / ".heartbeat"),
                            str(tmp_path / "log"), poll_s=0.1)
    assert (rc, stalled) == (None, True) and time.time() - t0 < 60.0
    assert "beaten" in open(tmp_path / "log").read()


def test_supervise_timeout_kills_even_with_live_heartbeat(tmp_path):
    Heartbeat(str(tmp_path)).beat(grace=9999.0)
    rc, stalled = supervise([sys.executable, "-c", "import time\nwhile True: time.sleep(0.1)"],
                            str(tmp_path / ".heartbeat"), str(tmp_path / "log"), poll_s=0.1,
                            timeout_s=1.0)
    assert (rc, stalled) == (None, True)


def test_supervise_never_deadlocks_on_chatty_child(tmp_path):
    rc, stalled = supervise([sys.executable, "-c", "import sys\nsys.stdout.write('x' * 300000)\n"],
                            str(tmp_path / ".heartbeat"), str(tmp_path / "log"), poll_s=0.1)
    assert (rc, stalled) == (0, False)
    assert os.path.getsize(tmp_path / "log") == 300000


def test_per_rank_heartbeat_files_and_any_rank_stall(tmp_path):
    start = time.time() - 5.0
    hb0, hb1 = Heartbeat(str(tmp_path), host=0), Heartbeat(str(tmp_path), host=1)
    assert hb0.path.endswith(".heartbeat") and hb1.path.endswith(".heartbeat.h1")
    hb0.beat()
    hb1.beat()
    assert not is_stalled(hb0.path, start)
    hb1.beat(grace=0.0)
    time.sleep(0.05)
    hb0.beat()
    assert is_stalled(hb0.path, start)


def test_stale_sibling_from_previous_run_is_ignored(tmp_path):
    hb0, hb1 = Heartbeat(str(tmp_path), host=0), Heartbeat(str(tmp_path), host=1)
    hb1.beat(grace=0.0)
    time.sleep(0.05)
    start = time.time()
    hb0.beat()
    assert not is_stalled(hb0.path, start)


def test_beat_scratch_file_not_seen_as_rank_file(tmp_path):
    Heartbeat(str(tmp_path), host=1).beat()
    assert sorted(os.listdir(tmp_path)) == [".heartbeat.h1"]


def test_supervise_kills_when_nonzero_rank_stalls(tmp_path):
    child = _child("hb0 = Heartbeat(%r, host=0); hb1 = Heartbeat(%r, host=1); "
                   "hb1.beat(grace=0.5); threading.Thread(target=lambda: [hb0.beat(60.0) or "
                   "time.sleep(0.2) for _ in range(3000)], daemon=True).start(); "
                   "print('beaten', flush=True); time.sleep(600)", str(tmp_path), str(tmp_path))
    t0 = time.time()
    rc, stalled = supervise([sys.executable, "-c", child], str(tmp_path / ".heartbeat"),
                            str(tmp_path / "log"), poll_s=0.1)
    assert (rc, stalled) == (None, True) and time.time() - t0 < 60.0


def test_port_and_jax_heartbeats_read_each_other(tmp_path):
    """One file format: the JAX package's monitor reads the port's beats and back."""
    start = time.time() - 5.0
    Heartbeat(str(tmp_path), host=1).beat(grace=0.0)
    jax_watchdog.Heartbeat(str(tmp_path)).beat(grace=123.0)
    time.sleep(0.05)
    path = str(tmp_path / ".heartbeat")
    assert read_heartbeat(path, start)[1] == jax_watchdog.read_heartbeat(path, start)[1] == 123.0
    assert is_stalled(path, start) and jax_watchdog.is_stalled(path, start)
