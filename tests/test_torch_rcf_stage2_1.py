"""The port's RCF stage 2.1 (the CRF target, its loss, its step) against the
JAX package's, on the CPU.

The reduced model of ``test_torch_rcf_step.py`` (ResNet-18 OS8, heads 32
wide, 64^2 frames, 16^2 masks, no dropout) with the stage-2.1 settings of
the DAVIS recipe (the CRF on a 32^2 grid, the MAP-stability exit) and of
the SegTrackv2 recipe (its layout, a fixed 50 iterations), the EMA on:
two train steps against JAX's ``make_train_step(crf_fn=...)`` with the
weights carried by ``rcf_state_from_jax``: the CRF target, ``loss_crf``,
the total loss, the gradients and the EMA. Then what the step must and
must not do around the target, and the full-width build of the three
stage-2.1 YAMLs.
"""

from __future__ import annotations

import copy
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.config import Config, load_config
from rcf_tpu.models import build_model as jax_build_model
from rcf_tpu.ops import resize_bilinear as jax_resize
from rcf_tpu.ops.crf import make_crf_fn as jax_make_crf_fn
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train import make_train_step as jax_make_train_step
from rcf_tpu_torch.convert import rcf_state_from_jax
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.ops import crf as tcrf
from rcf_tpu_torch.train import create_train_state, make_train_step, maybe_crf_fn
from rcf_tpu_torch.train.step import _crf_targets
from test_torch_rcf_step import _batch, _jax_param_counts, _state_dict, _train_cfg, tiny_kwargs
from torch_parity import init_variables, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Losses, relative (the stage-1 step's RTOL_LOSS; measured <= 5.4e-6).
RTOL_LOSS = 1e-4
# The gradients, each leaf's L2 difference over its L2 norm, at steps 1 and 2
# (measured <= 2.2e-5 on the same weights: train-mode BN over few samples
# amplifies summation-order noise; <= 1.6e-2 at step 2, on weights that
# Adam's first update moved apart where a gradient was float noise).
REL_GRAD = (1e-3, 5e-2)
# The EMA's increment per tensor, over the L2 of JAX's (the stage-1 step's
# leaf rule; measured <= 1.8e-2; a tensor left unchanged reads 1).
MAX_EMA_REL = 0.1


def tiny_crf_kwargs(variant: str = "davis") -> dict:
    """The reduced model with its recipe's stage-2.1 settings."""
    kw = tiny_kwargs(variant)
    kw.update(w_entropy=0, w_crf=10.0, crf_use_ema=True, crf_pos_weight=2.0, crf_neg_weight=1.0)
    if variant == "stv2":
        kw.update(w_compactness=0, compactness_head=None)
        kw["crf_head"] = {"type": "CRFHead", "resolution": [32, 32], "chunk": 256}
    else:
        kw["crf_head"] = {"type": "CRFHead", "resolution": [32, 32], "stable_exit": True,
                          "chunk": 256}
    return kw


def _jax_target(jmodel, jstate, imgs, object_channel, crf_fn):
    """JAX's ``_crf_targets`` with the EMA (``rcf_tpu/train/step.py:38-54``)."""
    b, i = imgs.shape[:2]
    flat = imgs.reshape(b * i, *imgs.shape[2:])
    probs = jmodel.apply({"params": jstate.ema_params, "batch_stats": jstate.ema_stats}, flat,
                         train=False, method=jmodel.mask_probs)
    obj = jnp.sum(probs * jax.nn.one_hot(object_channel, probs.shape[-1], dtype=probs.dtype), -1)
    full = jax_resize(obj[..., None], imgs.shape[2:4], jmodel.align_corners)[..., 0]
    target = jax_resize(crf_fn(flat, full)[..., None], tuple(jmodel.mask_size),
                        jmodel.align_corners)[..., 0]
    return target.reshape(b, i, *jmodel.mask_size)


def _jax_grads(jmodel, jstate, batch, target):
    def loss_fn(params):
        (losses, _), _ = jmodel.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, batch["imgs"],
            gt_fw_flows=batch["gt_fw_flows"], gt_bw_flows=batch["gt_bw_flows"],
            crf_target_masks=target, object_channel=0, object_channel_set=True, train=True,
            mutable=["batch_stats"])
        return losses["loss"], losses
    return jax.jit(jax.grad(loss_fn, has_aux=True))(jstate.params)


@pytest.mark.parametrize("variant", ["davis", "stv2"])
def test_stage_2_1_steps_match_jax(variant):
    """Two steps (one per epoch: the learning rate moves), object channel 0:
    the target, every loss, every parameter's gradient and the EMA's increment."""
    cfg = _train_cfg(tiny_crf_kwargs(variant))
    batch = _batch(7)
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    jstate = jax_create_train_state(Config(cfg), jmodel, variables, steps_per_epoch=1)
    jcrf_fn = jax_make_crf_fn(**jmodel.crf_head_kwargs)
    jstep = jax_make_train_step(jmodel, donate=False, crf_fn=jcrf_fn)

    model = build_model(cfg["model_kwargs"], device="cpu")
    model.load_state_dict(_state_dict(jstate))
    state = create_train_state(cfg, model, steps_per_epoch=1)
    crf_fn = maybe_crf_fn(model)
    assert crf_fn.resolution == [32, 32]
    assert crf_fn.params.stable_exit == (variant == "davis")
    step = make_train_step(crf_fn=crf_fn)
    tb = dict({k: to_torch(v) for k, v in batch.items()}, object_channel=0,
              object_channel_set=True)

    for k in range(2):
        jtarget = _jax_target(jmodel, jstate, jb["imgs"], 0, jcrf_fn)
        model.train()
        target = _crf_targets(model, tb["imgs"], 0, crf_fn)
        np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget), err_msg=f"step {k}")
        jgrads, jref = _jax_grads(jmodel, jstate, jb, jtarget)
        before = _state_dict(jstate)
        jstate, jlosses = jstep(jstate, jb, jax.random.PRNGKey(k), jnp.zeros((), jnp.int32),
                                object_channel_set=True)
        assert float(jref["loss_crf"]) == pytest.approx(float(jlosses["loss_crf"]), rel=1e-6)
        losses = step(state, tb)
        assert set(losses) == set(jlosses) == {"loss_warp_seg", "loss_crf", "loss"}
        for name in jlosses:
            np.testing.assert_allclose(float(losses[name]), float(jlosses[name]),
                                       rtol=RTOL_LOSS, err_msg=f"step {k} {name}")
        ref_grads = rcf_state_from_jax({"params": jgrads, "batch_stats": jstate.batch_stats})
        named = dict(model.named_parameters())
        for key, g in ref_grads.items():
            if key in named and named[key].requires_grad:
                rel = float((named[key].grad - g).norm() / g.norm())
                assert rel <= REL_GRAD[k], (k, key, rel)
        ref, ours = _state_dict(jstate), model.state_dict()
        for key in (x for x in ours if "_ema." in x):
            change = ref[key] - before[key]
            rel = float(((ours[key] - before[key]) - change).norm() / change.norm())
            assert rel <= MAX_EMA_REL, (k, key, rel)


def test_step_needs_a_crf_fn():
    """A model with w_crf > 0 and no crf_fn: the step raises, as JAX's
    make_train_step does; maybe_crf_fn gives None for a stage-1 model."""
    cfg = _train_cfg(tiny_crf_kwargs())
    model = build_model(cfg["model_kwargs"], device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=1)
    with pytest.raises(ValueError, match="crf_fn"):
        make_train_step()(state, {k: to_torch(v) for k, v in _batch().items()})
    with pytest.raises(ValueError, match="crf_fn"):
        jax_make_train_step(jax_build_model(cfg["model_kwargs"]), donate=False)
    assert maybe_crf_fn(build_model(tiny_kwargs(), device="cpu")) is None


def test_crf_use_ema_false_raises_as_jax_does():
    """``crf_use_ema: false`` (no recipe sets it): JAX's target applies the main
    weights in training mode with immutable batch statistics, which Flax
    refuses; the port raises too."""
    cfg = _train_cfg(dict(tiny_crf_kwargs(), crf_use_ema=False))
    cfg["model_kwargs"]["crf_head"].update(resolution=[16, 16], refine_iters=2)
    batch = _batch(8)
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    jstate = jax_create_train_state(Config(cfg), jmodel, variables, steps_per_epoch=1)
    jstep = jax_make_train_step(jmodel, donate=False,
                                crf_fn=jax_make_crf_fn(**jmodel.crf_head_kwargs))
    with pytest.raises(flax.errors.ModifyScopeVariableError):
        jstep(jstate, jb, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32), object_channel_set=True)
    model = build_model(cfg["model_kwargs"], device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=1)
    tb = dict({k: to_torch(v) for k, v in batch.items()}, object_channel_set=True)
    with pytest.raises(NotImplementedError, match="crf_use_ema"):
        make_train_step(crf_fn=maybe_crf_fn(model))(state, tb)


def test_target_reads_the_ema_in_eval_mode_and_leaves_it():
    """The target's forward runs the EMA copies in eval mode (their running
    statistics, not the batch's), moves none of their statistics and gives
    them back in training mode; before the object channel is set the step
    makes no target and no loss_crf."""
    cfg = _train_cfg(tiny_crf_kwargs())
    model = build_model(cfg["model_kwargs"], device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=1)
    imgs = to_torch(_batch(9)["imgs"])
    model.train()
    ema = {k: v.clone() for k, v in model.state_dict().items() if "_ema." in k}
    fn = maybe_crf_fn(model)
    target = _crf_targets(model, imgs, 0, fn)
    assert model.backbone2_ema.training and model.decode_head2_ema.training
    assert all(torch.equal(model.state_dict()[k], v) for k, v in ema.items())
    with torch.no_grad():
        model.eval()
        probs = model.mask_probs(imgs.reshape(-1, *imgs.shape[2:]), use_ema=True)
    flat = imgs.reshape(-1, *imgs.shape[2:])
    full = tcrf.resize_bilinear(probs[..., :1], (64, 64))[..., 0]
    expect = tcrf.resize_bilinear(fn(flat, full)[..., None], (16, 16))[..., 0]
    np.testing.assert_array_equal(target.numpy(), expect.reshape(target.shape).numpy())

    step = make_train_step(crf_fn=fn)
    losses = step(state, {k: to_torch(v) for k, v in _batch(9).items()})
    assert "loss_crf" not in losses


@pytest.mark.parametrize("recipe", ["rcf", "rcf_stv2", "rcf_fbms59"])
def test_full_width_stage2_1_recipes_load_strictly(recipe):
    """Each stage-2.1 YAML's model at full width builds (the CRF loss and the EMA
    on), loads JAX's variables (by ``eval_shape``, converted as zeros, the EMA
    copies included) with ``strict=True``, has JAX's parameter count and the
    YAML's CRF settings; chip_smoke.py's two stage-2.1 recipe dicts equal the
    resolved YAMLs."""
    import chip_smoke

    cfg = load_config(os.path.join(REPO, "configs", recipe, "rcf_stage2.1.yaml"))
    kw = cfg.model_kwargs.to_dict()
    if recipe in chip_smoke.RCF_CRF_RECIPES:
        smoke = chip_smoke.RCF_CRF_RECIPES[recipe]
        assert smoke["model_kwargs"] == kw
        assert smoke["compute_dtype"] == cfg.tpu.compute_dtype
        for key, value in smoke["train"].items():
            assert cfg.to_dict()[key] == value, key
    n_params, _, shapes = _jax_param_counts(copy.deepcopy(kw))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    ema = {"params": {k: zeros["params"][k] for k in ("backbone2", "decode_head2")},
           "batch_stats": {k: zeros["batch_stats"][k] for k in ("backbone2", "decode_head2")}}
    model = build_model(kw, device="cpu")
    model.load_state_dict(rcf_state_from_jax(zeros, ema=ema), strict=True)
    assert sum(p.numel() for p in model.parameters() if p.requires_grad) == n_params
    assert model.w_crf == 10.0 and model.crf_use_ema and model.has_ema
    assert (model.crf_pos_weight, model.crf_neg_weight, model.crf_mask_pos_th) == (2.0, 1.0, -1.0)
    jmodel = jax_build_model(kw)
    assert model.crf_head_kwargs == jmodel.crf_head_kwargs
    fn = maybe_crf_fn(model)
    assert fn.resolution == kw["crf_head"]["resolution"]
    assert fn.params.stable_exit == (recipe == "rcf") and fn.params.refine_iters == 50
