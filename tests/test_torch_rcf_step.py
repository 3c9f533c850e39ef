"""The port's RCF stage-1 model and steps against the JAX package, on the CPU.

A reduced model (ResNet-18 OS8, heads 32 wide, 64^2 frames, 16^2 masks:
``in_channels`` [64, 512] and 1024) in three variants: the DAVIS recipe's
layout (resize_concat mask head, free residual, entropy), the STv2
recipe's (input_transform null, affine WLS, compactness on channel 0, 8^2
masks), and one that reaches the remaining branches (mask resize,
object-aware sharpening, the pseudo-label loss, compactness on a device
object channel, the joint residual, the outlier-robust loss). Then the
bf16 forward, two train steps with the EMA, the eval step from the main
and the EMA weights, and the full-width build of the three stage-1 YAMLs
(the stage-2.1 ones: ``test_torch_rcf_stage2_1.py``).
Weights are drawn with numpy in JAX's shapes and converted; dropout is 0.
"""

from __future__ import annotations

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.config import Config, load_config
from rcf_tpu.models import build_model as jax_build_model
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train import make_train_step as jax_make_train_step
from rcf_tpu.train.step import make_eval_step as jax_make_eval_step
from rcf_tpu_torch.convert import rcf_state_from_jax
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from torch_parity import assert_close, init_variables, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Losses of the f32 forward, relative, and the mask probabilities over their
# scale (measured <= 1.8e-5: train-mode BN over few samples a channel
# amplifies the convolutions' summation-order noise).
RTOL_LOSS = 1e-4
REL_PROBS = 5e-5
# bf16 forward against JAX's bf16 forward, both classifiers at their real
# init scale (normal, 0.01). Over input seeds 4-9, both variants, for the
# port and, as the control, for JAX's f32 forward rounded to bf16 at the end
# (what a port that computed in f32 and cast only at the end would give):
# - every loss, relative, the worst key (RTOL_LOSS_BF16): port 5.7e-5 to
#   7.6e-4, the control 1.3e-3 to 2.0e-3 on DAVIS and 1.85e-3 to 1.87e-3 on
#   STv2 (there only the entropy loss, f32 against JAX's bf16 scalar, tells
#   them apart);
# - the probabilities, max abs (ATOL_PROBS_BF16): port <= 3.9e-3 (one bf16
#   step at 0.5), the control <= 2.9e-3: no reading of the probabilities
#   separates the two;
# - what separates them at the convolutions: the mask head's logits, their
#   RMS distance to JAX's f32 logits over that of JAX's bf16 logits
#   (LOGIT_DEV_BF16): port 1.12 to 1.36, the control 0.096 to 0.14;
# - the same logits' RMS distance to JAX's bf16 logits over the same gap
#   (LOGIT_ERR_BF16): port 1.25 to 1.43 (the control 1.0): eager PyTorch
#   rounds every op's output to bf16, XLA on the CPU keeps a fusion's
#   intermediates in f32.
# The entropy loss is bit-equal (tests/test_torch_rcf_modules.py holds the
# step-by-step softmax and quirk_log to JAX's bf16 rounding). With he-normal
# classifiers the softmax saturates and the gaps grow tenfold.
# `PYTHONPATH=. python tests/test_torch_rcf_step.py` prints these numbers.
RTOL_LOSS_BF16 = 1e-3
ATOL_PROBS_BF16 = 4e-3
LOGIT_DEV_BF16 = (0.5, 2.0)
LOGIT_ERR_BF16 = 2.0
# Train steps, as tests/test_torch_step.py holds the AMD step (losses at
# RTOL_LOSS: measured <= 1.5e-6): BN running statistics against their own
# scale (measured <= 9e-7); the fraction of parameters whose update differs
# from JAX's by > 0.1 lr (measured 2.0e-4 and 6.4e-3 after steps 1 and 2: a
# sign flip of Adam's first update where a gradient is float noise); each
# parameter tensor's L2 difference, and each EMA tensor's increment's, over
# the L2 of JAX's change (parameters 4.3e-2 and 8.4e-2, EMA parameters
# 4.3e-2 and 5.5e-2, EMA statistics 1.8e-5 and 8.9e-5). A tensor left
# unchanged reads 1, a sign error 2.
REL_STATS = 1e-3
MAX_OFF_FRACTION = (1e-3, 1e-2)
MAX_LEAF_REL = (0.1, 0.2)
# Eval-mode probabilities (measured <= 3.4e-5: on the random running
# statistics the activations grow layer by layer and the logits with them).
REL_EVAL = 1e-4


def tiny_kwargs(variant: str = "davis") -> dict:
    """The reduced model_kwargs of a variant (the verify skill's tiny config)."""
    kw = {
        "w_seg": 1.0, "w_sharpen": 0, "w_entropy": 0.05, "separate_residual": True,
        "mask_layer": 4, "align_corners": False, "mask_size": [16, 16],
        "backbone2": {"type": "ResNet", "depth": 18, "num_stages": 4,
                      "out_indices": [0, 1, 2, 3], "strides": [1, 2, 1, 1],
                      "dilations": [1, 1, 2, 4], "contract_dilation": True,
                      "norm_cfg": {"type": "SyncBN", "requires_grad": True},
                      "norm_eval": False, "style": "pytorch"},
        "decode_head": {"type": "FlowAggregationHeadWithResidual", "mask_layer": 4,
                        "flow_feat_before_agg_kernel_size": 3, "num_flow_feat_channels": 64,
                        "mask_size": [16, 16], "norm_flow": False, "clamp_flow_t": 20.0,
                        "free_residual": True, "free_residual_with_affine": False,
                        "outlier_robust_loss": False, "allow_residual_resize": True,
                        "residual_adjustment_scale": 10.0, "pred_div_coeff": 10.0},
        "decode_head2": {"type": "FCNHead", "input_transform": "resize_concat",
                         "in_channels": [64, 512], "in_index": [0, 3], "channels": 32,
                         "num_convs": 2, "dilation": 6, "dropout_ratio": 0.0, "num_classes": 4,
                         "concat_input": False, "align_corners": False},
        "decode_head3": {"type": "FCNHead", "in_channels": 1024, "in_index": -1,
                         "channels": 32, "num_convs": 2, "dilation": 6, "dropout_ratio": 0.0,
                         "num_classes": 16, "concat_input": False, "align_corners": False},
    }
    if variant == "stv2":
        kw.update(mask_size=[8, 8], allow_mask_resize=False, w_compactness=1.0,
                  compactness_head={"type": "CompactnessHead", "compact_channel": 0})
        kw["decode_head"].update(mask_size=[8, 8], free_residual=False,
                                 free_residual_with_affine=True, allow_residual_resize=False)
        kw["decode_head2"].update(input_transform=None, in_channels=512, in_index=3)
    elif variant == "branches":
        kw.update(allow_mask_resize=True, w_sharpen=0.5, object_aware_sharpening=True,
                  w_pl=1.0, w_compactness=0.5, separate_residual=False,
                  compactness_head={"type": "CompactnessHead", "compact_channel": -1})
        kw["decode_head"].update(outlier_robust_loss=True, free_residual_with_affine=True)
        kw["decode_head2"].update(input_transform=None, in_channels=512, in_index=3)
        kw["decode_head3"].update(num_classes=8)
    return kw


def _batch(seed=0, b=2, hw=64, pl=False):
    rng = np.random.default_rng(seed)
    batch = {"imgs": rng.standard_normal((b, 2, hw, hw, 3)).astype(np.float32),
             "gt_fw_flows": (rng.standard_normal((b, 1, hw, hw, 2)) * 5).astype(np.float32),
             "gt_bw_flows": (rng.standard_normal((b, 1, hw, hw, 2)) * 5).astype(np.float32)}
    if pl:
        batch["pl_masks"] = rng.uniform(0, 1, (b, 2, hw // 2, hw // 2)).astype(np.float32)
    return batch


def _jax_forward(jmodel, variables, batch, object_channel=0, object_channel_set=False):
    def fwd(v, b, oc):
        return jmodel.apply(v, b["imgs"], b["gt_fw_flows"], b["gt_bw_flows"],
                            pl_masks=b.get("pl_masks"), object_channel=oc,
                            object_channel_set=object_channel_set, train=True,
                            mutable=["batch_stats"])
    (losses, probs), _ = jax.jit(fwd)(variables, jax.tree_util.tree_map(jnp.asarray, batch),
                                      jnp.asarray(object_channel, jnp.int32))
    return losses, probs


def _models(kw, batch, dtype=torch.float32, jdtype=jnp.float32):
    jmodel = jax_build_model(kw, dtype=jdtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "pl_masks"}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    model = build_model(kw, device="cpu", dtype=dtype)
    model.load_state_dict(rcf_state_from_jax(variables))
    return jmodel, variables, model


VARIANTS = {"davis": {}, "stv2": {},
            "branches": {"object_channel": 2, "object_channel_set": True}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rcf_forward_matches_jax(variant):
    """Every loss key and the probabilities of the training forward."""
    opts = VARIANTS[variant]
    batch = _batch(pl=variant == "branches")
    jmodel, variables, model = _models(tiny_kwargs(variant), batch)
    jlosses, jprobs = _jax_forward(jmodel, variables, batch, **opts)
    tb = {k: to_torch(v) for k, v in batch.items()}
    if "object_channel" in opts:  # a device channel, as an elected one stays on the card
        opts = dict(opts, object_channel=torch.tensor(opts["object_channel"]))
    losses, probs = model(**tb, **opts)
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=RTOL_LOSS,
                                   err_msg=k)
    assert_close(probs.detach().numpy(), np.asarray(jprobs), REL_PROBS, "probs")


def _bf16_case(variant, seed):
    """JAX's f32 and bf16 forwards and the port's bf16 one, the classifiers at
    their init scale: {"jax32", "jax16", "port"}, each (losses, probs, mask
    logits in f32)."""
    batch = _batch(seed)
    kw = tiny_kwargs(variant)
    jmodel, variables, model = _models(kw, batch, torch.bfloat16, jnp.bfloat16)
    for head in ("decode_head2", "decode_head3"):
        seg = variables["params"][head]["conv_seg"]
        seg["kernel"] = (seg["kernel"] / seg["kernel"].std() * 0.01).astype(np.float32)
    model.load_state_dict(rcf_state_from_jax(variables))
    imgs = jnp.asarray(batch["imgs"].reshape(-1, *batch["imgs"].shape[2:]))

    def jax_case(m):
        logits, _ = jax.jit(lambda v, x: m.apply(v, x, train=True, method=m.mask_logits,
                                                 mutable=["batch_stats"]))(variables, imgs)
        return (*_jax_forward(m, variables, batch), np.asarray(logits, np.float32))

    out = {"jax32": jax_case(jax_build_model(kw)), "jax16": jax_case(jmodel)}
    with torch.no_grad():
        tb = {k: to_torch(v) for k, v in batch.items()}
        out["port"] = (*model(**tb), model.mask_logits(to_torch(np.asarray(imgs))).float().numpy())
    return out


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _bf16_readings(case, losses, probs, logits) -> dict:
    """A bf16 forward's readings against JAX's (see RTOL_LOSS_BF16 above)."""
    jlosses, jprobs, jlogits = case["jax16"]
    gap = _rms(jlogits - case["jax32"][2])
    return {"loss_rel": max(abs(float(losses[k]) - float(jlosses[k])) / abs(float(jlosses[k]))
                            for k in jlosses),
            "probs_err": float(np.abs(np.asarray(probs, np.float32)
                                      - np.asarray(jprobs, np.float32)).max()),
            "logit_dev": _rms(logits - case["jax32"][2]) / gap,
            "logit_err": _rms(logits - jlogits) / gap}


def _bf16_failures(r: dict) -> list:
    held = {"loss_rel": r["loss_rel"] <= RTOL_LOSS_BF16,
            "probs_err": r["probs_err"] <= ATOL_PROBS_BF16,
            "logit_dev": LOGIT_DEV_BF16[0] <= r["logit_dev"] <= LOGIT_DEV_BF16[1],
            "logit_err": r["logit_err"] <= LOGIT_ERR_BF16}
    return [k for k, ok in held.items() if not ok]


def _f32_control(case):
    """JAX's f32 forward with its probabilities and logits rounded to bf16."""
    losses, probs, logits = case["jax32"]
    rnd = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return losses, rnd(probs), rnd(logits)


@pytest.mark.parametrize("variant", ["davis", "stv2"])
def test_rcf_forward_bf16_matches_jax(variant):
    """The port's bf16 forward within JAX's bf16 limits above, and JAX's own f32
    forward, rounded to bf16 at the end, outside them."""
    case = _bf16_case(variant, 4)
    (jlosses, jprobs, _), (losses, probs, logits) = case["jax16"], case["port"]
    assert probs.dtype == torch.bfloat16 and jprobs.dtype == jnp.bfloat16
    assert set(losses) == set(jlosses)
    for k in jlosses:  # f32, and bf16 where JAX gives bf16 (the entropy loss)
        assert losses[k].dtype == getattr(torch, str(jlosses[k].dtype)), k
    ours = _bf16_readings(case, losses, probs.float().numpy(), logits)
    assert _bf16_failures(ours) == [], ours
    control = _bf16_readings(case, *_f32_control(case))
    assert {"loss_rel", "logit_dev"} <= set(_bf16_failures(control)), control


def _measure_bf16_gaps(seeds=range(4, 10)):
    """Print the readings behind RTOL_LOSS_BF16 .. LOGIT_ERR_BF16."""
    for variant in ("davis", "stv2"):
        for seed in seeds:
            case = _bf16_case(variant, seed)
            losses, probs, logits = case["port"]
            for name, r in (("port", _bf16_readings(case, losses, probs.float().numpy(), logits)),
                            ("f32 control", _bf16_readings(case, *_f32_control(case)))):
                print(f"{variant} seed {seed} {name}: "
                      + ", ".join(f"{k} {v:.2e}" for k, v in r.items()), flush=True)


# The recipe's Adam and schedule; weight decay raised from 1e-4 so that the
# L2-before-moments term shows in the updates, and the EMA on. ema_m 0.9 in
# place of the recipe's 0.999: at 0.999 a step moves an EMA weight of ~1 by
# ~1e-7, under f32's resolution there (1.2e-7), and the two frameworks'
# roundings of the lerp differ by that much.
def _train_cfg(kw, ema_m=0.9):
    kw = copy.deepcopy(kw)
    kw["backbone2"]["create_ema"] = True
    kw["decode_head2"]["create_ema"] = True
    kw["ema_m"] = ema_m
    return {"optimizer": "adam", "learning_rate": 1e-4, "weight_decay": 0.05, "epochs": 8,
            "lr_scheduler_kwargs": {"power": 0.9, "min_lr": 1e-6}, "model_kwargs": kw}


def _state_dict(jstate):
    return rcf_state_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                              ema={"params": jstate.ema_params, "batch_stats": jstate.ema_stats})


def test_two_train_steps_with_ema_match_jax():
    """Losses, every parameter, the BN statistics and the EMA's increment after
    each of two steps (one step per epoch: the learning rate moves)."""
    cfg = _train_cfg(tiny_kwargs("davis"))
    batch = _batch(2)
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    jstate = jax_create_train_state(Config(cfg), jmodel, variables, steps_per_epoch=1)
    jstep = jax_make_train_step(jmodel, donate=False)

    model = build_model(cfg["model_kwargs"], device="cpu")
    model.load_state_dict(_state_dict(jstate))  # strict: the EMA copies included
    state = create_train_state(cfg, model, steps_per_epoch=1)
    assert state.ema_m == 0.9
    step = make_train_step()
    tb = {k: to_torch(v) for k, v in batch.items()}

    for k in range(2):
        before = _state_dict(jstate)
        jstate, jlosses = jstep(jstate, jb, jax.random.PRNGKey(k), jnp.zeros((), jnp.int32))
        losses = step(state, tb)
        for name in jlosses:
            np.testing.assert_allclose(float(losses[name]), float(jlosses[name]),
                                       rtol=RTOL_LOSS, err_msg=f"step {k} {name}")
        ref, ours = _state_dict(jstate), model.state_dict()
        assert set(ours) == set(ref)
        n_off = n_all = 0
        for key, t in ours.items():
            # The EMA's raw values are dominated by their initial copy: hold its
            # increment this step instead, by the parameters' leaf rule.
            change = ref[key] - before[key]
            diff = (t - before[key]) - change if "_ema." in key else t - ref[key]
            if "running" in key and "_ema." not in key:
                assert_close(t.numpy(), ref[key].numpy(), REL_STATS, msg=f"step {k} {key}")
                continue
            rel = float(diff.norm() / change.norm())
            assert rel <= MAX_LEAF_REL[k], (k, key, rel)
            if "_ema." not in key and "running" not in key:
                off = diff.abs() > 0.1 * cfg["learning_rate"]
                n_off += int(off.sum())
                n_all += off.numel()
        assert n_off <= MAX_OFF_FRACTION[k] * n_all, (k, n_off, n_all)


@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_step_matches_jax(use_ema):
    """Eval-mode probabilities from the main or the EMA weights, with the EMA
    set to other weights than the main ones."""
    cfg = _train_cfg(tiny_kwargs("davis"))
    batch = _batch(3)
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"])
    variables = init_variables(jmodel, *args, train=True)
    other = init_variables(jmodel, *args, seed=1, train=True)
    jstate = jax_create_train_state(Config(cfg), jmodel, variables, steps_per_epoch=1)
    jstate = jstate.replace(
        ema_params={k: other["params"][k] for k in ("backbone2", "decode_head2")},
        ema_stats={k: other["batch_stats"][k] for k in ("backbone2", "decode_head2")})
    imgs = batch["imgs"].reshape(-1, 64, 64, 3)
    ref = jax_make_eval_step(jmodel, use_ema=use_ema)(jstate, jnp.asarray(imgs))

    model = build_model(cfg["model_kwargs"], device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=1)
    model.load_state_dict(_state_dict(jstate))
    probs = make_eval_step(use_ema=use_ema)(state, to_torch(imgs))
    assert not model.training and model.decode_head3.training
    assert_close(probs.numpy(), np.asarray(ref), REL_EVAL)


def _jax_param_counts(kw) -> tuple[int, int, dict]:
    model = jax_build_model(kw)
    x = jax.ShapeDtypeStruct((1, 2, 384, 384, 3), jnp.float32)
    f = jax.ShapeDtypeStruct((1, 1, 384, 384, 2), jnp.float32)
    shapes = jax.eval_shape(lambda k, x, f: model.init(k, x, f, f, train=True),
                            jax.random.PRNGKey(0), x, f)
    count = lambda t: sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(t))  # noqa: E731
    return count(shapes["params"]), count(shapes["batch_stats"]), shapes


@pytest.mark.parametrize("recipe", ["rcf", "rcf_stv2", "rcf_fbms59"])
def test_full_width_stage1_recipes_load_strictly(recipe):
    """Each stage-1 YAML's model at full width: JAX's variables (by ``eval_shape``,
    no compute) converted as zeros load into the port with ``strict=True``, and
    the port has JAX's parameter and statistics counts, EMA copies included.
    chip_smoke.py's two recipe dicts equal the resolved YAMLs."""
    import chip_smoke

    cfg = load_config(os.path.join(REPO, "configs", recipe, "rcf_stage1.yaml"))
    kw = cfg.model_kwargs.to_dict()
    if recipe in chip_smoke.RCF_RECIPES:
        smoke = chip_smoke.RCF_RECIPES[recipe]
        assert smoke["model_kwargs"] == kw
        assert smoke["compute_dtype"] == cfg.tpu.compute_dtype
        for key, value in smoke["train"].items():
            assert cfg.to_dict()[key] == value, key
    kw["backbone2"]["create_ema"] = True
    n_params, n_stats, shapes = _jax_param_counts(kw)
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    ema = {"params": {k: zeros["params"][k] for k in ("backbone2", "decode_head2")},
           "batch_stats": {k: zeros["batch_stats"][k] for k in ("backbone2", "decode_head2")}}
    model = build_model(kw, device="cpu")
    model.load_state_dict(rcf_state_from_jax(zeros, ema=ema), strict=True)
    main = {k: v for k, v in model.state_dict().items() if "_ema." not in k}
    ema_keys = [k for k in model.state_dict() if "_ema." in k]
    assert sum(p.numel() for k, p in main.items() if "running" not in k) == n_params
    assert sum(p.numel() for k, p in main.items() if "running" in k) == n_stats
    assert sum(p.numel() for p in model.parameters() if p.requires_grad) == n_params
    ema_count = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(ema))
    assert sum(model.state_dict()[k].numel() for k in ema_keys) == ema_count


if __name__ == "__main__":
    _measure_bf16_gaps()
