"""The options no recipe sets, in the port against the JAX package, on the CPU.

* ResNet ``deep_stem``, ``avg_down`` (basic and bottleneck blocks),
  ``stem_channels``, ``base_channels``, ``frozen_stages``: features in eval
  and training mode and the running statistics, at ``test_torch_modules.py``'s
  limits (1e-5 eval, 1e-3 training, relative to scale); the backbone import
  reads exactly the tensors JAX's ``import_resnet`` reads;
* FCN head ``kernel_size``, ``input_dilation``, ``input_stride``: logits at the
  same limits, and the fused conv0 taken only where JAX takes it (stride 1);
* the optimizers ``adamw``, ``sgd`` and ``tpu.fused_optimizer`` (torch's
  ``Adam(fused=True)``) over three steps (the learning rate moving each
  step) against optax's chain and ``fused_adam``: parameters within rtol
  2e-6 / atol 1e-7 (``tests/test_fused_adam.py``'s limit); under a
  ``freeze_*`` mask the fused optimizer is off, as in JAX; its state is the
  unfused optimizer's, so a checkpoint moves between the two;
* ``tpu.scan_steps`` (inert in eager PyTorch): two single steps of the port,
  what the loop runs for ``scan_steps: 2``, against JAX's
  ``make_scanned_train_step`` (losses [K] at ``RTOL_LOSS``, parameters by
  ``test_torch_rcf_step.py``'s second-step rule), and the loop with
  ``scan_steps: 3`` against ``scan_steps: 1``, bit for bit;
* ``cross_entropy`` / ``binary_cross_entropy`` in every reduction, with
  sample weights, class weights and ignored labels, rel 1e-6.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcf_tpu.config import Config as JaxConfig
from rcf_tpu.losses import cross_entropy as jce
from rcf_tpu.models import build_model as jax_build_model
from rcf_tpu.nn import FCNHead as JaxFCNHead
from rcf_tpu.nn import ResNet as JaxResNet
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train.checkpoint import import_resnet
from rcf_tpu.train.state import fused_adam, make_optimizer
from rcf_tpu.train.step import make_scanned_train_step as jax_make_scanned_train_step
from rcf_tpu.train.step import stack_batches as jax_stack_batches
from rcf_tpu_torch import convert
from rcf_tpu_torch.config import Config
from rcf_tpu_torch.losses import cross_entropy as tce
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.nn import FCNHead, ResNet
from rcf_tpu_torch.train import create_train_state, make_train_step, step_seed
from rcf_tpu_torch.train import loop
from rcf_tpu_torch.train.checkpoint import _resnet_take
from test_torch_rcf_step import RTOL_LOSS, _batch, _state_dict, _train_cfg, tiny_kwargs
from test_torch_rcf_step import MAX_LEAF_REL, MAX_OFF_FRACTION, REL_STATS
from test_torch_train_loop import _tree
from torch_parity import assert_close, init_variables, to_torch

REL = 1e-5
REL_TRAIN = 1e-3
STAGE = {"depth": 18, "num_stages": 4, "out_indices": [0, 1, 2, 3],
         "strides": [1, 2, 2, 1], "dilations": [1, 1, 1, 2]}
# The option cases at a quarter width (stem and base 16); the width options
# themselves move from there.
NARROW = dict(stem_channels=16, base_channels=16)

RESNET_OPTIONS = {
    "deep_stem": dict(NARROW, deep_stem=True),
    "avg_down": dict(NARROW, avg_down=True),
    "avg_down_bottleneck": dict(avg_down=True, depth=50, base_channels=8, stem_channels=16),
    "stem_channels": dict(NARROW, stem_channels=32),
    "base_channels": dict(NARROW, base_channels=8),
    "frozen_stages": dict(NARROW, frozen_stages=2),
}


@pytest.mark.parametrize("name", sorted(RESNET_OPTIONS))
def test_resnet_option_matches_jax(name):
    cfg = dict(STAGE, **RESNET_OPTIONS[name])
    # 64^2: the last stages' BN still sees 32 values a channel in training.
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jnet = JaxResNet(**cfg)
    v = init_variables(jnet, jnp.asarray(x), train=False)
    tnet = ResNet(**cfg)
    tnet.load_state_dict(convert.resnet_state_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    tnet.eval()
    with torch.no_grad():
        ours = tnet(to_torch(x))
    ref = jnet.apply(v, jnp.asarray(x), train=False)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert_close(a.numpy(), np.asarray(b), REL)
    ref, new = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tnet.train()
    with torch.no_grad():
        ours = tnet(to_torch(x))
    for a, b in zip(ours, ref):
        assert_close(a.numpy(), np.asarray(b), REL_TRAIN)
    new_sd = convert.resnet_state_from_jax(v["params"], new["batch_stats"])
    for k, t in tnet.state_dict().items():
        assert_close(t.numpy(), new_sd[k].numpy(), REL_TRAIN, k)


def _reference_sd(avg_down_layout: bool) -> dict:
    """A torchvision-style ResNet-18 state dict (or mmseg's avg-down layout:
    ``downsample.0`` is the pool, the conv and BN are ``.1``, ``.2``)."""
    sd = ResNet(**STAGE).state_dict()
    if avg_down_layout:
        sd = {k.replace("downsample.1.", "downsample.2.").replace("downsample.0.",
                                                                   "downsample.1."): v
              for k, v in sd.items()}
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randn(v.shape, generator=gen) for k, v in sd.items()}


@pytest.mark.parametrize("model_opts,mmseg_layout", [
    (dict(avg_down=True), False), (dict(avg_down=True), True), (dict(deep_stem=True), False),
    ({}, True)])
def test_backbone_import_reads_what_jax_reads(model_opts, mmseg_layout):
    """The port imports a checkpoint's backbone tensors exactly where JAX's
    ``import_resnet`` reads them, and no others: a deep stem stays at its init,
    an avg-down checkpoint's downsample (no ``downsample.0.weight``) too."""
    sd = _reference_sd(mmseg_layout)
    jp, js = import_resnet(sd, depth=18)
    jax_read = convert.resnet_state_from_jax(jp, js)
    own = ResNet(**STAGE, **model_opts).state_dict()
    take = _resnet_take(own, sd, "")
    assert set(take) == set(jax_read) & set(own)
    for k, v in take.items():
        assert torch.equal(v, jax_read[k]), k
    if mmseg_layout:
        assert not any(".downsample." in k for k in take)


FCN_OPTIONS = {"kernel_size_1": dict(kernel_size=1), "kernel_size_5": dict(kernel_size=5),
               "input_dilation": dict(input_dilation=2),
               "input_stride": dict(input_stride=2)}


@pytest.mark.parametrize("name", sorted(FCN_OPTIONS))
def test_fcn_head_option_matches_jax(name):
    opts = FCN_OPTIONS[name]
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((2, 16, 16, 8)).astype(np.float32),
             rng.standard_normal((2, 8, 8, 16)).astype(np.float32)]
    cfg = dict(num_classes=5, channels=8, num_convs=2, dilation=3, dropout_ratio=0.0,
               in_index=[0, 1], input_transform="resize_concat", concat_input=False, **opts)
    jhead = JaxFCNHead(**cfg)
    jfeats = [jnp.asarray(f) for f in feats]
    v = init_variables(jhead, jfeats, train=False)
    thead = FCNHead(in_channels=[8, 16], **cfg)
    thead.load_state_dict(convert.fcn_head_state_from_jax(v["params"], v["batch_stats"]),
                          strict=True)
    assert thead.fast == (opts.get("input_stride", 1) == 1)  # JAX's fused conv0 condition
    for train in (False, True):
        ref = jhead.apply(v, jfeats, train=train, mutable=["batch_stats"])[0]
        thead.train(train)
        with torch.no_grad():
            ours = thead([to_torch(f) for f in feats])
        assert ours.shape == ref.shape
        assert_close(ours.numpy(), np.asarray(ref), REL_TRAIN if train else REL)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


class _Params(torch.nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.backbone2 = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()})


def _opt_cfg(name: str, fused: bool = False, freeze: bool = False) -> dict:
    return {"optimizer": name, "learning_rate": 1e-2, "weight_decay": 0.05, "epochs": 10,
            "lr_scheduler_kwargs": {"power": 0.9, "min_lr": 1e-4},
            "tpu": {"fused_optimizer": fused}, "model_kwargs": {"freeze_backbone": freeze}}


@pytest.mark.parametrize("name,fused", [("adamw", False), ("sgd", False), ("adam", True),
                                        ("adamw", True)])
def test_optimizer_matches_optax_over_three_steps(name, fused):
    """``adamw``/``sgd`` against ``make_optimizer``; ``adam`` with the fused
    optimizer against ``fused_adam``. ``adamw`` ignores the fused flag, as in JAX."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    cfg = _opt_cfg(name, fused)
    tx = (fused_adam if fused and name == "adam" else make_optimizer)(JaxConfig(cfg), 1)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    module = _Params(params)
    state = create_train_state(cfg, module, steps_per_epoch=1)
    assert bool(state.optimizer.defaults.get("fused")) == (fused and name == "adam")
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.backbone2.items():
            p.grad = torch.from_numpy(grads[k])
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        for k, p in module.backbone2.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=2e-6,
                                       atol=1e-7, err_msg=f"step {step} {k}")


def test_fused_optimizer_is_off_under_a_freeze_mask():
    """As ``create_train_state`` in JAX: a ``freeze_*`` mask needs the per-tensor
    path; the frozen subtree takes no update."""
    module = _Params({"a": np.ones((2, 2), np.float32)})
    module.head = torch.nn.Linear(2, 2)
    state = create_train_state(_opt_cfg("adam", fused=True, freeze=True), module, 1)
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert not state.optimizer.defaults["fused"]
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == \
        list(module.head.parameters())


def test_fused_adam_state_round_trips_a_checkpoint():
    """The fused optimizer's state is the unfused one's, tensor by tensor: saved
    from either, it restores into the other, and the next step agrees with the
    other's own."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]

    def stepped(fused: bool, start: dict, grad: dict, state_dict=None):
        module = _Params(start)
        state = create_train_state(_opt_cfg("adam", fused), module, 1)
        if state_dict is not None:
            state.optimizer.load_state_dict(state_dict)
        for k, p in module.backbone2.items():
            p.grad = torch.from_numpy(grad[k])
        state.optimizer.step()
        return {k: p.detach().numpy().copy() for k, p in module.backbone2.items()}, state

    for src, dst in ((True, False), (False, True)):
        after1, saved = stepped(src, params, grads[0])
        _, ref_state = stepped(dst, params, grads[0])
        after2, again = stepped(dst, after1, grads[1], saved.optimizer.state_dict())
        ref2, _ = stepped(dst, after1, grads[1], ref_state.optimizer.state_dict())
        for p_src in saved.optimizer.param_groups[0]["params"]:
            assert set(saved.optimizer.state[p_src]) == {"step", "exp_avg", "exp_avg_sq"}
        for k in params:
            np.testing.assert_allclose(after2[k], ref2[k], rtol=2e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# The scanned step
# ---------------------------------------------------------------------------


def _scan_case():
    cfg = _train_cfg(tiny_kwargs())
    batches = [_batch(s) for s in (11, 12)]
    jmodel = jax_build_model(cfg["model_kwargs"])
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = init_variables(jmodel, jb["imgs"], jb["gt_fw_flows"], jb["gt_bw_flows"],
                               train=True)
    jstate = jax_create_train_state(JaxConfig(cfg), jmodel, variables, steps_per_epoch=1)
    return cfg, batches, jmodel, jstate


def _port_state(cfg, sd):
    model = build_model(cfg["model_kwargs"], device="cpu")
    model.load_state_dict(sd)
    return create_train_state(cfg, model, steps_per_epoch=1)


def test_scanned_step_matches_single_steps_and_jax():
    """``scan_steps: 2`` runs two single steps in the port (the same math as a
    scanned call): they match JAX's ``make_scanned_train_step`` over the
    stacked batches."""
    cfg, batches, jmodel, jstate = _scan_case()
    sd = _state_dict(jstate)
    tbatches = [{k: to_torch(v) for k, v in b.items()} for b in batches]

    single = _port_state(cfg, sd)
    gen = torch.Generator()
    step = make_train_step()
    single_losses = []
    for k, b in enumerate(tbatches):
        gen.manual_seed(step_seed(0, k))
        single_losses.append(step(single, b, generator=gen))
    assert single.step == 2
    losses = {key: torch.stack([s[key] for s in single_losses]) for key in single_losses[0]}
    ours = single.model.state_dict()

    jscan = jax_make_scanned_train_step(jmodel, 2, donate=False)
    jnew, jlosses = jscan(jstate, jax_stack_batches(batches), jax.random.PRNGKey(0),
                          jnp.zeros((), jnp.int32))
    for key, v in jlosses.items():
        np.testing.assert_allclose(losses[key].numpy(), np.asarray(v), rtol=RTOL_LOSS,
                                   err_msg=key)
    ref = _state_dict(jnew)
    n_off = n_all = 0
    for key, t in ref.items():
        if "running" in key and "_ema." not in key:
            assert_close(ours[key].numpy(), t.numpy(), REL_STATS, key)
            continue
        change = t - sd[key]
        diff = (ours[key] - sd[key]) - change if "_ema." in key else ours[key] - t
        assert float(diff.norm() / change.norm()) <= MAX_LEAF_REL[1], key
        if "_ema." not in key and "running" not in key:
            n_off += int((diff.abs() > 0.1 * cfg["learning_rate"]).sum())
            n_all += diff.numel()
    assert n_off <= MAX_OFF_FRACTION[1] * n_all


def test_loop_scan_steps_runs_the_epoch_tail_as_single_steps(davis_like, tmp_path):
    """``tpu.scan_steps: 3`` over an epoch of 4 steps runs every step, the tail's
    too, as ``scan_steps: 1`` does: the same state bit for bit and the same
    logged losses, step by step."""
    states = {}
    for k in (1, 3):
        tree = _tree(davis_like, tmp_path / f"scan{k}", dropout=0.1)
        tree.update(global_batch_size=2, epochs=1, loss_log_interval=1)
        tree["trainer_kwargs"] = {"check_val_every_n_epoch": 0}
        tree["tpu"] = {"scan_steps": k}
        states[k] = loop.run(Config(tree), no_test=True, device="cpu")
    assert states[1].step == states[3].step == 4
    a, b = states[1].model.state_dict(), states[3].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    logs = [[json.loads(line) for line in open(tmp_path / f"scan{k}" / "metrics.jsonl")
             if '"step"' in line] for k in (1, 3)]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]] == [1, 2, 3, 4]
    assert [r["train_loss"] for r in logs[0]] == [r["train_loss"] for r in logs[1]]


def test_check_tpu_keys_runs_what_jax_runs(davis_like, tmp_path):
    tree = _tree(davis_like, tmp_path)
    tree["optimizer"] = "adamw"
    tree["tpu"] = {"scan_steps": 4, "fused_optimizer": True, "mesh_shape": [-1],
                   "compute_dtype": "float32", "donate_state": True}
    loop.check_tpu_keys(Config(tree))
    tree["tpu"]["mesh_shape"] = [1]
    loop.check_tpu_keys(Config(tree))


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------


def _ce_inputs():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (3, 4, 5))
    labels[0, 0, :3] = 255
    weight = rng.uniform(0.2, 2.0, (3, 4, 5)).astype(np.float32)
    class_weight = rng.uniform(0.5, 1.5, 6).astype(np.float32).tolist()
    targets = rng.uniform(0, 1, logits.shape).astype(np.float32)
    return logits, labels, weight, class_weight, targets


REDUCTIONS = [("none", None), ("sum", None), ("mean", None), ("mean", 17.0)]


@pytest.mark.parametrize("reduction,avg_factor", REDUCTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(reduction, avg_factor, weighted):
    logits, labels, weight, class_weight, _ = _ce_inputs()
    w = weight if weighted else None
    cw = class_weight if weighted else None
    ref = jce.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if w is None else jnp.asarray(w), cw, reduction, avg_factor,
                            ignore_index=255)
    ours = tce.cross_entropy(to_torch(logits), to_torch(labels), None if w is None else to_torch(w),
                             cw, reduction, avg_factor, ignore_index=255)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction,avg_factor", REDUCTIONS)
def test_binary_cross_entropy_matches_jax(reduction, avg_factor):
    logits, _, weight, _, targets = _ce_inputs()
    w = weight[..., None]
    ref = jce.binary_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(w),
                                   reduction, avg_factor, pos_weight=1.5)
    ours = tce.binary_cross_entropy(to_torch(logits), to_torch(targets), to_torch(w), reduction,
                                    avg_factor, pos_weight=1.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_cross_entropy_loss_callable_matches_jax(use_sigmoid):
    logits, labels, _, class_weight, targets = _ce_inputs()
    target = targets if use_sigmoid else np.where(labels == 255, 0, labels)
    kw = dict(use_sigmoid=use_sigmoid, loss_weight=2.0,
              class_weight=None if use_sigmoid else class_weight)
    ref = jce.CrossEntropyLoss(**kw)(jnp.asarray(logits), jnp.asarray(target))
    ours = tce.CrossEntropyLoss(**kw)(to_torch(logits), to_torch(target))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tce.CrossEntropyLoss(use_mask=True)
