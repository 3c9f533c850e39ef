"""Two AMD training steps in the port against the JAX package, on the CPU.

Equal weights (drawn with numpy, converted), the same frames, dropout 0,
a reduced model (ResNet-18 backbone, narrow head, 64^2 frames, flow_size
64x96) at the recipe's optimizer: Adam with L2 weight decay and the poly
epoch schedule, one step per epoch so that the learning rate moves
between the steps. After each step the losses, every parameter and every
BN running statistic are compared. With ``freeze_flownet`` the flownet's
parameters must come out bit-identical and the rest is held to JAX as
without it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcf_tpu.config import Config
from rcf_tpu.models.amd import build_amd_model as jax_build_amd_model
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train import make_train_step as jax_make_train_step
from rcf_tpu_torch.convert import torch_state_from_jax
from rcf_tpu_torch.models.amd import build_amd_model
from rcf_tpu_torch.train import create_train_state, make_train_step, poly_epoch_schedule
from torch_parity import assert_close, init_variables, to_torch

MODEL_KWARGS = {
    "w_seg": 1.0, "mask_layer": 5, "flow_size": (64, 96),
    "backbone2": {"type": "ResNet", "depth": 18, "num_stages": 4,
                  "out_indices": [0, 1, 2, 3], "strides": [1, 2, 1, 1],
                  "dilations": [1, 1, 1, 2], "contract_dilation": False},
    "decode_head2": {"type": "FCNHead", "in_channels": 512, "in_index": 3, "channels": 32,
                     "num_convs": 2, "dilation": 6, "dropout_ratio": 0.0,
                     "num_classes": 5, "concat_input": False},
}
# The recipe's Adam and schedule; weight decay raised from 1e-6 so that the
# L2-before-moments term is visible in the updates.
CFG = {"optimizer": "adam", "learning_rate": 1e-4, "weight_decay": 0.05, "epochs": 8,
       "lr_scheduler_kwargs": {"power": 0.9, "min_lr": 1e-6}, "model_kwargs": {}}
# Losses: f32 forward through ~40 layers in two frameworks.
RTOL_LOSS = 1e-4
# BN running statistics against their own scale (measured <= 2e-4 at step 2).
REL_STATS = 1e-3
# Fraction of parameters whose update may differ by > 0.1 lr after step 1
# and 2 (measured 1.1e-4 and 3.5e-3: a sign flip at step 1 changes step 2's
# gradients); a wrong learning rate or decay moves nearly all of them.
MAX_OFF_FRACTION = (1e-3, 1e-2)
# Each parameter tensor on its own: |ours - JAX| over |JAX's update| after
# step 1 and 2 (largest measured over the 116 tensors: 3.6e-2 and 6.9e-2, the
# sign flips above); a tensor left unchanged reads 1, a sign error 2.
MAX_LEAF_REL = (0.1, 0.2)


def test_poly_epoch_schedule_matches_jax():
    from rcf_tpu.train.state import poly_epoch_schedule as jax_schedule

    ours, ref = poly_epoch_schedule(1e-4, 1e-6, 0.9, 8, 3), jax_schedule(1e-4, 1e-6, 0.9, 8, 3)
    for step in (0, 2, 3, 10, 23, 24, 40):
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("freeze_flownet", [False, True])
def test_two_train_steps_match_jax(freeze_flownet):
    cfg = dict(CFG, model_kwargs={"decode_head": {"freeze_flownet": freeze_flownet}})
    imgs = np.random.default_rng(0).standard_normal((2, 2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_amd_model(MODEL_KWARGS)
    variables = init_variables(jmodel, jnp.asarray(imgs), train=True)
    jstate = jax_create_train_state(Config(cfg), jmodel, variables, steps_per_epoch=1)
    jstep = jax_make_train_step(jmodel, donate=False)

    model = build_amd_model(MODEL_KWARGS, device="cpu")
    model.load_state_dict(torch_state_from_jax(variables))
    state = create_train_state(cfg, model, steps_per_epoch=1)
    step = make_train_step()
    initial = {k: t.clone() for k, t in model.state_dict().items()}

    for k in range(2):
        before = torch_state_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
        jstate, jlosses = jstep(jstate, {"imgs": jnp.asarray(imgs)}, jax.random.PRNGKey(k),
                                jnp.zeros((), jnp.int32))
        losses = step(state, {"imgs": to_torch(imgs)})
        for name in jlosses:
            np.testing.assert_allclose(float(losses[name]), float(jlosses[name]), rtol=RTOL_LOSS,
                                       err_msg=f"step {k} {name}")
        ref = torch_state_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
        ours = model.state_dict()
        assert set(ours) == set(ref)
        for key, t in ours.items():
            if "running" in key:
                assert_close(t.numpy(), ref[key].numpy(), REL_STATS, msg=f"step {k} {key}")
        # Adam's early updates are about lr * sign(g): where a gradient is
        # within float noise of 0 the two frameworks may step opposite ways.
        # Count the elements whose update differs from JAX's by > 0.1 lr.
        # Count the elements whose update differs from JAX's by > 0.1 lr, and
        # hold each tensor's difference against the size of its own update.
        n_off = n_all = 0
        for key, t in ours.items():
            if freeze_flownet and key.startswith("flownet."):
                assert torch.equal(t, initial[key]), (k, key)
                assert torch.equal(ref[key], initial[key]), (k, key)
            elif "running" not in key:
                diff = t.numpy() - ref[key].numpy()
                off = np.abs(diff) > 0.1 * CFG["learning_rate"]
                n_off += int(off.sum())
                n_all += off.size
                rel = np.linalg.norm(diff) / np.linalg.norm(ref[key].numpy() - before[key].numpy())
                assert rel <= MAX_LEAF_REL[k], (k, key, rel)
        assert n_off <= MAX_OFF_FRACTION[k] * n_all, (k, n_off, n_all)
