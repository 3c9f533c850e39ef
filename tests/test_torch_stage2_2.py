"""Stage 2.2 in the port end to end on the CPU: the port's semantic-constraint
pseudo-labels read back by the port's loop, and its first step against the
JAX package's on the same batch and weights.

The reduced model of ``test_loop_e2e._cfg`` (ResNet-18 OS8, 64^2 crops,
16^2 masks, dropout off, the EMA on) with the DAVIS stage-2.2 settings
(``configs/rcf/rcf_stage2.2.yaml``: ``w_seg`` 0.1, no entropy, ``w_pl`` 2
with weights 2/1, pseudo-labels loaded and augmented with the frames) on
the ``davis_like`` fixture's set. Limits: the losses of the first step
within 1e-4 relative (``test_torch_rcf_step.RTOL_LOSS``).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcf_tpu.config import Config as JaxConfig
from rcf_tpu.models import build_from_config as jax_build
from rcf_tpu.train import create_train_state as jax_create_train_state
from rcf_tpu.train import make_train_step as jax_make_train_step
from rcf_tpu_torch.config import Config
from rcf_tpu_torch.grouping import semantic_constraints
from rcf_tpu_torch.models import build_model
from rcf_tpu_torch.train import create_train_state, loop
from rcf_tpu_torch.train.checkpoint import save_checkpoint
from test_loop_e2e import _cfg
from test_torch_rcf_step import RTOL_LOSS, _state_dict
from torch_parity import init_variables


def _stage2_2_tree(davis_like, ckpt_dir, pl_root, pretrained=None) -> dict:
    tree = _cfg(davis_like, ckpt_dir).to_dict()
    tree.update(epochs=1, object_channel=0, pretrained_model=pretrained, learning_rate=1e-5)
    tree["train_transform_kwargs"]["has_pl"] = True
    tree["train_dataset_kwargs"].update(load_pl=True, pl_root=str(pl_root))
    mk = tree["model_kwargs"]
    mk.update(w_seg=0.1, w_entropy=0, w_pl=2.0, pl_pos_weight=2.0, pl_neg_weight=1.0)
    for head in ("backbone2", "decode_head2"):
        mk[head]["create_ema"] = True
    for head in ("decode_head2", "decode_head3"):
        mk[head]["dropout_ratio"] = 0.0
    return tree


@pytest.fixture(scope="module")
def pseudo_labels(davis_like, tmp_path_factory):
    """The port's semantic constraints (native CRF, colour features) over the
    set's frames, from EMA masks exported as the stage-2.1 export writes them."""
    tmp = tmp_path_factory.mktemp("sc")
    (tmp / "data").mkdir()
    os.symlink(davis_like, tmp / "data" / "data_davis")
    export = tmp / "s21" / "saved_eval_export_trainval_ema" / "0"
    export.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for seq in ("bear", "cows"):
        for f in sorted(os.listdir(davis_like / "JPEGImages/480p" / seq)):
            m = np.where(np.arange(96)[None, :] < 40, 190, 40) + rng.normal(0, 30, (96, 96))
            Image.fromarray(np.clip(m, 0, 255).astype(np.uint8)).save(
                export / f"pred_seg_{seq}_{f[:-4]}_0000000.png")
    assert semantic_constraints.main(
        ["--pretrain_dir", str(tmp / "s21"), "--object-channel", "0", "--data-dir",
         str(tmp / "data"), "--crf-engine", "native"], device="cpu") == 0
    out = tmp / "s21" / ("saved_eval_export_trainval_ema" + semantic_constraints.SAVE_SUFFIX) / "0"
    assert len(os.listdir(out)) == 7
    return out


def test_stage2_2_reads_port_pseudo_labels_and_matches_jax(davis_like, tmp_path, pseudo_labels,
                                                           monkeypatch):
    pl = np.array(Image.open(next(pseudo_labels.iterdir())))
    assert pl.shape == (120, 214) and 0 < (pl > 127).mean() < 1

    # Equal weights: JAX's drawn with numpy, saved as a port checkpoint that the
    # loop restores weights-only.
    tree = _stage2_2_tree(davis_like, tmp_path / "ckpt", pseudo_labels)
    jmodel = jax_build(JaxConfig(tree))
    x = jnp.zeros((2, 2, 64, 64, 3), jnp.float32)
    flows = jnp.zeros((2, 1, 64, 64, 2), jnp.float32)
    jvars = init_variables(jmodel, x, flows, flows, train=True)
    jstate = jax_create_train_state(JaxConfig(tree), jmodel, jvars, steps_per_epoch=1)
    model = build_model(tree["model_kwargs"], device="cpu")
    model.load_state_dict(_state_dict(jstate))
    save_checkpoint(str(tmp_path / "init"), "last", create_train_state(tree, model, 1))
    tree["pretrained_model"] = str(tmp_path / "init" / "last")

    seen = []
    real = loop.make_train_step

    def spy(**kw):
        step = real(**kw)

        def wrapped(state, batch, generator=None):
            first = not seen
            if first:
                seen.append({k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()})
            losses = step(state, batch, generator=generator)
            if first:
                seen.append({k: float(v) for k, v in losses.items()})
            return losses
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", spy)
    loop.run(Config(tree), no_test=True, device="cpu")
    batch, losses = seen
    assert batch["pl_masks"].shape == (8, 2, 64, 64) and batch["object_channel_set"]
    assert 0 < float((batch["pl_masks"] > 0.5).float().mean()) < 1

    jb = {k: jnp.asarray(batch[k].numpy()) for k in ("imgs", "gt_fw_flows", "gt_bw_flows",
                                                      "pl_masks")}
    jstep = jax_make_train_step(jmodel, donate=False)
    _, jlosses = jstep(jstate, jb, jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32),
                       object_channel_set=True)
    assert set(losses) == set(jlosses) and "loss_pl" in losses
    for name in jlosses:
        np.testing.assert_allclose(losses[name], float(jlosses[name]), rtol=RTOL_LOSS,
                                   err_msg=name)
    with open(tmp_path / "ckpt" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f if "train_loss_pl" in line]
    assert logged and all(np.isfinite(r["train_loss_pl"]) for r in logged)
