"""The train and eval steps (port of ``rcf_tpu/train/step.py``).

One optimizer step: forward in training mode (BN batch statistics, their
running averages updated), the losses, backward, one Adam update at the
scheduled learning rate, then the EMA update where the state has one.
The batch's keys are the model's ``forward`` arguments: ``imgs`` for the
AMD model; ``imgs``, ``gt_fw_flows``, ``gt_bw_flows`` and optionally
``pl_masks``, ``object_channel``, ``object_channel_set`` for the RCF
model.

Stage 2.1 (``w_crf > 0``): once the object channel is set, the step first
makes the CRF target (``_crf_targets``): the EMA copies' masks of every
frame, in eval mode and without gradient, from the EMA as it stands
before this step's update; the object channel's mask resized to the
frames; ``crf_fn`` (``ops/crf.py::make_crf_fn``; ``maybe_crf_fn`` builds
it from the model's ``crf_head``); the refined map resized to the mask
grid. It enters ``forward`` as ``crf_target_masks``.

Over several ranks (``parallel/dist.py``) each rank runs the step on its
rows: the BatchNorms reduce their statistics over the ranks, the
gradients are averaged over ranks (one all-reduce) before the optimizer,
and the returned losses are the ranks' means, so every rank's state and
losses are those of the whole batch. Stage 2.1's target is made from the
rank's rows alone (each image's mean field stops on its own). The EMA
moves on every rank from the same weights.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from ..models.rcf import take_channel
from ..ops.crf import make_crf_fn
from ..ops.resize import resize_bilinear
from ..parallel import dist
from .state import TrainState, ema_update


def maybe_crf_fn(model) -> Callable | None:
    """The CRF of the model's ``crf_head`` settings where it has a CRF loss, else None
    (``rcf_tpu/train/loop.py::_maybe_crf_fn``)."""
    if getattr(model, "w_crf", 0.0) <= 0:
        return None
    return make_crf_fn(**(model.crf_head_kwargs or {}))


@contextlib.contextmanager
def _eval_mode(*modules: torch.nn.Module):
    """``modules`` in eval mode inside the block, each restored to its mode after."""
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


@torch.no_grad()
def _crf_targets(model, imgs: torch.Tensor, object_channel, crf_fn) -> torch.Tensor:
    """Stage 2.1's target [B, I, h, w] for frames [B, I, H, W, 3]
    (``rcf_tpu/train/step.py::_crf_targets``)."""
    if not model.crf_use_ema:
        # JAX applies the main weights in training mode with immutable batch
        # statistics there, which Flax refuses (ModifyScopeVariableError).
        raise NotImplementedError("crf_use_ema: false raises in the JAX package too "
                                  "(train-mode BN with immutable batch_stats)")
    b, i = imgs.shape[:2]
    imgs_flat = imgs.reshape(b * i, *imgs.shape[2:])
    # model.train() set the EMA copies training too: the target reads their
    # running statistics and must not move them.
    with _eval_mode(model.backbone2_ema, model.decode_head2_ema):
        probs = model.mask_probs(imgs_flat, use_ema=True)
    obj = take_channel(probs, object_channel)
    obj_full = resize_bilinear(obj[..., None], tuple(imgs.shape[2:4]), model.align_corners)[..., 0]
    refined = crf_fn(imgs_flat, obj_full)
    target = resize_bilinear(refined[..., None], model.mask_size, model.align_corners)[..., 0]
    return target.reshape(b, i, *model.mask_size)


def make_train_step(crf_fn: Callable | None = None) -> Callable[..., dict]:
    """Return ``step(state, batch, generator=None) -> losses`` (detached tensors).

    ``batch["imgs"]`` is [B, 2, H, W, 3] on the model's device, and the
    flows [B, 1, H0, W0, 2]; ``generator`` drives the model's dropout.
    ``crf_fn`` (normalized frames [N, H, W, 3], masks [N, H, W]) -> [N, H, W]
    makes stage 2.1's target; a model with ``w_crf > 0`` needs one (the
    step raises without it, as JAX's ``make_train_step`` does).
    """

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        model = state.model
        w_crf = getattr(model, "w_crf", 0.0)
        if w_crf > 0 and crf_fn is None:
            raise ValueError("model has w_crf > 0 but no crf_fn was provided")
        model.train()
        if w_crf > 0 and batch.get("object_channel_set", False):
            target = _crf_targets(model, batch["imgs"], batch.get("object_channel", 0), crf_fn)
            batch = dict(batch, crf_target_masks=target)
        state.optimizer.zero_grad(set_to_none=True)
        losses, _ = model(**batch, generator=generator)
        losses["loss"].backward()
        dist.all_reduce_mean_([p.grad for group in state.optimizer.param_groups
                               for p in group["params"]])
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if state.ema_m is not None:
            ema_update(model, state.ema_m)
        state.step += 1
        return dist.mean_losses({k: v.detach() for k, v in losses.items()})

    return train_step


def step_seed(seed: int, global_step: int) -> int:
    """The dropout generator's seed of one step, from (seed, global_step)
    (the counterpart of ``fold_in(PRNGKey(seed), global_step)``)."""
    return int(np.random.SeedSequence([seed, global_step]).generate_state(1, np.uint64)[0] >> 1)


def make_eval_step(use_ema: bool = False) -> Callable[..., torch.Tensor]:
    """Return ``eval_step(state, imgs) -> probs``: the model's mask
    probabilities [B, h, w, C] for frames [B, H, W, 3], in eval mode, from
    the main or (an RCF model's) EMA weights."""

    @torch.no_grad()
    def eval_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        if use_ema:
            return state.model.mask_probs(imgs, use_ema=True)
        return state.model.mask_probs(imgs)

    return eval_step
