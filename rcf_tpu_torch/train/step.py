"""The train and eval steps (port of ``rcf_tpu/train/step.py``).

One optimizer step: forward in training mode (BN batch statistics, their
running averages updated), the losses, backward, one Adam update at the
scheduled learning rate, then the EMA update where the state has one.
The batch's keys are the model's ``forward`` arguments: ``imgs`` for the
AMD model; ``imgs``, ``gt_fw_flows``, ``gt_bw_flows`` and optionally
``pl_masks``, ``object_channel``, ``object_channel_set`` for the RCF
model. Stage 2.1's CRF target is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState, ema_update


def make_train_step() -> Callable[..., dict]:
    """Return ``step(state, batch, generator=None) -> losses`` (detached tensors).

    ``batch["imgs"]`` is [B, 2, H, W, 3] on the model's device, and the
    flows [B, 1, H0, W0, 2]; ``generator`` drives the model's dropout.
    """

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses, _ = state.model(**batch, generator=generator)
        losses["loss"].backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if state.ema_m is not None:
            ema_update(state.model, state.ema_m)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_eval_step(use_ema: bool = False) -> Callable[..., torch.Tensor]:
    """Return ``eval_step(state, imgs) -> probs``: an RCF model's mask
    probabilities [B, h, w, C] for frames [B, H, W, 3], in eval mode, from
    the main or the EMA weights."""

    @torch.no_grad()
    def eval_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        return state.model.mask_probs(imgs, use_ema=use_ema)

    return eval_step
