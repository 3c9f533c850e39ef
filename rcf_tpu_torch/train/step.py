"""The train step (port of ``rcf_tpu/train/step.py::make_train_step``).

One optimizer step: forward in training mode (BN batch statistics, their
running averages updated), the losses, backward, one Adam update at the
scheduled learning rate. For models without a CRF target or an EMA copy,
which is the AMD recipe.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState


def make_train_step() -> Callable[..., dict]:
    """Return ``step(state, batch, generator=None) -> losses`` (detached tensors).

    ``batch["imgs"]`` is [B, 2, H, W, 3] on the model's device; ``generator``
    drives the model's dropout.
    """

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses, _ = state.model(batch["imgs"], generator=generator)
        losses["loss"].backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return train_step
