"""Train state: the model, torch Adam with the poly-epoch LR, and the step count.

Port of ``rcf_tpu/train/state.py`` for the optimizer the AMD recipe uses:
``torch.optim.Adam(lr, weight_decay)``, i.e. an L2 term added to the
gradient before the moments (not AdamW), betas (0.9, 0.999), eps 1e-8,
as ``make_optimizer`` chains ``add_decayed_weights`` ahead of
``scale_by_adam``. The learning rate of update ``k`` (0-based) is
``poly_epoch_schedule(k)``, as optax counts. No EMA, no frozen subtrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


def poly_epoch_schedule(base_lr: float, min_lr: float, power: float, epochs: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = (base - min) * (1 - epoch/epochs)^power + min, epoch = step // steps_per_epoch."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        return (base_lr - min_lr) * (1.0 - epoch / epochs) ** power + min_lr

    return schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(cfg: dict, model: nn.Module, steps_per_epoch: int) -> TrainState:
    """Adam + poly schedule over all of ``model``'s parameters, from a recipe config dict."""
    name = str(cfg.get("optimizer", "adam")).lower()
    if name != "adam":
        raise NotImplementedError(f"the port's train state has Adam only, got {name!r}")
    sched_cfg = cfg.get("lr_scheduler_kwargs", {})
    schedule = poly_epoch_schedule(
        base_lr=float(cfg["learning_rate"]),
        min_lr=float(sched_cfg.get("min_lr", 0.0)),
        power=float(sched_cfg.get("power", 0.9)),
        epochs=int(cfg["epochs"]),
        steps_per_epoch=steps_per_epoch,
    )
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=float(cfg.get("weight_decay", 0.0)))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
