"""Train state: the model, torch Adam with the poly-epoch LR, and the step count.

Port of ``rcf_tpu/train/state.py`` for the optimizer the AMD recipe uses:
``torch.optim.Adam(lr, weight_decay)``, i.e. an L2 term added to the
gradient before the moments (not AdamW), betas (0.9, 0.999), eps 1e-8,
as ``make_optimizer`` chains ``add_decayed_weights`` ahead of
``scale_by_adam``. The learning rate of update ``k`` (0-based) is
``poly_epoch_schedule(k)``, as optax counts. No EMA.

Frozen subtrees, as ``make_optimizer``'s ``optax.set_to_zero`` mask:
``model_kwargs.freeze_backbone`` freezes ``backbone2`` and
``model_kwargs.decode_head.freeze_flownet`` freezes ``flownet``. They are
left out of the optimizer (no update, no weight decay, no Adam moments)
and, as in the reference, set ``requires_grad=False``; gradients still
flow through them to the trainable parameters. Their BN running
statistics go on updating in training mode, as the JAX step's do.
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


def compute_dtype(cfg: dict) -> torch.dtype:
    """The recipe's ``tpu.compute_dtype``: bfloat16 if it says so, else float32."""
    name = (cfg.get("tpu") or {}).get("compute_dtype")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _frozen_subtrees(cfg: dict) -> tuple[str, ...]:
    """Top-level submodules the recipe freezes (``freeze_backbone``, ``freeze_flownet``)."""
    model_kwargs = cfg.get("model_kwargs") or {}
    frozen = []
    if model_kwargs.get("freeze_backbone", False):
        frozen.append("backbone2")
    if (model_kwargs.get("decode_head") or {}).get("freeze_flownet", False):
        frozen.append("flownet")
    return tuple(frozen)


def create_train_state(cfg: dict, model: nn.Module, steps_per_epoch: int) -> TrainState:
    """Adam + poly schedule over ``model``'s trainable parameters, from a recipe config dict."""
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
    frozen = _frozen_subtrees(cfg)
    for name in frozen:
        getattr(model, name).requires_grad_(False)
    params = [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]
    optimizer = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=float(cfg.get("weight_decay", 0.0)))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
