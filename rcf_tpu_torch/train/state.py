"""Train state: the model, torch Adam with the poly-epoch LR, and the step count.

Port of ``rcf_tpu/train/state.py`` for the optimizer the AMD recipe uses:
``torch.optim.Adam(lr, weight_decay)``, i.e. an L2 term added to the
gradient before the moments (not AdamW), betas (0.9, 0.999), eps 1e-8,
as ``make_optimizer`` chains ``add_decayed_weights`` ahead of
``scale_by_adam``. The learning rate of update ``k`` (0-based) is
``poly_epoch_schedule(k)``, as optax counts.

EMA (RCF models built with ``backbone2.create_ema``): the model's copies
``backbone2_ema`` and ``decode_head2_ema`` take no optimizer update; the
state resets them to the weights it starts from, as JAX's
``create_train_state`` copies its ``ema_params``/``ema_stats``, and
``ema_update`` moves their parameters and BN running statistics after
each Adam update: ``ema = ema * m + new * (1 - m)``, ``m = ema_m``, from the
updated parameters and the step's new statistics.

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


EMA_SUBTREES = ("backbone2", "decode_head2")


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    ema_m: float | None = None  # None: no EMA


def _ema_pairs(model: nn.Module) -> tuple[list, list]:
    """(EMA tensors, their sources): parameters and float buffers of each EMA subtree."""
    ema, src = [], []
    for name in EMA_SUBTREES:
        own = dict(getattr(model, name).state_dict(keep_vars=True))
        for key, t in getattr(model, f"{name}_ema").state_dict(keep_vars=True).items():
            if t.is_floating_point():
                ema.append(t.data)
                src.append(own[key].data)
    return ema, src


@torch.no_grad()
def ema_update(model: nn.Module, m: float) -> None:
    """ema = ema * m + new * (1 - m) over the EMA subtrees, rounded as JAX's lerp."""
    ema, src = _ema_pairs(model)
    torch._foreach_mul_(ema, m)
    torch._foreach_add_(ema, torch._foreach_mul(src, 1.0 - m))


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
    ema_names = tuple(f"{k}_ema" for k in EMA_SUBTREES)
    params = [p for name, p in model.named_parameters()
              if name.split(".")[0] not in frozen + ema_names]
    optimizer = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=float(cfg.get("weight_decay", 0.0)))
    ema_m = None
    if ((cfg.get("model_kwargs") or {}).get("backbone2") or {}).get("create_ema", False):
        if not getattr(model, "has_ema", False):
            raise ValueError("the recipe asks for an EMA; build the model from the same "
                             "model_kwargs (backbone2.create_ema)")
        model.copy_to_ema_()
        ema_m = float(model.ema_m)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, ema_m=ema_m)
