"""Cross-entropy and BCE losses with mmdet's weighting (port of
``rcf_tpu/losses/cross_entropy.py``).

The reference builds ``models/cross_entropy_loss.py`` from the decode-head
configs but no RCF loss uses it; the JAX package and the port keep it for
completeness, so that a segmentation head can be supervised where labels
exist. Channel-last: logits ``[..., C]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, weight=None, reduction: str = "mean", avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is not None:
        return loss.sum() / avg_factor
    if weight is not None:
        return loss.sum() / torch.clamp(weight.sum(), min=1e-12)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight=None, class_weight=None,
                  reduction: str = "mean", avg_factor=None,
                  ignore_index: int = -100) -> torch.Tensor:
    """logits [..., C]; integer labels [...]. Ignored labels contribute 0 and
    are left out of the mean's count."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, safe[..., None].long())[..., 0]
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=nll.dtype, device=nll.device)[safe]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    vweight = valid.to(nll.dtype) if weight is None else weight * valid
    return _reduce(nll, vweight, reduction, avg_factor)


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, weight=None,
                         reduction: str = "mean", avg_factor=None,
                         pos_weight=None) -> torch.Tensor:
    """Sigmoid BCE with logits; targets in [0, 1]."""
    pos = targets * F.logsigmoid(logits) * (pos_weight if pos_weight is not None else 1.0)
    loss = -(pos + (1.0 - targets) * F.logsigmoid(-logits))
    return _reduce(loss, weight, reduction, avg_factor)


class CrossEntropyLoss:
    """Config-compatible callable (``models/cross_entropy_loss.py:123``)."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", class_weight=None, loss_weight: float = 1.0):
        if use_mask:
            raise NotImplementedError("mask CE is not used by any shipped config")
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None, reduction_override=None):
        reduction = reduction_override or self.reduction
        if self.use_sigmoid:
            loss = binary_cross_entropy(pred, target, weight, reduction, avg_factor)
        else:
            loss = cross_entropy(pred, target, weight, self.class_weight, reduction, avg_factor)
        return self.loss_weight * loss
