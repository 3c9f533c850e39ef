"""Mask regularizer losses, channel-last (port of ``rcf_tpu/losses/regularizers.py``).

* entropy and sharpen losses over the mask axis;
* the pseudo-label loss (one-sided weighted MSE; stage 2.2, and stage
  2.1's CRF loss);
* the compactness loss of one soft mask.

``quirk_log`` keeps the reference's quirk that the JAX package reproduces:
the "log" of the entropy and sharpen terms is a log-softmax applied to
*probabilities*, ``p - logsumexp(p)``, not ``log p``. The published weights
(``w_entropy: 0.05``) were tuned against it.

Each function mirrors the JAX one operation by operation, so that in bf16
the same intermediates are rounded: a bf16 input stays bf16 where JAX keeps
it bf16, and sums accumulate in f32 and round once, as ``jnp.sum`` does.
Masks are ``[..., C]`` with the mask axis last.
"""

from __future__ import annotations

import torch


def _one_hot(channel: int | torch.Tensor, c: int, like: torch.Tensor) -> torch.Tensor:
    """``jax.nn.one_hot(channel, c)`` on ``like``'s device and dtype, with no host copy."""
    return (torch.arange(c, device=like.device) == channel).to(like.dtype)


def quirk_log(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax`` applied to probabilities (the reference quirk)."""
    shifted = probs - probs.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


def entropy_loss(probs: torch.Tensor) -> torch.Tensor:
    """-(p * quirk_log p) summed over masks, mean over the rest."""
    return -(probs * quirk_log(probs)).sum(-1).mean()


def sharpen(p: torch.Tensor, t: float, dim: int = -1) -> torch.Tensor:
    """Temperature sharpening p^(1/T) / sum (PAWS-style)."""
    sharp = p ** (1.0 / t)
    return sharp / sharp.sum(dim, keepdim=True)


def sharpen_loss(probs: torch.Tensor, t_sharpen: float) -> torch.Tensor:
    """KL(p_sharp || p) elementwise mean, the sharp target without gradient."""
    target = sharpen(probs.detach(), t_sharpen)
    return (target * (torch.log(target) - quirk_log(probs))).mean()


def object_aware_sharpen_loss(probs: torch.Tensor, t_sharpen: float,
                              object_channel: int | torch.Tensor) -> torch.Tensor:
    """Hinge on |p_obj - max_{c != obj} p_c|: mean(relu(t - diff))."""
    onehot = _one_hot(object_channel, probs.shape[-1], probs)
    obj = (probs * onehot).sum(-1)
    others = probs.detach() * (1.0 - onehot)
    diff = (obj - others.amax(-1)).abs()
    return torch.clamp(t_sharpen - diff, min=0.0).mean()


def pseudo_label_loss(object_probs: torch.Tensor, target_masks: torch.Tensor,
                      pos_weight: float = 1.0, neg_weight: float = 1.0,
                      pos_th: float = -1.0) -> torch.Tensor:
    """One-sided weighted MSE between the object-channel mask and a target.

    ``pos_th != -1`` binarizes the target first.
    """
    if pos_th != -1.0:
        target_masks = (target_masks > pos_th).float()
    gap = target_masks.float() - object_probs.float()
    loss_pos = (torch.clamp(gap, min=0.0) ** 2).mean() * pos_weight
    loss_neg = (torch.clamp(gap, max=0.0) ** 2).mean() * neg_weight
    return loss_pos + loss_neg


def compactness_loss(compact_probs: torch.Tensor) -> torch.Tensor:
    """GWM-style spatial compactness of one soft mask [N, H, W].

    Mask mass weighted by its squared distance to the soft centroid, with
    coordinates normalized by H and W. The grids are made on the mask's
    device.
    """
    n, h, w = compact_probs.shape
    m = compact_probs.float()
    dev = m.device
    y = (torch.arange(h, dtype=torch.float32, device=dev) / h)[None, :, None]
    x = (torch.arange(w, dtype=torch.float32, device=dev) / w)[None, None, :]
    count = m.sum((1, 2), keepdim=True)
    yc = (y * m).sum((1, 2), keepdim=True) / count
    xc = (x * m).sum((1, 2), keepdim=True) / count
    err = (y - yc) ** 2 + (x - xc) ** 2
    return (err * m).mean()
