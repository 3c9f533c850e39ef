"""Soft normalized cut over DINO feature affinities (port of ``rcf_tpu/grouping/ncut.py``).

As the reference (`tools/SemanticConstraintsAndMAA/maa.py:19-36`,
`semantic_constraints.py:21-75`) and the JAX package:

* affinity ``A = (f̂ f̂ᵀ) > tau ? 1 : eps`` over L2-normalized patch key
  features (token 0, the CLS, dropped);
* ``NCut(x) = cut(x, 1-x)/assoc(x) + cut(x, 1-x)/assoc(1-x)`` of the soft
  mask ``x`` flattened at the feature grid;
* refinement: the mask is the parameter of 10 Adam steps on the NCut value
  (torch's additive weight decay 1e-6, then optax's ``scale_by_adam``
  with b1 0.9, b2 0.999, eps 1e-8 and bias correction, then a step of
  -0.45), clamped to [0, 1] after every step. The gradient comes from
  autograd.

Each function takes one frame or a batch of frames (leading dimensions);
each frame keeps its own affinity, value and refinement, so a batch only
issues fewer, larger launches (the semantic constraint's eight frames a
step would otherwise leave the card waiting for ~3,200 small ones).

All products run with TF32 off (``utils/precision.full_f32``): a TF32
error of ~1e-3 flips affinity pairs near ``tau``. Spans (``train/metrics.py``):
``rcf.ncut.affinity`` around ``build_affinity``, ``rcf.ncut.refine`` around
the Adam steps; ``grouping.STATS["ncut_steps"]`` counts the steps of every frame.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..utils.precision import full_f32
from . import STATS


def build_affinity(feats: torch.Tensor, tau: float = 0.2, eps: float = 1e-5) -> torch.Tensor:
    """feats [..., N+1, D] (token 0 = CLS, dropped) -> [..., N, N] thresholded affinity, f32."""
    with record_function("rcf.ncut.affinity"):
        f = feats[..., 1:, :].float()
        f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-12)
        with full_f32():
            a = (f @ f.mT) > tau
        return torch.where(a, 1.0, eps).to(torch.float32)


def _ncut_from_affinity(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """a [..., N, N], mask [..., h, w] (or [..., N]) -> the NCut values [...]."""
    x = mask.reshape(*a.shape[:-2], -1).float()
    with full_f32():
        ax = (a @ x[..., None])[..., 0]
        cut_ab = ((1.0 - x) * ax).sum(-1)
        assoc_bv = (a @ (1.0 - x)[..., None]).sum((-2, -1))
    return cut_ab / ax.sum(-1) + cut_ab / assoc_bv


def soft_ncut_value(feats: torch.Tensor, mask: torch.Tensor, tau: float = 0.2,
                    eps: float = 1e-5) -> torch.Tensor:
    """feats [..., N+1, D]; mask [..., h, w] (or [..., N]) soft in [0, 1] -> the NCut values [...]."""
    return _ncut_from_affinity(build_affinity(feats, tau, eps), mask)


def ncut_refine(feats: torch.Tensor, mask: torch.Tensor, tau: float = 0.2, eps: float = 1e-5,
                steps: int = 10, learning_rate: float = 0.45,
                weight_decay: float = 1e-6) -> torch.Tensor:
    """Gradient-refine soft masks [..., h, w] against the NCut objective of
    feats [..., N+1, D], each frame on its own."""
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    a = build_affinity(feats, tau, eps)
    STATS["ncut_steps"] += steps * a.shape[:-2].numel()
    with record_function("rcf.ncut.refine"):
        m = mask.detach().float().clone()
        mu, nu = torch.zeros_like(m), torch.zeros_like(m)
        for t in range(1, steps + 1):
            mm = m.clone().requires_grad_(True)
            # A frame's value depends on its own mask alone: the sum's gradient is each one's.
            (grad,) = torch.autograd.grad(_ncut_from_affinity(a, mm).sum(), mm)
            with torch.no_grad():
                g = grad + weight_decay * m
                mu = (1.0 - b1) * g + b1 * mu
                nu = (1.0 - b2) * g * g + b2 * nu
                mu_hat = mu / (1.0 - b1 ** t)
                nu_hat = nu / (1.0 - b2 ** t)
                m = torch.clamp(m + (-learning_rate) * (mu_hat / (torch.sqrt(nu_hat) + adam_eps)),
                                0.0, 1.0)
        return m
