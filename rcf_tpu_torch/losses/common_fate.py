"""Relaxed common-fate loss primitives, channel-last (port of ``rcf_tpu/losses/common_fate.py``).

* ``norm_and_clamp_flow`` - flow preprocessing;
* ``demean_affine_flow``  - closed-form per-mask affine motion by weighted
  least squares over mask-normalized, centred moments, solved in f32 with a
  small relative ridge, on coordinates normalized to [0, 1) (the JAX
  package's documented deviation from the reference's pixel indices: the
  prediction is the same, the f32 solve better conditioned);
* ``residual_adjustment`` - tanh-bounded, mask-gated residual;
* ``common_fate_loss``    - L1 or outlier-robust reconstruction gap.

Masks ``[B, H, W, C]`` (softmaxed over C), flow ``[B, H, W, 2]``,
residuals ``[B, H, W, 2, C]`` (component-major). ``promoted_einsum``
promotes its operands to one dtype as ``jnp.einsum`` does (bf16 with f32
gives f32); ``torch.einsum`` wants equal dtypes.
"""

from __future__ import annotations

import functools

import torch


def promoted_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` after promoting the operands to their common dtype, as JAX does."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(equation, *(o.to(dt) for o in operands))


def norm_and_clamp_flow(flow: torch.Tensor, norm_flow: bool = False,
                        clamp_flow_t: float | None = None,
                        filter_flow_t: float | None = None) -> torch.Tensor:
    """Optionally normalize by the global abs-max, clamp, and zero small flow."""
    if norm_flow:
        flow = flow / flow.abs().amax()
    if clamp_flow_t is not None:
        flow = flow.clamp(-clamp_flow_t, clamp_flow_t)
    if filter_flow_t is not None:
        flow = torch.where(flow.abs() < filter_flow_t, torch.zeros_like(flow), flow)
    return flow


@functools.lru_cache(maxsize=32)
def _coord_map(h: int, w: int, quadratic: bool, device: torch.device) -> torch.Tensor:
    """[H*W, K] f32 coordinate basis (y, x) or (y, x, y^2, x^2, yx) in [0, 1), made on ``device``."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) / h)[:, None].expand(h, w)
    xs = (torch.arange(w, dtype=torch.float32, device=device) / w)[None, :].expand(h, w)
    cols = [ys, xs]
    if quadratic:
        cols += [ys * ys, xs * xs, ys * xs]
    return torch.stack([c.reshape(-1) for c in cols], dim=-1)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for a batch of small f32 systems, without a host check of the result.

    ``torch.linalg.solve`` reads its error code on the host, which waits for
    the stream; JAX's solve never raises either (a singular system gives
    non-finite values).
    """
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def demean_affine_flow(masks: torch.Tensor, flow: torch.Tensor, quadratic: bool = False,
                       ridge: float = 1e-6) -> torch.Tensor:
    """Closed-form de-meaned per-mask affine flow, summed over masks, in f32.

    masks [B, H, W, C], flow [B, H, W, 2] -> [B, H, W, 2]:
    sum_c mask_c * A*_c (omega - mu_omega_c), where A*_c minimizes the
    mask-weighted squared error to the de-meaned flow.
    """
    b, h, w, c = masks.shape
    p = h * w
    m = masks.reshape(b, p, c).float()
    f = flow.reshape(b, p, 2).float()
    omega = _coord_map(h, w, quadratic, masks.device)  # [P, K]
    k = omega.shape[-1]

    mhat = m / m.sum(1, keepdim=True)
    mu_f = torch.einsum("bpc,bpk->bck", mhat, f)      # [B, C, 2]
    mu_w = torch.einsum("bpc,pk->bck", mhat, omega)   # [B, C, K]

    # Centred before the contraction: raw moments minus mean products cancel
    # catastrophically in f32.
    wd = omega[None, :, None, :] - mu_w[:, None, :, :]          # [B, P, C, K]
    fd = f[:, :, None, :] - mu_f[:, None, :, :]                 # [B, P, C, 2]
    s_fw = torch.einsum("bpc,bpck,bpcl->bckl", mhat, fd, wd)    # [B, C, 2, K]
    s_ww = torch.einsum("bpc,bpck,bpcl->bckl", mhat, wd, wd)    # [B, C, K, K]

    # Relative ridge: the solve stays well posed when a mask collapses.
    diag_scale = s_ww.diagonal(dim1=-2, dim2=-1).sum(-1).mean(-1) / k  # [B]
    eye = torch.eye(k, dtype=torch.float32, device=masks.device)
    s_ww = s_ww + (ridge * diag_scale)[:, None, None, None] * eye

    a_star = solve(s_ww, s_fw.transpose(-1, -2)).transpose(-1, -2)  # [B, C, 2, K]
    pred = torch.einsum("bpc,bckl,bpcl->bpk", m, a_star, wd)
    return pred.reshape(b, h, w, 2)


def residual_adjustment(residual: torch.Tensor, masks: torch.Tensor, scale: float = 10.0,
                        div_coeff: float = 10.0) -> torch.Tensor:
    """Mask-gated tanh-bounded residual flow.

    residual [B, H, W, 2, C], masks [B, H, W, C] -> [B, H, W, 2].
    ``scale == -1`` disables the tanh bound.
    """
    if scale == -1.0:
        return promoted_einsum("bhwkc,bhwc->bhwk", residual, masks)
    bounded = torch.tanh(residual / div_coeff)
    return promoted_einsum("bhwkc,bhwc->bhwk", bounded, masks) * scale


def common_fate_loss(gt_flow: torch.Tensor, pred_flow: torch.Tensor, outlier_robust: bool = False,
                     eps: float = 0.01, q: float = 0.4) -> torch.Tensor:
    """Reconstruction gap: mean |gt - pred|, or mean (|gt - pred| + eps)^q."""
    diff = (gt_flow.float() - pred_flow.float()).abs()
    if outlier_robust:
        return ((diff + eps) ** q).mean()
    return diff.mean()
