"""Emission-absorption compositing (counterpart of the JAX ops/compositing.py).

  dt_i  = t_{i+1} - t_i (last dt = 0) unless given, times |d|
  sigma = max(sigma, sigma_clip_min)
  alpha = 1 - exp(-sigma * dt)
  T_i   = exp(-sum_{j<i} sigma_j dt_j)        (exclusive transmittance)
  C     = sum_i T_i * alpha_i * rgb_i

SDF mode (``composite_sdf``): phi = clip(sigmoid(b * s), 1e-6, 1),
alpha_i = relu(1 - phi_{i+1} / phi_i), last alpha 0, T = exclusive
cumprod(1 - alpha); dt is not used.

NeuS section alphas (``neus_alphas``, the ``neuralangelo`` head, the
source's ``compute_neus_alphas``): with the interval to the next depth
(the last one's to ``far``) and the annealed cosine c = -(relu(0.5 - 0.5
cos) (1 - a) + relu(-cos) a), f_i^-+ = f_i -+ c delta_i / 2 and alpha_i =
clip((Phi_s(f_i^-) - Phi_s(f_i^+)) / (Phi_s(f_i^-) + 1e-5), 0, 1), Phi_s
the sigmoid at sharpness s; ``alpha_weights`` composites them, w_i =
alpha_i prod_{j<i} (1 - alpha_j).
"""

from __future__ import annotations

import torch


def exclusive_cumsum(x, dim: int = -1):
    """Cumulative sum shifted right by one, with a leading zero."""
    c = torch.cumsum(x, dim=dim)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    return torch.cat([zero, c.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def exclusive_cumprod(x, dim: int = -1):
    """Cumulative product shifted right by one, with a leading one."""
    c = torch.cumprod(x, dim=dim)
    one = torch.ones_like(c.narrow(dim, 0, 1))
    return torch.cat([one, c.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def composite(t, rgb, sigma, dir_norm=None, *, sigma_clip_min: float = -10.0,
              white_background: bool = False, dt=None):
    """t (..., S), rgb (..., S, 3), sigma (..., S); ``dir_norm`` (..., 1)
    or (...,) scales dt to metric distance; ``dt`` (..., S) overrides the
    neighbour differences.  Returns (color (..., 3), weights, trans)."""
    if dt is None:
        dt = torch.cat([t[..., 1:] - t[..., :-1], torch.zeros_like(t[..., :1])],
                       dim=-1)
    if dir_norm is not None:
        dt = dt * (dir_norm if dir_norm.dim() == t.dim() else dir_norm[..., None])
    sigma = torch.clamp(sigma, min=sigma_clip_min)
    prod = sigma * dt
    alpha = 1.0 - torch.exp(-prod)
    trans = torch.exp(-exclusive_cumsum(prod, dim=-1))
    weights = trans * alpha
    color = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_background:
        color = color + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return color, weights, trans


def composite_sdf(t, rgb, sdf, b, dir_norm=None):
    """NeuS-style compositing of an SDF-like field: sdf (..., S) is the
    density channel read as a signed field, b the learned sharpness (a
    scalar tensor).  t and dir_norm are not used.  Returns (color (..., 3),
    weights, trans)."""
    del t, dir_norm
    # the sigmoid as the JAX package writes it; maximum and minimum (not
    # clamp) split a tie's gradient in halves, as jnp.clip and jnp.maximum
    # do: two equal neighbours (masked samples, sdf 0) tie at alpha 0
    sig = 1.0 / (1.0 + torch.exp(-(b * sdf)))
    phi = torch.minimum(torch.maximum(sig, torch.full_like(sig, 1e-6)),
                        torch.ones_like(sig))
    ratio = phi[..., 1:] / phi[..., :-1]
    alpha = torch.maximum(1.0 - ratio, torch.zeros_like(ratio))
    alpha = torch.cat([alpha, torch.zeros_like(alpha[..., :1])], dim=-1)
    trans = exclusive_cumprod(1.0 - alpha, dim=-1)
    weights = trans * alpha
    color = torch.sum(weights[..., None] * rgb, dim=-2)
    return color, weights, trans


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis whose backward is autograd's
    for inputs without zeros, reversed_cumsum(grad * out) / input, taken
    without autograd's check for zeros: that check reads the device from
    the host, which a CUDA graph's capture refuses.  For inputs that hold
    no zero alone."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        w = (grad * out).flip(-1).cumsum(-1).flip(-1)
        return w / x


def alpha_weights(alpha):
    """Compositing weights of alphas (..., S): alpha times the product of
    (1 - alpha) over the samples in front.  NeuS alphas stay below 1
    (``neus_alphas``: at most p / (p + 1e-5)), so no factor is zero and
    the product's backward divides by it."""
    front = torch.cat([torch.zeros_like(alpha[..., :1]), alpha[..., :-1]],
                      dim=-1)
    return alpha * _Cumprod.apply(1.0 - front)


def neus_alphas(sdf, cos, t, far: float, inv_s, anneal, eps: float = 1e-5):
    """Section alphas (B, S) of signed distances ``sdf`` at depths ``t``
    (B, S) whose true cosine with the ray is ``cos``; ``inv_s`` the
    sharpness, ``anneal`` the cosine anneal's ratio in [0, 1]."""
    iter_cos = -(torch.relu(-cos * 0.5 + 0.5) * (1.0 - anneal)
                 + torch.relu(-cos) * anneal)
    ends = torch.cat([t, torch.full_like(t[..., :1], far)], dim=-1)
    intv = ends[..., 1:] - ends[..., :-1]
    prev_cdf = torch.sigmoid((sdf - iter_cos * intv * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * intv * 0.5) * inv_s)
    return torch.clamp((prev_cdf - next_cdf) / (prev_cdf + eps), 0.0, 1.0)


def psnr(pred, target, max_val: float = 1.0):
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / mse)
