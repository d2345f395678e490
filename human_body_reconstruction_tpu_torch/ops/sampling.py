"""Sample placement along rays, eval mode (counterpart of the JAX
ops/sampling.py).

Serving renders are deterministic: the stratified ladder has no jitter, the
inverse CDF draws fixed quantiles ``u = linspace(0, 1 - 1e-6, K)``, and the
occupancy-guided placement probes interval midpoints with no exploration
floor.  The training-time random variants are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import occupancy as occ_lib


def _f32(x) -> float:
    """A Python float holding the f32 rounding of x: scalars enter the
    tensor ops as kernel arguments, with no host-to-device copy."""
    return float(np.float32(x))


def linspace(start: float, stop: float, num: int, device=None):
    """f32 ``start * (1 - s) + stop * s`` with ``s = i / (num - 1)`` and an
    exact endpoint: the formula ``jnp.linspace`` uses."""
    start, stop = _f32(start), _f32(stop)
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([start * (1.0 - s) + stop * s,
                      torch.full((1,), stop, dtype=torch.float32,
                                 device=device)])


def stratified_ts(batch_shape, near: float, far: float, num_samples: int,
                  log_sampling: bool = False, device=None):
    """The unjittered sample ladder, broadcast to batch_shape + (S,)."""
    if log_sampling:
        t = torch.exp(linspace(math.log(near), math.log(far), num_samples,
                               device))
    else:
        t = linspace(near, far, num_samples, device)
    return t.expand(tuple(batch_shape) + (num_samples,))


def sample_pdf(bins, weights, num_samples: int, *, eps: float = 1e-5, u=None):
    """Deterministic inverse-CDF sampling of a piecewise-constant pdf.

    bins (..., S) sorted; weights (..., S-1) non-negative.  ``u`` (broadcast
    to (..., num_samples)) replaces the fixed quantiles, for tests.  The
    JAX version computes each pick as a masked reduction; the largest j
    with ``cdf_j <= u`` is ``searchsorted(cdf, u, right=True) - 1``, which
    picks the same bins.  Returns (..., num_samples) in [bins[0], bins[-1]].
    """
    weights = torch.clamp(weights, min=0.0) + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (num_samples,)
    if u is None:
        u = linspace(0.0, 1.0 - 1e-6, num_samples, cdf.device)
    u = torch.broadcast_to(torch.as_tensor(u, dtype=cdf.dtype,
                                           device=cdf.device), shape)
    cdf = cdf.contiguous()
    below = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    # u >= cdf[-1] leaves the above-set empty: clamp to the last bin
    above = torch.clamp(below + 1, max=cdf.shape[-1] - 1)
    bins = torch.broadcast_to(bins, cdf.shape)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return bins_below + frac * (bins_above - bins_below)


def occupancy_guided_ts(rays_o, rays_d, occ, mu, sigma, near: float,
                        far: float, num_samples: int, num_probe: int = 0,
                        eps: float = 1e-3, dt_mode: str = "clip"):
    """Eval-mode occupancy-guided placement: probe ``num_probe`` interval
    midpoints against the grid, place ``num_samples`` samples at fixed
    quantiles of each ray's occupied-interval CDF.  Returns (t (B, K)
    sorted, dt (B, K)); ``dt_mode`` "mass" is the importance-weighted
    dt = h*W/(K*m), "clip" runs dt to the next sample clipped at the
    sample's interval end (see the JAX docstring for both)."""
    M = num_probe or 2 * num_samples
    dev = rays_o.device
    near, far = _f32(near), _f32(far)
    h = _f32(np.float32(far - near) / np.float32(M))
    idx = torch.arange(M, dtype=torch.float32, device=dev)
    tm = near + (idx + 0.5) * h                                     # (M,)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * tm[None, :, None]
    m = occ_lib.lookup(occ, pts, mu, sigma)                         # (B, M)
    bins = near + torch.arange(M + 1, dtype=torch.float32, device=dev) * h
    bins = bins.expand(m.shape[:-1] + (M + 1,))
    t = sample_pdf(bins, m, num_samples, eps=eps)                   # sorted
    interval = torch.floor((t - near) / h)                          # (B, K)
    if dt_mode == "mass":
        K = num_samples
        W = torch.sum(m, dim=-1, keepdim=True)                      # (B, 1)
        inside = (interval >= 0) & (interval < M)
        slot = torch.clamp(interval, 0, M - 1).long()
        m_t = torch.where(inside, torch.gather(m, -1, slot),
                          torch.zeros_like(t))
        dt = h * W / (K * torch.clamp(m_t, min=1e-8))
        dt = torch.where(m_t >= 1.0 - 1e-6, dt, torch.clamp(dt, max=h))
        dt = torch.where(W > 1e-6, dt,
                         _f32(np.float32(far - near) / np.float32(K)))
        return t, dt
    interval_end = near + (interval + 1.0) * h
    t_next = torch.cat([t[..., 1:], torch.full_like(t[..., :1], far)], dim=-1)
    dt = torch.minimum(t_next, interval_end) - t
    return t, torch.clamp(dt, min=0.0)
