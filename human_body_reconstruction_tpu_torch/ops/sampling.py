"""Sample placement along rays (counterpart of the JAX ops/sampling.py).

Serving renders are deterministic: the stratified ladder has no jitter, the
inverse CDF draws fixed quantiles ``u = linspace(0, 1 - 1e-6, K)``, and the
occupancy-guided placement probes interval midpoints with no exploration
floor.  Training (``jitter=True``) jitters the ladder per ray, draws the
inverse CDF's ``u`` iid or stratified, and may jitter the probes and route
a share of the sample mass to empty intervals.  The hierarchical
resampler (``hierarchical_ts``) draws its quantiles iid in both, as the
JAX one does.  NeuS up-sampling (``neus_upsample``, the ``neuralangelo``
head's) is deterministic given its first depths.  Every random draw comes
from an explicit ``torch.Generator`` and can be injected instead (``u``,
``xi``, ``probe_u``): the JAX package draws other bits from its keys, so the
tests hand both sides the same numbers.
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


def _uniform(shape, generator, device, high: float = 1.0):
    """U[0, high) in f32 from ``generator`` (which lives on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u if high == 1.0 else u * high


def stratified_ts(batch_shape, near: float, far: float, num_samples: int,
                  log_sampling: bool = False, device=None, *,
                  jitter: bool = False, per_ray_jitter: bool = True,
                  generator=None, u=None):
    """The sample ladder, broadcast to batch_shape + (S,).  With ``jitter``
    each sample moves by ``u * (far - near) / S`` with u ~ U[0, 1) per ray
    (or one u vector shared by the batch without ``per_ray_jitter``);
    ``u`` replaces the draw."""
    shape = tuple(batch_shape) + (num_samples,)
    if log_sampling:
        lo, hi = _f32(math.log(near)), _f32(math.log(far))
        base = linspace(lo, hi, num_samples, device)
    else:
        lo, hi = _f32(near), _f32(far)
        base = linspace(near, far, num_samples, device)
    t = base
    if jitter:
        if u is None:
            u = _uniform(shape if per_ray_jitter else (num_samples,),
                         generator, device)
        step = _f32(np.float32(np.float32(hi) - np.float32(lo))
                    / np.float32(num_samples))
        t = base + u * step
    if log_sampling:
        t = torch.exp(t)
    return t.expand(shape)


def sample_pdf(bins, weights, num_samples: int, *, eps: float = 1e-5, u=None,
               jitter: bool = False, stratified: bool = False,
               generator=None, xi=None):
    """Inverse-CDF sampling of a piecewise-constant pdf.

    bins (..., S) sorted; weights (..., S-1) non-negative.  The quantiles
    ``u`` are, unless given: fixed ``linspace(0, 1 - 1e-6, K)`` without
    ``jitter``; with it, ``(i + xi) / K`` for ``stratified`` (one draw per
    CDF stratum, so t comes out sorted) or iid, each draw U[0, 1 - 1e-6)
    (``xi`` replaces the stratified draw).  The JAX version computes each
    pick as a masked reduction; the largest j with ``cdf_j <= u`` is
    ``searchsorted(cdf, u, right=True) - 1``, which picks the same bins.
    Returns (..., num_samples) in [bins[0], bins[-1]].
    """
    weights = torch.clamp(weights, min=0.0) + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (num_samples,)
    if u is None and not jitter:
        u = linspace(0.0, 1.0 - 1e-6, num_samples, cdf.device)
    elif u is None and stratified:
        if xi is None:
            xi = _uniform(shape, generator, cdf.device, 1.0 - 1e-6)
        u = (torch.arange(num_samples, dtype=torch.float32,
                          device=cdf.device) + xi) / num_samples
    elif u is None:
        u = _uniform(shape, generator, cdf.device, 1.0 - 1e-6)
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
                        eps: float = 1e-3, dt_mode: str = "clip", *,
                        jitter: bool = False, explore_frac: float = 0.0,
                        probe_jitter: bool = False, stratified: bool = False,
                        generator=None, u=None, xi=None, probe_u=None):
    """Occupancy-guided placement: probe ``num_probe`` intervals of
    [near, far] against the grid, place ``num_samples`` samples by inverse
    CDF over each ray's occupied intervals.  Returns (t (B, K) sorted,
    dt (B, K)); ``dt_mode`` "mass" is the importance-weighted
    dt = h*W/(K*m), "clip" runs dt to the next sample clipped at the
    sample's interval end (see the JAX docstring for both).

    Eval (the defaults): midpoint probes, fixed quantiles, no exploration.
    Training: ``jitter`` draws the quantiles (``stratified`` or iid, then
    sorted), ``probe_jitter`` moves each probe uniformly within its
    interval (``probe_u`` (B, M) replaces that draw), and ``explore_frac``
    floors the empty intervals so that they get that share of each ray's
    mass.  ``u``/``xi`` go to :func:`sample_pdf`."""
    M = num_probe or 2 * num_samples
    dev = rays_o.device
    near, far = _f32(near), _f32(far)
    h = _f32(np.float32(far - near) / np.float32(M))
    idx = torch.arange(M, dtype=torch.float32, device=dev)
    if probe_jitter:
        if probe_u is None:
            probe_u = _uniform(rays_o.shape[:-1] + (M,), generator, dev)
        tm = near + (idx + probe_u) * h                              # (B, M)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * tm[..., None]
    else:
        tm = near + (idx + 0.5) * h                                  # (M,)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * tm[None, :, None]
    m = occ_lib.lookup(occ, pts, mu, sigma)                         # (B, M)
    if explore_frac > 0.0:
        n_occ = torch.sum(m, dim=-1, keepdim=True)                  # (B, 1)
        f = explore_frac
        c = (f / (1.0 - f)) * n_occ / torch.clamp(M - n_occ, min=1.0)
        m = m + c * (1.0 - m)
    bins = near + torch.arange(M + 1, dtype=torch.float32, device=dev) * h
    bins = bins.expand(m.shape[:-1] + (M + 1,))
    t = sample_pdf(bins, m, num_samples, eps=eps, u=u, jitter=jitter,
                   stratified=stratified, generator=generator, xi=xi)
    if jitter and not stratified:
        t = torch.sort(t, dim=-1).values             # iid u land unordered
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


def hierarchical_ts(t_coarse, weights, num_fine: int, *, generator=None,
                    u=None):
    """The coarse depths (..., S) merged with ``num_fine`` depths drawn by
    inverse CDF from the leading S - 1 weights (iid quantiles from
    ``generator``, or ``u``), sorted: (..., S + num_fine)."""
    w = weights[..., :t_coarse.shape[-1] - 1]
    t_fine = sample_pdf(t_coarse, w, num_fine, u=u, jitter=True,
                        generator=generator)
    return torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values


def _neus_fine(t, sdf, inv_s: float, n_fine: int):
    """(B, n_fine) depths drawn from the section alphas of f at sorted
    depths t (B, S) at sharpness ``inv_s`` (the source's
    ``sample_dists_hierarchical``, robust cosine): the weights'
    normalised CDF inverted at the n_fine midpoints of [0, 1]."""
    prev, nxt = sdf[..., :-1], sdf[..., 1:]
    t0, t1 = t[..., :-1], t[..., 1:]
    mid = (prev + nxt) * 0.5
    cos = (nxt - prev) / (t1 - t0 + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos[..., :1]), cos[..., :-1]], -1)
    cos = torch.minimum(prev_cos, cos)
    intv = t1 - t0
    prev_cdf = torch.sigmoid((mid - cos * intv * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * intv * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf) / (prev_cdf + 1e-5), 0.0, 1.0)
    front = torch.cat([torch.zeros_like(alpha[..., :1]), alpha[..., :-1]], -1)
    w = alpha * torch.cumprod(1.0 - front, dim=-1)
    pdf = w / torch.clamp(torch.sum(torch.abs(w), -1, keepdim=True),
                          min=1e-12)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf, -1)], -1).contiguous()
    grid = torch.linspace(0.0, 1.0, n_fine + 1, device=t.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(
        *cdf.shape[:-1], n_fine).contiguous()
    idx = torch.searchsorted(cdf, unif, right=True)
    low = torch.clamp(idx - 1, min=0)
    high = torch.clamp(idx, max=cdf.shape[-1] - 1)
    d0, d1 = torch.gather(t, -1, low), torch.gather(t, -1, high)
    c0, c1 = torch.gather(cdf, -1, low), torch.gather(cdf, -1, high)
    frac = (unif - c0) / (c1 - c0 + 1e-8)
    return d0 + frac * (d1 - d0)


def neus_upsample(t, rays_o, rays_d, sdf_fn, n_fine: int, rounds: int):
    """NeuS up-sampling (the source's ``sample_dists_all``): f at the
    depths t (B, S0), then ``rounds`` rounds, round h drawing ``n_fine``
    depths at sharpness 64 * 2^h, merged and sorted, f evaluated at the new
    depths of every round but the last.  ``sdf_fn`` maps (N, 3) world points
    to (N,) f.  Returns (B, S0 + rounds * n_fine) sorted depths; every shape
    is fixed, so a CUDA graph captures the loop."""
    B = t.shape[0]

    def at(ts):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]
        return sdf_fn(pts.reshape(-1, 3)).reshape(B, -1)

    sdf = at(t)
    for h in range(rounds):
        fine = _neus_fine(t, sdf, 64.0 * 2 ** h, n_fine)
        t, order = torch.sort(torch.cat([t, fine], -1), dim=-1, stable=True)
        if h != rounds - 1:
            sdf = torch.gather(torch.cat([sdf, at(fine)], -1), -1, order)
    return t
