"""Dense coarse levels (counterpart of the JAX ops/dense_grid.py).

The first ``cfg.dense_levels`` levels store a dense (G, G, G, F) grid each,
trilinearly interpolated.  The level geometry (``grid_size``,
``dense_grid_sizes``, ``auto_dense_levels``) is host numpy, as in the JAX
package.  ``dense_encode`` is the plain PyTorch version of the JAX XLA path
(``dense_grid.dense_encode``), rounding where it rounds in bf16 compute:

  wx, wy, wz = bf16(1 - bf16(frac)), bf16(frac)  (two-hot rows in bf16)
  w_yz       = bf16(wy * wz)
  T_i        = sum_jk w_yz * bf16(grid)         (f32 accumulation)
  out        = sum_i T_i * wx_i                 (f32)

It gathers the 8 corners instead of forming the two-hot matrix product,
which sums the same non-zero terms.  The serving path runs the Pallas
kernel's numerics instead (ops/dense_kernel.py).
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.utils.config import HashConfig, level_scales


def grid_size(scale: float) -> int:
    """Corner-grid side for a level of resolution ``scale``."""
    return int(np.floor(scale)) + 2


def dense_grid_sizes(cfg: HashConfig) -> list:
    scales = level_scales(cfg)
    return [grid_size(float(scales[l])) for l in range(cfg.dense_levels)]


def auto_dense_levels(cfg: HashConfig, flop_budget: float = 2.0 ** 19,
                      max_side: int = 64) -> int:
    """Coarse levels whose per-point contraction 2*G^3*F stays under
    ``flop_budget`` and whose side stays at most ``max_side`` (the JAX
    package's rule; the flagship gets 2)."""
    scales = level_scales(cfg)
    d = 0
    for l in range(cfg.num_levels):
        g = grid_size(float(scales[l]))
        if g > max_side or 2.0 * g ** 3 * cfg.features_per_level > flop_budget:
            break
        d += 1
    return d


def init_dense(cfg: HashConfig, generator: torch.Generator):
    """(G, G, G, F) grids, U(-init_scale, init_scale), on the generator's
    device."""
    dev = generator.device
    return [torch.empty((g, g, g, cfg.features_per_level), device=dev)
            .uniform_(-cfg.init_scale, cfg.init_scale, generator=generator)
            for g in dense_grid_sizes(cfg)]


def round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def normalise(x, mu, sigma):
    """World points -> normalised scene coordinates (f32)."""
    return (x.to(torch.float32) - mu) / sigma


def axis_coords(xl, g: int):
    """Level coordinates xl = xn * scale -> (cell x0 (long), frac) with
    x0 = clip(floor(xl), 0, g-2), frac = clip(xl - floor(xl), 0, 1).
    The position itself is never clamped."""
    x0f = torch.floor(xl)
    frac = torch.clamp(xl - x0f, 0.0, 1.0)
    return torch.clamp(x0f, 0.0, float(g - 2)).long(), frac


def corner_values(grid, x0):
    """grid (G, G, G, F), cells (N, 3) -> corner features (N, 2, 2, 2, F)
    indexed [n, a, b, c] for the corner (x0 + a, y0 + b, z0 + c)."""
    one = torch.arange(2, device=x0.device)
    ix = (x0[:, 0, None] + one)[:, :, None, None]
    iy = (x0[:, 1, None] + one)[:, None, :, None]
    iz = (x0[:, 2, None] + one)[:, None, None, :]
    return grid[ix, iy, iz]


def dense_encode(grids, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, dense_levels * F) features, f32."""
    if cfg.dim != 3 or len(grids) != cfg.dense_levels:
        raise ValueError("dense grids are 3-D, one per dense level")
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    scales = level_scales(cfg)
    xn = normalise(x, mu, sigma)
    outs = []
    for l, grid in enumerate(grids):
        x0, frac = axis_coords(xn * float(np.float32(scales[l])),
                               grid.shape[0])
        fb = rnd(frac)
        w = torch.stack([rnd(1.0 - fb), fb], dim=-1)                # (N, 3, 2)
        w_yz = rnd(w[:, 1, :, None] * w[:, 2, None, :])             # (N, 2, 2)
        corners = rnd(corner_values(grid.to(torch.float32), x0))    # (N,2,2,2,F)
        t = (w_yz[:, None, :, :, None] * corners).sum(dim=(2, 3))   # (N, 2, F)
        outs.append((t * w[:, 0, :, None]).sum(dim=1))              # (N, F)
    return torch.cat(outs, dim=-1)
