"""Occupancy grid (counterpart of the JAX ops/occupancy.py).

The grid is a float density EMA plus a float {0, 1} mask; a lookup is a
multiplicative density mask.  Cells are ``trunc((x - mu) / sigma * G)``
clipped into the grid: the conversion truncates toward zero before the
clip, as the JAX ``astype(int32)`` does, and the flat index is
``(cx * G + cy) * G + cz``.  ``update`` is one training-time culling round:
decay the EMA and re-evaluate the density at jittered centres of a random
subset of cells.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGrid(NamedTuple):
    density: torch.Tensor    # (G, G, G) float32 density EMA
    mask: torch.Tensor       # (G, G, G) float32 in {0.0, 1.0}
    threshold: torch.Tensor  # scalar


def init_grid(resolution: int = 256, threshold: float = 0.01,
              device=None) -> OccupancyGrid:
    """All cells occupied (never-visited cells hold +inf density)."""
    g = resolution
    return OccupancyGrid(
        density=torch.full((g, g, g), float("inf"), dtype=torch.float32,
                           device=device),
        mask=torch.ones((g, g, g), dtype=torch.float32, device=device),
        threshold=torch.tensor(threshold, dtype=torch.float32, device=device))


def cell_indices(points, mu, sigma, resolution: int):
    """World points (..., 3) -> integer cells (..., 3), clipped."""
    xn = (points - mu) / sigma * resolution
    return torch.clamp(xn.to(torch.int32), 0, resolution - 1)


def lookup(grid: OccupancyGrid, points, mu, sigma):
    """(..., 3) points -> (...) mask values (1.0 where occupied)."""
    g = grid.mask.shape[0]
    c = cell_indices(points, mu, sigma, g).long()
    flat = (c[..., 0] * g + c[..., 1]) * g + c[..., 2]
    return grid.mask.reshape(-1)[flat]


def update(grid: OccupancyGrid, density_fn, mu, sigma, *,
           num_cells: int = 2 ** 18, decay: float = 0.95, generator=None,
           flat_idx=None, jitter=None) -> OccupancyGrid:
    """One culling round (a new grid; the old one is not modified).

    ``density_fn`` maps (N, 3) world points to (N,) density.  Cells never
    visited hold +inf (occupied) and take the fresh estimate directly;
    visited cells take max(decayed, fresh).  ``flat_idx`` (num_cells,) and
    ``jitter`` (num_cells, 3) replace the draws from ``generator``.  A cell
    drawn twice in one round gets several candidate values; the JAX
    ``.at[].set`` keeps an unspecified one, and this port keeps the largest
    (``scatter_reduce`` amax), which is one of them and does not depend on
    the device or the order of the writes."""
    g = grid.density.shape[0]
    dev = grid.density.device
    if flat_idx is None:
        flat_idx = torch.randint(0, g * g * g, (num_cells,),
                                 generator=generator, device=dev)
    if jitter is None:
        jitter = torch.rand((flat_idx.shape[0], 3), generator=generator,
                            device=dev)
    cells = torch.stack([flat_idx // (g * g), (flat_idx // g) % g,
                         flat_idx % g], dim=-1).to(torch.float32)
    pts = (cells + jitter) / g * sigma + mu
    d = torch.clamp(density_fn(pts), min=0.0)
    dens = grid.density.reshape(-1)
    decayed = torch.where(torch.isinf(dens), dens, dens * decay)
    old = decayed[flat_idx]
    new = torch.where(torch.isinf(old), d, torch.maximum(old, d))
    density = decayed.scatter_reduce(0, flat_idx, new, reduce="amax",
                                     include_self=False).reshape(g, g, g)
    mask = (torch.isinf(density) | (density > grid.threshold)).to(
        torch.float32)
    return OccupancyGrid(density, mask, grid.threshold)


def occupied_fraction(grid: OccupancyGrid):
    return torch.mean(grid.mask)


@torch.no_grad()
def update_from_field(grid: OccupancyGrid, field, scene, cfg, *,
                      num_cells: int = 2 ** 18, decay: float = 0.95,
                      generator=None, flat_idx=None,
                      jitter=None) -> OccupancyGrid:
    """One culling round against the model's own density field (f32):
    ``update`` of ``num_cells`` cells with ``decay``, the JAX function's
    defaults (callers that need a large grid to converge on a short budget
    pass a scaled count).  A given ``flat_idx`` must hold ``num_cells``
    cells."""
    from human_body_reconstruction_tpu_torch.models import nerf

    if flat_idx is not None and flat_idx.shape[0] != num_cells:
        raise ValueError(f"flat_idx holds {flat_idx.shape[0]} cells, "
                         f"num_cells is {num_cells}")
    return update(grid, lambda p: nerf.density_only(field, scene, p, cfg),
                  scene["mu"], scene["sigma"], num_cells=num_cells,
                  decay=decay, generator=generator, flat_idx=flat_idx,
                  jitter=jitter)
