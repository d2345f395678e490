"""Occupancy grid lookups (counterpart of the JAX ops/occupancy.py).

The grid is a float density EMA plus a float {0, 1} mask; a lookup is a
multiplicative density mask.  Cells are ``trunc((x - mu) / sigma * G)``
clipped into the grid: the conversion truncates toward zero before the
clip, as the JAX ``astype(int32)`` does, and the flat index is
``(cx * G + cy) * G + cz``.  The EMA update belongs to training and is not
ported yet.
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
