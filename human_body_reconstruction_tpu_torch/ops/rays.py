"""Camera rays and scene bounds (counterpart of the JAX ops/rays.py).

Pixel (i, j) maps to the camera-space direction ``((i - cx)/fx,
-(j - cy)/fy, -1)`` rotated by ``c2w[:3, :3]``.  The rotation is written as
a broadcast multiply and sum rather than a matrix product, so that no TF32
setting can change it on the card.
"""

from __future__ import annotations

import torch


def pixel_dirs(i, j, K):
    """Camera-space (unnormalised) directions (..., 3) for pixel centres."""
    x = (i - K[0, 2]) / K[0, 0]
    y = -(j - K[1, 2]) / K[1, 1]
    z = -torch.ones_like(x)
    return torch.stack([x, y, z], dim=-1)


def rays_for_pixels(i, j, K, c2w):
    """World-space rays through pixels (i, j) of one camera.

    ``c2w`` is (4, 4) or (..., 4, 4), broadcastable against the pixels.
    Returns (rays_o (..., 3), unit rays_d (..., 3), dir_norm (..., 1)).
    """
    dirs = pixel_dirs(i.to(torch.float32), j.to(torch.float32), K)
    R = c2w[..., :3, :3]
    rays_d = (R * dirs[..., None, :]).sum(dim=-1)
    rays_o = torch.broadcast_to(c2w[..., :3, 3], rays_d.shape)
    dir_norm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d / dir_norm, dir_norm


def _pixel_grid(H: int, W: int, device):
    j, i = torch.meshgrid(torch.arange(H, device=device),
                          torch.arange(W, device=device), indexing="ij")
    return i.reshape(-1), j.reshape(-1)


def full_image_rays(H: int, W: int, K, c2w):
    """All H*W rays of one camera, row-major."""
    i, j = _pixel_grid(H, W, K.device)
    return rays_for_pixels(i, j, K, c2w)


def scene_bounds(H: int, W: int, K, c2ws, near: float, far: float,
                 margin: float = 1.5):
    """Axis-aligned bounds (min (3,), max (3,)) of every ray of every pose
    at t in {near, far + margin}."""
    t = torch.tensor([near, far + margin], dtype=torch.float32,
                     device=K.device)
    i, j = _pixel_grid(H, W, K.device)
    o, d, _ = rays_for_pixels(i, j, K, c2ws[:, None, :, :])
    pts = (o[..., None, :] + d[..., None, :] * t[None, None, :, None])
    pts = pts.reshape(-1, 3)
    return pts.amin(dim=0), pts.amax(dim=0)
