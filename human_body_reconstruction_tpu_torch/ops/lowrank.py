"""CP factor-line encoding of the fine levels (counterpart of the JAX
ops/lowrank.py).

Each fine level stores a rank-R CP factorisation of its feature grid, three
1-D factor lines of length G_l:

    feat_l[r](x, y, z) = a_l[x, r] * b_l[y, r] * c_l[z, r]

with each line linearly interpolated at the level's resolution.
``cp_encode`` is the plain PyTorch version of the JAX XLA path: per axis, a
two-hot interpolation matrix W (B, sum_G) times the block-diagonal factor
matrix M (sum_G, L*R), with W = (bf16(1 - bf16(frac)), bf16(frac)) and M in
bf16 under ``cfg.dense_bf16``, f32 accumulation.  ``cp_encode_reference`` is
the direct-gather f32 reference.  The serving path runs the Pallas kernel's
numerics instead (ops/cp_kernel.py).
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.utils.config import (
    HashConfig, fine_scales, level_scales)


def cp_line_sizes(cfg: HashConfig) -> list:
    """Line length G_l = floor(N_l) + 2 of each CP level."""
    scales = level_scales(cfg)
    return [int(np.floor(float(scales[l]))) + 2
            for l in range(cfg.dense_levels, cfg.num_levels)]


def init_lines(cfg: HashConfig, generator: torch.Generator):
    """(dim, G_l, R) lines per CP level, U(-cp_init_scale, cp_init_scale),
    on the generator's device."""
    dev = generator.device
    return [torch.empty((cfg.dim, g, cfg.cp_rank), device=dev)
            .uniform_(-cfg.cp_init_scale, cfg.cp_init_scale,
                      generator=generator)
            for g in cp_line_sizes(cfg)]


def _check(lines, cfg: HashConfig):
    if len(lines) != cfg.num_levels - cfg.dense_levels or cfg.dim != 3:
        raise ValueError("expected one (3, G_l, R) line set per CP level")


def cp_encode(lines, x, mu, sigma, cfg: HashConfig, block: int = 4096):
    """(N, 3) world points -> (N, n_cp_levels * R) f32 features, two-hot
    matrix form, ``block`` points at a time."""
    _check(lines, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    sizes = cp_line_sizes(cfg)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    rank = lines[0].shape[-1]
    mat = torch.zeros((3, int(offs[-1]), len(lines) * rank),
                      dtype=torch.float32, device=x.device)
    for l, ln in enumerate(lines):
        mat[:, offs[l]:offs[l + 1], l * rank:(l + 1) * rank] = rnd(
            ln.to(torch.float32))
    scales = fine_scales(cfg)
    xn = normalise(x, mu, sigma)
    outs = []
    for s in range(0, xn.shape[0], block):
        xb = xn[s:s + block]
        w = torch.zeros((3, xb.shape[0], int(offs[-1])), dtype=torch.float32,
                        device=x.device)
        rows = torch.arange(xb.shape[0], device=x.device)
        for l, g in enumerate(sizes):
            x0, frac = axis_coords(xb * float(scales[l]), g)        # (B, 3)
            fb = rnd(frac)
            for d in range(3):
                w[d, rows, offs[l] + x0[:, d]] = rnd(1.0 - fb[:, d])
                w[d, rows, offs[l] + x0[:, d] + 1] = fb[:, d]
        t = torch.bmm(w, mat)                                       # (3, B, C)
        outs.append(t[0] * t[1] * t[2])
    if not outs:
        return torch.zeros((0, len(lines) * rank), device=x.device)
    return torch.cat(outs)


def cp_encode_reference(lines, x, mu, sigma, cfg: HashConfig):
    """Direct-gather f32 reference: per level, lerp each axis line at the
    point and multiply across axes."""
    _check(lines, cfg)
    xn = normalise(x, mu, sigma)
    outs = []
    for ln, g, scale in zip(lines, cp_line_sizes(cfg), fine_scales(cfg)):
        x0, frac = axis_coords(xn * float(scale), g)
        feat = 1.0
        for d in range(3):
            lo, hi = ln[d][x0[:, d]], ln[d][x0[:, d] + 1]
            feat = feat * (lo * (1.0 - frac[:, d:d + 1])
                           + hi * frac[:, d:d + 1])
        outs.append(feat)
    return torch.cat(outs, dim=-1)
