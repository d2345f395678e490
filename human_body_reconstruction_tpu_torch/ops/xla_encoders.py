"""The JAX XLA encoders' numerics in plain PyTorch, for configs that name
them (``cp_impl="xla"``, ``dense_impl="xla"``: the ``_xla`` modes of the
quality matrix).

JAX runs those levels as two-hot matrix products (``lowrank.cp_encode``,
``dense_grid.dense_encode``) over blocks of points in a ``lax.map``, and
takes their gradients by autodiff.  In bf16 compute that rounds where the
Pallas kernels do not:

- the forward weights are bf16(1 - bf16(frac)) and bf16(frac) (the dense
  pair weight bf16(wy * wz)), times bf16 tables, summed in f32;
- the backward sums a block's terms in f32 and rounds that block's partial
  gradient to bf16;
- the CP factor matrix is one bf16 operand of every block, so its partials
  add up in bf16, in the reverse block order of the map's transpose; the
  dense grids enter each block in f32, so theirs add up in f32.

A block is ``max(1024, min(N, 2^23 // sum_G))`` points for the CP levels
and ``max(1024, min(N, 2^25 // G_max^2))`` for the dense ones, rounded
down to a multiple of 1024, as JAX picks them.  With ``dense_bf16`` off
nothing is rounded.  These are plain PyTorch on either device: the JAX
XLA path is no TPU kernel, so the port has none for it either.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, dense_encode, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.ops.lowrank import _check, cp_line_sizes
from human_body_reconstruction_tpu_torch.utils.config import (
    HashConfig, fine_scales, level_scales)


def _rounding(cfg: HashConfig):
    return round_bf16 if cfg.dense_bf16 else (lambda v: v)


def block_size(n: int, per_block: int) -> int:
    """The JAX encoders' lax.map block: max(1024, min(n, per_block)),
    rounded down to a multiple of 1024."""
    block = int(max(1024, min(n, per_block)))
    return max(1024, (block // 1024) * 1024)


def _cp_terms(ln, xn, g: int, scale: float, rnd):
    """Per axis of one level: (cells x0 (N,), weight lo (N, 1), weight hi
    (N, 1), T_d (N, R)), the XLA path's roundings."""
    x0, frac = axis_coords(xn * scale, g)
    fb = rnd(frac)
    lo_w = rnd(1.0 - fb)
    out = []
    for d in range(3):
        w_lo, w_hi = lo_w[:, d:d + 1], fb[:, d:d + 1]
        out.append((x0[:, d], w_lo, w_hi,
                    w_lo * ln[d][x0[:, d]] + w_hi * ln[d][x0[:, d] + 1]))
    return out


def cp_encode_xla(lines, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, n_cp_levels * R) f32, JAX
    ``lowrank.cp_encode``'s XLA numerics (two rows a line, as the two-hot
    product sums them)."""
    _check(lines, cfg)
    rnd = _rounding(cfg)
    xn = normalise(x, mu, sigma)
    outs = []
    for ln, g, scale in zip(lines, cp_line_sizes(cfg), fine_scales(cfg)):
        (_, _, _, t0), (_, _, _, t1), (_, _, _, t2) = _cp_terms(
            rnd(ln.detach().to(torch.float32)), xn, g, float(scale), rnd)
        outs.append(t0 * t1 * t2)
    return torch.cat(outs, dim=-1)


def cp_encode_xla_backward(lines, x, mu, sigma, cfg: HashConfig, grad):
    """Gradient of ``cp_encode_xla`` w.r.t. each level's lines, given the
    gradient ``grad`` (N, n_cp_levels * R) of its output, as JAX's autodiff
    of the XLA path computes it: per block, W_d^T dT_d summed in f32 and
    rounded; the blocks' partials added in the factor matrix's dtype, last
    block first.  Returns a list of f32 (3, G_l, R) tensors."""
    _check(lines, cfg)
    rnd = _rounding(cfg)
    sizes = cp_line_sizes(cfg)
    rank = lines[0].shape[-1]
    n = x.shape[0]
    block = block_size(n, 2 ** 23 // max(int(sum(sizes)), 1))
    nblk = -(-n // block)
    blk = torch.arange(n, device=x.device) // block
    xn = normalise(x, mu, sigma)
    # every level's and axis's block partials side by side, so that the
    # blocks add up in one pass: (nblk, 3, sum_G, R)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    part = torch.zeros((nblk, 3, int(offs[-1]), rank), dtype=torch.float32,
                       device=x.device)
    for l, (ln, g, scale) in enumerate(zip(lines, sizes, fine_scales(cfg))):
        terms = _cp_terms(rnd(ln.detach().to(torch.float32)), xn, g,
                          float(scale), rnd)
        t0, t1, t2 = (t for *_, t in terms)
        gl = grad[:, l * rank:(l + 1) * rank]
        d01 = gl * t2
        dts = (d01 * t1, t0 * d01, (t0 * t1) * gl)
        for d, ((x0, w_lo, w_hi, _), dt) in enumerate(zip(terms, dts)):
            rows = (blk * 3 + d) * int(offs[-1]) + int(offs[l]) + x0
            flat = part.view(-1, rank)
            flat.index_add_(0, rows, w_lo * dt)
            flat.index_add_(0, rows + 1, w_hi * dt)
    part = rnd(part)
    acc = torch.zeros_like(part[0])
    for b in range(nblk - 1, -1, -1):
        acc = rnd(acc + part[b])
    return [acc[:, offs[l]:offs[l + 1]].contiguous()
            for l in range(len(sizes))]


def dense_encode_xla(grids, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, dense_levels * F) f32, JAX
    ``dense_grid.dense_encode``'s XLA numerics."""
    return dense_encode([g.detach() for g in grids], x, mu, sigma, cfg)


def dense_encode_xla_backward(grids, x, mu, sigma, cfg: HashConfig, grad):
    """Gradient of ``dense_encode_xla`` w.r.t. each grid, as JAX's autodiff
    of the XLA path computes it: each term bf16(wy * wz) * (g * wx), a
    block's terms summed in f32 and rounded, the blocks' partials added in
    f32, last block first.  Returns a list of f32 (G, G, G, F) tensors."""
    rnd = _rounding(cfg)
    scales = level_scales(cfg)
    n = x.shape[0]
    block = block_size(n, 2 ** 25 // max(g.shape[0] for g in grids) ** 2)
    nblk = -(-n // block)
    blk = torch.arange(n, device=x.device) // block
    xn = normalise(x, mu, sigma)
    F = cfg.features_per_level
    out = []
    for l, grid in enumerate(grids):
        G = grid.shape[0]
        x0, frac = axis_coords(xn * float(np.float32(scales[l])), G)
        fb = rnd(frac)
        w = torch.stack([rnd(1.0 - fb), fb], dim=-1)                # (N, 3, 2)
        gl = grad[:, l * F:(l + 1) * F]
        part = torch.zeros((nblk * G ** 3, F), dtype=torch.float32,
                           device=x.device)
        for a in range(2):
            g_wx = gl * w[:, 0, a:a + 1]                            # (N, F)
            for b in range(2):
                for c in range(2):
                    w_yz = rnd(w[:, 1, b] * w[:, 2, c])[:, None]
                    cell = (((x0[:, 0] + a) * G + x0[:, 1] + b) * G
                            + x0[:, 2] + c)
                    part.index_add_(0, blk * G ** 3 + cell, w_yz * g_wx)
        part = rnd(part).reshape(nblk, G, G, G, F)
        acc = torch.zeros((G, G, G, F), dtype=torch.float32, device=x.device)
        for b in range(nblk - 1, -1, -1):
            acc += part[b]
        out.append(acc)
    return out
