"""Dense coarse-level encoder: the CUDA kernels and their plain versions.

Counterpart of the JAX ops/dense_pallas.py: the forward ``_fwd_kernel``
(via ``dense_encode_pallas``) and the backward ``_bwd_kernel`` (the VJP
``_dense_matmul_bwd``).  The kernels are ``hbr_dense_forward`` and
``hbr_dense_backward`` in csrc/encoders.cu; the notes there say what bounds
them on Hopper and how their design answers that.  Both versions compute
the Pallas kernels' numerics:

  pair_bc = bf16(wy_b * wz_c)                   (f32 weights, bf16 product)
  T_a     = sum over the four (b, c) corners of pair_bc * bf16(grid)   (f32)
  out     = bf16(T_0 * wx_0) + bf16(T_1 * wx_1)  (the Pallas x fold)

  dgrid[x0 + a, y0 + b, z0 + c, f] += bf16(bf16(dout_f) * wx_a) * pair_bc
                                      (f32 sums, then bf16)

with wx, wy, wz = (1 - frac, frac) in f32, and nothing rounded when
``cfg.dense_bf16`` is off.  The gradient lands in the (G, G, G, F) grid
layout (the Pallas kernel's transposed (G^2, G*F) operand is a layout of
the TPU's matrix unit).  ``dense_encode_kernel`` and
``dense_encode_backward_kernel`` are the wrappers: for tensors on the CPU
they run ``dense_encode_plain`` and ``dense_encode_plain_backward``; for
tensors on a CUDA device they launch the kernel or raise.  The kernels take
the world points with mu and sigma and normalise them as ``normalise``
does, and read the grids flat, each level from a multiple of
``LEVEL_ALIGN`` elements (``_levels``, ``_flat_grids``); the backward keeps
the leading levels that fit ``cuda_lib.BWD_SHARED_BYTES`` in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, corner_values, dense_grid_sizes, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig, level_scales

LEVEL_ALIGN = 4     # elements: a grid starts 16-byte aligned in f32 and bf16
MAX_FEATURES = 8    # DENSE_MAX_F in csrc/encoders.cu


def _scales(cfg: HashConfig):
    return np.asarray(level_scales(cfg)[:cfg.dense_levels], np.float32)


def _check_cfg(grids, cfg: HashConfig):
    if cfg.dim != 3 or len(grids) != cfg.dense_levels:
        raise ValueError("dense grids are 3-D, one per dense level")


def _weights(xn, scale, g, rnd):
    """(cells x0 (N, 3), wx pair, rounded pair products [b][c] (N, 1))."""
    x0, frac = axis_coords(xn * float(scale), g)
    wx, wy, wz = ((1.0 - frac[:, d], frac[:, d]) for d in range(3))
    pair = [[rnd(wy[b] * wz[k])[:, None] for k in range(2)] for b in range(2)]
    return x0, wx, pair


def dense_encode_plain(grids, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, dense_levels * F) f32, Pallas numerics."""
    _check_cfg(grids, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    outs = []
    for grid, scale in zip(grids, _scales(cfg)):
        x0, wx, pair = _weights(xn, scale, grid.shape[0], rnd)
        c = rnd(corner_values(grid.to(torch.float32), x0))    # (N,2,2,2,F)
        out = None
        for a in range(2):
            t = pair[0][0] * c[:, a, 0, 0]
            t = t + pair[0][1] * c[:, a, 0, 1]
            t = t + pair[1][0] * c[:, a, 1, 0]
            t = t + pair[1][1] * c[:, a, 1, 1]
            folded = rnd(t * wx[a][:, None])
            out = folded if out is None else out + folded
        outs.append(out)
    return torch.cat(outs, dim=-1)


def dense_encode_plain_backward(grids, x, mu, sigma, cfg: HashConfig, grad):
    """Gradient of ``dense_encode_plain`` w.r.t. each grid, given the
    gradient ``grad`` (N, dense_levels * F) of its output, Pallas numerics.
    Returns a list of f32 (G, G, G, F) tensors."""
    _check_cfg(grids, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    f = cfg.features_per_level
    feat = torch.arange(f, device=x.device)
    out = []
    for l, (grid, scale) in enumerate(zip(grids, _scales(cfg))):
        g = grid.shape[0]
        x0, wx, pair = _weights(xn, scale, g, rnd)
        gl = rnd(grad[:, l * f:(l + 1) * f])                       # (N, F)
        dgrid = torch.zeros(g * g * g * f, dtype=torch.float32,
                            device=x.device)
        for a in range(2):
            da = rnd(gl * wx[a][:, None])
            for b in range(2):
                for c in range(2):
                    cell = ((x0[:, 0] + a) * g + x0[:, 1] + b) * g + x0[:, 2] + c
                    idx = cell[:, None] * f + feat
                    dgrid.index_add_(0, idx.reshape(-1),
                                     (da * pair[b][c]).reshape(-1))
        out.append(rnd(dgrid).reshape(g, g, g, f))
    return out


def _check_args(grids, x, cfg: HashConfig):
    """Shapes and devices the kernels rely on; returns (n, F, D*F)."""
    _check_cfg(grids, cfg)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(x.shape)}")
    f = cfg.features_per_level
    for grid, g in zip(grids, dense_grid_sizes(cfg)):
        if grid.device != x.device or tuple(grid.shape) != (g, g, g, f):
            raise ValueError(f"grids must be ({g}, {g}, {g}, {f}) on the "
                             f"points' device, got {tuple(grid.shape)} on "
                             f"{grid.device}")
    if not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"the dense kernels take 1 to {MAX_FEATURES} "
                         f"features a level, got {f}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense encoder kernels: unsupported device {x.device}")
    return x.shape[0], f, cfg.dense_levels * f


def _levels(grids, cfg: HashConfig):
    """(level struct, element offset of each grid and of the end).  Each
    level starts on a multiple of ``LEVEL_ALIGN`` elements, so that the
    kernels' vector loads and adds of a corner row are aligned."""
    offsets = [0]
    for g in grids:
        offsets.append(offsets[-1] + -(-g.numel() // LEVEL_ALIGN) * LEVEL_ALIGN)
    lv = cuda_lib.make_levels(dense_grid_sizes(cfg), offsets[:-1], _scales(cfg))
    return lv, offsets


def _flat_grids(grids, offsets, dtype):
    """The grids in the kernels' flat layout (``_levels``), zeros between
    levels, as ``dtype``."""
    pieces = []
    for l, g in enumerate(grids):
        pieces.append(g.detach().reshape(-1))
        pad = offsets[l + 1] - offsets[l] - g.numel()
        if pad:
            pieces.append(g.new_zeros(pad))
    return torch.cat(pieces).to(dtype)


def _points(x, mu, sigma):
    """What the kernels normalise in place of ``normalise``: (x (N, 3) f32
    contiguous, mu (3,), sigma (1,) or (3,), sigma's step between axes)."""
    if mu.device != x.device or sigma.device != x.device:
        raise ValueError("mu and sigma must lie on the points' device")
    mu = mu.to(torch.float32).reshape(-1).expand(3).contiguous()
    sigma = sigma.to(torch.float32).reshape(-1).contiguous()
    if sigma.numel() not in (1, 3):
        raise ValueError(f"sigma must hold 1 or 3 values, got {sigma.numel()}")
    return (x.to(torch.float32).contiguous(), mu, sigma,
            int(sigma.numel() == 3))


def dense_encode_kernel(grids, x, mu, sigma, cfg: HashConfig, out=None):
    """Forward wrapper: CPU tensors -> ``dense_encode_plain``; CUDA tensors
    -> ``hbr_dense_forward``.  ``out`` (optional) is an (N, dense_levels * F)
    f32 view with unit column stride to write into (a column block of the
    encoder's feature matrix).  Returns the features.  Shapes and devices
    are checked before either runs, so the CPU tests see what the kernel
    refuses."""
    n, f, c = _check_args(grids, x, cfg)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = dense_encode_plain(grids, x, mu, sigma, cfg)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lv, offsets = _levels(grids, cfg)
    flat = _flat_grids(grids, offsets,
                       torch.bfloat16 if cfg.dense_bf16 else torch.float32)
    xf, mu, sigma, step = _points(x, mu, sigma)
    code = cuda_lib.library().hbr_dense_forward(
        xf.data_ptr(), mu.data_ptr(), sigma.data_ptr(), step, flat.data_ptr(),
        int(cfg.dense_bf16), n, f, lv, out.data_ptr(), out.stride(0),
        cuda_lib.stream_handle(x.device))
    dense_encode_kernel.launches += 1
    cuda_lib.check(code, "hbr_dense_forward")
    return out


def dense_encode_backward_kernel(grids, x, mu, sigma, cfg: HashConfig, grad):
    """Backward wrapper: the gradient of the grids given ``grad``, the
    (N, dense_levels * F) f32 gradient of the features (any row stride,
    unit column stride: a column block of the encoder's gradient).  CPU
    tensors -> ``dense_encode_plain_backward``; CUDA tensors ->
    ``hbr_dense_backward``.  The grids' values are not read (the trilerp is
    linear in them); only their shapes are.  Returns a list of f32
    (G, G, G, F) tensors."""
    n, f, c = _check_args(grids, x, cfg)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    if x.device.type == "cpu":
        return dense_encode_plain_backward(grids, x, mu, sigma, cfg, grad)
    lv, offsets = _levels(grids, cfg)
    dflat = torch.zeros(offsets[-1], dtype=torch.float32, device=x.device)
    if n > 0:
        k = cuda_lib.shared_prefix(
            [4 * (b - a) for a, b in zip(offsets, offsets[1:])],
            cuda_lib.BWD_SHARED_BYTES)
        xf, mu, sigma, step = _points(x, mu, sigma)
        code = cuda_lib.library().hbr_dense_backward(
            xf.data_ptr(), mu.data_ptr(), sigma.data_ptr(), step,
            int(cfg.dense_bf16), grad.data_ptr(),
            grad.stride(0), n, f, lv, offsets[k], dflat.data_ptr(),
            cuda_lib.stream_handle(x.device))
        dense_encode_backward_kernel.launches += 1
        cuda_lib.check(code, "hbr_dense_backward")
    if cfg.dense_bf16:
        dflat = round_bf16(dflat)
    return [dflat[offsets[l]:offsets[l] + g.numel()].view(g.shape)
            for l, g in enumerate(grids)]


dense_encode_kernel.launches = 0
dense_encode_backward_kernel.launches = 0
