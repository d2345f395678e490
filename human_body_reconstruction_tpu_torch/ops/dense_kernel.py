"""Dense coarse-level encoder forward: the CUDA kernel and its plain version.

Counterpart of the JAX ops/dense_pallas.py (``_fwd_kernel`` via
``dense_encode_pallas``).  The kernel is ``hbr_dense_forward`` in
csrc/encoders.cu; the note there says what bounds it on Hopper and how its
design answers that.  Both versions compute the Pallas kernel's numerics:

  pair_bc = bf16(wy_b * wz_c)                   (f32 weights, bf16 product)
  T_a     = sum over the four (b, c) corners of pair_bc * bf16(grid)   (f32)
  out     = bf16(T_0 * wx_0) + bf16(T_1 * wx_1)  (the Pallas x fold)

with wx, wy, wz = (1 - frac, frac) in f32, and nothing rounded when
``cfg.dense_bf16`` is off.  ``dense_encode_kernel`` is the wrapper: for
tensors on the CPU it runs ``dense_encode_plain``; for tensors on a CUDA
device it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, corner_values, dense_grid_sizes, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig, level_scales


def _scales(cfg: HashConfig):
    return np.asarray(level_scales(cfg)[:cfg.dense_levels], np.float32)


def _check_cfg(grids, cfg: HashConfig):
    if cfg.dim != 3 or len(grids) != cfg.dense_levels:
        raise ValueError("dense grids are 3-D, one per dense level")


def dense_encode_plain(grids, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, dense_levels * F) f32, Pallas numerics."""
    _check_cfg(grids, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    outs = []
    for grid, scale in zip(grids, _scales(cfg)):
        x0, frac = axis_coords(xn * float(scale), grid.shape[0])
        wx, wy, wz = ((1.0 - frac[:, d], frac[:, d]) for d in range(3))
        c = rnd(corner_values(grid.to(torch.float32), x0))    # (N,2,2,2,F)
        pair = [[rnd(wy[b] * wz[k])[:, None] for k in range(2)]
                for b in range(2)]
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


def dense_encode_kernel(grids, x, mu, sigma, cfg: HashConfig, out=None):
    """Wrapper: CPU tensors -> ``dense_encode_plain``; CUDA tensors -> the
    CUDA kernel.  ``out`` (optional) is an (N, dense_levels * F) f32 view
    with unit column stride to write into (a column block of the encoder's
    feature matrix).  Returns the features.  Shapes and devices are checked
    before either runs, so the CPU tests see what the kernel refuses."""
    _check_cfg(grids, cfg)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(x.shape)}")
    n, f = x.shape[0], cfg.features_per_level
    c = cfg.dense_levels * f
    sizes = dense_grid_sizes(cfg)
    for grid, g in zip(grids, sizes):
        if grid.device != x.device or tuple(grid.shape) != (g, g, g, f):
            raise ValueError(f"grids must be ({g}, {g}, {g}, {f}) on the "
                             f"points' device, got {tuple(grid.shape)} on "
                             f"{grid.device}")
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = dense_encode_plain(grids, x, mu, sigma, cfg)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"dense_encode_kernel: unsupported device {x.device}")
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    store = torch.bfloat16 if cfg.dense_bf16 else torch.float32
    flat = torch.cat([g.detach().reshape(-1) for g in grids]).to(store)
    xn = normalise(x, mu, sigma).contiguous()
    offsets = np.concatenate([[0], np.cumsum([g.numel() for g in grids])])
    lv = cuda_lib.make_levels(sizes, offsets[:-1], _scales(cfg))
    lib = cuda_lib.library()
    code = lib.hbr_dense_forward(
        xn.data_ptr(), flat.data_ptr(), int(cfg.dense_bf16), n, f,
        lv, out.data_ptr(), out.stride(0), cuda_lib.stream_handle(x.device))
    dense_encode_kernel.launches += 1
    cuda_lib.check(code, "hbr_dense_forward")
    return out


dense_encode_kernel.launches = 0
