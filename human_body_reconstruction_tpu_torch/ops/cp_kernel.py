"""CP factor-line encoder forward: the CUDA kernel and its plain version.

Counterpart of the JAX ops/cp_pallas.py (``_fwd_kernel`` and
``_fwd_kernel_axis`` via ``cp_encode_pallas``).  The kernel is
``hbr_cp_forward`` in csrc/encoders.cu; the note there says what bounds it
on Hopper and why it gathers two rows per line instead of forming the
TPU's two-hot matrix product.  Both versions compute the Pallas kernel's
numerics:

  T_d = bf16(1 - frac_d) * bf16(line_d[x0_d]) + bf16(frac_d) * bf16(line_d[x0_d + 1])
  out = T_0 * T_1 * T_2                       (f32 throughout)

with the weights computed in f32 before rounding, and nothing rounded when
``cfg.dense_bf16`` is off.  ``cp_encode_kernel`` is the wrapper: for tensors
on the CPU it runs ``cp_encode_plain``; for tensors on a CUDA device it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.ops.lowrank import (
    _check, cp_line_sizes, cp_scales)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig


def cp_encode_plain(lines, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, n_cp_levels * R) f32, Pallas numerics."""
    _check(lines, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    outs = []
    for ln, g, scale in zip(lines, cp_line_sizes(cfg), cp_scales(cfg)):
        x0, frac = axis_coords(xn * float(scale), g)                # (N, 3)
        ln = rnd(ln.to(torch.float32))
        feat = None
        for d in range(3):
            lo = rnd(1.0 - frac[:, d:d + 1]) * ln[d][x0[:, d]]
            hi = rnd(frac[:, d:d + 1]) * ln[d][x0[:, d] + 1]
            feat = lo + hi if feat is None else feat * (lo + hi)
        outs.append(feat)
    return torch.cat(outs, dim=-1)


def cp_encode_kernel(lines, x, mu, sigma, cfg: HashConfig, out=None):
    """Wrapper: CPU tensors -> ``cp_encode_plain``; CUDA tensors -> the CUDA
    kernel.  ``out`` (optional) is an (N, n_cp_levels * R) f32 view with
    unit column stride to write into (a column block of the encoder's
    feature matrix).  Returns the features.  Shapes and devices are checked
    before either runs, so the CPU tests see what the kernel refuses."""
    _check(lines, cfg)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(x.shape)}")
    n, rank = x.shape[0], lines[0].shape[-1]
    c = len(lines) * rank
    sizes = cp_line_sizes(cfg)
    for ln, g in zip(lines, sizes):
        if ln.device != x.device or tuple(ln.shape) != (3, g, rank):
            raise ValueError(f"lines must be (3, {g}, {rank}) on the "
                             f"points' device, got {tuple(ln.shape)} on "
                             f"{ln.device}")
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = cp_encode_plain(lines, x, mu, sigma, cfg)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"cp_encode_kernel: unsupported device {x.device}")
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    store = torch.bfloat16 if cfg.dense_bf16 else torch.float32
    packed = torch.cat([ln.detach() for ln in lines], dim=1).to(store)
    packed = packed.contiguous()                           # (3, sum_G, R)
    xn = normalise(x, mu, sigma).contiguous()
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    lv = cuda_lib.make_levels(sizes, offsets[:-1], cp_scales(cfg))
    lib = cuda_lib.library()
    code = lib.hbr_cp_forward(
        xn.data_ptr(), packed.data_ptr(), int(cfg.dense_bf16), n,
        int(offsets[-1]), rank, lv, out.data_ptr(), out.stride(0),
        cuda_lib.stream_handle(x.device))
    cp_encode_kernel.launches += 1
    cuda_lib.check(code, "hbr_cp_forward")
    return out


cp_encode_kernel.launches = 0
