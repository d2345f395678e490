"""CP factor-line encoder: the CUDA kernels and their plain versions.

Counterpart of the JAX ops/cp_pallas.py: the forward ``_fwd_kernel`` and
``_fwd_kernel_axis`` (via ``cp_encode_pallas``) and the backward
``_bwd_kernel`` (the VJP ``_cp_matmul_bwd``).  The kernels are
``hbr_cp_forward`` and ``hbr_cp_backward`` in csrc/encoders.cu; the notes
there say what bounds them on Hopper and why they gather and scatter two
rows per line instead of forming the TPU's two-hot matrix products.  Both
versions compute the Pallas kernels' numerics:

  T_d  = bf16(1 - frac_d) * bf16(line_d[x0_d]) + bf16(frac_d) * bf16(line_d[x0_d + 1])
  out  = (T_0 * T_1) * T_2                     (f32 throughout)

  dT_0 = (g * T_2) * T_1,  dT_1 = T_0 * (g * T_2),  dT_2 = (T_0 * T_1) * g
  dline_d[x0_d]     += bf16(1 - frac_d) * bf16(dT_d)
  dline_d[x0_d + 1] += bf16(frac_d) * bf16(dT_d)     (f32 sums, then bf16)

with the weights computed in f32 before rounding, and nothing rounded when
``cfg.dense_bf16`` is off.  Positions get no gradient (the Pallas path
stop-gradients the fractions).  ``cp_encode_kernel`` and
``cp_encode_backward_kernel`` are the wrappers: for tensors on the CPU they
run ``cp_encode_plain`` and ``cp_encode_plain_backward``; for tensors on a
CUDA device they launch the kernel or raise.  Around a launch they pack the
lines into the kernels' padded layout (``pack_lines``), and size the
backward's padded accumulator and fold it back.
"""

from __future__ import annotations

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.ops import cuda_lib
from human_body_reconstruction_tpu_torch.ops.dense_grid import (
    axis_coords, normalise, round_bf16)
from human_body_reconstruction_tpu_torch.ops.lowrank import _check, cp_line_sizes
from human_body_reconstruction_tpu_torch.utils.config import HashConfig, fine_scales


def _lerps(ln, x0, frac, rnd):
    """Per axis: (weight lo, weight hi, T_d) of one level, (N, R) each."""
    out = []
    for d in range(3):
        w_lo, w_hi = rnd(1.0 - frac[:, d:d + 1]), rnd(frac[:, d:d + 1])
        t = w_lo * ln[d][x0[:, d]] + w_hi * ln[d][x0[:, d] + 1]
        out.append((w_lo, w_hi, t))
    return out


def cp_encode_plain(lines, x, mu, sigma, cfg: HashConfig):
    """(N, 3) world points -> (N, n_cp_levels * R) f32, Pallas numerics."""
    _check(lines, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    outs = []
    for ln, g, scale in zip(lines, cp_line_sizes(cfg), fine_scales(cfg)):
        x0, frac = axis_coords(xn * float(scale), g)                # (N, 3)
        (_, _, t0), (_, _, t1), (_, _, t2) = _lerps(
            rnd(ln.to(torch.float32)), x0, frac, rnd)
        outs.append(t0 * t1 * t2)
    return torch.cat(outs, dim=-1)


def cp_encode_plain_backward(lines, x, mu, sigma, cfg: HashConfig, grad):
    """Gradient of ``cp_encode_plain`` w.r.t. each level's lines, given the
    gradient ``grad`` (N, n_cp_levels * R) of its output, Pallas numerics.
    Returns a list of f32 (3, G_l, R) tensors."""
    _check(lines, cfg)
    rnd = round_bf16 if cfg.dense_bf16 else (lambda v: v)
    xn = normalise(x, mu, sigma)
    rank = lines[0].shape[-1]
    out = []
    for l, (ln, g, scale) in enumerate(zip(lines, cp_line_sizes(cfg),
                                           fine_scales(cfg))):
        x0, frac = axis_coords(xn * float(scale), g)
        (wl0, wh0, t0), (wl1, wh1, t1), (wl2, wh2, t2) = _lerps(
            rnd(ln.detach().to(torch.float32)), x0, frac, rnd)
        gl = grad[:, l * rank:(l + 1) * rank]
        dp = gl * t2
        dline = torch.zeros((3, g, rank), dtype=torch.float32,
                            device=x.device)
        for d, (w_lo, w_hi, dt) in enumerate(((wl0, wh0, dp * t1),
                                              (wl1, wh1, t0 * dp),
                                              (wl2, wh2, (t0 * t1) * gl))):
            dt = rnd(dt)
            dline[d].index_add_(0, x0[:, d], w_lo * dt)
            dline[d].index_add_(0, x0[:, d] + 1, w_hi * dt)
        out.append(rnd(dline))
    return out


def _check_args(lines, x, cfg: HashConfig):
    """Shapes and devices the kernels rely on; returns (n, rank, C)."""
    _check(lines, cfg)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(x.shape)}")
    n, rank = x.shape[0], lines[0].shape[-1]
    for ln, g in zip(lines, cp_line_sizes(cfg)):
        if ln.device != x.device or tuple(ln.shape) != (3, g, rank):
            raise ValueError(f"lines must be (3, {g}, {rank}) on the "
                             f"points' device, got {tuple(ln.shape)} on "
                             f"{ln.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CP encoder kernels: unsupported device {x.device}")
    return n, rank, len(lines) * rank


def padded(rank: int, multiple: int) -> int:
    """``rank`` rounded up to a multiple of ``multiple``."""
    return -(-rank // multiple) * multiple


LINE_COLS = 8      # packed line rows: 8 columns a 16-byte bf16 load
ACC_COLS = 4       # backward accumulator rows: 4 f32 columns a reduction


def pack_lines(lines, cfg: HashConfig):
    """The kernels' line layout: every level's (3, G_l, R) lines stacked as
    (3, sum_G, RPf) in the stored dtype (bf16 when ``cfg.dense_bf16``), RPf
    = R rounded up to ``LINE_COLS``, zero after column R, so that each row
    starts 16-byte aligned.  Made once a call (0.5 MB at the flagship)."""
    rank = lines[0].shape[-1]
    store = torch.bfloat16 if cfg.dense_bf16 else torch.float32
    packed = torch.zeros((3, sum(cp_line_sizes(cfg)), padded(rank, LINE_COLS)),
                         dtype=store, device=lines[0].device)
    packed[..., :rank] = torch.cat([ln.detach() for ln in lines], dim=1)
    return packed


def _kernel_inputs(lines, x, mu, sigma, cfg: HashConfig):
    """(normalised points, packed lines, level struct, level sizes) for a
    launch."""
    sizes = cp_line_sizes(cfg)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    lv = cuda_lib.make_levels(sizes, offsets[:-1], fine_scales(cfg))
    return (normalise(x, mu, sigma).contiguous(), pack_lines(lines, cfg), lv,
            sizes)


def cp_encode_kernel(lines, x, mu, sigma, cfg: HashConfig, out=None):
    """Forward wrapper: CPU tensors -> ``cp_encode_plain``; CUDA tensors ->
    ``hbr_cp_forward``.  ``out`` (optional) is an (N, n_cp_levels * R) f32
    view with unit column stride to write into (a column block of the
    encoder's feature matrix).  Returns the features.  Shapes and devices
    are checked before either runs, so the CPU tests see what the kernel
    refuses."""
    n, rank, c = _check_args(lines, x, cfg)
    if out is not None:
        cuda_lib.check_out(out, n, c, x.device)
    if x.device.type == "cpu":
        res = cp_encode_plain(lines, x, mu, sigma, cfg)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    xn, packed, lv, _ = _kernel_inputs(lines, x, mu, sigma, cfg)
    code = cuda_lib.library().hbr_cp_forward(
        xn.data_ptr(), packed.data_ptr(), int(cfg.dense_bf16), n,
        packed.shape[1], rank, packed.shape[2], lv, out.data_ptr(),
        out.stride(0), cuda_lib.stream_handle(x.device))
    cp_encode_kernel.launches += 1
    cuda_lib.check(code, "hbr_cp_forward")
    return out


def cp_encode_backward_kernel(lines, x, mu, sigma, cfg: HashConfig, grad):
    """Backward wrapper: the gradient of the lines given ``grad``, the
    (N, n_cp_levels * R) f32 gradient of the features (any row stride, unit
    column stride: a column block of the encoder's gradient).  CPU tensors
    -> ``cp_encode_plain_backward``; CUDA tensors -> ``hbr_cp_backward``,
    which accumulates into (3, sum_G, R rounded up to ``ACC_COLS``) f32,
    folded back to R columns here.  Returns a list of f32 (3, G_l, R)
    tensors."""
    n, rank, c = _check_args(lines, x, cfg)
    cuda_lib.check_out(grad, n, c, x.device, name="grad")
    if x.device.type == "cpu":
        return cp_encode_plain_backward(lines, x, mu, sigma, cfg, grad)
    rp = padded(rank, ACC_COLS)
    xn, packed, lv, sizes = _kernel_inputs(lines, x, mu, sigma, cfg)
    dacc = torch.zeros((3, packed.shape[1], rp), dtype=torch.float32,
                       device=x.device)
    if n > 0:
        code = cuda_lib.library().hbr_cp_backward(
            xn.data_ptr(), packed.data_ptr(), int(cfg.dense_bf16),
            grad.data_ptr(), grad.stride(0), n, packed.shape[1], rank,
            packed.shape[2], rp, lv, dacc.data_ptr(),
            cuda_lib.stream_handle(x.device))
        cp_encode_backward_kernel.launches += 1
        cuda_lib.check(code, "hbr_cp_backward")
    dlines = dacc[..., :rank]
    dlines = round_bf16(dlines) if cfg.dense_bf16 else dlines.contiguous()
    return list(torch.split(dlines, sizes, dim=1))


cp_encode_kernel.launches = 0
cp_encode_backward_kernel.launches = 0
