"""Full encoder (counterpart of ``encode_params`` in the JAX
ops/hash_encoding.py), for the dense and CP variants.

Feature order: the dense (coarsest) levels first, then the CP levels, as in
the JAX package, so the MLP sees the same layout.  ``encode_params`` is one
``torch.autograd.Function`` over (grids..., lines...): its forward has the
two forward kernel wrappers write their column blocks of one (N, out_dim)
feature matrix, and its backward hands the matching column blocks of the
incoming gradient to the two backward kernel wrappers.  The wrappers run
the plain versions for tensors on the CPU and launch the CUDA kernels for
tensors on a CUDA device.  The forward saves only the points, the scene
normalisation and the tables; the backward recomputes the per-axis lerps
instead of keeping the (3, N, C) products (1.15 GB at 768k points).
Positions get no gradient.  The hashed variants (corner, cell, stochastic,
packed) are not ported yet.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.ops import cp_kernel, dense_kernel
from human_body_reconstruction_tpu_torch.utils.config import HashConfig


class _Encode(torch.autograd.Function):
    """(x, mu, sigma, cfg, n_dense, *tables) -> (N, cfg.out_dim) f32."""

    @staticmethod
    def forward(ctx, x, mu, sigma, cfg: HashConfig, n_dense: int, *tables):
        grids, lines = tables[:n_dense], tables[n_dense:]
        d_dense = cfg.dense_levels * cfg.features_per_level
        rank = lines[0].shape[-1] if lines else 0
        out = torch.empty((x.shape[0], d_dense + len(lines) * rank),
                          dtype=torch.float32, device=x.device)
        if grids:
            dense_kernel.dense_encode_kernel(grids, x, mu, sigma, cfg,
                                             out=out[:, :d_dense])
        if lines:
            cp_kernel.cp_encode_kernel(lines, x, mu, sigma, cfg,
                                       out=out[:, d_dense:])
        ctx.save_for_backward(x, mu, sigma, *tables)
        ctx.cfg, ctx.n_dense, ctx.d_dense = cfg, n_dense, d_dense
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mu, sigma, *tables = ctx.saved_tensors
        cfg, n_dense, d_dense = ctx.cfg, ctx.n_dense, ctx.d_dense
        grids, lines = tables[:n_dense], tables[n_dense:]
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        need = ctx.needs_input_grad[5:]
        g_grids = [None] * len(grids)
        g_lines = [None] * len(lines)
        if grids and any(need[:n_dense]):
            g_grids = dense_kernel.dense_encode_backward_kernel(
                grids, x, mu, sigma, cfg, grad[:, :d_dense])
        if lines and any(need[n_dense:]):
            g_lines = cp_kernel.cp_encode_backward_kernel(
                lines, x, mu, sigma, cfg, grad[:, d_dense:])
        return (None, None, None, None, None, *g_grids, *g_lines)


def encode_params(enc_params, x, mu, sigma, cfg: HashConfig):
    """enc_params: {"dense": sequence of (G, G, G, F) grids (when
    cfg.dense_levels > 0), "lines": sequence of (3, G_l, R) lines}.
    Returns (N, cfg.out_dim) f32 features, differentiable w.r.t. every
    grid and line on both devices."""
    if cfg.variant != "cp" and cfg.num_hashed_levels > 0:
        raise NotImplementedError(
            f"encoder variant {cfg.variant!r} is not ported; only 'cp' "
            "(with optional dense coarse levels) is")
    grids, lines = [], []
    if cfg.dense_levels > 0:
        if "dense" not in enc_params:
            raise ValueError(f"cfg.dense_levels={cfg.dense_levels} but the "
                             "encoder params carry no 'dense' grids")
        grids = list(enc_params["dense"])
    if cfg.num_hashed_levels > 0:
        lines = list(enc_params["lines"])
    mu, sigma = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                 for v in (mu, sigma))
    return _Encode.apply(x, mu, sigma, cfg, len(grids), *grids, *lines)
