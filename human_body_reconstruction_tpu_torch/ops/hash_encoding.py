"""Full encoder (counterpart of ``encode_params`` in the JAX
ops/hash_encoding.py): dense coarse grids, then CP factor lines or the
hashed levels of the ``corner`` variant.

Feature order: the dense (coarsest) levels first, then the CP or hashed
levels (hashed level l, feature f at column ``l * F + f``), as in the JAX
package, so the MLP sees the same layout.  ``encode_params`` is one
``torch.autograd.Function`` over (grids..., lines... or table): its forward
has the kernel wrappers write their column blocks of one (N, out_dim)
feature matrix, and its backward hands the matching column blocks of the
incoming gradient to the backward kernel wrappers.  The wrappers run the
plain versions for tensors on the CPU and launch the CUDA kernels for
tensors on a CUDA device.  The forward saves only the points, the scene
normalisation, the tables and, in stochastic mode, the picked corners'
offset bits, uint8 (L, N), which the hash forward writes beside its
features; the uniforms are not kept (197 MB against the bits' 16 MB at the
hash path's 1,024,000 points).  The backward recomputes the per-axis lerps
and the cells instead of keeping them (the (3, N, C) CP products are 1.15
GB at 768k points).  Positions get no gradient.

The hashed levels run exact (8 corners, ops/hash_kernel.py) or, when
training with ``stochastic``, the single-corner estimator driven by
uniforms u (3, L, N): drawn by ``stoch_uniform`` (the Philox kernel of
ops/rng_kernel.py when ``cfg.hw_rng``, else ``torch.rand``) or handed in.
What is not ported raises with a message (``unported``): the ``cell``
variant, packed bf16/int8 gathers, ``packed_exact``, gradient
subsampling, the sorted scatter strategies and level parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch

from human_body_reconstruction_tpu_torch.ops import (
    cp_kernel, dense_kernel, hash_kernel, rng_kernel)
from human_body_reconstruction_tpu_torch.utils.config import HashConfig

_UNPORTED_FLAGS = (
    ("packed", "packed bf16/int8 gathers (--packed, --packed_exact)"),
    ("grad_subsample", "gradient feature subsampling (--grad_subsample)"),
    ("grad_level_subsample", "--grad_level_subsample"),
    ("grad_level_pair", "--grad_level_pair"),
    ("level_axis", "level parallelism"))


def unported(cfg: HashConfig) -> Optional[str]:
    """Why the port cannot run this encoder config, or None when it can."""
    if cfg.num_hashed_levels == 0 or cfg.variant == "cp":
        return None
    if cfg.variant != "corner":
        return (f"encoder variant {cfg.variant!r} is not ported; 'cp' and "
                "'corner' are")
    for flag, what in _UNPORTED_FLAGS:
        if getattr(cfg, flag):
            return f"{what} is not ported to the PyTorch encoder yet"
    if cfg.scatter_strategy != "random":
        return (f"scatter strategy {cfg.scatter_strategy!r} is not ported; "
                "the port's backward adds with atomics ('random')")
    return None


def init_table(cfg: HashConfig, generator: torch.Generator):
    """(L_hashed, T, F) table, U(-init_scale, init_scale), on the
    generator's device."""
    return torch.empty(
        (cfg.num_hashed_levels, cfg.table_size, cfg.payload),
        device=generator.device).uniform_(-cfg.init_scale, cfg.init_scale,
                                          generator=generator)


def stoch_uniform(shape, cfg: HashConfig, device,
                  generator: Optional[torch.Generator] = None):
    """Uniforms driving the stochastic corner bits (counterpart of
    ``_stoch_uniform``): with ``cfg.hw_rng`` a seed drawn on the device as
    JAX draws it, randint(0, 2^31 - 1), then the Philox kernel; otherwise
    ``torch.rand`` (the counterpart of threefry)."""
    if cfg.hw_rng:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int32)
        return rng_kernel.uniform(seed, shape)
    return torch.rand(shape, generator=generator, device=device)


class _Encode(torch.autograd.Function):
    """(x, mu, sigma, u, cfg, n_dense, n_lines, *tables) -> (N, out_dim)
    f32, where tables = grids + lines + (table,) and u (3, L, N) selects the
    stochastic hashed path (None: exact)."""

    @staticmethod
    def forward(ctx, x, mu, sigma, u, cfg: HashConfig, n_dense: int,
                n_lines: int, *tables):
        grids = tables[:n_dense]
        lines = tables[n_dense:n_dense + n_lines]
        table = tables[n_dense + n_lines:]
        d_dense = n_dense * cfg.features_per_level
        if lines:
            width = len(lines) * lines[0].shape[-1]
        elif table:
            width = table[0].shape[0] * table[0].shape[2]
        else:
            width = 0
        out = torch.empty((x.shape[0], d_dense + width), dtype=torch.float32,
                          device=x.device)
        if grids:
            dense_kernel.dense_encode_kernel(grids, x, mu, sigma, cfg,
                                             out=out[:, :d_dense])
        if lines:
            cp_kernel.cp_encode_kernel(lines, x, mu, sigma, cfg,
                                       out=out[:, d_dense:])
        bits = None
        if table:
            res = hash_kernel.hash_encode_kernel(table[0], x, mu, sigma, cfg,
                                                 u, out=out[:, d_dense:])
            bits = None if u is None else res[1]
        ctx.save_for_backward(x, mu, sigma, bits, *tables)
        ctx.cfg, ctx.n_dense, ctx.n_lines = cfg, n_dense, n_lines
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mu, sigma, bits, *tables = ctx.saved_tensors
        cfg, n_dense, n_lines = ctx.cfg, ctx.n_dense, ctx.n_lines
        d_dense = n_dense * cfg.features_per_level
        grids = tables[:n_dense]
        lines = tables[n_dense:n_dense + n_lines]
        table = tables[n_dense + n_lines:]
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        need = ctx.needs_input_grad[7:]
        g_grids = [None] * len(grids)
        g_rest = [None] * (len(lines) + len(table))
        if grids and any(need[:n_dense]):
            g_grids = dense_kernel.dense_encode_backward_kernel(
                grids, x, mu, sigma, cfg, grad[:, :d_dense])
        if lines and any(need[n_dense:]):
            g_rest = cp_kernel.cp_encode_backward_kernel(
                lines, x, mu, sigma, cfg, grad[:, d_dense:])
        if table and need[-1]:
            g_rest = [hash_kernel.hash_encode_backward_kernel(
                table[0], x, mu, sigma, cfg, grad[:, d_dense:], bits)]
        return (None,) * 7 + (*g_grids, *g_rest)


def encode_params(enc_params, x, mu, sigma, cfg: HashConfig, *,
                  stochastic: bool = False,
                  generator: Optional[torch.Generator] = None, u=None):
    """enc_params: {"dense": sequence of (G, G, G, F) grids (when
    cfg.dense_levels > 0), "lines": sequence of (3, G_l, R) lines (variant
    "cp") or "table": (L_hashed, T, F) (variant "corner")}.  ``stochastic``
    (training, corner variant) picks one corner per (point, level) from
    uniforms ``u`` (3, L_hashed, N), drawn from ``generator`` when not given.
    Returns (N, cfg.out_dim) f32 features, differentiable w.r.t. every grid,
    line and table on both devices."""
    msg = unported(cfg)
    if msg:
        raise NotImplementedError(msg)
    grids, lines, table = [], [], []
    if cfg.dense_levels > 0:
        if "dense" not in enc_params:
            raise ValueError(f"cfg.dense_levels={cfg.dense_levels} but the "
                             "encoder params carry no 'dense' grids")
        grids = list(enc_params["dense"])
    if cfg.num_hashed_levels > 0:
        if cfg.variant == "cp":
            lines = list(enc_params["lines"])
        else:
            table = [enc_params["table"]]
    if not (stochastic and table):
        u = None
    elif u is None:
        u = stoch_uniform((3, cfg.num_hashed_levels, x.shape[0]), cfg,
                          x.device, generator)
    mu, sigma = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                 for v in (mu, sigma))
    return _Encode.apply(x, mu, sigma, u, cfg, len(grids), len(lines),
                         *grids, *lines, *table)
