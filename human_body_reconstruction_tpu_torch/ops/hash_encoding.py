"""Full encoder (counterpart of ``encode_params`` in the JAX
ops/hash_encoding.py), for the dense and CP variants.

Feature order: the dense (coarsest) levels first, then the CP levels, as in
the JAX package, so the MLP sees the same layout.  Both parts go through
the kernel wrappers, which run the plain versions for tensors on the CPU
and launch the CUDA kernels for tensors on a CUDA device; on the card the
two kernels write their column blocks of one feature matrix.  The hashed
variants (corner, cell, stochastic, packed) are not ported yet.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.ops import cp_kernel, dense_kernel
from human_body_reconstruction_tpu_torch.utils.config import HashConfig


def encode_params(enc_params, x, mu, sigma, cfg: HashConfig):
    """enc_params: {"dense": sequence of (G, G, G, F) grids (when
    cfg.dense_levels > 0), "lines": sequence of (3, G_l, R) lines}.
    Returns (N, cfg.out_dim) f32 features."""
    if cfg.variant != "cp" and cfg.num_hashed_levels > 0:
        raise NotImplementedError(
            f"encoder variant {cfg.variant!r} is not ported; only 'cp' "
            "(with optional dense coarse levels) is")
    d_dense = cfg.dense_levels * cfg.features_per_level
    rank = enc_params["lines"][0].shape[-1] if cfg.num_hashed_levels else 0
    out = torch.empty((x.shape[0], d_dense + cfg.num_hashed_levels * rank),
                      dtype=torch.float32, device=x.device)
    if cfg.dense_levels > 0:
        if "dense" not in enc_params:
            raise ValueError(f"cfg.dense_levels={cfg.dense_levels} but the "
                             "encoder params carry no 'dense' grids")
        dense_kernel.dense_encode_kernel(enc_params["dense"], x, mu, sigma,
                                         cfg, out=out[:, :d_dense])
    if cfg.num_hashed_levels > 0:
        cp_kernel.cp_encode_kernel(enc_params["lines"], x, mu, sigma, cfg,
                                   out=out[:, d_dense:])
    return out
