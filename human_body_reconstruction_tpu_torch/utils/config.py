"""Configuration: the JAX package's config dataclasses, plus level geometry.

``human_body_reconstruction_tpu.utils.config`` imports no JAX (the JAX
package's ``__init__`` imports only that module), so the port reuses its
dataclasses and JSON round trip as they are: a run directory written by
either package restores in the other.

``level_scales`` is float64 numpy on the host, as in the JAX package
(ops/hash_encoding.py:45).  The kernels see it cast to f32; computed in f32
from the start, the flagship's finest line would become 1450 long instead
of 1449 and its checkpoints would no longer load.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from human_body_reconstruction_tpu.utils.config import (  # noqa: F401
    ClassicNeRFConfig,
    HashConfig,
    MLPConfig,
    PipelineConfig,
    PosEncConfig,
    RenderConfig,
    TrainConfig,
    from_json,
    to_json,
)


def level_scales(cfg: HashConfig) -> np.ndarray:
    """Per-level resolutions N_l = n_min * b**l (float64, host)."""
    if cfg.num_levels == 1:
        return np.asarray([float(cfg.n_min)])
    b = np.exp((np.log(cfg.n_max) - np.log(cfg.n_min)) / (cfg.num_levels - 1))
    return cfg.n_min * b ** np.arange(cfg.num_levels)


def flagship_config() -> PipelineConfig:
    """The zero-flag ``--preset flagship`` config of the JAX trainer
    (cli/train_hash.py resolve_preset + make_config with default flags):
    CP encoder, 7 levels up to n_max 1448 at rank 25, auto dense levels,
    occupancy-guided mass-dt placement on a 128-sample ladder."""
    from human_body_reconstruction_tpu_torch.ops import dense_grid

    hcfg = HashConfig(n_max=1448, log2_table_size=16, num_levels=7,
                      features_per_level=2, variant="cp", cp_rank=25,
                      dense_levels=0)
    hcfg = dataclasses.replace(
        hcfg, dense_levels=dense_grid.auto_dense_levels(hcfg))
    return PipelineConfig(
        hash=hcfg,
        mlp=MLPConfig(density_activation="leaky_relu",
                      rgb_activation="sigmoid"),
        render=RenderConfig(
            near=2.0, far=6.0, num_samples=128, hierarchical=False,
            use_sdf=False, white_background=False, occupancy=True,
            compact_samples=48, occ_guided=True, occ_probes=32,
            occ_explore=0.05, occ_probe_jitter=False, occ_dt="mass",
            occ_stratified=True, occ_threshold=0.01, eval_guided=0,
            normalization="diagonal"),
        train=TrainConfig(
            num_epochs=1000, ray_batch=16000, update_rate=15, seed=0,
            occ_warmup_steps=256, cp_tv_weight=1e-2, cp_tv_warmup=256 + 64,
            sigma_l1_weight=0.0, eikonal_subsample=16384),
    )
