"""Radiance-field forward and ray rendering (counterpart of the JAX
models/nerf.py), density mode.

The model is a ``Field`` module holding the encoder tables (dense coarse
grids, CP factor lines or the hash table) and the MLP head; it plays the
role of the JAX params pytree.  ``scene`` is {"mu": (3,), "sigma": scalar or (3,),
"min_bound", "max_bound"} as tensors on the field's device.

``render_rays`` has the eval branch (no jitter, the occupancy mask applied,
guided placement when ``cfg.render.eval_guided`` > 0 with a grid, else the
ladder) and the training branch (``jitter=True``): the jittered ladder
while no grid is attached, then occupancy-guided placement with
exploration, computed under ``no_grad`` and with no mask lookup (masking
would zero the gradient of every exploration sample).  With
``cfg.hash.stochastic_train`` the training branch encodes the hashed levels
with the single-corner estimator, as JAX ``render_rays`` does; the eval
branch, ``density_only`` and serving always encode exactly.  Not ported
yet, and raising: top-K compaction (training with a grid but without guided
placement), SDF mode and the hierarchical second pass.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from human_body_reconstruction_tpu_torch.models.mlp import (
    MLP3D, apply_density_activation)
from human_body_reconstruction_tpu_torch.ops import (
    compositing, dense_grid, hash_encoding, lowrank, occupancy, positional,
    sampling)
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig


class Field(nn.Module):
    """Encoder tables plus MLP head of one model.

    With a ``generator`` the tables and MLP are initialised as the JAX
    package does (U(-init_scale, init_scale) grids and hash table,
    U(-cp_init_scale, cp_init_scale) lines, torch-default linears) on the
    generator's device and then moved to ``device``; without one they are
    zeros, to be loaded from a checkpoint.  ``table`` is None unless the
    variant hashes its fine levels.
    """

    def __init__(self, cfg: PipelineConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hash
        msg = hash_encoding.unported(h)
        if msg:
            raise NotImplementedError(msg)
        if cfg.render.use_sdf:
            raise NotImplementedError("SDF mode is not ported yet")
        cp = h.variant == "cp" and h.num_hashed_levels > 0
        hashed = h.variant != "cp" and h.num_hashed_levels > 0
        lines, table = [], None
        if generator is not None:
            dense = dense_grid.init_dense(h, generator)
            if cp:
                lines = lowrank.init_lines(h, generator)
            if hashed:
                table = hash_encoding.init_table(h, generator)
        else:
            dense = [torch.zeros((g, g, g, h.features_per_level))
                     for g in dense_grid.dense_grid_sizes(h)]
            if cp:
                lines = [torch.zeros((h.dim, g, h.cp_rank))
                         for g in lowrank.cp_line_sizes(h)]
            if hashed:
                table = torch.zeros((h.num_hashed_levels, h.table_size,
                                     h.payload))
        self.dense = nn.ParameterList(nn.Parameter(g) for g in dense)
        self.lines = nn.ParameterList(nn.Parameter(ln) for ln in lines)
        self.table = None if table is None else nn.Parameter(table)
        self.mlp = MLP3D(cfg.mlp, h.out_dim, cfg.dir_enc.out_dim,
                         generator=generator)
        if device is not None:
            self.to(device)


def scene_from_bounds(lo, hi, normalization: str = "diagonal", device=None):
    """Scene dict from bounds: mu = min bound; sigma = the diagonal norm
    ("diagonal") or the per-axis extent ("unit_box")."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    if normalization == "unit_box":
        sigma = torch.clamp(hi - lo, min=1e-6)
    else:
        sigma = torch.sqrt(torch.sum((hi - lo) ** 2))
    return {"mu": lo, "sigma": sigma, "min_bound": lo, "max_bound": hi}


def encode_points(field: Field, scene, pts, cfg: PipelineConfig, *,
                  stochastic: bool = False, generator=None, enc_u=None):
    """(N, 3) world points -> (N, cfg.hash.out_dim) features; ``stochastic``
    (training) uses the single-corner estimator of the hashed levels, on
    uniforms ``enc_u`` (3, L, N) or ones drawn from ``generator``."""
    enc = {"dense": list(field.dense), "lines": list(field.lines),
           "table": field.table}
    return hash_encoding.encode_params(
        enc, pts, scene["mu"], scene["sigma"], cfg.hash,
        stochastic=stochastic, generator=generator, u=enc_u)


def field_forward(field: Field, scene, pts, dirs_enc, cfg: PipelineConfig,
                  compute_dtype=None, **encode):
    """(rgb (N, 3), density (N,)) at world points with encoded view dirs;
    ``encode`` goes to ``encode_points``."""
    feats = encode_points(field, scene, pts, cfg, **encode)
    return field.mlp(feats, dirs_enc, compute_dtype)


def density_only(field: Field, scene, pts, cfg: PipelineConfig,
                 compute_dtype=None):
    """(N,) activated density at world points: the density branch only
    (occupancy refreshes)."""
    raw, _ = field.mlp.density(encode_points(field, scene, pts, cfg),
                               compute_dtype)
    return apply_density_activation(raw, cfg.mlp)[..., 0]


def _render_pass(field, scene, rays_o, rays_d, dir_norm, t,
                 cfg: PipelineConfig, occ, compute_dtype, dt_override=None,
                 apply_mask=True, **encode):
    """One encode -> MLP -> composite pass at samples t (B, S), with the
    occupancy mask applied when a grid is given and ``apply_mask``;
    ``encode`` goes to ``encode_points``."""
    B, S = t.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]    # (B,S,3)
    mask = None
    if occ is not None and apply_mask:
        mask = occupancy.lookup(occ, pts, scene["mu"], scene["sigma"])
    dirs_enc = positional.positional_encode(
        rays_d, cfg.dir_enc.num_freq, cfg.dir_enc.mode)             # (B, dv)
    dirs_rep = dirs_enc[:, None, :].expand(B, S, dirs_enc.shape[-1])
    rgb, density = field_forward(field, scene, pts.reshape(B * S, 3),
                                 dirs_rep.reshape(B * S, -1), cfg,
                                 compute_dtype=compute_dtype, **encode)
    rgb = rgb.reshape(B, S, 3)
    density = density.reshape(B, S)
    if mask is not None:
        density = density * mask
    color, weights, _ = compositing.composite(
        t, rgb, density, dir_norm, sigma_clip_min=cfg.render.sigma_clip_min,
        white_background=cfg.render.white_background, dt=dt_override)
    return color, weights, density


def render_rays(field: Field, scene, rays_o, rays_d, dir_norm,
                cfg: PipelineConfig, *, num_samples: Optional[int] = None,
                occ: Optional[occupancy.OccupancyGrid] = None,
                compute_dtype=None, jitter: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None, placement=None):
    """Render a ray batch.  Returns {"coarse", "fine" (the same tensor: no
    hierarchical pass), "weights", "t", "density"}.

    ``jitter`` selects the training branch, whose random draws come from
    ``generator``; ``draws`` may replace them: "u" (the ladder jitter, or
    the iid quantiles of guided placement), "xi" (its stratified draw),
    "probe_u" (its probe jitter), "enc_u" (the stochastic encoder's
    uniforms, (3, L_hashed, B * S)).  ``placement`` (t (B, S), dt (B, S) or
    None) replaces the sampler's output altogether: a step's gradient moves
    measurably when t moves by a few f32 ulps, so comparisons of one step
    across devices hand both the same samples."""
    r = cfg.render
    if r.use_sdf:
        raise NotImplementedError("SDF mode is not ported yet")
    if jitter and r.hierarchical:
        raise NotImplementedError("hierarchical sampling is not ported yet")
    S = r.num_samples if num_samples is None else num_samples
    draws = draws or {}
    dt_guided = None
    guided_train = r.occ_guided and occ is not None and jitter
    guided_eval = r.eval_guided > 0 and occ is not None and not jitter
    if jitter and occ is not None and not guided_train and \
            0 < r.compact_samples < S:
        raise NotImplementedError("top-K sample compaction is not ported yet")
    with torch.no_grad():              # placement depends on no parameter
        if placement is not None:
            t, dt_guided = placement
        elif guided_train or guided_eval:
            t, dt_guided = sampling.occupancy_guided_ts(
                rays_o, rays_d, occ, scene["mu"], scene["sigma"], r.near,
                r.far, (r.compact_samples or S) if guided_train
                else r.eval_guided,
                num_probe=r.occ_probes or S, dt_mode=r.occ_dt, jitter=jitter,
                explore_frac=r.occ_explore if guided_train else 0.0,
                probe_jitter=r.occ_probe_jitter and jitter,
                stratified=r.occ_stratified and jitter, generator=generator,
                u=draws.get("u"), xi=draws.get("xi"),
                probe_u=draws.get("probe_u"))
        else:
            t = sampling.stratified_ts(
                (rays_o.shape[0],), r.near, r.far, S,
                log_sampling=r.log_sampling, device=rays_o.device,
                jitter=jitter, per_ray_jitter=r.per_ray_jitter,
                generator=generator, u=draws.get("u"))
    color, weights, density = _render_pass(
        field, scene, rays_o, rays_d, dir_norm, t, cfg, occ, compute_dtype,
        dt_override=dt_guided, apply_mask=not guided_train,
        stochastic=jitter and cfg.hash.stochastic_train, generator=generator,
        enc_u=draws.get("enc_u"))
    return {"coarse": color, "fine": color, "weights": weights, "t": t,
            "density": density}
