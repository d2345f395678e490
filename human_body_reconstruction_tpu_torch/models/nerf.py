"""Radiance-field forward and ray rendering (counterpart of the JAX
models/nerf.py): density and SDF mode, with the optional hierarchical
second pass.

The model is a ``Field`` module holding the encoder tables (dense coarse
grids, CP factor lines or the hash table), the MLP head and, in SDF mode,
the learnable sharpness ``var_b``; it plays the role of the JAX params
pytree.  ``scene`` is {"mu": (3,), "sigma": scalar or (3,), "min_bound",
"max_bound"} as tensors on the field's device.

``render_rays`` has the eval branch (no jitter, the occupancy mask applied,
guided placement when ``cfg.render.eval_guided`` > 0 with a grid, else the
ladder) and the training branch (``jitter=True``): the jittered ladder
while no grid is attached, then occupancy-guided placement with
exploration, computed under ``no_grad`` and with no mask lookup (masking
would zero the gradient of every exploration sample), or, with a grid but
without guided placement, the masked ladder cut to each ray's first
``compact_samples`` occupied samples (top-K compaction; never in SDF
mode).  With ``cfg.hash.stochastic_train`` the training branch encodes the
hashed levels with the single-corner estimator, as JAX ``render_rays``
does; the eval branch, ``density_only`` and serving always encode exactly
(a packed config through its packed words, JAX's ``packed_eval``).

SDF mode composites the 2·sigmoid−1 head with ``composite_sdf`` and adds
``out["eikonal_norm"]``, the finite-difference gradient norm of the field
at the pass's points (a with-replacement subsample of
``cfg.train.eikonal_subsample`` of them while training).  The hierarchical
pass resamples ``num_fine_samples`` (or S) depths from the first pass's
weights (gradient stopped), merges them with the first pass's and renders
again, masked; its colour is ``out["fine"]``.  At evaluation the JAX
package draws the fine samples from one fixed key, the same for every
chunk; the port draws them from a generator seeded 0.

``Field.mlp`` is an ``MLP3D`` or, under the ``neuralangelo`` head
(``cfg.mlp.head``, the port's own), ``sdf_head.NeuralangeloHead``, a
density-free SDF field that renders itself (its ``renders`` is true):
``render_rays`` and ``density_only`` hand over to its methods (NeuS
up-sampling and section-alpha compositing, six taps on every sample; its
f), and ``var_b`` holds its sharpness parameter s_var (s = exp(s_var)).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from human_body_reconstruction_tpu_torch.models import sdf_head
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
    variant hashes its fine levels; ``var_b`` (the SDF sharpness, 0.5 at
    init) is None unless ``cfg.render.use_sdf``.  ``lp`` is None, or, on a
    level-parallel rank (parallel/level_parallel.py ``shard_field``), the
    ``hash_encoding.LevelShard`` whose slice ``lines`` or ``table`` hold:
    the JAX ``params["lp_scales"]``, placement data beside the
    parameters.
    """

    def __init__(self, cfg: PipelineConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hash
        msg = hash_encoding.unported(h) or sdf_head.unported(cfg)
        if msg:
            raise NotImplementedError(msg)
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
        neuralangelo = cfg.mlp.head == sdf_head.HEAD
        self.mlp = (sdf_head.NeuralangeloHead(cfg, generator=generator)
                    if neuralangelo else
                    MLP3D(cfg.mlp, h.out_dim, cfg.dir_enc.out_dim,
                          generator=generator))
        # SDF sharpness b (JAX init_var_model), or the neuralangelo head's
        # s_var; the JAX "lines" and "table" optimizer labels depend on the
        # variant (train/checkpoint.py)
        self.var_b = (nn.Parameter(torch.tensor(
            sdf_head.S_VAR_INIT if neuralangelo else 0.5,
            device=None if generator is None else generator.device))
            if cfg.render.use_sdf or neuralangelo else None)
        self.variant = h.variant
        self.lp = None
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
                  stochastic: bool = False, generator=None, enc_draws=None):
    """(N, 3) world points -> (N, cfg.hash.out_dim) features; ``stochastic``
    (training) uses the single-corner estimator of the hashed levels, on the
    draws ``enc_draws`` ({"u": (3, L, N) uniforms, and a subsampled
    backward's "pick", "lsel", "psel"}) or ones drawn from ``generator``.  A
    level-parallel field (``field.lp``) encodes its slice and joins the
    level group's (``cfg.hash.level_axis`` set)."""
    enc = {"dense": list(field.dense), "lines": list(field.lines),
           "table": field.table}
    return hash_encoding.encode_params(
        enc, pts, scene["mu"], scene["sigma"], cfg.hash,
        stochastic=stochastic, generator=generator, shard=field.lp,
        **(enc_draws or {}))


def field_forward(field: Field, scene, pts, dirs_enc, cfg: PipelineConfig,
                  compute_dtype=None, **encode):
    """(rgb (N, 3), density (N,)) at world points with encoded view dirs;
    ``encode`` goes to ``encode_points``.  The neuralangelo head reads
    unit view directions, not their encoding, and refuses the call."""
    feats = encode_points(field, scene, pts, cfg, **encode)
    return field.mlp(feats, dirs_enc, compute_dtype)


def density_only(field: Field, scene, pts, cfg: PipelineConfig,
                 compute_dtype=None):
    """(N,) activated density at world points: the density branch only
    (occupancy refreshes); the neuralangelo head's f, at its last stage."""
    if field.mlp.renders:
        return field.mlp.density_only(field, scene, pts, cfg)
    raw, _ = field.mlp.density(encode_points(field, scene, pts, cfg),
                               compute_dtype)
    return apply_density_activation(raw, cfg.mlp)[..., 0]


def sdf_finite_difference_normals(field: Field, scene, pts,
                                  cfg: PipelineConfig, eps: float = 5e-4,
                                  compute_dtype=None):
    """(N, 3) central-difference gradient of the SDF head at world points,
    its six offsets (clipped to the scene bounds) in one ``density_only``
    call of N * 6 points laid out (N, 6, 3).  The encoders pass no gradient
    to positions, so the analytic d(field)/dx is zero; the parameters'
    gradient flows through every tap.  The neuralangelo head's
    ``sdf_head.taps`` lays its taps out the same way, after the centre
    points, unclipped, on every sample, one cell of the finest active level
    from their centre, and also takes the Laplacian."""
    eye = torch.eye(3, device=pts.device)
    offs = torch.cat([eye, -eye]) * eps                              # (6, 3)
    q = torch.clamp(pts[:, None, :] + offs[None, :, :], scene["min_bound"],
                    scene["max_bound"])                              # (N,6,3)
    d = density_only(field, scene, q.reshape(-1, 3), cfg,
                     compute_dtype=compute_dtype).reshape(-1, 6)
    return (d[:, :3] - d[:, 3:]) / (2.0 * eps)


def eikonal_loss(norm):
    """mean((|grad| - 1)^2)."""
    return torch.mean((norm - 1.0) ** 2)


def _render_pass(field, scene, rays_o, rays_d, dir_norm, t,
                 cfg: PipelineConfig, occ, compute_dtype, dt_override=None,
                 allow_compact=True, **encode):
    """One encode -> MLP -> composite pass at samples t (B, S); ``encode``
    goes to ``encode_points``.  The occupancy mask is applied when a grid
    is given, except to guided training placement (``dt_override`` with
    ``allow_compact``); without ``dt_override``, ``allow_compact`` keeps
    each ray's first ``compact_samples`` occupied samples in depth order
    (not in SDF mode).  Returns (color, weights, density, pts, t) of the
    samples kept."""
    B, S = t.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]    # (B,S,3)
    K = cfg.render.compact_samples if allow_compact else 0
    mask, dt = None, dt_override
    if occ is not None and (dt_override is None or not allow_compact):
        mask = occupancy.lookup(occ, pts, scene["mu"], scene["sigma"])
        if dt_override is None and 0 < K < S and not cfg.render.use_sdf:
            # occupied first, then depth: the keys are distinct, so the K
            # smallest come in the order JAX's top_k gives them
            key = (1.0 - mask) * S + torch.arange(S, dtype=torch.float32,
                                                  device=t.device)
            order = torch.topk(-key, K, dim=-1).indices              # (B, K)
            dt = torch.gather(torch.cat([t[..., 1:] - t[..., :-1],
                                         torch.zeros_like(t[..., :1])], -1),
                              -1, order)
            t = torch.gather(t, -1, order)
            mask = torch.gather(mask, -1, order)
            pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
            S = K
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
    if cfg.render.use_sdf:
        color, weights, _ = compositing.composite_sdf(
            t, rgb, density, field.var_b, dir_norm)
    else:
        color, weights, _ = compositing.composite(
            t, rgb, density, dir_norm,
            sigma_clip_min=cfg.render.sigma_clip_min,
            white_background=cfg.render.white_background, dt=dt)
    return color, weights, density, pts, t


def _enc_draws(draws: dict, prefix: str) -> dict:
    """The encoder's draws of one pass: {"u", "pick", "lsel", "psel"} from
    ``draws[prefix + name]``, None where not given."""
    return {k: draws.get(prefix + k) for k in ("u", "pick", "lsel", "psel")}


def render_rays(field: Field, scene, rays_o, rays_d, dir_norm,
                cfg: PipelineConfig, *, num_samples: Optional[int] = None,
                hierarchical: Optional[bool] = None,
                occ: Optional[occupancy.OccupancyGrid] = None,
                compute_dtype=None, jitter: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None, placement=None,
                enc_generator: Optional[torch.Generator] = None):
    """Render a ray batch.  Returns {"coarse", "fine" (the second pass's
    colour, or the coarse one without ``hierarchical``, which defaults to
    ``cfg.render.hierarchical``), "weights", "t", "density"}, plus
    "fine_weights" with the second pass and "eikonal_norm" in SDF mode.

    ``jitter`` selects the training branch, whose random draws come from
    ``generator``, the stochastic encoder's from ``enc_generator`` when
    given (a level-parallel rank's own stream, JAX ``_fold_level_axis``:
    the ranks of one data shard draw the same rays and samples but not the
    same corner bits); ``draws`` may replace them: "u" (the ladder jitter, or
    the iid quantiles of guided placement), "xi" (its stratified draw),
    "probe_u" (its probe jitter), "enc_u" and "fine_enc_u" (the stochastic
    encoder's uniforms of each pass, (3, L_hashed, points)), "enc_pick",
    "enc_lsel", "enc_psel" and their "fine_" twins (a subsampled packed
    backward's draws, ``hash_encoding.draw_subsample``), "fine_u" (the
    second pass's quantiles, (B, n_fine)) and "eik_idx" (the eikonal
    subsample's point indices).  At evaluation the second pass draws from
    ``generator``, else from one seeded 0.  ``placement`` (t (B, S), dt
    (B, S) or None) replaces the sampler's output altogether: a step's
    gradient moves measurably when t moves by a few f32 ulps, so
    comparisons of one step across devices hand both the same samples.
    A head that renders itself (``field.mlp.renders``) renders through its
    ``render_rays``, the neuralangelo head at its last stage (a training
    step hands it the step's stage itself), from ``generator`` and
    ``draws["u"]``; it takes no grid or placement."""
    if field.mlp.renders:
        return field.mlp.render_rays(field, scene, rays_o, rays_d, cfg,
                                     jitter=jitter, generator=generator,
                                     draws=draws)
    r = cfg.render
    hier = r.hierarchical if hierarchical is None else hierarchical
    S = r.num_samples if num_samples is None else num_samples
    draws = draws or {}
    dt_guided = None
    guided_train = r.occ_guided and occ is not None and jitter
    guided_eval = r.eval_guided > 0 and occ is not None and not jitter
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
    stochastic = jitter and cfg.hash.stochastic_train
    enc_gen = generator if enc_generator is None else enc_generator
    coarse, weights, density, pts, t = _render_pass(
        field, scene, rays_o, rays_d, dir_norm, t, cfg, occ, compute_dtype,
        dt_override=dt_guided, allow_compact=jitter, stochastic=stochastic,
        generator=enc_gen, enc_draws=_enc_draws(draws, "enc_"))
    out = {"coarse": coarse, "fine": coarse, "weights": weights, "t": t,
           "density": density}
    sdf_pts = pts
    if hier:
        with torch.no_grad():
            t_h, w_h = t, weights.detach()
            if occ is not None and jitter and 0 < r.compact_samples:
                # compaction puts occupied samples first: sort again for
                # the inverse CDF's sorted bins
                t_h, order = torch.sort(t_h, dim=-1, stable=True)
                w_h = torch.gather(w_h, -1, order)
            fine_gen = generator
            if fine_gen is None and "fine_u" not in draws:
                fine_gen = torch.Generator(rays_o.device).manual_seed(0)
            t_fine = sampling.hierarchical_ts(
                t_h, w_h, r.num_fine_samples or S, generator=fine_gen,
                u=draws.get("fine_u"))
        fine, fweights, _, sdf_pts, _ = _render_pass(
            field, scene, rays_o, rays_d, dir_norm, t_fine, cfg, occ,
            compute_dtype, allow_compact=jitter, stochastic=stochastic,
            generator=enc_gen, enc_draws=_enc_draws(draws, "fine_enc_"))
        out["fine"], out["fine_weights"] = fine, fweights
    if r.use_sdf:
        mid = sdf_pts.reshape(-1, 3)
        n_sub = cfg.train.eikonal_subsample
        if jitter and 0 < n_sub < mid.shape[0]:
            idx = draws.get("eik_idx")
            if idx is None:
                idx = torch.randint(0, mid.shape[0], (n_sub,),
                                    generator=generator, device=mid.device)
            mid = mid[idx]
        grads = sdf_finite_difference_normals(field, scene, mid, cfg,
                                              compute_dtype=compute_dtype)
        out["eikonal_norm"] = torch.sqrt(torch.sum(grads ** 2, dim=-1)
                                         + 1e-12)
    return out
