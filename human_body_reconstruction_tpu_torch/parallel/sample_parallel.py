"""Sample-axis parallelism: one render, each ray's samples split over the
ranks of a sample group (counterpart of the JAX
parallel/sample_parallel.py).

Emission-absorption compositing is associative in log-transmittance.  For a
ray split into contiguous segments s = 0..n-1 of the deterministic ladder,

    tau_s    = sum_i sigma_i dt_i                 (segment optical depth)
    C_s      = sum_i T^loc_i alpha_i rgb_i        (segment partial colour)
    T_pre_s  = exp(-sum_{j<s} tau_j)              (upstream transmittance)
    C        = sum_s T_pre_s * C_s                (+ 1 - sum_s T_pre_s A_s
                                                   on a white background)

so each rank evaluates the field (all the work) at its own segment of every
ray, and only per-segment (n, B) and (n, B, 3) partials cross ranks.  In SDF
mode alpha_i depends on the pair (phi_i, phi_{i+1}): a segment needs one
halo value, the next segment's first phi, and the upstream transmittance is
the prefix product of the segments' (1 - alpha) products.
``segment_partials`` computes one segment's partials, ``combine_segments``
(pure) the colour from every segment's, stacked; ``make_sp_render`` runs
them over a (data, sample) layout (rays over "data", samples over
"sample", the collectives on the sample group only), ``render_segments`` the
same segments one after another on one device.  Use case: a large eval
render (hundreds of samples a ray at high resolution) beyond one device's
memory or latency budget.
"""

from __future__ import annotations

import torch

from human_body_reconstruction_tpu_torch.models import nerf
from human_body_reconstruction_tpu_torch.ops import (
    compositing, occupancy, positional, sampling)
from human_body_reconstruction_tpu_torch.parallel import comm
from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig

SAMPLE_AXIS = "sample"


def make_sp_mesh(n_data: int, n_sample: int) -> comm.Mesh:
    """The (data, sample) layout over the whole world; either extent may be
    1."""
    return comm.make_mesh(n_data, n_sample, SAMPLE_AXIS)


def ladder(cfg: PipelineConfig, num_samples: int, device):
    """The deterministic ladder t (S,) from near to far and its dt (S,),
    the last dt 0."""
    t = sampling.linspace(cfg.render.near, cfg.render.far, num_samples, device)
    return t, torch.cat([t[1:] - t[:-1], torch.zeros_like(t[:1])])


def segment_field(field, scene, rays_o, rays_d, t, cfg: PipelineConfig,
                  occ=None, compute_dtype=None):
    """(rgb (B, s, 3), density (B, s)) at the segment's depths t (s,) of
    every ray, the occupancy mask applied."""
    B, s = rays_o.shape[0], t.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]
    dirs = positional.positional_encode(rays_d, cfg.dir_enc.num_freq,
                                        cfg.dir_enc.mode)
    dirs = dirs[:, None, :].expand(B, s, dirs.shape[-1])
    rgb, density = nerf.field_forward(field, scene, pts.reshape(B * s, 3),
                                      dirs.reshape(B * s, -1), cfg,
                                      compute_dtype=compute_dtype)
    density = density.reshape(B, s)
    if occ is not None:
        density = density * occupancy.lookup(occ, pts, scene["mu"],
                                             scene["sigma"])
    return rgb.reshape(B, s, 3), density


def sdf_phi(density, b):
    """clip(sigmoid(b * s), 1e-6, 1), as ``compositing.composite_sdf``."""
    sig = 1.0 / (1.0 + torch.exp(-(b * density)))
    return torch.clamp(sig, 1e-6, 1.0)


def segment_partials(rgb, density, dt, dir_norm, cfg: PipelineConfig,
                     next_phi=None, var_b=None) -> dict:
    """One segment's partials.  Density mode: {"tau" (B,), "color" (B, 3),
    "acc" (B,)}.  SDF mode (``density`` is then phi, ``next_phi`` (B,) the
    next segment's first phi or None for the last segment): {"prod" (B,),
    "color" (B, 3)}."""
    if cfg.render.use_sdf:
        phi = density
        last = (torch.ones_like(phi[:, -1]) if next_phi is None
                else next_phi / phi[:, -1])
        ratio = torch.cat([phi[:, 1:] / phi[:, :-1], last[:, None]], dim=-1)
        alpha = torch.clamp(1.0 - ratio, min=0.0)
        one_m = 1.0 - alpha
        w = compositing.exclusive_cumprod(one_m, dim=-1) * alpha
        return {"prod": torch.prod(one_m, dim=-1),
                "color": torch.sum(w[..., None] * rgb, dim=-2)}
    sigma = torch.clamp(density, min=cfg.render.sigma_clip_min)
    prod = sigma * dt[None, :] * dir_norm.reshape(-1)[:, None]
    alpha = 1.0 - torch.exp(-prod)
    w = torch.exp(-compositing.exclusive_cumsum(prod, dim=-1)) * alpha
    return {"tau": torch.sum(prod, dim=-1),
            "color": torch.sum(w[..., None] * rgb, dim=-2),
            "acc": torch.sum(w, dim=-1)}


def combine_segments(parts: dict, cfg: PipelineConfig):
    """(B, 3) colours from every segment's partials stacked on a leading
    segment axis (n, ...), in ray order."""
    if cfg.render.use_sdf:
        t_pre = compositing.exclusive_cumprod(parts["prod"], dim=0)
        return torch.sum(t_pre[..., None] * parts["color"], dim=0)
    t_pre = torch.exp(-compositing.exclusive_cumsum(parts["tau"], dim=0))
    color = torch.sum(t_pre[..., None] * parts["color"], dim=0)
    if cfg.render.white_background:
        color = color + (1.0 - torch.sum(t_pre * parts["acc"], dim=0))[:, None]
    return color


def _split(num_samples: int, n: int):
    if num_samples % n:
        raise ValueError(f"num_samples {num_samples} not divisible by "
                         f"sample-axis size {n}")
    return num_samples // n


@torch.no_grad()
def render_segments(field, scene, rays_o, rays_d, dir_norm,
                    cfg: PipelineConfig, num_samples: int, n: int, occ=None,
                    compute_dtype=None):
    """The sample-split render on one device: the n segments' fields one
    after another, then ``combine_segments``; (B, 3)."""
    s = _split(num_samples, n)
    t, dt = ladder(cfg, num_samples, rays_o.device)
    fields = [segment_field(field, scene, rays_o, rays_d, t[i * s:(i + 1) * s],
                            cfg, occ, compute_dtype) for i in range(n)]
    if cfg.render.use_sdf:
        phis = [sdf_phi(d, field.var_b) for _, d in fields]
        terms = [segment_partials(rgb, phis[i], None, dir_norm, cfg,
                                  phis[i + 1][:, 0] if i + 1 < n else None)
                 for i, (rgb, _) in enumerate(fields)]
    else:
        terms = [segment_partials(rgb, d, dt[i * s:(i + 1) * s], dir_norm, cfg)
                 for i, (rgb, d) in enumerate(fields)]
    return combine_segments({k: torch.stack([p[k] for p in terms])
                             for k in terms[0]}, cfg)


def make_sp_render(cfg: PipelineConfig, mesh: comm.Mesh, num_samples: int,
                   compute_dtype=torch.bfloat16):
    """render(field, scene, rays_o, rays_d, dir_norm, occ=None) -> (B, 3) on
    every rank: rays split over the data group, this rank's segment of
    every ray's ``num_samples``-sample ladder, the partials gathered over
    the sample group and combined."""
    n = mesh.n_inner
    s = _split(num_samples, n)
    i = mesh.inner_index

    def local(field, scene, occ, rays_o, rays_d, dir_norm):
        t, dt = ladder(cfg, num_samples, rays_o.device)
        rgb, density = segment_field(field, scene, rays_o, rays_d,
                                     t[i * s:(i + 1) * s], cfg, occ,
                                     compute_dtype)
        if cfg.render.use_sdf:
            phi = sdf_phi(density, field.var_b)
            firsts = comm.all_gather_stack(phi[:, 0], mesh.inner_group)
            terms = segment_partials(rgb, phi, None, dir_norm, cfg,
                                     firsts[i + 1] if i + 1 < n else None)
        else:
            terms = segment_partials(rgb, density, dt[i * s:(i + 1) * s],
                                     dir_norm, cfg)
        return combine_segments(
            {k: comm.all_gather_stack(v, mesh.inner_group)
             for k, v in terms.items()}, cfg)

    @torch.no_grad()
    def render(field, scene, rays_o, rays_d, dir_norm, occ=None):
        return dp.render_split(
            lambda o, d, dn: local(field, scene, occ, o, d, dn), mesh,
            rays_o, rays_d, dir_norm)

    return render
