"""The ``neuralangelo`` head (MLPConfig.head): Neuralangelo's NeuralSDF and
IDR NeuralRGB (Li et al., CVPR 2023; ``projects/neuralangelo/utils/
modules.py``), its six-tap numerical gradient and curvature, its
coarse-to-fine schedule and its NeuS rendering, on the port's encoder.

SDF MLP: input [x (3), the hash features times the level mask (L F)],
SDF_LAYERS hidden layer of ``sdf_width`` with softplus (beta
SOFTPLUS_BETA), last layer 1 + ``sdf_width`` wide: f(x), then the
feature.  Geometric init: hidden weights N(0, sqrt(2 / d_out)) with the
first layer's feature columns zero, biases 0; last weights N(sqrt(pi /
d_in), 1e-4), bias -SPHERE_RADIUS, so that f starts near |x| - radius.
Colour MLP: input [x, SH(view dir) of degree SH_LEVELS ((levels + 1)^2
bases), n = grad f / |grad f|, feature], RGB_LAYERS ReLU layers of
``rgb_width``, 3 outputs, sigmoid; torch's default init.  Every layer is
weight-normalised (w = g v / |v| per output row, as
``torch.nn.utils.weight_norm``; g starts at |v|).  The layers compute in f32
with TF32 off (the source's plain ``nn.Linear``), through cuBLAS: the fused
kernels of ops/mlp_kernel.py are MLP3D's and are never called here.

Taps (paper Eq. 7-8): the N centre points and their 6 N taps x +- eps e_i
are one (7 N, 3) batch, encoded in one call and run through one SDF MLP
call whose last layer gives the centre rows all 1 + ``sdf_width`` outputs
and the tap rows f alone; grad f = (f(x + eps e_i) - f(x - eps e_i)) /
(2 eps) and the Laplacian sum_i (f(x + eps e_i) + f(x - eps e_i) - 2
f(x)) / eps^2.  The taps carry the parameters' gradient (the encoder gives
positions none): every sample's normal feeds the colour MLP, the eikonal
term and the curvature term.

Schedule (``stage``, the source's ``set_active_levels``,
``set_normal_epsilon`` and the curvature weight of its trainer), at update
count c, warm-up w, level step k: anneal = clip((c - w) // k, 1, L); the
active levels max(``c2f_init_levels``, anneal) (all L without coarse to
fine); eps = 1 / res[active - 1] in the grid's units, res_l = floor(n_min
g^l) + 1 (g the grid's growth), so the taps lie sigma eps from their centre
in world units: one cell of the finest active level, as the grid reads (x -
mu) / sigma; the curvature weight c / w times CURVATURE_WEIGHT up to w,
then CURVATURE_WEIGHT over g^(anneal - 1); the cosine anneal min(c /
(ANNEAL_END horizon), 1).  It is evaluated on the device from the optimizer's count,
so a captured training step replays every stage with no new capture.

Counters, as the kernel wrappers keep theirs: ``centre_points``,
``tap_points`` and ``upsample_points`` add each call's points (the
up-sampling's are evaluated without gradient), and ``step_points()`` gives
the last render's three counts.  In a ``torch.profiler`` trace the
up-sampling, the taps and the compositing are the spans
``hbr.sdf.upsample``, ``hbr.sdf.taps`` and ``hbr.sdf.composite`` (recorded
where the step runs eagerly or is captured; a replay records none).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from human_body_reconstruction_tpu_torch.ops import (
    compositing, hash_encoding, sampling)
from human_body_reconstruction_tpu_torch.utils import observability as obs
from human_body_reconstruction_tpu_torch.utils.config import PipelineConfig

HEAD = "neuralangelo"
EVAL_RAYS = 2048           # rays a render pass on the eval branch
# the published settings (base.yaml) that no configuration varies
SDF_LAYERS, RGB_LAYERS, SH_LEVELS = 1, 4, 3
SOFTPLUS_BETA, SPHERE_RADIUS = 100.0, 0.5
CURVATURE_WEIGHT = 5e-4
ANNEAL_END = 0.1           # the cosine anneal's end, a share of the horizon
S_VAR_INIT = 3.0           # s = exp(s_var) at init
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

centre_points = 0
tap_points = 0
upsample_points = 0
_last = {"centre": 0, "taps": 0, "upsample": 0}


def step_points() -> dict:
    """The last render's {"centre", "taps", "upsample"} point counts."""
    return dict(_last)


def _count(centre: int, upsample: int):
    global centre_points, tap_points, upsample_points
    centre_points += centre
    tap_points += 6 * centre
    upsample_points += upsample
    _last.update(centre=centre, taps=6 * centre, upsample=upsample)


class WNLinear(nn.Module):
    """A weight-normalised linear layer: parameters ``v`` (d_out, d_in),
    ``g`` (d_out,) and ``bias`` (d_out,); w = g v / |v| per row."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.v = nn.Parameter(torch.zeros((d_out, d_in), device=device))
        self.g = nn.Parameter(torch.zeros((d_out,), device=device))
        self.bias = nn.Parameter(torch.zeros((d_out,), device=device))

    @property
    def weight(self):
        return self.v * (self.g / torch.linalg.vector_norm(self.v, dim=1))[:, None]

    def forward(self, x, rows: Optional[int] = None):
        """x @ w.T + b, or, with ``rows``, the first ``rows`` outputs."""
        w, b = self.weight, self.bias
        if rows is not None:
            w, b = w[:rows], b[:rows]
        return F.linear(x, w, b)

    def slots(self):
        """(parameter, transposed?) in the JAX layout's key order: b, g, v
        (v stored (d_in, d_out))."""
        return [(self.bias, False), (self.g, False), (self.v, True)]


def _normed(layer: WNLinear):
    with torch.no_grad():
        layer.g.copy_(torch.linalg.vector_norm(layer.v, dim=1))


def sdf_dims(cfg: PipelineConfig) -> list:
    """(d_in, d_out) of the SDF MLP's layers."""
    m = cfg.mlp
    d0 = cfg.hash.dim + cfg.hash.out_dim
    dims = [d0] + [m.sdf_width] * SDF_LAYERS + [m.sdf_width]
    pairs = list(zip(dims[:-1], dims[1:]))
    pairs[-1] = (pairs[-1][0], pairs[-1][1] + 1)
    return pairs


def rgb_dims(cfg: PipelineConfig) -> list:
    """(d_in, d_out) of the colour MLP's layers."""
    m = cfg.mlp
    d0 = 6 + (SH_LEVELS + 1) ** 2 + m.sdf_width
    dims = [d0] + [m.rgb_width] * RGB_LAYERS + [3]
    return list(zip(dims[:-1], dims[1:]))


class NeuralangeloHead(nn.Module):
    """The SDF MLP (``sig``) and the colour MLP (``col``), WNLinear layers.
    With a ``generator`` the layers take the source's init, drawn on its
    device; without one they are zeros, to be loaded."""

    def __init__(self, cfg: PipelineConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg.mlp
        dev = None if generator is None else generator.device
        self.sig = nn.ModuleList(WNLinear(a, b, dev) for a, b in sdf_dims(cfg))
        self.col = nn.ModuleList(WNLinear(a, b, dev) for a, b in rgb_dims(cfg))
        if generator is not None:
            self._init(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def _init(self, gen):
        last = len(self.sig) - 1
        for i, layer in enumerate(self.sig):
            d_out, d_in = layer.v.shape
            if i == last:
                layer.v.normal_(math.sqrt(math.pi / d_in), 1e-4,
                                generator=gen)
                layer.bias.fill_(-SPHERE_RADIUS)
            else:
                layer.v.normal_(0.0, math.sqrt(2.0 / d_out), generator=gen)
                if i == 0:
                    layer.v[:, 3:] = 0.0
                layer.bias.zero_()
            _normed(layer)
        for layer in self.col:
            bound = 1.0 / math.sqrt(layer.v.shape[1])
            layer.v.uniform_(-bound, bound, generator=gen)
            layer.bias.uniform_(-bound, bound, generator=gen)
            _normed(layer)

    def hidden(self, inp):
        """The SDF MLP's hidden activations of (N, 3 + L F) inputs."""
        h = inp
        for layer in self.sig[:-1]:
            h = F.softplus(layer(h), beta=SOFTPLUS_BETA)
        return h

    def color(self, x, sh, normals, feat):
        """(N, 3) colours from points, view SH, normals and SDF features."""
        h = torch.cat([x, sh, normals, feat], dim=-1)
        for i, layer in enumerate(self.col):
            h = layer(h)
            if i < len(self.col) - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)

    # The calls in which the head takes the place of models/nerf.py's
    # rendering (``renders``): nerf.render_rays and density_only,
    # step.loss_fn, the Trainer's stage records and the mesh sweep hand
    # over to them.
    renders = True

    def forward(self, *args, **kwargs):
        raise NotImplementedError("the neuralangelo head takes unit view "
                                  "directions: its sweep, or field_rgb_sdf")

    def render_rays(self, field, scene, rays_o, rays_d, cfg, **kwargs):
        return render_rays(field, scene, rays_o, rays_d, cfg, **kwargs)

    def loss_fn(self, field, scene, batch, cfg, *, step=None, horizon=None,
                generator=None, draws=None):
        """(loss, aux) of a ray batch at the schedule's stage at the device
        count ``step`` over ``horizon`` steps (the last stage without a
        step)."""
        rays_o, rays_d, _, gt = batch
        st = (final_stage(cfg, rays_o.device) if step is None
              else stage(cfg, step, horizon or 1))
        out = render_rays(field, scene, rays_o, rays_d, cfg, jitter=True,
                          generator=generator, draws=draws, st=st)
        total, aux = loss(out, gt, cfg, st)
        aux["psnr"] = compositing.psnr(out["fine"], gt)
        return total, aux

    def density_only(self, field, scene, pts, cfg):
        """(N,) f at world points, at the last stage."""
        return sdf_only(field, scene, pts, cfg, final_stage(cfg, pts.device))

    def sweep(self, field, scene, pts, cfg):
        """(rgb (N, 3), f (N,)) at world points seen along (0, 0, 1)."""
        view = torch.tensor([[0.0, 0.0, 1.0]], device=pts.device)
        return field_rgb_sdf(field, scene, pts, view.expand(pts.shape[0], 3),
                             cfg)

    def stage_key(self, cfg, step: int) -> tuple:
        return stage_key(cfg, step)

    def stage_record(self, cfg, step: int, horizon: int, scene) -> dict:
        """The stage at ``step`` for a log record: "active_levels",
        "normal_eps" (the taps' step in world units), "curvature_weight"."""
        st = stage_host(cfg, step, horizon)
        return {"active_levels": st["active_levels"],
                "normal_eps": st["eps"] * float(scene["sigma"]),
                "curvature_weight": st["curvature_weight"]}


def named_leaves(field) -> dict:
    """{name: parameter} of a neuralangelo field, named as the plain
    reference (benchmark/reference/neuralangelo.py) names its leaves: "table",
    "sdf.<i>.v|g|b", "rgb.<i>.v|g|b", "s_var"."""
    out = {"table": field.table}
    for branch, layers in (("sdf", field.mlp.sig), ("rgb", field.mlp.col)):
        for i, layer in enumerate(layers):
            out.update({f"{branch}.{i}.v": layer.v, f"{branch}.{i}.g": layer.g,
                        f"{branch}.{i}.b": layer.bias})
    out["s_var"] = field.var_b
    return out


@torch.no_grad()
def load_leaves(field, weights: dict):
    """Copy {name: tensor} (``named_leaves``' names) into the field."""
    leaves = named_leaves(field)
    if set(leaves) != set(weights):
        raise ValueError(f"field leaves {sorted(leaves)} are not "
                         f"{sorted(weights)}")
    for name, p in leaves.items():
        if p.shape != weights[name].shape:
            raise ValueError(f"{name}: field {tuple(p.shape)}, given "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def spherical_harmonics(d, levels: int):
    """(N, (levels + 1)^2) real SH bases of unit directions d (N, 3), as
    the source's ``get_spherical_harmonics`` (levels <= 3)."""
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if levels >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if levels >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if levels >= 3:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


# -- schedule ----------------------------------------------------------------

def growth(cfg: PipelineConfig) -> float:
    h = cfg.hash
    return float(np.exp((np.log(h.n_max) - np.log(h.n_min))
                        / (h.num_levels - 1)))


def resolutions(cfg: PipelineConfig) -> list:
    """res_l = floor(n_min g^l) + 1, in float64 as the source computes it
    (2048 at the finest of 32 to 2048: 32 g^15 rounds below 2048)."""
    g = growth(cfg)
    return [int(np.floor(cfg.hash.n_min * g ** l)) + 1
            for l in range(cfg.hash.num_levels)]


def _anneal_levels(cfg: PipelineConfig, step: int) -> int:
    t = cfg.train
    return int(min(cfg.hash.num_levels,
                   max((step - t.warmup_steps) // t.c2f_every, 1)))


def stage_host(cfg: PipelineConfig, step: int, horizon: int) -> dict:
    """The schedule at update count ``step`` as host numbers:
    {"active_levels", "eps" (in the grid's units), "curvature_weight",
    "anneal"}."""
    t, L = cfg.train, cfg.hash.num_levels
    anneal = _anneal_levels(cfg, step)
    active = max(t.c2f_init_levels, anneal) if t.c2f_init_levels else L
    if step <= t.warmup_steps and t.warmup_steps > 0:
        curv = step / t.warmup_steps * CURVATURE_WEIGHT
    else:
        curv = CURVATURE_WEIGHT / growth(cfg) ** (anneal - 1)
    end = ANNEAL_END * max(horizon, 1)
    return {"active_levels": active,
            "eps": 1.0 / resolutions(cfg)[active - 1],
            "curvature_weight": curv,
            "anneal": min(step / end, 1.0) if end > 0 else 1.0}


def stage_key(cfg: PipelineConfig, step: int) -> tuple:
    """What changes at a stage change: (active levels, eps, annealed
    levels, in the warm-up)."""
    st = stage_host(cfg, step, 1)
    return (st["active_levels"], st["eps"], _anneal_levels(cfg, step),
            step <= cfg.train.warmup_steps)


_TABLES = {}


def _tables(cfg: PipelineConfig, device):
    """Device tables of eps by active level and of the curvature weight by
    annealed level, made once (outside any capture)."""
    key = (cfg.hash, cfg.train, str(device))
    if key not in _TABLES:
        g = growth(cfg)
        eps = [1.0 / r for r in resolutions(cfg)]
        curv = [CURVATURE_WEIGHT / g ** a
                for a in range(cfg.hash.num_levels)]
        _TABLES[key] = (torch.tensor(eps, dtype=torch.float32, device=device),
                        torch.tensor(curv, dtype=torch.float32, device=device))
    return _TABLES[key]


def stage(cfg: PipelineConfig, count, horizon: int) -> dict:
    """The schedule at the update count ``count`` (an int32 device tensor)
    as device tensors: {"mask" (L F,) of the active levels' features,
    "eps", "curvature_weight", "anneal"}; evaluated in f32 as
    ``stage_host`` gives it."""
    t, h = cfg.train, cfg.hash
    eps_t, curv_t = _tables(cfg, count.device)
    anneal = torch.clamp(torch.div(count - t.warmup_steps, t.c2f_every,
                                   rounding_mode="floor"),
                         min=1, max=h.num_levels)
    active = (torch.clamp(anneal, min=t.c2f_init_levels) if t.c2f_init_levels
              else torch.full_like(count, h.num_levels))
    lv = torch.arange(h.num_levels, device=count.device)
    mask = (lv < active).to(torch.float32).repeat_interleave(
        h.features_per_level)
    c = count.to(torch.float32)
    # index_select, not indexing by a 0-d tensor (which reads the host)
    curv = curv_t.index_select(0, (anneal - 1).reshape(1)).reshape(())
    if t.warmup_steps > 0:
        curv = torch.where(count <= t.warmup_steps,
                           c / t.warmup_steps * CURVATURE_WEIGHT, curv)
    end = ANNEAL_END * max(horizon, 1)
    ann = torch.clamp(c / end, max=1.0) if end > 0 else torch.ones_like(c)
    return {"mask": mask,
            "eps": eps_t.index_select(0, (active - 1).reshape(1)).reshape(()),
            "curvature_weight": curv, "anneal": ann}


def final_stage(cfg: PipelineConfig, device) -> dict:
    """Every level active, eps of the finest, no curvature, anneal 1: the
    eval branch's stage (a checkpoint's never-active levels meet zero
    first-layer columns, which no masked step updates)."""
    count = torch.full((), 1 << 30, dtype=torch.int32, device=device)
    st = stage(cfg, count, 1)
    st["curvature_weight"] = torch.zeros((), device=device)
    return st


# -- field evaluation ------------------------------------------------------

def _inputs(field, scene, pts, cfg, mask):
    from human_body_reconstruction_tpu_torch.models import nerf

    feats = nerf.encode_points(field, scene, pts, cfg)
    return torch.cat([pts, feats * mask], dim=-1)


def sdf_only(field, scene, pts, cfg: PipelineConfig, st: dict):
    """(N,) f at world points (the up-sampling's evaluation)."""
    head = field.mlp
    h = head.hidden(_inputs(field, scene, pts, cfg, st["mask"]))
    return head.sig[-1](h, rows=1)[:, 0]


def tap_step(st: dict, scene):
    """The taps' step in world units: one cell of the finest active level,
    the stage's eps times the sigma that the grid divides by."""
    return st["eps"] * scene["sigma"]


def tap_batch(x, eps):
    """(7 N, 3): the N points x, then their six taps x + eps e_i and x -
    eps e_i, laid out (N, 6)."""
    eye = torch.eye(3, device=x.device)
    offs = torch.cat([eye, -eye]) * eps                             # (6, 3)
    return torch.cat([x, (x[:, None, :] + offs[None]).reshape(-1, 3)])


def taps(field, scene, x, cfg: PipelineConfig, st: dict):
    """(f (N,), feature (N, sdf_width), grad f (N, 3), Laplacian (N,)) at
    the N world points x, from one encode and one SDF MLP call over the
    centre points and their six taps, laid out [x (N), x + eps e_i (N, 3)
    and x - eps e_i (N, 3) as (N, 6)], as
    ``nerf.sdf_finite_difference_normals`` lays out its taps (unclipped
    here), eps the stage's ``tap_step``."""
    n = x.shape[0]
    eps = tap_step(st, scene)
    q = tap_batch(x, eps)
    head = field.mlp
    h = head.hidden(_inputs(field, scene, q, cfg, st["mask"]))
    out = head.sig[-1](h[:n])
    ft = head.sig[-1](h[n:], rows=1).reshape(n, 6)
    f = out[:, 0]
    grad = (ft[:, :3] - ft[:, 3:]) / (2.0 * eps)
    lap = torch.sum((ft[:, :3] + ft[:, 3:] - 2.0 * f[:, None]) / (eps * eps),
                    dim=-1)
    return f, out[:, 1:], grad, lap


def field_rgb_sdf(field, scene, pts, view_dirs, cfg: PipelineConfig,
                  st: Optional[dict] = None):
    """(rgb (N, 3), f (N,)) at world points seen along unit ``view_dirs``
    (N, 3): the mesh sweep's field, no gradient kept."""
    st = st or final_stage(cfg, pts.device)
    f, feat, grad, _ = taps(field, scene, pts, cfg, st)
    sh = spherical_harmonics(view_dirs, SH_LEVELS)
    return field.mlp.color(pts, sh, F.normalize(grad, dim=-1), feat), f


def stratified(B: int, cfg: PipelineConfig, device, *, jitter: bool,
               generator=None, u=None):
    """(B, num_samples) depths (i + u) / S (far - near) + near, u U[0, 1)
    per sample when training (or given), 0.5 at evaluation."""
    r = cfg.render
    S = r.num_samples
    if u is None:
        u = (torch.rand((B, S), generator=generator, device=device) if jitter
             else torch.full((B, S), 0.5, device=device))
    ticks = torch.arange(S, dtype=torch.float32, device=device)
    return (ticks + u) / S * (r.far - r.near) + r.near


def render_rays(field, scene, rays_o, rays_d, cfg: PipelineConfig, *,
                jitter: bool = False, generator=None, draws=None,
                st: Optional[dict] = None):
    """NeuS rendering of a ray batch (unit directions): stratified depths
    ("u" in ``draws`` replaces their jitter), up-sampled without gradient,
    then f, its taps, the colour MLP and the section-alpha compositing.
    Returns {"coarse", "fine" (the colour), "weights", "t", "density" (f),
    "eikonal_norm" (|grad f|), "laplacian"}.  The eval branch renders in
    passes of EVAL_RAYS rays without gradient."""
    if not jitter and rays_o.shape[0] > EVAL_RAYS:
        parts = [render_rays(field, scene, rays_o[a:a + EVAL_RAYS],
                             rays_d[a:a + EVAL_RAYS], cfg, st=st)
                 for a in range(0, rays_o.shape[0], EVAL_RAYS)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    r = cfg.render
    B = rays_o.shape[0]
    st = st or final_stage(cfg, rays_o.device)
    draws = draws or {}
    with torch.no_grad():
        t = stratified(B, cfg, rays_o.device, jitter=jitter,
                       generator=generator, u=draws.get("u"))
        with obs.span("sdf.upsample"):
            t = sampling.neus_upsample(
                t, rays_o, rays_d,
                lambda p: sdf_only(field, scene, p, cfg, st),
                r.neus_fine_samples, r.neus_rounds)
    S = t.shape[1]
    _count(B * S, B * (r.num_samples + (r.neus_rounds - 1)
                       * r.neus_fine_samples))
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    with obs.span("sdf.taps"):
        f, feat, grad, lap = taps(field, scene, pts.reshape(-1, 3), cfg, st)
    sh = spherical_harmonics(rays_d, SH_LEVELS)
    rgb = field.mlp.color(pts.reshape(-1, 3),
                          sh[:, None, :].expand(B, S, sh.shape[-1]).reshape(
                              B * S, -1), F.normalize(grad, dim=-1), feat)
    with obs.span("sdf.composite"):
        cos = torch.sum(rays_d[:, None, :] * grad.reshape(B, S, 3), dim=-1)
        alpha = compositing.neus_alphas(
            f.reshape(B, S), cos, t, r.far, torch.exp(field.var_b),
            st["anneal"])
        weights = compositing.alpha_weights(alpha)
        color = torch.sum(weights[..., None] * rgb.reshape(B, S, 3), dim=-2)
        if r.white_background:
            color = color + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return {"coarse": color, "fine": color, "weights": weights, "t": t,
            "density": f.reshape(B, S),
            "eikonal_norm": torch.linalg.vector_norm(grad, dim=-1),
            "laplacian": lap}


def loss(out, gt, cfg: PipelineConfig, st: dict):
    """(loss, aux): the mean L1 colour error, the eikonal term mean((|grad|
    - 1)^2) at ``eikonal_weight`` and the curvature term mean|Laplacian| at
    the stage's weight; aux "mse" (of the colour), "eikonal", "curvature"."""
    l1 = torch.mean(torch.abs(out["fine"] - gt))
    eik = torch.mean((out["eikonal_norm"] - 1.0) ** 2)
    curv = torch.mean(torch.abs(out["laplacian"]))
    total = (l1 + cfg.train.eikonal_weight * eik
             + st["curvature_weight"] * curv)
    mse = torch.mean((out["fine"] - gt) ** 2)
    return total, {"mse": mse, "eikonal": eik, "curvature": curv}


def unported(cfg: PipelineConfig, level_parallel: int = 1) -> Optional[str]:
    """Why the port cannot run this head's configuration (on
    ``level_parallel`` level ranks), or None."""
    if cfg.mlp.head != HEAD:
        return None
    if level_parallel > 1:
        return ("--level_parallel with --preset neuralangelo is not ported: "
                "the level mask and the taps are not split")
    h = cfg.hash
    if h.variant != "corner" or h.dense_levels or h.dim != 3:
        return ("the neuralangelo head runs on the exact corner hash grid "
                "alone (no CP, cell or dense levels)")
    if (h.stochastic_train or h.packed
            or hash_encoding.hash_route(h, False) != "hash_encode"):
        return (f"the neuralangelo head trains the exact f32 hash grid; its "
                f"taps need the exact interpolant: the stochastic and packed "
                f"reads at F {h.features_per_level} are not run by the port")
    if cfg.render.normalization != "diagonal":
        return ("the neuralangelo head's taps step one cell of the grid in "
                "every axis: it reads the diagonal normalisation alone")
    if cfg.render.occupancy or cfg.render.hierarchical:
        return ("the neuralangelo head places its samples by NeuS "
                "up-sampling: no occupancy grid, no hierarchical pass")
    return None
