"""A plain reference of Neuralangelo (Li et al., "Neuralangelo: High-Fidelity
Neural Surface Reconstruction", CVPR 2023) as the ``neuralangelo``
configuration runs it: forward, loss and, through autograd, gradients, in
plain PyTorch, f32 with TF32 off, imports nothing of any other module of
this repository (a copy of it stands beside the benchmark, the same file).

It follows the paper and ``projects/neuralangelo/configs/base.yaml`` with
``projects/neuralangelo/utils/modules.py`` (``NeuralSDF``, ``NeuralRGB``):

* encoder: a multi-resolution hash grid (Instant-NGP corner hash, 8
  corners trilinear) of L levels of F features in 2^T-entry tables,
  resolutions n_min b^l up to n_max, times the coarse-to-fine level mask;
* SDF MLP on [x, masked features]: weight-normalised layers, softplus
  (beta 100) between them, the last giving f and the feature;
* six-tap central differences for grad f and the Laplacian, at eps = one
  cell of the finest active level, sigma / res in world units (res_l =
  floor(n_min b^l) + 1, sigma the scene's diagonal, which the grid divides
  by: the paper's grid size, Eq. 7-8);
* colour MLP (IDR) on [x, SH(view dir), grad f / |grad f|, feature]:
  weight-normalised ReLU layers, sigmoid out;
* NeuS: stratified depths, up-sampled in rounds at sharpness 64 * 2^h,
  section alphas with the cosine anneal and s = exp(s_var), compositing;
* loss: mean L1 colour error + eikonal weight * mean((|grad f| - 1)^2) +
  the stage's curvature weight * mean |Laplacian|.

Departures from the source, each deliberate:

* no background NeRF (``model.background``) and no appearance embedding:
  the inputs are segmented subjects on a plain background;
* the scene: rays sample [near, far] of the configuration, there is no
  bounding sphere (so no ``outside`` mask on the eikonal and curvature
  terms), the last interval ends at ``far``, and the hash grid reads the
  port's normalisation, (x - min bound) / |max bound - min bound|, in
  place of the config's ``range: [-2, 2]``, so a cell of the grid, and
  the taps' step with it, spans sigma / res world units; the MLPs read
  world x;
* the hash grid's cell and resolution: the port's n_min b^l with floor
  cells and no half-cell offset (tcnn's grid differs), and the port's
  table init U(-1e-4, 1e-4);
* the optimizer: the port's grouped one, Adam (eps 1e-15) on the table,
  AdamW (eps 1e-8, weight decay) on the MLPs, both on the two-step
  schedule, AdamW (optax's weight decay 1e-4) at a constant rate on s_var;
  the source takes one AdamW over every parameter;
* precision: every encoder, MLP and compositing operation in f32 (the
  source runs tcnn's encoder in half precision).

Random draws come from one ``torch.Generator`` in the program's order: the
rays' images and pixels, then the stratified jitter (B, S0).  Handed a
generator in the same state, the reference draws what the program draws;
the up-sampling draws nothing.  ``Rounding`` puts a narrow type on the
MLPs' operands (the control: bfloat16 in place of f32).  ``fault`` plants
a fault for the control's readings: "drop_tap" (the -z tap replaced by the
centre), "eps" (twice the step) or "no_laplacian" (the curvature term left
out).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)
ADAM_B1, ADAM_B2 = 0.9, 0.999
BLOCK_RAYS = 256          # rays a block of the blocked forward and backward
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
FAULTS = ("drop_tap", "eps", "no_laplacian")
# base.yaml's settings that the configuration does not carry
SDF_LAYERS, RGB_LAYERS, SH_LEVELS = 1, 4, 3
SOFTPLUS_BETA, SPHERE_RADIUS = 100.0, 0.5
CURVATURE_WEIGHT = 5e-4
ANNEAL_END = 0.1
S_VAR_INIT = 3.0


class Rounding:
    """x -> x rounded to ``dtype`` and back to f32 (identity for None)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, x):
        return x if self.dtype is None else x.to(self.dtype).to(torch.float32)


class no_tf32:
    """TF32 off for the reference's products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def f32(x) -> float:
    return float(np.float32(x))


# -- rays and scene ---------------------------------------------------------

def pixel_rays(i, j, K, c2w):
    """World rays through pixels (i, j): (origins, unit dirs, norms)."""
    i, j = i.to(torch.float32), j.to(torch.float32)
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1)
    d = (c2w[..., :3, :3] * dirs[..., None, :]).sum(-1)
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[..., :3, 3], d.shape), d / n, n


def bounds_of(ds, near: float, far: float, margin: float = 1.5):
    """Axis-aligned (min, max) of every ray of every camera of ``ds`` at t
    in {near, far + margin}."""
    H, W, K = ds["H"], ds["W"], ds["K"]
    j, i = torch.meshgrid(torch.arange(H, device=K.device),
                          torch.arange(W, device=K.device), indexing="ij")
    o, d, _ = pixel_rays(i.reshape(-1), j.reshape(-1), K,
                         ds["c2ws"][:, None, :, :])
    t = torch.tensor([near, far + margin], device=K.device)
    pts = (o[..., None, :] + d[..., None, :] * t[:, None]).reshape(-1, 3)
    return pts.amin(0), pts.amax(0)


def scene_of(lo, hi):
    """mu = the box's min, sigma = its diagonal."""
    return {"mu": lo, "sigma": torch.sqrt(torch.sum((hi - lo) ** 2))}


# -- hash grid ---------------------------------------------------------------

def level_scales(h: dict) -> np.ndarray:
    """Per-level resolutions n_min * b^l (float64)."""
    b = np.exp((np.log(h["n_max"]) - np.log(h["n_min"]))
               / (h["num_levels"] - 1))
    return h["n_min"] * b ** np.arange(h["num_levels"])


def _mul_lo32(c, p: int):
    return ((c & 0xFFFF) * p + ((((c >> 16) * p) & 0xFFFF) << 16)) & MASK32


def hash_rows(c, T: int):
    """Instant-NGP spatial hash of int64 corner coords (..., 3) -> rows."""
    c = c & MASK32
    h = _mul_lo32(c[..., 0], PRIMES[0])
    for k in (1, 2):
        h = h ^ _mul_lo32(c[..., k], PRIMES[k])
    return h & (T - 1)


def hash_level(table_l, xn, scale, T: int):
    """One level (T, F): the 8 corners weighted trilinearly."""
    xl = xn * f32(scale)
    x0f = torch.floor(xl)
    frac, x0 = xl - x0f, x0f.long()
    out = 0.0
    for corner in range(8):
        off = [(corner >> k) & 1 for k in range(3)]
        w = None
        for k in range(3):
            wk = frac[:, k] if off[k] else 1.0 - frac[:, k]
            w = wk if w is None else w * wk
        rows = hash_rows(x0 + torch.tensor(off, device=xn.device), T)
        out = out + table_l[rows] * w[:, None]
    return out


def encode(table, p: dict, x, scene):
    """(N, 3) world points -> (N, L F) features."""
    h = p["hash"]
    xn = (x - scene["mu"]) / scene["sigma"]
    T = 2 ** h["log2_table_size"]
    return torch.cat([hash_level(table[l], xn, s, T)
                      for l, s in enumerate(level_scales(h))], -1)


# -- schedule ----------------------------------------------------------------

def growth(h: dict) -> float:
    return float(np.exp((np.log(h["n_max"]) - np.log(h["n_min"]))
                        / (h["num_levels"] - 1)))


def stage(p: dict, count: int, horizon: int) -> dict:
    """{"active", "eps", "curvature_weight", "anneal"} at update count
    ``count`` (Python numbers; eps, in the grid's units, weight and anneal
    rounded to f32)."""
    h, t = p["hash"], p["train"]
    L = h["num_levels"]
    anneal = int(min(L, max((count - t["warmup_steps"]) // t["c2f_every"], 1)))
    active = max(t["c2f_init_levels"], anneal) if t["c2f_init_levels"] else L
    g = growth(h)
    res = int(np.floor(h["n_min"] * g ** (active - 1))) + 1
    if t["warmup_steps"] > 0 and count <= t["warmup_steps"]:
        curv = (np.float32(count) / np.float32(t["warmup_steps"])
                * np.float32(CURVATURE_WEIGHT))
    else:
        curv = np.float32(CURVATURE_WEIGHT / g ** (anneal - 1))
    end = np.float32(ANNEAL_END * max(horizon, 1))
    return {"active": active, "eps": f32(1.0 / res),
            "curvature_weight": f32(curv),
            "anneal": f32(min(np.float32(count) / end, np.float32(1.0)))}


# -- weights -------------------------------------------------------------------

def layer_dims(p: dict) -> dict:
    """{"sdf": [(d_in, d_out)], "rgb": [...]} of the two MLPs."""
    h, m = p["hash"], p["mlp"]
    d0 = 3 + h["num_levels"] * h["features_per_level"]
    sdf = [d0] + [m["sdf_width"]] * SDF_LAYERS + [m["sdf_width"]]
    sdf = list(zip(sdf[:-1], sdf[1:]))
    sdf[-1] = (sdf[-1][0], sdf[-1][1] + 1)
    rgb = ([6 + (SH_LEVELS + 1) ** 2 + m["sdf_width"]]
           + [m["rgb_width"]] * RGB_LAYERS + [3])
    return {"sdf": sdf, "rgb": list(zip(rgb[:-1], rgb[1:]))}


def leaf_shapes(p: dict) -> list:
    """(name, shape) of every parameter: the table, the SDF layers' v, g
    and b, the colour layers', and s_var."""
    h = p["hash"]
    out = [("table", (h["num_levels"], 2 ** h["log2_table_size"],
                      h["features_per_level"]))]
    for branch, dims in layer_dims(p).items():
        for i, (a, b) in enumerate(dims):
            out += [(f"{branch}.{i}.v", (b, a)), (f"{branch}.{i}.g", (b,)),
                    (f"{branch}.{i}.b", (b,))]
    return out + [("s_var", ())]


@torch.no_grad()
def init_weights(p: dict, seed: int, device) -> dict:
    """{leaf: f32 tensor} drawn on the device from ``seed``: the table
    U(-init_scale, init_scale); the SDF MLP's geometric init (hidden v
    N(0, sqrt(2 / d_out)), the first layer's feature columns 0, biases 0;
    the last layer's v N(sqrt(pi / d_in), 1e-4), bias -sphere radius);
    the colour MLP's v and b U(-1/sqrt(d_in), 1/sqrt(d_in)); every g the
    row norm of its v; s_var its initial value."""
    h = p["hash"]
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    shape = dict(leaf_shapes(p))
    s = h["init_scale"]
    out["table"] = torch.empty(shape["table"], device=device).uniform_(
        -s, s, generator=gen)
    dims = layer_dims(p)
    for i, (d_in, d_out) in enumerate(dims["sdf"]):
        v = torch.empty((d_out, d_in), device=device)
        if i == len(dims["sdf"]) - 1:
            v.normal_(math.sqrt(math.pi / d_in), 1e-4, generator=gen)
            b = torch.full((d_out,), -SPHERE_RADIUS, device=device)
        else:
            v.normal_(0.0, math.sqrt(2.0 / d_out), generator=gen)
            if i == 0:
                v[:, 3:] = 0.0
            b = torch.zeros((d_out,), device=device)
        out[f"sdf.{i}.v"], out[f"sdf.{i}.b"] = v, b
        out[f"sdf.{i}.g"] = torch.linalg.vector_norm(v, dim=1)
    for i, (d_in, d_out) in enumerate(dims["rgb"]):
        bound = 1.0 / math.sqrt(d_in)
        v = torch.empty((d_out, d_in), device=device).uniform_(
            -bound, bound, generator=gen)
        out[f"rgb.{i}.b"] = torch.empty((d_out,), device=device).uniform_(
            -bound, bound, generator=gen)
        out[f"rgb.{i}.v"] = v
        out[f"rgb.{i}.g"] = torch.linalg.vector_norm(v, dim=1)
    out["s_var"] = torch.tensor(S_VAR_INIT, device=device)
    return out


# -- model ---------------------------------------------------------------------

def wn_linear(w, name, x, rnd, rows=None):
    v, g, b = w[name + ".v"], w[name + ".g"], w[name + ".b"]
    weight = v * (g / torch.linalg.vector_norm(v, dim=1))[:, None]
    if rows is not None:
        weight, b = weight[:rows], b[:rows]
    return F.linear(rnd(x), rnd(weight), rnd(b))


def sdf_hidden(w, p, inp, rnd):
    n = len(layer_dims(p)["sdf"])
    h = inp
    for i in range(n - 1):
        h = F.softplus(wn_linear(w, f"sdf.{i}", h, rnd),
                       beta=SOFTPLUS_BETA)
    return h


def sdf_inputs(w, p, x, scene, mask):
    return torch.cat([x, encode(w["table"], p, x, scene) * mask], -1)


def spherical_harmonics(d, levels: int):
    """(N, (levels + 1)^2) real SH bases (degree at most 3)."""
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
    return torch.stack(out, -1)


def level_mask(p, active: int, device):
    h = p["hash"]
    lv = torch.arange(h["num_levels"], device=device)
    return (lv < active).to(torch.float32).repeat_interleave(
        h["features_per_level"])


def taps(w, p, x, scene, st, rnd, fault=None):
    """(f, feature, grad f, Laplacian) at the N points x from the centre and
    its six taps, one encode and one SDF MLP pass over [x, x + eps e_i,
    x - eps e_i], eps the stage's step times the scene's sigma."""
    n = x.shape[0]
    eps = st["eps"] * scene["sigma"] * (2.0 if fault == "eps" else 1.0)
    eye = torch.eye(3, device=x.device)
    offs = torch.cat([eye, -eye]) * eps
    q = torch.cat([x, (x[:, None, :] + offs[None]).reshape(-1, 3)])
    mask = level_mask(p, st["active"], x.device)
    h = sdf_hidden(w, p, sdf_inputs(w, p, q, scene, mask), rnd)
    last = f"sdf.{len(layer_dims(p)['sdf']) - 1}"
    out = wn_linear(w, last, h[:n], rnd)
    ft = wn_linear(w, last, h[n:], rnd, rows=1).reshape(n, 6)
    f = out[:, 0]
    if fault == "drop_tap":
        ft = torch.cat([ft[:, :5], f[:, None]], -1)
    grad = (ft[:, :3] - ft[:, 3:]) / (2.0 * eps)
    lap = torch.sum((ft[:, :3] + ft[:, 3:] - 2.0 * f[:, None]) / (eps * eps),
                    -1)
    return f, out[:, 1:], grad, lap


def color(w, p, x, sh, normals, feat, rnd):
    n = len(layer_dims(p)["rgb"])
    h = torch.cat([x, sh, normals, feat], -1)
    for i in range(n):
        h = wn_linear(w, f"rgb.{i}", h, rnd)
        if i < n - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def weights_of(alpha):
    front = torch.cat([torch.zeros_like(alpha[..., :1]), alpha[..., :-1]], -1)
    return alpha * torch.cumprod(1.0 - front, -1)


def fine_depths(t, sdf, inv_s: float, n_fine: int):
    """One up-sampling round's n_fine depths from the section alphas of f
    at depths t (robust cosine, midpoint quantiles)."""
    prev, nxt = sdf[..., :-1], sdf[..., 1:]
    t0, t1 = t[..., :-1], t[..., 1:]
    mid = (prev + nxt) * 0.5
    cos = (nxt - prev) / (t1 - t0 + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[..., :1]),
                                   cos[..., :-1]], -1), cos)
    intv = t1 - t0
    prev_cdf = torch.sigmoid((mid - cos * intv * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * intv * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf) / (prev_cdf + 1e-5), 0.0, 1.0)
    wts = weights_of(alpha)
    pdf = wts / torch.clamp(wts.abs().sum(-1, keepdim=True), min=1e-12)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), pdf.cumsum(-1)],
                    -1).contiguous()
    grid = torch.linspace(0.0, 1.0, n_fine + 1, device=t.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(
        *cdf.shape[:-1], n_fine).contiguous()
    idx = torch.searchsorted(cdf, unif, right=True)
    low = torch.clamp(idx - 1, min=0)
    high = torch.clamp(idx, max=cdf.shape[-1] - 1)
    d0, d1 = torch.gather(t, -1, low), torch.gather(t, -1, high)
    c0, c1 = torch.gather(cdf, -1, low), torch.gather(cdf, -1, high)
    return d0 + (unif - c0) / (c1 - c0 + 1e-8) * (d1 - d0)


@torch.no_grad()
def upsample(w, p, o, d, t, scene, st, rnd):
    """NeuS up-sampling of depths t (B, S0): f at t, then the rounds."""
    r = p["render"]
    mask = level_mask(p, st["active"], o.device)
    last = f"sdf.{len(layer_dims(p)['sdf']) - 1}"
    B = t.shape[0]

    def at(ts):
        x = (o[:, None, :] + d[:, None, :] * ts[..., None]).reshape(-1, 3)
        h = sdf_hidden(w, p, sdf_inputs(w, p, x, scene, mask), rnd)
        return wn_linear(w, last, h, rnd, rows=1)[:, 0].reshape(B, -1)

    sdf = at(t)
    for h in range(r["neus_rounds"]):
        fine = fine_depths(t, sdf, 64.0 * 2 ** h, r["neus_fine_samples"])
        t, order = torch.sort(torch.cat([t, fine], -1), dim=-1, stable=True)
        if h != r["neus_rounds"] - 1:
            sdf = torch.gather(torch.cat([sdf, at(fine)], -1), -1, order)
    return t


def render(w, p, o, d, t, scene, st, rnd, fault=None):
    """NeuS rendering of rays at final depths t (B, S): (colour (B, 3),
    |grad f| (B S,), Laplacian (B S,), f (B, S), weights (B, S))."""
    r = p["render"]
    B, S = t.shape
    x = (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)
    f, feat, grad, lap = taps(w, p, x, scene, st, rnd, fault)
    sh = spherical_harmonics(d, SH_LEVELS)
    normals = grad / torch.clamp(torch.linalg.vector_norm(
        grad, dim=-1, keepdim=True), min=1e-12)
    rgb = color(w, p, x, sh[:, None, :].expand(B, S, -1).reshape(B * S, -1),
                normals, feat, rnd).reshape(B, S, 3)
    cos = torch.sum(d[:, None, :] * grad.reshape(B, S, 3), -1)
    a = st["anneal"]
    iter_cos = -(torch.relu(-cos * 0.5 + 0.5) * (1.0 - a)
                 + torch.relu(-cos) * a)
    ends = torch.cat([t, torch.full_like(t[..., :1], r["far"])], -1)
    intv = ends[..., 1:] - ends[..., :-1]
    sdf = f.reshape(B, S)
    inv_s = torch.exp(w["s_var"])
    prev_cdf = torch.sigmoid((sdf - iter_cos * intv * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * intv * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf) / (prev_cdf + 1e-5), 0.0, 1.0)
    wts = weights_of(alpha)
    col = torch.sum(wts[..., None] * rgb, -2)
    if r["white_background"]:
        col = col + (1.0 - wts.sum(-1, keepdim=True))
    return (col, torch.linalg.vector_norm(grad, dim=-1), lap, sdf, wts)


def stratified(B: int, r: dict, u):
    S = r["num_samples"]
    ticks = torch.arange(S, dtype=torch.float32, device=u.device)
    return (ticks + u) / S * (r["far"] - r["near"]) + r["near"]


def train_step(w: dict, p: dict, ds, scene, count: int, horizon: int, gen,
               rnd, fault=None, n_rays=None):
    """Loss and gradients of one training step at update count ``count``
    (grads accumulated into each leaf's ``.grad``): rays, stratified
    depths, up-sampling, taps, colour, compositing, the loss.  The rays go
    through in blocks of BLOCK_RAYS.  ``n_rays`` replaces the
    configuration's ray batch.  Returns the loss."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    r, tr = p["render"], p["train"]
    images = ds["images"]
    V, H, W = images.shape[:3]
    dev = images.device
    B = n_rays or tr["ray_batch"]
    img = torch.randint(0, V, (B,), generator=gen, device=dev)
    pix = torch.randint(0, H * W, (B,), generator=gen, device=dev)
    j, i = pix // W, pix % W
    o, d, _ = pixel_rays(i, j, ds["K"], ds["c2ws"][img])
    gt = images[img, j, i]
    u = torch.rand((B, r["num_samples"]), generator=gen, device=dev)
    st = stage(p, count, horizon)
    curv_w = 0.0 if fault == "no_laplacian" else st["curvature_weight"]
    S = r["num_samples"] + r["neus_rounds"] * r["neus_fine_samples"]
    total = 0.0
    for a in range(0, B, BLOCK_RAYS):
        b = min(a + BLOCK_RAYS, B)
        t = upsample(w, p, o[a:b], d[a:b], stratified(b - a, r, u[a:b]),
                     scene, st, rnd)
        col, gnorm, lap, _, _ = render(w, p, o[a:b], d[a:b], t, scene, st,
                                       rnd, fault)
        part = (torch.sum(torch.abs(col - gt[a:b])) / (B * 3)
                + tr["eikonal_weight"] * torch.sum((gnorm - 1.0) ** 2)
                / (B * S) + curv_w * torch.sum(torch.abs(lap)) / (B * S))
        part.backward()
        total += float(part.detach())
    return total


def two_steps_rate(lr: float, warmup: int, total: int, count: int):
    """lr * count / warmup before the warm-up's end, then lr, lr / 10 past
    0.6 of the horizon, lr / 100 past 0.8 of it."""
    if warmup > 0 and count < warmup:
        return np.float32(count) / np.float32(warmup) * np.float32(lr)
    if count > int(0.8 * total):
        return np.float32(lr / 100.0)
    if count > int(0.6 * total):
        return np.float32(lr / 10.0)
    return np.float32(lr)


@torch.no_grad()
def adam_update(w: dict, moments: dict, p: dict, count: int, total: int):
    """Adam (eps 1e-15) on the table and AdamW (eps 1e-8, weight decay) on
    the MLPs at their two-step rates, AdamW (eps 1e-8, decay 1e-4) on s_var
    at its constant rate, bias-corrected with count + 1; moments {leaf: (m,
    v)} updated in place."""
    tr = p["train"]
    c1 = np.float32(count + 1)
    bc1 = 1.0 - float(np.float32(ADAM_B1) ** c1)
    bc2 = 1.0 - float(np.float32(ADAM_B2) ** c1)
    for name, leaf in w.items():
        if name == "table":
            eps, decay = 1e-15, 0.0
            rate = two_steps_rate(tr["lr_hash"], tr["warmup_steps"], total,
                                  count)
        elif name == "s_var":
            eps, decay, rate = 1e-8, 1e-4, np.float32(tr["lr_var"])
        else:
            eps, decay = 1e-8, tr["weight_decay"]
            rate = two_steps_rate(tr["lr_mlp"], tr["warmup_steps"], total,
                                  count)
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        m, v = moments[name]
        m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decay:
            upd = upd + decay * leaf
        leaf.sub_(float(rate) * upd)
        leaf.grad = None
