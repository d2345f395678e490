"""The plain reference of the benchmark's configurations: the radiance
field, its training step and its served frame in plain PyTorch, f32 with
TF32 off, computing each rounding the configuration states.

It imports nothing of the program.  It follows the configuration files'
``pipeline`` sections (the program's config fields) and the published
models: dense coarse grids and CP factor lines (TensoRF-CP) or the
Instant-NGP corner hash grid with single-corner stochastic training, the
two-branch MLP head, emission-absorption compositing, the MSE loss with the
factor-line TV, optax-style Adam on the tables and AdamW on the MLP under a
cosine-to-floor schedule, and the occupancy grid's refresh.

Precision.  ``Rounding`` names the narrow type that the configuration's
bf16 roundings take: bfloat16 as stated, or float8_e4m3fn for the control
(the nearest lower precision).  The MLP rounds its operands to it and
multiplies in f32; the dense and CP levels round their interpolation
weights, lines and grid corners to it (``dense_bf16``).  Gradients come
from autograd through the same operations (a rounding passes its gradient
straight through).

Random draws.  A training step draws from one ``torch.Generator`` in the
program's order: the rays' images and pixels, then the placement's jitter
(ladder) or stratified quantiles (guided), then for a stochastic hash grid
a Philox seed and the Philox4x32-10 stream keyed by it; a refresh draws its
cells and their jitter.  Handed a generator in the same state, the
reference draws what the program draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.inputs import level_scales

MASK32 = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ADAM_B1, ADAM_B2 = 0.9, 0.999
BLOCK_RAYS = 2048          # rays a block of the blocked forward/backward


class Rounding:
    """x -> x rounded to ``dtype`` and back to f32 (identity for None)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, x):
        return x if self.dtype is None else x.to(self.dtype).to(torch.float32)


def f32(x) -> float:
    return float(np.float32(x))


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


def check_supported(p: dict):
    """Refuse a configuration whose mathematics this reference lacks."""
    r, h, m = p["render"], p["hash"], p["mlp"]
    lacks = [k for k, bad in (
        ("use_sdf", r["use_sdf"]), ("hierarchical", r["hierarchical"]),
        ("log_sampling", r["log_sampling"]),
        ("white_background", r["white_background"]),
        ("per_ray_jitter off", not r["per_ray_jitter"]),
        ("normalization", r["normalization"] != "diagonal"),
        ("occupancy without guided placement",
         r["occupancy"] and not r["occ_guided"]),
        ("occ_probe_jitter", r["occ_probe_jitter"]),
        ("occ_stratified off", r["occupancy"] and not r["occ_stratified"]),
        ("occ_dt", r["occ_dt"] != "mass"),
        ("packed tables", h["packed"]), ("cell variant", h["variant"] == "cell"),
        ("grad_subsample", h["grad_subsample"]),
        ("xla encoders", "xla" in (h["cp_impl"], h["dense_impl"])),
        ("density activation", m["density_activation"] != "leaky_relu"),
        ("rgb activation", m["rgb_activation"] != "sigmoid"),
        ("dir encoding", p["dir_enc"]["mode"] != "linear"),
        ("sigma_l1", p["train"]["sigma_l1_weight"] > 0),
        ("schedule", p["train"]["schedule"] != "cosine")) if bad]
    if lacks:
        raise NotImplementedError(f"the reference lacks: {', '.join(lacks)}")


# -- rays and scene ---------------------------------------------------------

def pixel_rays(i, j, K, c2w):
    """World rays through pixels (i, j): (origins, unit dirs, norms)."""
    i, j = i.to(torch.float32), j.to(torch.float32)
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1)
    d = (c2w[..., :3, :3] * dirs[..., None, :]).sum(-1)
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[..., :3, 3], d.shape), d / n, n


def scene_of(lo, hi):
    """mu = the box's min, sigma = its diagonal ("diagonal" normalisation)."""
    return {"mu": lo, "sigma": torch.sqrt(torch.sum((hi - lo) ** 2))}


def bounds_of(ds, near: float, far: float, margin: float = 1.5):
    """Axis-aligned (min, max) of every ray of every camera of ``ds`` at t
    in {near, far + margin}: the program's scene box."""
    H, W, K = ds["H"], ds["W"], ds["K"]
    j, i = torch.meshgrid(torch.arange(H, device=K.device),
                          torch.arange(W, device=K.device), indexing="ij")
    o, d, _ = pixel_rays(i.reshape(-1), j.reshape(-1), K,
                         ds["c2ws"][:, None, :, :])
    t = torch.tensor([near, far + margin], device=K.device)
    pts = (o[..., None, :] + d[..., None, :] * t[:, None]).reshape(-1, 3)
    return pts.amin(0), pts.amax(0)


# -- sampling --------------------------------------------------------------

def linspace(start: float, stop: float, num: int, device):
    start, stop = f32(start), f32(stop)
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([start * (1.0 - s) + stop * s,
                      torch.full((1,), stop, device=device)])


def ladder(B: int, near, far, S: int, device, gen):
    """The jittered ladder: S uniform depths, each ray shifted by its own
    U[0, 1) times the spacing."""
    u = torch.rand((B, S), generator=gen, device=device)
    step = f32(np.float32(np.float32(far) - np.float32(near)) / np.float32(S))
    return linspace(near, far, S, device) + u * step


def sample_pdf(bins, weights, K: int, u):
    """Inverse-CDF placement of quantiles u (B, K) over piecewise-constant
    weights (B, M) on sorted bins (B, M + 1)."""
    weights = torch.clamp(weights, min=0.0) + 1e-3
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)],
                    -1).contiguous()
    below = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    above = torch.clamp(below + 1, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = torch.where(c1 - c0 < 1e-8, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def guided(o, d, occ, scene, r: dict, K: int, *, train: bool, gen=None):
    """Occupancy-guided placement over M probes of [near, far] (their
    midpoints): training draws stratified quantiles and floors the empty
    intervals to the exploration share; serving places fixed quantiles.
    dt by the "mass" rule.  Returns (t (B, K), dt (B, K))."""
    M = r["occ_probes"] or 2 * K
    near, far = f32(r["near"]), f32(r["far"])
    h = f32(np.float32(far - near) / np.float32(M))
    idx = torch.arange(M, dtype=torch.float32, device=o.device)
    tm = near + (idx + 0.5) * h
    m = lookup(occ, o[:, None, :] + d[:, None, :] * tm[None, :, None], scene)
    if train and r["occ_explore"] > 0:
        n_occ = torch.sum(m, -1, keepdim=True)
        f = r["occ_explore"]
        m = m + (f / (1.0 - f)) * n_occ / torch.clamp(M - n_occ, min=1.0) * (
            1.0 - m)
    bins = (near + torch.arange(M + 1, dtype=torch.float32, device=o.device)
            * h).expand(m.shape[0], M + 1)
    if train:
        xi = torch.rand((o.shape[0], K), generator=gen, device=o.device) * (
            1.0 - 1e-6)
        u = (torch.arange(K, dtype=torch.float32, device=o.device) + xi) / K
    else:
        u = linspace(0.0, 1.0 - 1e-6, K, o.device).expand(o.shape[0], K)
    t = sample_pdf(bins, m, K, u)
    interval = torch.floor((t - near) / h)
    W = torch.sum(m, -1, keepdim=True)
    inside = (interval >= 0) & (interval < M)
    m_t = torch.where(inside, torch.gather(
        m, -1, torch.clamp(interval, 0, M - 1).long()), torch.zeros_like(t))
    dt = h * W / (K * torch.clamp(m_t, min=1e-8))
    dt = torch.where(m_t >= 1.0 - 1e-6, dt, torch.clamp(dt, max=h))
    dt = torch.where(W > 1e-6, dt, f32(np.float32(far - near) / np.float32(K)))
    return t, dt


# -- occupancy -------------------------------------------------------------

def cells(pts, scene, g: int):
    c = torch.clamp(((pts - scene["mu"]) / scene["sigma"] * g).to(torch.int32),
                    0, g - 1).long()
    return (c[..., 0] * g + c[..., 1]) * g + c[..., 2]


def lookup(occ, pts, scene):
    """Mask values (1 occupied) of the grid's cells holding ``pts``."""
    return occ["mask"].reshape(-1)[cells(pts, scene, occ["mask"].shape[0])]


@torch.no_grad()
def refresh(occ, density_fn, scene, threshold: float, gen,
            num_cells: int = 2 ** 18, decay: float = 0.95):
    """One culling round: decay the density EMA, evaluate the field at a
    jittered point of ``num_cells`` cells drawn with replacement (a cell
    drawn twice takes its last draw's value), keep the larger of old and
    new (a never-seen cell, +inf, takes the new one); mask = density above
    the threshold.  Returns the new {"density", "mask"} and the cells
    drawn, "drawn"."""
    g = occ["density"].shape[0]
    dev = occ["density"].device
    flat = torch.randint(0, g ** 3, (num_cells,), generator=gen, device=dev)
    jit = torch.rand((num_cells, 3), generator=gen, device=dev)
    c = torch.stack([flat // (g * g), (flat // g) % g, flat % g], -1).float()
    d = torch.clamp(density_fn((c + jit) / g * scene["sigma"] + scene["mu"]),
                    min=0.0)
    dens = occ["density"].reshape(-1)
    decayed = torch.where(torch.isinf(dens), dens, dens * decay)
    old = decayed[flat]
    new = torch.where(torch.isinf(old), d, torch.maximum(old, d))
    pos = torch.arange(num_cells, device=dev)
    last = torch.full_like(dens, -1, dtype=torch.long).scatter_reduce(
        0, flat, pos, reduce="amax")
    density = decayed.clone()
    density[flat] = new[last[flat]]
    density = density.reshape(g, g, g)
    mask = (torch.isinf(density) | (density > threshold)).float()
    return {"density": density, "mask": mask, "drawn": flat}


# -- encoders --------------------------------------------------------------

def _coords(xl, g: int):
    x0 = torch.floor(xl)
    frac = torch.clamp(xl - x0, 0.0, 1.0)
    return torch.clamp(x0, 0.0, float(g - 2)).long(), frac


def dense_level(grid, xn, scale, rnd):
    """Trilinear read of a dense (G, G, G, F) grid: the (y, z) weight
    products and the corners rounded, summed per x slab, each slab's term
    rounded, then the two slabs added."""
    g = grid.shape[0]
    x0, frac = _coords(xn * f32(scale), g)
    w = [(1.0 - frac[:, k], frac[:, k]) for k in range(3)]
    gr = rnd(grid)
    out = 0.0
    for a in range(2):
        t = 0.0
        for b in range(2):
            for c in range(2):
                corner = gr[x0[:, 0] + a, x0[:, 1] + b, x0[:, 2] + c]
                t = t + rnd(w[1][b] * w[2][c])[:, None] * corner
        out = out + rnd(t * w[0][a][:, None])
    return out


def cp_level(lines, xn, scale, rnd):
    """CP factor lines (3, G, R): per axis the line lerped with rounded
    weights and rounded line values, the three products multiplied."""
    g = lines.shape[1]
    x0, frac = _coords(xn * f32(scale), g)
    ln = rnd(lines)
    prod = None
    for k in range(3):
        t = (rnd(1.0 - frac[:, k:k + 1]) * ln[k][x0[:, k]]
             + rnd(frac[:, k:k + 1]) * ln[k][x0[:, k] + 1])
        prod = t if prod is None else prod * t
    return prod


def _mul_lo32(c, p: int):
    return ((c & 0xFFFF) * p + ((((c >> 16) * p) & 0xFFFF) << 16)) & MASK32


def hash_rows(c, T: int):
    """Instant-NGP spatial hash of int64 corner coords (..., 3) -> rows."""
    c = c & MASK32
    h = _mul_lo32(c[..., 0], PRIMES[0])
    for k in (1, 2):
        h = h ^ _mul_lo32(c[..., k], PRIMES[k])
    return h & (T - 1)


def hash_level(table_l, xn, scale, T: int, u_l=None):
    """One hash level (T, F): the 8 corners weighted trilinearly (exact),
    or, given uniforms u_l (3, N), the one corner whose offset on each axis
    is (u < frac) (single-corner stochastic estimator)."""
    xl = xn * f32(scale)
    x0f = torch.floor(xl)
    frac, x0 = xl - x0f, x0f.long()
    if u_l is not None:
        bits = (u_l.t() < frac).long()
        return table_l[hash_rows(x0 + bits, T)]
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


def philox_uniform(seed: int, n: int, device):
    """n f32 uniforms (bits >> 8) * 2^-24 of Philox4x32-10 keyed by (seed,
    0), counter (i, 0, 0, 0) giving words 4i .. 4i + 3."""
    idx = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)

    def mulhilo(a, m):
        a0, a1, m0, m1 = a & 0xFFFF, a >> 16, m & 0xFFFF, m >> 16
        p00 = a0 * m0
        mid = a0 * m1 + a1 * m0 + (p00 >> 16)
        return a1 * m1 + (mid >> 16), ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)

    c0, c1 = idx & MASK32, idx >> 32
    c2, c3 = torch.zeros_like(idx), torch.zeros_like(idx)
    k0, k1 = seed & MASK32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = torch.stack([c0, c1, c2, c3], -1).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def encode(w: dict, p: dict, x, scene, rnd, u=None):
    """(N, 3) world points -> (N, width) features: dense levels, then the
    CP levels or the hash levels (stochastic given u (3, L, N))."""
    h = p["hash"]
    scales = level_scales(h)
    D = h["dense_levels"]
    xn = (x - scene["mu"]) / scene["sigma"]
    cols = [dense_level(w[f"dense.{l}"], xn, scales[l],
                        rnd if h["dense_bf16"] else Rounding(None))
            for l in range(D)]
    if h["variant"] == "cp":
        cols += [cp_level(w[f"lines.{l}"], xn, scales[l],
                          rnd if h["dense_bf16"] else Rounding(None))
                 for l in range(D, h["num_levels"])]
    else:
        T = 2 ** h["log2_table_size"]
        cols += [hash_level(w["table"][l - D], xn, scales[l], T,
                            None if u is None else u[:, l - D])
                 for l in range(D, h["num_levels"])]
    return torch.cat(cols, -1)


# -- MLP and compositing ---------------------------------------------------

def linear(w, name, x, rnd):
    return rnd(x) @ rnd(w[name + ".w"]).t() + rnd(w[name + ".b"])


def density_branch(w, p, feats, rnd):
    hcur = feats
    n = p["mlp"]["num_sig"] + 1
    for i in range(n):
        hcur = linear(w, f"mlp.sig.{i}", hcur, rnd)
        if i < n - 1:
            hcur = torch.relu(hcur)
    return F.leaky_relu(hcur[:, :1], 0.01)[:, 0], hcur[:, 1:]


def colour_branch(w, p, geo, dirs_enc, rnd):
    hcur = torch.cat([geo, dirs_enc], -1)
    n = p["mlp"]["num_col"] + 1
    for i in range(n):
        hcur = linear(w, f"mlp.col.{i}", hcur, rnd)
        if i < n - 1:
            hcur = torch.relu(hcur)
    return torch.sigmoid(hcur)


def dir_encoding(d, num_freq: int):
    """sin(2 k d), cos(2 k d) for k < num_freq, per channel."""
    k = torch.arange(num_freq, dtype=d.dtype, device=d.device)
    ph = 2.0 * d[..., None] * k
    out = torch.cat([torch.sin(ph), torch.cos(ph)], -1)
    return out.reshape(out.shape[:-2] + (d.shape[-1] * num_freq * 2,))


def composite(t, rgb, sigma, dir_norm, dt=None, clip_min: float = -10.0):
    if dt is None:
        dt = torch.cat([t[..., 1:] - t[..., :-1], torch.zeros_like(t[..., :1])],
                       -1)
    prod = torch.clamp(sigma, min=clip_min) * (dt * dir_norm)
    trans = torch.exp(-torch.cat([torch.zeros_like(prod[..., :1]),
                                  torch.cumsum(prod, -1)[..., :-1]], -1))
    return torch.sum((trans * (1.0 - torch.exp(-prod)))[..., None] * rgb, -2)


def render(w, p, o, d, n, t, scene, rnd, dt=None, occ=None, u=None):
    """Colours (B, 3) of rays at depths t (B, S): encode, MLP, mask (when
    ``occ`` is given), composite."""
    B, S = t.shape
    pts = (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)
    feats = encode(w, p, pts, scene, rnd, u)
    sigma, geo = density_branch(w, p, feats, rnd)
    de = dir_encoding(d, p["dir_enc"]["num_freq"])
    rgb = colour_branch(w, p, geo, de[:, None, :].expand(B, S, -1).reshape(
        B * S, -1), rnd)
    sigma = sigma.reshape(B, S)
    if occ is not None:
        sigma = sigma * lookup(occ, pts.reshape(B, S, 3), scene)
    return composite(t, rgb.reshape(B, S, 3), sigma, n, dt,
                     p["render"]["sigma_clip_min"])


# -- training --------------------------------------------------------------

def tv(w, p):
    """Mean over CP levels of the lines' squared neighbour differences,
    normalised by 3 (G - 1) R."""
    h = p["hash"]
    names = [f"lines.{l}" for l in range(h["dense_levels"], h["num_levels"])]
    return sum(torch.sum((w[k][:, 1:] - w[k][:, :-1]) ** 2)
               / (3 * (w[k].shape[1] - 1) * h["cp_rank"])
               for k in names) / len(names)


def train_step(w: dict, p: dict, ds, scene, count: int, gen, rnd,
               occ=None, half_batch: bool = False):
    """Loss and gradients of one training step at update count ``count``
    (grads written to each leaf's ``.grad``): rays, placement (the ladder,
    or guided once a grid is attached), encode (stochastic hash levels
    from Philox), MLP, composite, coarse + fine MSE (one pass: twice the
    MSE), the TV once ``count`` reaches its warmup.  The rays go through
    in blocks of BLOCK_RAYS.  ``half_batch`` (a fault reading) takes the
    mean over the first half of the rays alone.  Returns the loss."""
    check_supported(p)
    r, tr, h = p["render"], p["train"], p["hash"]
    images = ds["images"]
    V, H, W = images.shape[:3]
    dev = images.device
    B = tr["ray_batch"]
    img = torch.randint(0, V, (B,), generator=gen, device=dev)
    pix = torch.randint(0, H * W, (B,), generator=gen, device=dev)
    j, i = pix // W, pix % W
    o, d, n = pixel_rays(i, j, ds["K"], ds["c2ws"][img])
    gt = images[img, j, i]
    with torch.no_grad():
        if occ is not None and r["occ_guided"]:
            t, dt = guided(o, d, occ, scene, r, r["compact_samples"],
                           train=True, gen=gen)
        else:
            t, dt = ladder(B, r["near"], r["far"], r["num_samples"], dev,
                           gen), None
        S = t.shape[1]
        u = None
        if h["variant"] != "cp" and h["stochastic_train"]:
            L = h["num_levels"] - h["dense_levels"]
            if not h["hw_rng"]:
                raise NotImplementedError("stochastic training without "
                                          "hw_rng draws torch.rand uniforms")
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                     device=dev, dtype=torch.int32))
            u = philox_uniform(seed, 3 * L * B * S, dev).reshape(3, L, B * S)
    used = B // 2 if half_batch else B
    total = 0.0
    for a in range(0, used, BLOCK_RAYS):
        b = min(a + BLOCK_RAYS, used)
        ub = None if u is None else u[:, :, a * S:b * S]
        col = render(w, p, o[a:b], d[a:b], n[a:b], t[a:b], scene, rnd,
                     None if dt is None else dt[a:b], None, ub)
        part = 2.0 * torch.sum((col - gt[a:b]) ** 2) / (used * 3)
        part.backward()
        total += float(part.detach())
    if h["variant"] == "cp" and tr["cp_tv_weight"] > 0 and (
            tr["cp_tv_warmup"] <= 0 or count >= tr["cp_tv_warmup"]):
        reg = tr["cp_tv_weight"] * tv(w, p)
        reg.backward()
        total += float(reg.detach())
    return total


def cosine_rate(lr: float, lr_final: float, total: int, count: int):
    frac = np.clip(np.float32(count) / np.float32(max(total, 1)), 0.0, 1.0)
    return np.float32(lr_final + np.float32(0.5 * (lr - lr_final))
                      * (np.float32(1.0) + np.cos(np.float32(math.pi)
                                                  * np.float32(frac))))


@torch.no_grad()
def adam_update(w: dict, moments: dict, p: dict, count: int, total: int):
    """Adam (eps 1e-15) on the tables and AdamW (eps 1e-8, weight decay) on
    the MLP, each at its cosine-to-floor rate at ``count``, bias-corrected
    with count + 1; moments {leaf: (m, v)} updated in place."""
    tr = p["train"]
    c1 = np.float32(count + 1)
    bc1 = 1.0 - float(np.float32(ADAM_B1) ** c1)
    bc2 = 1.0 - float(np.float32(ADAM_B2) ** c1)
    for name, leaf in w.items():
        mlp = name.startswith("mlp.")
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        m, v = moments[name]
        m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + (1e-8 if mlp else 1e-15))
        if mlp:
            upd = upd + tr["weight_decay"] * leaf
        rate = cosine_rate(tr["lr_mlp"] if mlp else tr["lr_hash"],
                           tr["lr_final"], total, count)
        leaf.sub_(float(rate) * upd)
        leaf.grad = None


def field_density(w, p, scene, rnd):
    """The refresh's density function: exact encode at the configuration's
    roundings (``rnd``), f32 MLP, leaky ReLU."""
    def fn(pts):
        out = []
        for a in range(0, pts.shape[0], 1 << 16):
            feats = encode(w, p, pts[a:a + (1 << 16)], scene, rnd)
            out.append(density_branch(w, p, feats, Rounding(None))[0])
        return torch.cat(out)
    return fn


@torch.no_grad()
def frame(w, p, scene, occ, K, c2w, H: int, W: int, samples: int, rnd,
          chunk: int = 16384):
    """A served (H, W, 3) frame: guided placement of ``samples`` fixed
    quantiles over the grid, exact encode, MLP at the rounding, masked
    densities, composite."""
    check_supported(p)
    j, i = torch.meshgrid(torch.arange(H, device=K.device),
                          torch.arange(W, device=K.device), indexing="ij")
    o, d, n = pixel_rays(i.reshape(-1), j.reshape(-1), K, c2w)
    out = []
    for a in range(0, o.shape[0], chunk):
        oc, dc, nc = o[a:a + chunk], d[a:a + chunk], n[a:a + chunk]
        t, dt = guided(oc, dc, occ, scene, p["render"], samples, train=False)
        out.append(render(w, p, oc, dc, nc, t, scene, rnd, dt, occ))
    return torch.cat(out).reshape(H, W, 3)
