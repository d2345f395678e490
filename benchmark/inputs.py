"""Inputs the benchmark makes from ``--seed`` and hands to the program and
to the plain reference alike: the synthetic textured scene, the weights of
a configuration, the served poses and a served occupancy grid.

The scene is a frozen copy of the port's textured scene (the traffic's
"scene": 20 views at 400x400 on a radius-4 orbit at elevation 0.35, focal
440, ground truth from 384 uniform samples of an analytic emissive volume:
a thin shell at radius 0.85, three rods and a core under a 3-octave trig
albedo).  It is
the same for every seed; the seed draws the weights, the training draws
and the served poses, so that every seed asks for the same work.  All of it
is made on the device in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GT_CHUNK_RAYS = 16384


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """OpenGL-style camera-to-world (4, 4) float32 looking from ``eye``."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = eye - target
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1] = right, np.cross(fwd, right)
    c2w[:3, 2], c2w[:3, 3] = fwd, eye
    return c2w


def orbit_pose(theta: float, radius: float, elevation: float):
    return look_at_pose((radius * math.cos(theta), radius * math.sin(theta),
                         elevation * radius))


def intrinsics(H: int, W: int, focal: float, device):
    return torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def _albedo(pts):
    freq = 24.0
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def octave(f, phase):
        return (torch.sin(f * x + phase) * torch.sin(f * 1.31 * y + 2.1 * phase)
                * torch.sin(f * 0.87 * z + 0.7 * phase))

    tex = (octave(freq, 0.0) + 0.5 * octave(2.3 * freq, 1.0),
           octave(1.7 * freq, 2.0) + 0.5 * octave(3.1 * freq, 0.4),
           octave(1.3 * freq, 4.0) + 0.5 * octave(2.7 * freq, 1.7))
    return torch.clamp(torch.stack([0.5 + 0.33 * t for t in tex], -1), 0, 1)


def textured_field(pts):
    """(rgb (N, 3), sigma (N,)) of the textured subject."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    sharp, rod_r = 200.0, 0.03
    shell = torch.exp(-((r - 0.85) / 0.025) ** 2)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    inside = (r < 0.95).to(torch.float32)
    rods = (torch.sigmoid(-sharp * (torch.sqrt(y ** 2 + z ** 2) - rod_r))
            + torch.sigmoid(-sharp * (torch.sqrt(x ** 2 + z ** 2) - rod_r))
            + torch.sigmoid(-sharp * (torch.sqrt(x ** 2 + y ** 2) - rod_r))
            ) * inside
    core = torch.sigmoid(-sharp * (r - 0.18))
    sigma = 120.0 * shell + 90.0 * torch.clamp(rods, 0.0, 1.0) + 90.0 * core
    return _albedo(pts), sigma


def image_rays(H: int, W: int, K, c2w):
    """All H*W rays of one camera, row-major: (origins, unit directions,
    direction norms (N, 1))."""
    j, i = torch.meshgrid(torch.arange(H, device=K.device),
                          torch.arange(W, device=K.device), indexing="ij")
    i, j = i.reshape(-1).float(), j.reshape(-1).float()
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1)
    d = (c2w[..., :3, :3] * dirs[..., None, :]).sum(-1)
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[..., :3, 3], d.shape), d / n, n


@torch.no_grad()
def make_scene(device, scene: dict):
    """{"images" (V, H, W, 3), "c2ws" (V, 4, 4), "K", "H", "W"} on the
    device: the ground truth rendered from uniform samples of the
    analytic volume by emission-absorption compositing."""
    H, W, S = scene["H"], scene["W"], scene["gt_samples"]
    K = intrinsics(H, W, scene["focal"], device)
    c2ws = torch.as_tensor(np.stack([
        orbit_pose(2 * math.pi * k / scene["n_views"], scene["radius"],
                   scene["elevation"]) for k in range(scene["n_views"])]),
        device=device)
    near, far = scene["near"], scene["far"]
    s = torch.arange(S - 1, dtype=torch.float32, device=device) / (S - 1)
    t_row = torch.cat([near * (1 - s) + far * s,
                       torch.full((1,), far, device=device)])
    images = []
    for c2w in c2ws:
        o, d, n = image_rays(H, W, K, c2w)
        out = []
        for a in range(0, o.shape[0], GT_CHUNK_RAYS):
            oc, dc, nc = (v[a:a + GT_CHUNK_RAYS] for v in (o, d, n))
            pts = oc[:, None, :] + dc[:, None, :] * t_row[None, :, None]
            rgb, sigma = textured_field(pts.reshape(-1, 3))
            dt = torch.cat([t_row[1:] - t_row[:-1], t_row.new_zeros(1)])
            prod = sigma.reshape(-1, S) * dt * nc
            trans = torch.exp(-(torch.cumsum(prod, -1) - prod))
            w = trans * (1 - torch.exp(-prod))
            out.append((w[..., None] * rgb.reshape(-1, S, 3)).sum(-2))
        images.append(torch.cat(out).reshape(H, W, 3))
    return {"images": torch.stack(images), "c2ws": c2ws, "K": K, "H": H,
            "W": W}


def level_scales(h: dict) -> np.ndarray:
    """Per-level resolutions n_min * b^l (float64)."""
    if h["num_levels"] == 1:
        return np.asarray([float(h["n_min"])])
    b = np.exp((np.log(h["n_max"]) - np.log(h["n_min"]))
               / (h["num_levels"] - 1))
    return h["n_min"] * b ** np.arange(h["num_levels"])


def leaf_shapes(p: dict) -> list:
    """(name, shape) of every parameter of a configuration's field, in the
    order the benchmark draws and compares them: dense grids, CP lines or
    the hash table, then the MLP's density and colour layers (weight (out,
    in), then bias)."""
    h, m = p["hash"], p["mlp"]
    scales = level_scales(h)
    D, F = h["dense_levels"], h["features_per_level"]
    out = [(f"dense.{l}", (int(scales[l]) + 2,) * 3 + (F,)) for l in range(D)]
    if h["variant"] == "cp":
        out += [(f"lines.{l}", (3, int(np.floor(scales[l])) + 2, h["cp_rank"]))
                for l in range(D, h["num_levels"])]
        in_dim = D * F + (h["num_levels"] - D) * h["cp_rank"]
    else:
        out.append(("table", (h["num_levels"] - D, 2 ** h["log2_table_size"],
                              F)))
        in_dim = h["num_levels"] * F
    d_view = p["dir_enc"]["d_model"] * p["dir_enc"]["num_freq"] * 2
    w = m["width"]
    sig = [(in_dim, w)] + [(w, 1 + m["geo_feat_dim"] if i == m["num_sig"] - 1
                            else w) for i in range(m["num_sig"])]
    col = [(m["geo_feat_dim"] + d_view, w)] + [
        (w, 3 if i == m["num_col"] - 1 else w) for i in range(m["num_col"])]
    for branch, dims in (("sig", sig), ("col", col)):
        for i, (a, b) in enumerate(dims):
            out += [(f"mlp.{branch}.{i}.w", (b, a)), (f"mlp.{branch}.{i}.b",
                                                       (b,))]
    return out


def make_weights(p: dict, seed: int, device, scale: dict = None) -> dict:
    """{leaf name: f32 tensor} drawn on the device from ``seed`` in one
    uniform call: the tables U(-s, s) with s the configuration's
    ``init_scale`` (grids, table) or ``cp_init_scale`` (lines), unless
    ``scale`` gives another ("dense", "lines", "table"); the MLP's layers
    U(-s/sqrt(d_in), s/sqrt(d_in)), s 1 as the program initialises them
    unless ``scale["mlp"]`` gives another."""
    h, scale = p["hash"], scale or {}
    shapes = leaf_shapes(p)
    bounds = []
    for name, shape in shapes:
        kind = name.split(".")[0]
        if kind == "mlp":
            d_in = dict(shapes)[name[:-1] + "w"][1]
            bounds.append(scale.get("mlp", 1.0) / math.sqrt(d_in))
        else:
            default = h["cp_init_scale"] if kind == "lines" else h["init_scale"]
            bounds.append(scale.get(kind, default))
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part, b in zip(shapes, u.split(sizes), bounds):
        out[name] = ((2.0 * part - 1.0) * b).reshape(shape)
    return out


def program_leaves(field) -> dict:
    """{leaf name: parameter} of a program ``Field``, named as
    ``leaf_shapes`` names them."""
    out = {f"dense.{i}": g for i, g in enumerate(field.dense)}
    out.update({f"lines.{i + len(field.dense)}": ln
                for i, ln in enumerate(field.lines)})
    if field.table is not None:
        out["table"] = field.table
    for branch in ("sig", "col"):
        for i, layer in enumerate(getattr(field.mlp, branch)):
            out[f"mlp.{branch}.{i}.w"] = layer.weight
            out[f"mlp.{branch}.{i}.b"] = layer.bias
    return out


@torch.no_grad()
def load_into(field, weights: dict):
    """Copy the benchmark's weights into a program field, in place."""
    leaves = program_leaves(field)
    if set(leaves) != set(weights):
        raise ValueError(f"field leaves {sorted(leaves)} are not the "
                         f"benchmark's {sorted(weights)}")
    for name, p in leaves.items():
        if p.shape != weights[name].shape:
            raise ValueError(f"{name}: field {tuple(p.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


@torch.no_grad()
def subject_grid(resolution: int, lo, hi, radius: float, device):
    """A served occupancy grid: (density, mask), 1 in the cells whose
    centre lies within ``radius`` of the subject's centre and 0 elsewhere,
    over the program's normalisation (mu the box's min, sigma its
    diagonal).  Returns (density, mask, occupied fraction)."""
    g = resolution
    sigma = torch.sqrt(torch.sum((hi - lo) ** 2))
    c = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    x = lo[:, None] + c[None, :] * sigma                          # (3, G)
    r2 = (x[0][:, None, None] ** 2 + x[1][None, :, None] ** 2
          + x[2][None, None, :] ** 2)
    mask = (r2 <= radius ** 2).to(torch.float32)
    return mask.clone(), mask, float(mask.mean())
