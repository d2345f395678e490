"""Where the occupied cells of a trained quality-protocol run lie, and how
far the rule for a cell drawn twice in one refresh can move them.

Reads a run directory that ``quality_holdout --save_params`` wrote (the
field, its occupancy grid and bounds) and splits the grid's occupied cells
by their centres: outside the scene's bounding box (no ray of the protocol
samples there), inside it but seen by no training camera (in no view's
image, or nearer than ``near`` or further than ``far``), seen and empty
in the analytic scene, or on the subject (the scene's density above the
grid's threshold at the centre or a corner).  Then it takes one refresh
from the saved grid twice with the same draws: once with a cell drawn
more than once keeping its largest candidate, once its smallest.  The
refresh itself keeps the last draw's candidate (as the JAX ``.at[].set``
on the CPU), so it lies between the two.

Run:  python -m human_body_reconstruction_tpu_torch.cli.occ_report \\
          --run_dir results/quality_holdout_textured_<mode>_seed0 \\
          --scene textured      (the tangle: --scene tangle --scene_seed N)
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh


def cell_centres(g: int, scene, device):
    """(g^3, 3) world centres of the grid's cells, flat (x, y, z) order."""
    c = (torch.arange(g, device=device, dtype=torch.float32) + 0.5) / g
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    return cells.reshape(-1, 3) * scene["sigma"] + scene["mu"]


def seen(pts, K, poses, H: int, W: int, near: float, far: float):
    """(N,) bool: the point projects into at least one pose's image at a
    distance in [near, far] from its camera."""
    out = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for c2w in poses:
        rel = pts - c2w[:3, 3]
        cam = rel @ c2w[:3, :3]             # R^T (p - o), row vectors
        depth = -cam[:, 2]
        i = K[0, 2] + K[0, 0] * cam[:, 0] / depth
        j = K[1, 2] - K[1, 1] * cam[:, 1] / depth
        dist = torch.linalg.vector_norm(rel, dim=-1)
        out |= ((depth > 0) & (i >= -0.5) & (i <= W - 0.5) & (j >= -0.5)
                & (j <= H - 0.5) & (dist >= near) & (dist <= far))
    return out


@torch.no_grad()
def on_subject(pts, field_fn, half_cell, threshold: float,
               chunk: int = 2 ** 20):
    """(N,) bool: the analytic density exceeds ``threshold`` at the centre
    or one of the eight corners of the cell."""
    offs = torch.tensor([[0.0, 0.0, 0.0]] + [[sx, sy, sz] for sx in (-1, 1)
                                             for sy in (-1, 1)
                                             for sz in (-1, 1)],
                        device=pts.device) * half_cell
    out = []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk, None, :] + offs
        sigma = field_fn(p.reshape(-1, 3))[1].reshape(-1, offs.shape[0])
        out.append(sigma.amax(-1) > threshold)
    return torch.cat(out)


@torch.no_grad()
def refresh_bracket(grid, field, scene, cfg, num_cells: int, generator):
    """One refresh from ``grid`` with one set of draws: (occupied fraction
    keeping a twice-drawn cell's largest candidate, keeping its smallest,
    the share of drawn cells drawn more than once)."""
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.ops import occupancy

    g3 = grid.density.numel()
    dev = grid.density.device
    flat_idx = torch.randint(0, g3, (num_cells,), generator=generator,
                             device=dev)
    jitter = torch.rand((num_cells, 3), generator=generator, device=dev)

    def per_cell(reduce, fill):
        def fn(pts):
            d = torch.clamp(nerf.density_only(field, scene, pts, cfg), min=0.0)
            return torch.full((g3,), fill, device=dev).scatter_reduce(
                0, flat_idx, d, reduce=reduce)[flat_idx]
        return fn

    fracs = []
    for fn in (per_cell("amax", 0.0), per_cell("amin", float("inf"))):
        new = occupancy.update(grid, fn, scene["mu"], scene["sigma"],
                               num_cells=num_cells, flat_idx=flat_idx,
                               jitter=jitter)
        fracs.append(float(occupancy.occupied_fraction(new)))
    hits = torch.bincount(flat_idx, minlength=g3)
    twice = float((hits > 1).sum() / (hits > 0).sum())
    return fracs[0], fracs[1], twice


def report(args) -> dict:
    from human_body_reconstruction_tpu_torch.cli import device_from_flag
    from human_body_reconstruction_tpu_torch.data import synthetic
    from human_body_reconstruction_tpu_torch.pipeline import restore

    device = device_from_flag(args.device)
    res = restore.restore(args.run_dir, args.mode, device=device,
                          with_occ=True, log_fn=lambda s: None)
    grid, scene = res.occ, res.scene
    if grid is None:
        raise SystemExit(f"{args.run_dir} holds no occupancy grid")
    g = grid.mask.shape[0]
    H = args.height
    focal = qh.FOCAL_MULT * H
    K = torch.tensor([[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]],
                     device=device)
    poses = torch.as_tensor(qh.protocol_poses(args.views)[0], device=device)
    pts = cell_centres(g, scene, device)
    occ = grid.mask.reshape(-1) > 0
    r = res.cfg.render
    in_box = ((pts >= scene["min_bound"])
              & (pts <= scene["max_bound"])).all(-1)
    vis = seen(pts, K, poses, H, H, r.near, r.far)
    field_fn = getattr(synthetic, qh.SCENES[args.scene])
    if args.scene == "tangle":
        field_fn = functools.partial(field_fn, seed=args.scene_seed)
    subject = on_subject(pts, field_fn, 0.5 * scene["sigma"] / g,
                         float(grid.threshold))
    n = occ.numel()
    split = {
        "outside_box": occ & ~in_box,
        "unseen_in_box": occ & in_box & ~vis,
        "seen_empty": occ & in_box & vis & ~subject,
        "subject": occ & in_box & vis & subject,
    }
    gen = torch.Generator(device).manual_seed(args.seed)
    largest, smallest, twice = refresh_bracket(
        grid, res.field, scene, res.cfg, qh.refresh_cells(grid), gen)
    out = {
        "run_dir": args.run_dir, "scene": args.scene,
        "scene_seed": args.scene_seed if args.scene == "tangle" else None,
        "cells": n,
        "occ_frac": round(float(occ.float().mean()), 6),
        "of_grid": {k: round(float(v.sum()) / n, 6) for k, v in split.items()},
        "in_box": round(float(in_box.float().mean()), 6),
        "seen_in_box": round(float((in_box & vis).float().mean()), 6),
        "subject_cells": round(float((subject & in_box).float().mean()), 6),
        "subject_occupied": round(float((occ & subject & in_box).sum())
                                  / max(float((subject & in_box).sum()), 1.0),
                                  6),
        "refresh_largest": round(largest, 6),
        "refresh_smallest": round(smallest, 6),
        "drawn_twice": round(twice, 6),
    }
    print(json.dumps(out))
    return out


def build_parser():
    p = argparse.ArgumentParser(
        description="split a quality run's occupied cells (PyTorch/CUDA)")
    p.add_argument("--run_dir", type=str, required=True,
                   help="the run directory of quality_holdout --save_params")
    p.add_argument("--mode", type=str, default=qh.DEFAULT_MODE,
                   help="the model name in the run directory")
    p.add_argument("--scene", type=str, default="textured",
                   choices=sorted(qh.SCENES))
    p.add_argument("--scene_seed", type=int, default=0,
                   help="seed of the held-back 'tangle' family")
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the refresh's draws")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def main(argv=None) -> dict:
    return report(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
