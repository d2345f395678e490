"""The 4-pose holdout quality protocol for the CP guided modes (counterpart
of ``scripts/quality_matrix.py``'s ``load_or_render_gt``, ``make_modes``
and ``_run_mode``).

Data: a hard procedural scene (``--scene textured|humanoid``) rendered on
the device at 384 samples a ray, 400x400, focal 1.1·H: ``--views`` training
views on an orbit of radius 4 at elevation 0.35 (``orbit_poses(views +
1)[:views]``), and four holdout poses: the orbit's next pose (interior)
and three off-orbit eyes (exterior, close_low, top).  Training: batches of
``--batch`` rays, the optimizer's cosine horizon ``--max_steps`` even when
the run stops earlier; the first step is warm-up, off the clock, and counts
as step 1; the occupancy grid is installed once ``steps >=
occ_warmup_steps`` (one refresh, then one step, off the clock), then
refreshed after every step whose count is a multiple of 64, with
``num_cells = max(2**20, cells // 8)``.  The run stops at ``--max_steps``,
after ``--steps`` (the port's own flag: the step count a record holds
fixed) or when ``--budget`` seconds have passed on the clock.  Holdout:
the exact encoder, no occupancy, no guidance, 128 samples, chunks of 32768
rays; PSNR per pose is 10·log10(1/mse).

Output: one JSON object ``{mode: row}`` with the JAX row's keys plus
``seed``, ``card`` (the card's name and power limit, "cpu" on the CPU),
``occ_trace`` (the step and occupied fraction of every refresh) and, in
SDF mode, the last step's ``eikonal`` term and the sharpness ``var_b``, by
default under ``results/`` (git-ignored); ``--save_params`` adds the
trained model as a run directory that ``render``, ``nerf2mesh`` and
``occ_report`` restore.  The CP guided n1448 modes, the SDF modes
(``cp_r21_sdf_guided_es16k`` and its ``_xla`` twin) and the hierarchical
modes (``cp_r21_hier_64f64_tv1e2``, ``cp_r21_hier_xla``) of ``make_modes``
run; an ``_xla`` mode differs from its twin only in the JAX implementation
switch (``cp_impl``/``dense_impl``), so both run the port's one set of
kernels.  The holdout of a hierarchical mode renders the first pass
alone, as JAX's ``render_image`` does by default.  The tangle scene is
not ported.  The port's
random draws come from one ``torch.Generator`` seeded with ``--seed`` (init
and sampling), so runs are alike in distribution, not in samples, to the
JAX package's.

Run:  python -m human_body_reconstruction_tpu_torch.cli.quality_holdout \\
          --scene textured --max_steps 6000 --seed 0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.utils import config as C

SCENES = {"textured": "textured_field",
          "humanoid": "textured_humanoid_field"}
# the orbit's next pose, then three eyes off the training orbit (further
# out, closer in, steeper), each 3.2-5.0 from the origin so near 2 / far 6
# still bracket the subject
HOLDOUT_EYES = (
    None,                      # interior: orbit continuation
    (3.59, 3.01, 1.60),        # exterior: r=4.96, off-orbit azimuth
    (2.62, -1.75, 0.50),       # closer, low elevation: r=3.19
    (2.00, 0.50, 3.50),        # steep top-down: r=4.06
)
HOLDOUT_NAMES = ("interior", "exterior", "close_low", "top")
FOCAL_MULT, RADIUS, ELEVATION, GT_SAMPLES = 1.1, 4.0, 0.35, 384
HOLDOUT_SAMPLES, HOLDOUT_CHUNK = 128, 32768
REFRESH_EVERY = 64
DEFAULT_MODE = "cp_n1448_r25_guided_k32_p32_tv1e2_strat"


def protocol_poses(views: int):
    """(train (views, 4, 4), holdout (4, 4, 4)) c2w poses, numpy float32."""
    from human_body_reconstruction_tpu_torch.data import synthetic

    orbit = synthetic.orbit_poses(views + 1, radius=RADIUS,
                                  elevation=ELEVATION)
    hold = np.stack([orbit[views]] + [synthetic.look_at_pose(e)
                                      for e in HOLDOUT_EYES if e is not None])
    return orbit[:views], hold


def protocol_data(H: int, W: int, views: int, scene: str, device):
    """K (3, 3), training and holdout poses and their ground-truth images
    (384 samples a ray), f32 tensors on ``device``."""
    from human_body_reconstruction_tpu_torch.data import synthetic

    field = getattr(synthetic, SCENES[scene])
    focal = FOCAL_MULT * H
    K = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    train, hold = (torch.as_tensor(p, device=device)
                   for p in protocol_poses(views))

    def render(poses):
        return torch.stack([synthetic.render_gt_image(
            H, W, K, p, field=field, num_samples=GT_SAMPLES) for p in poses])

    return {"K": K, "train_poses": train, "hold_poses": hold,
            "train_imgs": render(train), "hold_imgs": render(hold)}


def make_modes() -> dict:
    """The modes of the JAX ``make_modes`` that the port runs (before
    ``ray_batch`` is set from ``--batch``)."""
    from human_body_reconstruction_tpu_torch.ops import dense_grid

    cp = C.HashConfig(num_levels=7, n_min=16, n_max=1448, variant="cp",
                      cp_rank=25)
    cp = dataclasses.replace(cp, dense_levels=dense_grid.auto_dense_levels(cp))
    render = C.RenderConfig(num_samples=128, near=2.0, far=6.0,
                            occupancy=True, occupancy_resolution=128,
                            compact_samples=32, occ_guided=True,
                            occ_probes=32, occ_dt="mass", occ_stratified=True)
    cp16 = C.HashConfig(num_levels=8, n_min=16, n_max=2048, variant="cp",
                        cp_rank=16)
    r21 = dataclasses.replace(
        cp16, cp_rank=21, dense_levels=dense_grid.auto_dense_levels(cp16))
    r21_xla = dataclasses.replace(r21, cp_impl="xla", dense_impl="xla")
    sdf_render = C.RenderConfig(num_samples=128, near=2.0, far=6.0,
                                occupancy=True, occupancy_resolution=128,
                                compact_samples=32, occ_guided=True,
                                occ_probes=64, occ_dt="mass",
                                occ_stratified=True, use_sdf=True)
    sdf = {"mlp": C.MLPConfig(density_activation="sdf"), "render": sdf_render,
           "train": C.TrainConfig(cp_tv_weight=1e-2, eikonal_subsample=16384)}
    hier = {"render": C.RenderConfig(near=2.0, far=6.0, num_samples=64,
                                     hierarchical=True, num_fine_samples=64),
            "train": C.TrainConfig(cp_tv_weight=1e-2)}
    return {
        DEFAULT_MODE: C.PipelineConfig(
            hash=cp, render=render, train=C.TrainConfig(cp_tv_weight=1e-2)),
        # the humanoid needs the TV warmup: ungated TV 1e-2 under-fits it
        "cp_n1448_r25_guided_k32_p32_tv1e2_w320_strat": C.PipelineConfig(
            hash=cp, render=render,
            train=C.TrainConfig(cp_tv_weight=1e-2, cp_tv_warmup=320)),
        "cp_r21_sdf_guided_es16k": C.PipelineConfig(hash=r21, **sdf),
        "cp_r21_sdf_guided_xla_es16k": C.PipelineConfig(hash=r21_xla, **sdf),
        "cp_r21_hier_64f64_tv1e2": C.PipelineConfig(hash=r21, **hier),
        "cp_r21_hier_xla": C.PipelineConfig(hash=r21_xla, **hier),
    }


def refresh_cells(grid) -> int:
    """Cells drawn by one refresh: max(2^20, an eighth of the grid)."""
    return max(2 ** 20, grid.density.numel() // 8)


def train_loop(step_fn, refresh_fn, *, max_steps: int, budget: float,
               warmup, log=print):
    """The JAX protocol's loop.  ``step_fn()`` takes one step and returns
    its metrics; ``refresh_fn(steps, install)`` refreshes the occupancy
    grid (``install``: attach it first).  ``warmup`` is the step count that
    installs the grid, None without one.  Returns (steps, seconds on the
    clock, last metrics)."""
    m = step_fn()                # warm-up step, off the clock
    float(m["loss"])
    steps, installed = 1, False
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget and steps < max_steps:
        if warmup is not None and not installed and steps >= warmup:
            refresh_fn(steps, True)
            installed = True
            tc = time.perf_counter()     # the first culled step, off the clock
            m = step_fn()
            float(m["loss"])
            steps += 1
            t0 += time.perf_counter() - tc
        m = step_fn()
        steps += 1
        if installed and steps % REFRESH_EVERY == 0:
            refresh_fn(steps, False)
        if steps % 32 == 0:      # keep the queue from running ahead of the clock
            float(m["loss"])
        if steps % 200 == 0:
            log(f"step {steps} train_psnr {float(m['psnr']):.2f}")
    float(m["loss"])
    return steps, time.perf_counter() - t0, m


def run_mode(name: str, cfg: C.PipelineConfig, args, data, device,
             log=print) -> dict:
    """Train one mode on the protocol's data and score the holdout poses;
    the JAX row plus seed and card."""
    from human_body_reconstruction_tpu_torch.cli import card_line, psnr
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.ops import occupancy
    from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
    from human_body_reconstruction_tpu_torch.train import checkpoint
    from human_body_reconstruction_tpu_torch.train import state as state_lib
    from human_body_reconstruction_tpu_torch.train import step as step_lib

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ray_batch=args.batch))
    r = cfg.render
    H = W = args.height
    K, imgs, poses = data["K"], data["train_imgs"], data["train_poses"]
    lo, hi = rays_lib.scene_bounds(H, W, K, poses, 2.0, 6.0)
    scene = nerf.scene_from_bounds(lo, hi, "diagonal", device=device)
    gen = torch.Generator(device).manual_seed(args.seed)
    state = state_lib.create_train_state(nerf.Field(cfg, generator=gen),
                                         cfg.train, args.max_steps)
    pending = (occupancy.init_grid(r.occupancy_resolution, r.occ_threshold,
                                   device) if r.occupancy else None)

    def step_fn():
        return step_lib.train_step(state, scene, imgs, poses, K, cfg,
                                   args.batch, gen)

    trace = []                   # (steps, occupied fraction) per refresh

    def refresh_fn(steps, install):
        grid = pending if install else state.occ
        state.occ = occupancy.update_from_field(
            grid, state.field, scene, cfg, num_cells=refresh_cells(grid),
            generator=gen)
        trace.append((steps, occupancy.occupied_fraction(state.occ)))
        if install:
            log(f"  [{name}] occupancy grid installed at step {steps}")

    limit = min(args.max_steps, args.steps) if args.steps else args.max_steps
    steps, dt, m = train_loop(
        step_fn, refresh_fn, max_steps=limit, budget=args.budget,
        warmup=cfg.train.occ_warmup_steps if pending is not None else None,
        log=lambda s: log(f"  [{name}] {s}"))

    eval_cfg = dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, stochastic_train=False),
        render=dataclasses.replace(r, occupancy=False, compact_samples=0,
                                   occ_guided=False))
    per_pose = {}
    for pname, pose, ref in zip(HOLDOUT_NAMES, data["hold_poses"],
                                data["hold_imgs"]):
        img = step_lib.render_image(state.field, scene, H, W, K, pose,
                                    eval_cfg, num_samples=HOLDOUT_SAMPLES,
                                    chunk=HOLDOUT_CHUNK)
        per_pose[pname] = round(psnr(img.cpu().numpy(), ref.cpu().numpy()), 2)
    vals = list(per_pose.values())
    row = {"mode": name, "steps": steps,
           "rays_per_sec": round(steps * args.batch / dt, 1),
           "train_psnr": round(float(m["psnr"]), 2),
           "holdout_psnr": round(float(np.mean(vals)), 2),
           "holdout_std": round(float(np.std(vals)), 2),
           "holdout_min": round(float(np.min(vals)), 2),
           "holdout_per_pose": per_pose,
           "scene": args.scene,
           "budget_s": round(dt, 1)}
    if state.occ is not None:
        row["occ_frac"] = round(
            float(occupancy.occupied_fraction(state.occ)), 4)
        row["occ_trace"] = [[n, round(float(f), 4)] for n, f in trace]
    if cfg.render.use_sdf:
        row["eikonal"] = round(float(m["eikonal"]), 6)
        row["var_b"] = round(float(state.field.var_b.detach()), 6)
    row["seed"] = args.seed
    row["card"] = card_line(device)
    if args.save_params:
        # a run directory beside --out that restore, render and nerf2mesh
        # read: <mode>_ckpt.npz (JAX layout, with the step and the grid),
        # <mode>_config.json, bounds_model.npy
        run_dir = os.path.splitext(args.out)[0]
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, f"{name}_ckpt.npz")
        checkpoint.save_train_state(path, state)
        C.to_json(cfg, os.path.join(run_dir, f"{name}_config.json"))
        checkpoint.save_bounds(os.path.join(run_dir, "bounds_model.npy"),
                               lo.cpu().numpy(), hi.cpu().numpy())
        row["params_path"] = path
    return row


def build_parser():
    p = argparse.ArgumentParser(
        description="4-pose holdout quality protocol (PyTorch/CUDA)")
    p.add_argument("--mode", type=str, default=DEFAULT_MODE,
                   help="a mode of the JAX quality matrix: "
                        + ", ".join(make_modes()) + " (an _xla mode names "
                        "the JAX XLA encoders; the port runs its one set of "
                        "kernels for both twins)")
    p.add_argument("--scene", type=str, default="textured",
                   choices=["textured", "humanoid", "tangle"],
                   help="'tangle' is not ported and is refused")
    p.add_argument("--budget", type=float, default=360.0,
                   help="training wall-clock budget (s), measured after "
                        "the first step")
    p.add_argument("--max_steps", type=int, default=6000,
                   help="the optimizer's cosine horizon and a cap on steps")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after this many steps (0: no cap but "
                        "--max_steps and --budget)")
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator for init and sampling")
    p.add_argument("--out", type=str, default=None,
                   help="result JSON (default results/quality_holdout_"
                        "<scene>_<mode>_seed<seed>.json)")
    p.add_argument("--save_params", action="store_true",
                   help="write the trained model as a run directory named "
                        "after --out (<mode>_ckpt.npz in the JAX checkpoint "
                        "layout, its config and bounds), which render and "
                        "nerf2mesh restore")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def main(argv=None, log=print) -> dict:
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.cli import device_from_flag
    from human_body_reconstruction_tpu_torch.data.synthetic import TANGLE_REFUSAL

    if args.scene == "tangle":
        raise SystemExit(TANGLE_REFUSAL)
    modes = make_modes()
    if args.mode not in modes:
        raise SystemExit(f"mode {args.mode!r} is not ported to the PyTorch "
                         "package; the ported modes are "
                         + ", ".join(modes))
    device = device_from_flag(args.device)
    if args.out is None:
        args.out = os.path.join(
            "results", f"quality_holdout_{args.scene}_{args.mode}"
                       f"_seed{args.seed}.json")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    H = args.height
    t0 = time.perf_counter()
    data = protocol_data(H, H, args.views, args.scene, device)
    log(f"ground truth: {args.views}+{len(HOLDOUT_NAMES)} views at {H}x{H} "
        f"({args.scene}) in {time.perf_counter() - t0:.1f}s")
    row = run_mode(args.mode, modes[args.mode], args, data, device, log=log)
    with open(args.out, "w") as f:
        json.dump({args.mode: row}, f, indent=2)
    log(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
