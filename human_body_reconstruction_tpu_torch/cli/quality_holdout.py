"""The 4-pose holdout quality protocol (counterpart of
``scripts/quality_matrix.py``'s ``load_or_render_gt``, ``make_modes`` and
``_run_mode``).

Data: a hard procedural scene (``--scene textured|humanoid|tangle``; the
tangle's capsules and texture drawn from ``--scene_seed``, seeds of 100 and
up being the held-back evaluations) rendered on the device at 384 samples
a ray, 400x400, focal 1.1·H: ``--views`` training views on an orbit of
radius 4 at elevation 0.35 (``orbit_poses(views + 1)[:views]``), and four
holdout poses: the orbit's next pose (interior) and three off-orbit eyes
(exterior, close_low, top).  Training: batches of ``--batch`` rays, the
optimizer's cosine horizon ``--max_steps`` even when the run stops
earlier; the first step is warm-up, off the clock, and counts as step 1;
the occupancy grid is installed once ``steps >= occ_warmup_steps`` (one
refresh, then one step, off the clock), then refreshed after every step
whose count is a multiple of 64, with ``num_cells = max(2**20, cells //
8)``.  The run stops at ``--max_steps``, after ``--steps`` (the port's own
flag: the step count a record holds fixed) or when ``--budget`` seconds
have passed on the clock.  Holdout: the exact encoder, no occupancy, no
guidance, 128 samples, chunks of 32768 rays; PSNR per pose is
10·log10(1/mse).

Output: one JSON object ``{mode: row}`` with the JAX row's keys plus
``seed``, ``card`` (the card's name and power limit, "cpu" on the CPU),
``occ_trace`` (the step and occupied fraction of every refresh), on the
tangle its ``scene_seed`` and, in SDF mode, the last step's ``eikonal``
term and the sharpness ``var_b``, by default under ``results/``
(git-ignored); ``--save_params`` adds the trained model as a run directory
that ``render``, ``nerf2mesh`` and ``occ_report`` restore.

Modes: ``all_modes`` builds the 60 configs of the JAX ``make_modes`` as it
builds them, and the port runs every one (``make_modes``; ``refused_modes``
names those whose encoder ``hash_encoding.unported`` refuses: none): the
CP modes, dense and CP levels on every ladder and rank, the SDF and
hierarchical ones, the ``exact``, ``stochastic`` and ``cell`` hash grids,
the packed bf16 ones and the int8 ones with dense coarse levels (their
holdout reads the f32 master table exactly, as the JAX protocol's, whose
``eval_config`` turns ``stochastic_train`` off).  An
``_xla`` mode differs from its twin only in the JAX implementation switch
(``cp_impl``/``dense_impl``): the port runs it in plain PyTorch with the
JAX XLA path's roundings (``ops/xla_encoders.py``) and its twin through
the kernels.  The holdout of a hierarchical mode renders the first pass
alone, as JAX's ``render_image`` does by default.  The port's random draws
come from one ``torch.Generator`` seeded with ``--seed`` (init and
sampling), so runs are alike in distribution, not in samples, to the JAX
package's.

Run:  python -m human_body_reconstruction_tpu_torch.cli.quality_holdout \\
          --scene textured --max_steps 6000 --seed 0
      python -m human_body_reconstruction_tpu_torch.cli.quality_holdout \\
          --scene tangle --scene_seed 101 \\
          --mode cp_r21_guided_k32_p32_tv1e2_strat
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from human_body_reconstruction_tpu_torch.utils import config as C

SCENES = {"textured": "textured_field",
          "humanoid": "textured_humanoid_field",
          "tangle": "tangle_field"}
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


def protocol_data(H: int, W: int, views: int, scene: str, device,
                  scene_seed: int = 0):
    """K (3, 3), training and holdout poses and their ground-truth images
    (384 samples a ray), f32 tensors on ``device``; ``scene_seed`` draws
    the tangle."""
    from human_body_reconstruction_tpu_torch.data import synthetic

    field = getattr(synthetic, SCENES[scene])
    if scene == "tangle":
        field = functools.partial(field, seed=scene_seed)
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


def all_modes() -> dict:
    """The 60 configs of the JAX ``make_modes``, built as it builds them
    (before ``ray_batch`` is set from ``--batch``)."""
    from human_body_reconstruction_tpu_torch.ops import dense_grid

    rep = dataclasses.replace
    h = dict(num_levels=16, features_per_level=2, n_min=16, n_max=2048,
             log2_table_size=16)
    r = dict(num_samples=128, near=2.0, far=6.0)
    occ_kw = dict(occupancy=True, occupancy_resolution=128)

    def auto(cfg):
        return rep(cfg, dense_levels=dense_grid.auto_dense_levels(cfg))

    int8 = auto(C.HashConfig(num_levels=8, features_per_level=4, n_min=16,
                             n_max=2048, log2_table_size=16,
                             stochastic_train=True, packed=True,
                             pack_format="int8", grad_subsample=True,
                             hw_rng=True))
    h16d = auto(C.HashConfig(**h, stochastic_train=True, packed=True,
                             grad_subsample=True, hw_rng=True))
    cp16 = auto(C.HashConfig(num_levels=8, n_min=16, n_max=2048,
                             variant="cp", cp_rank=16))
    cp32 = rep(cp16, cp_rank=32)
    cp_l12 = auto(C.HashConfig(num_levels=12, n_min=16, n_max=2048,
                               variant="cp", cp_rank=32))
    cp_n1024 = auto(C.HashConfig(num_levels=7, n_min=16, n_max=1024,
                                 variant="cp", cp_rank=25))
    r21, r48 = rep(cp16, cp_rank=21), rep(cp16, cp_rank=48)
    r21_xla = rep(cp16, cp_rank=21, cp_impl="xla", dense_impl="xla")
    packed = dict(stochastic_train=True, packed=True, hw_rng=True)

    def guided(k=32, probes=64, **kw):
        return C.RenderConfig(**r, **occ_kw, compact_samples=k,
                              occ_guided=True, occ_probes=probes,
                              occ_dt="mass", **kw)

    def compact(k=48, **kw):
        return C.RenderConfig(**r, **occ_kw, compact_samples=k, **kw)

    def tv(weight=1e-2, **kw):
        return C.TrainConfig(cp_tv_weight=weight, **kw)

    def mode(hash_cfg, render, train=None, **kw):
        return C.PipelineConfig(hash=hash_cfg, render=render,
                                train=train or C.TrainConfig(), **kw)

    strat32 = guided(32, 32, occ_stratified=True)
    sdf = C.MLPConfig(density_activation="sdf")
    hier = C.RenderConfig(near=2.0, far=6.0, num_samples=64,
                          hierarchical=True, num_fine_samples=64)
    return {
        # the n_max 1024 and 1448 ladders (7 levels, two of them dense)
        "cp_n1024_r25_guided_k32_p32_tv1e2_strat": mode(cp_n1024, strat32,
                                                        tv()),
        "cp_n1024_r50_guided_k32_p32_tv1e2_strat": mode(
            rep(cp_n1024, cp_rank=50), strat32, tv()),
        "cp_n1448_r25_guided_k32_p32_tv1e2_strat": mode(
            rep(cp_n1024, n_max=1448), strat32, tv()),
        # the humanoid needs the TV warmup: ungated TV 1e-2 under-fits it
        "cp_n1448_r25_guided_k32_p32_tv1e2_w320_strat": mode(
            rep(cp_n1024, n_max=1448), strat32, tv(cp_tv_warmup=320)),
        # the hash grids: the corner one exact or single-corner, the cell
        # variant, packed bf16 and int8 gathers
        "exact": mode(C.HashConfig(**h), C.RenderConfig(**r)),
        "cell": mode(C.HashConfig(**h, variant="cell"), C.RenderConfig(**r)),
        "stochastic": mode(C.HashConfig(**h, stochastic_train=True,
                                        hw_rng=True), C.RenderConfig(**r)),
        "packed": mode(C.HashConfig(**h, **packed), C.RenderConfig(**r)),
        "packed_gsub": mode(C.HashConfig(**h, **packed, grad_subsample=True),
                            C.RenderConfig(**r)),
        "packed_compact": mode(
            C.HashConfig(**h, **packed, grad_subsample=True), compact()),
        "packed_guided": mode(
            C.HashConfig(**h, **packed, grad_subsample=True),
            compact(occ_guided=True, occ_probes=64)),
        "packed_dense": mode(h16d, compact()),
        "int8_dense": mode(int8, compact()),
        "int8_dense_guided": mode(int8, compact(occ_guided=True,
                                                occ_probes=64)),
        "int8_dense_guided_lvl": mode(
            rep(int8, grad_level_subsample=True),
            compact(occ_guided=True, occ_probes=64)),
        "int8_dense_guided_k32": mode(int8, compact(32, occ_guided=True,
                                                    occ_probes=64)),
        "int8_dense_guided_k24": mode(int8, compact(24, occ_guided=True,
                                                    occ_probes=64)),
        "int8_dense_guided_k16": mode(int8, compact(16, occ_guided=True,
                                                    occ_probes=64)),
        "int8_dense_guided_k32_p128": mode(int8, compact(
            32, occ_guided=True, occ_probes=128)),
        "int8_dense_guided_k32_mass": mode(int8, guided()),
        "int8_dense_guided_k32_mass_lpair": mode(
            rep(int8, grad_level_pair=True), guided()),
        # the CP family on the 8-level ladder (2 dense, 6 CP levels): the
        # unculled ladder, then guided placement over rank, K, probes, TV,
        # sigma-L1 and stratified quantiles; then the 12-level ladder
        "cp_r16": mode(cp16, C.RenderConfig(**r)),
        "cp_r16_guided_k32_mass": mode(cp16, guided()),
        "cp_r32_guided_k32_mass": mode(cp32, guided()),
        "cp_r48_guided_k32_mass": mode(r48, guided()),
        "cp_r32_guided_k32_mass_p128": mode(cp32, guided(probes=128)),
        "cp_r32_guided_k48_mass": mode(cp32, guided(48)),
        "cp_r48_guided_k48_mass": mode(r48, guided(48)),
        "cp_r64_guided_k48_mass": mode(rep(cp16, cp_rank=64), guided(48)),
        "cp_l12_r32_guided_k48_mass": mode(cp_l12, guided(48)),
        "cp_r32_guided_k48_tv1e2": mode(cp32, guided(48), tv()),
        "cp_r32_guided_k48_tv1e3": mode(cp32, guided(48), tv(1e-3)),
        "cp_r16_guided_k32_tv1e2": mode(cp16, guided(), tv()),
        "cp_r32_guided_k32_tv1e2": mode(cp32, guided(), tv()),
        "cp_r32_guided_k48_tv1e2_sl1e4": mode(
            cp32, guided(48), tv(sigma_l1_weight=1e-4)),
        "cp_r48_guided_k48_sl1e3": mode(
            r48, guided(48), C.TrainConfig(sigma_l1_weight=1e-3)),
        "cp_r48_guided_k48_sl1e4": mode(
            r48, guided(48), C.TrainConfig(sigma_l1_weight=1e-4)),
        "cp_r21_guided_k32_tv1e2": mode(r21, guided(), tv()),
        "cp_r42_guided_k48_tv1e2": mode(rep(cp16, cp_rank=42), guided(48),
                                        tv()),
        "cp_r32_guided_k32_tv1e3": mode(cp32, guided(), tv(1e-3)),
        "cp_r32_guided_k32_tv1e4": mode(cp32, guided(), tv(1e-4)),
        "cp_r32_guided_k32_tv1e2_w320": mode(cp32, guided(),
                                             tv(cp_tv_warmup=320)),
        "cp_r32_guided_k32_tv1e2_strat": mode(
            cp32, guided(occ_stratified=True), tv()),
        "cp_r21_guided_k32_tv1e2_strat": mode(
            r21, guided(occ_stratified=True), tv()),
        "cp_r32_guided_k48_tv1e2_sl1e4_strat": mode(
            cp32, guided(48, occ_stratified=True),
            tv(sigma_l1_weight=1e-4)),
        "cp_r32_guided_k32_tv1e2_w320_strat": mode(
            cp32, guided(occ_stratified=True), tv(cp_tv_warmup=320)),
        "cp_r21_guided_k24_tv1e2_strat": mode(
            r21, guided(24, occ_stratified=True), tv()),
        "cp_r21_guided_k32_p32_tv1e2_strat": mode(r21, strat32, tv()),
        "cp_r21_guided_k24_p32_tv1e2_strat": mode(
            r21, guided(24, 32, occ_stratified=True), tv()),
        # SDF: the eikonal term on every sample (guided, unculled, the XLA
        # twin), then on a 16384-point subsample
        "cp_r21_sdf_guided_k32_tv1e2_strat": mode(
            r21, guided(occ_stratified=True, use_sdf=True), tv(), mlp=sdf),
        "cp_r21_sdf_plain": mode(r21, C.RenderConfig(**r, use_sdf=True),
                                 tv(), mlp=sdf),
        "cp_r21_sdf_guided_xla": mode(
            r21_xla, guided(occ_stratified=True, use_sdf=True), tv(),
            mlp=sdf),
        "cp_r21_sdf_guided_es16k": mode(
            r21, guided(occ_stratified=True, use_sdf=True),
            tv(eikonal_subsample=16384), mlp=sdf),
        "cp_r21_sdf_guided_xla_es16k": mode(
            r21_xla, guided(occ_stratified=True, use_sdf=True),
            tv(eikonal_subsample=16384), mlp=sdf),
        # 64 coarse + 64 inverse-CDF fine samples, the loss on both passes
        "cp_r21_hier_64f64_tv1e2": mode(r21, hier, tv()),
        "cp_r21_hier_xla": mode(r21_xla, hier, tv()),
        "cp_r48_guided_k48_tv1e2": mode(r48, guided(48), tv()),
        "cp_r48_guided_k48_thr1": mode(r48, guided(48, occ_threshold=1.0)),
        "cp_r32_guided_k32_sl1e4": mode(cp32, guided(),
                                        C.TrainConfig(sigma_l1_weight=1e-4)),
        "int8_dense_guided_k32_mass_g256": mode(
            int8, C.RenderConfig(**r, occupancy=True,
                                 occupancy_resolution=256,
                                 compact_samples=32, occ_guided=True,
                                 occ_probes=64, occ_dt="mass")),
    }


def make_modes() -> dict:
    """The modes of the JAX ``make_modes`` that the port runs."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding

    return {k: v for k, v in all_modes().items()
            if hash_encoding.unported(v.hash) is None}


def refused_modes() -> dict:
    """{mode: why the port does not run it} for the JAX modes left out."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding

    return {k: hash_encoding.unported(v.hash) for k, v in all_modes().items()
            if hash_encoding.unported(v.hash) is not None}


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


def eval_config(cfg: C.PipelineConfig) -> C.PipelineConfig:
    """The holdout's config: the exact encoder, no occupancy, no guidance."""
    return dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, stochastic_train=False),
        render=dataclasses.replace(cfg.render, occupancy=False,
                                   compact_samples=0, occ_guided=False))


class ModeRun:
    """One mode's training on the protocol's data: the field from a
    generator seeded ``seed`` (init and sampling), the optimizer over a
    ``max_steps`` horizon, and the occupancy grid, pending until
    ``install`` (``warmup``: the step count that installs it, None without
    one).  ``step`` takes one step, ``window(n)`` n (JAX
    ``train_step_multi``: on the card replays of one captured step).
    ``refresh`` draws ``refresh_cells`` cells, writes them into the
    installed grid's storage (which a captured step reads) and records the
    occupied fraction in ``trace``."""

    def __init__(self, name: str, cfg: C.PipelineConfig, data, H: int,
                 W: int, *, batch: int, max_steps: int, seed: int, device,
                 log=print):
        from human_body_reconstruction_tpu_torch.models import nerf
        from human_body_reconstruction_tpu_torch.ops import occupancy
        from human_body_reconstruction_tpu_torch.ops import rays as rays_lib
        from human_body_reconstruction_tpu_torch.train import state as state_lib

        self.name, self.data, self.H, self.W, self.log = name, data, H, W, log
        self.batch = batch
        self.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ray_batch=batch))
        r = self.cfg.render
        self.lo, self.hi = rays_lib.scene_bounds(
            H, W, data["K"], data["train_poses"], 2.0, 6.0)
        self.scene = nerf.scene_from_bounds(self.lo, self.hi, "diagonal",
                                            device=device)
        self.gen = torch.Generator(device).manual_seed(seed)
        self.state = state_lib.create_train_state(
            nerf.Field(self.cfg, generator=self.gen), self.cfg.train,
            max_steps)
        self.pending = (occupancy.init_grid(r.occupancy_resolution,
                                            r.occ_threshold, device)
                        if r.occupancy else None)
        self.warmup = (self.cfg.train.occ_warmup_steps
                       if self.pending is not None else None)
        self.trace = []          # (steps, occupied fraction) per refresh
        self.graph = None        # the window's captured step

    def step(self):
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        d = self.data
        return step_lib.train_step(self.state, self.scene, d["train_imgs"],
                                   d["train_poses"], d["K"], self.cfg,
                                   self.batch, self.gen)

    def window(self, n: int):
        """n steps; the window's mean metrics."""
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        if self.graph is None:
            self.graph = step_lib.WindowGraph()
        d = self.data
        return step_lib.train_step_multi(
            self.state, self.scene, d["train_imgs"], d["train_poses"], d["K"],
            self.cfg, self.batch, n, self.gen, graph=self.graph)

    def refresh(self, steps: int, install: bool):
        from human_body_reconstruction_tpu_torch.ops import occupancy

        grid = self.pending if install else self.state.occ
        self.state.occ = occupancy.write_(grid, occupancy.update_from_field(
            grid, self.state.field, self.scene, self.cfg,
            num_cells=refresh_cells(grid), generator=self.gen))
        self.trace.append((steps, occupancy.occupied_fraction(
            self.state.occ)))
        if install:
            self.pending = None
            self.log(f"  [{self.name}] occupancy grid installed at step "
                     f"{steps}")

    def holdout_psnr(self, pose, ref, cfg=None, occ=None) -> float:
        """PSNR of one holdout render (``cfg``: the exact holdout's unless
        given; ``occ``: the grid of a guided render)."""
        from human_body_reconstruction_tpu_torch.cli import psnr
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        img = step_lib.render_image(
            self.state.field, self.scene, self.H, self.W, self.data["K"],
            pose, cfg or eval_config(self.cfg), occ=occ,
            num_samples=HOLDOUT_SAMPLES, chunk=HOLDOUT_CHUNK)
        return psnr(img.cpu().numpy(), ref.cpu().numpy())


def run_mode(name: str, cfg: C.PipelineConfig, args, data, device,
             log=print) -> dict:
    """Train one mode on the protocol's data and score the holdout poses;
    the JAX row plus seed and card."""
    from human_body_reconstruction_tpu_torch.cli import card_line
    from human_body_reconstruction_tpu_torch.ops import occupancy
    from human_body_reconstruction_tpu_torch.train import checkpoint

    run = ModeRun(name, cfg, data, args.height, args.height,
                  batch=args.batch, max_steps=args.max_steps, seed=args.seed,
                  device=device, log=log)
    cfg, state = run.cfg, run.state
    limit = min(args.max_steps, args.steps) if args.steps else args.max_steps
    steps, dt, m = train_loop(
        run.step, run.refresh, max_steps=limit, budget=args.budget,
        warmup=run.warmup, log=lambda s: log(f"  [{name}] {s}"))

    per_pose = {pname: round(run.holdout_psnr(pose, ref), 2)
                for pname, pose, ref in zip(HOLDOUT_NAMES, data["hold_poses"],
                                            data["hold_imgs"])}
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
        row["occ_trace"] = [[n, round(float(f), 4)] for n, f in run.trace]
    if cfg.render.use_sdf:
        row["eikonal"] = round(float(m["eikonal"]), 6)
        row["var_b"] = round(float(state.field.var_b.detach()), 6)
    if args.scene == "tangle":
        row["scene_seed"] = args.scene_seed
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
                               run.lo.cpu().numpy(), run.hi.cpu().numpy())
        row["params_path"] = path
    return row


def build_parser():
    p = argparse.ArgumentParser(
        description="4-pose holdout quality protocol (PyTorch/CUDA)")
    p.add_argument("--mode", type=str, default=DEFAULT_MODE,
                   help="a mode of the JAX quality matrix that the port "
                        "runs: " + ", ".join(make_modes()) + " (an _xla "
                        "mode runs plain PyTorch with the JAX XLA path's "
                        "roundings, its twin the kernels)")
    p.add_argument("--scene", type=str, default="textured",
                   choices=sorted(SCENES))
    p.add_argument("--scene_seed", type=int, default=0,
                   help="seed of the held-back 'tangle' family (>= 100 "
                        "reserved for one-shot held-back evaluations)")
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


def main(argv=None, log=print, edit=None) -> dict:
    """One mode through the protocol; ``edit`` (a function of the mode's
    PipelineConfig returning the config to run) changes it first."""
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.cli import device_from_flag

    modes = make_modes()
    if args.mode not in modes:
        why = refused_modes().get(args.mode)
        if why is not None:
            raise SystemExit(f"mode {args.mode!r} is not ported to the "
                             f"PyTorch package: {why}")
        raise SystemExit(f"unknown mode {args.mode!r}; the ported modes are "
                         + ", ".join(modes))
    device = device_from_flag(args.device)
    if args.out is None:
        scene = args.scene + (str(args.scene_seed) if args.scene == "tangle"
                              else "")
        args.out = os.path.join(
            "results", f"quality_holdout_{scene}_{args.mode}"
                       f"_seed{args.seed}.json")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    H = args.height
    t0 = time.perf_counter()
    data = protocol_data(H, H, args.views, args.scene, device,
                         scene_seed=args.scene_seed)
    log(f"ground truth: {args.views}+{len(HOLDOUT_NAMES)} views at {H}x{H} "
        f"({args.scene}) in {time.perf_counter() - t0:.1f}s")
    cfg = modes[args.mode] if edit is None else edit(modes[args.mode])
    row = run_mode(args.mode, cfg, args, data, device, log=log)
    with open(args.out, "w") as f:
        json.dump({args.mode: row}, f, indent=2)
    log(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
