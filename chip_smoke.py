#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths once on one CUDA card.

1. Build the port's CUDA kernels from csrc/ with nvcc (one process per
   source, all started together).
2. Flagship training (the zero-flag run, at full width): render the
   synthetic textured dataset (20 views, 400x400, 384 GT samples), train it
   through the port's CLI objects for TRAIN_STEPS steps with the occupancy
   warmup cut to OCC_WARMUP (the TV warmup follows it), every kernel's
   launch count reset just before and counted per phase; print step time
   and rays/s of the unculled and the guided phase, occupied fraction and
   train PSNR.  Then hold each backward kernel to its plain version at the
   two training shapes (768,000 and 2,048,000 points) on the path's own
   points (a seeded ray batch's occupancy-guided placement and unculled
   128-sample ladder, each ray's samples consecutive) and on uniform random
   points; one training step's loss and gradients on the card to the same
   step on the CPU (plain versions); profile one guided step; save,
   restore and serve the trained model.
3. Hash-grid training (``--stochastic --hw_rng``, the reference repo's own
   model at full width: corner hash grid, L 16, T 2^16, n_max 2048, 64
   samples, 16,000 rays, no occupancy grid) on the same dataset for
   HASH_STEPS steps, the three hash-path kernels' launch counts reset just
   before; print ms/step, rays/s, PSNR and launches.  Hold the Philox kernel
   to its plain version bit for bit (and its mean and chi^2 on the card) and
   the hash forward (with its stochastic corner bits) and backward kernels,
   in both modes, to theirs on the path's own points (a seeded ray batch on
   the jittered 64-sample ladder, 1,024,000 points, each ray's samples
   consecutive, u of (3, 16, 1,024,000)) and on as many uniform random
   points, and the exact forward on a 16384-ray chunk of a served frame's
   64-sample ladder; print the cells a point visits per level on the path;
   one stochastic step on the card against the CPU from the same batch,
   ladder and encoder uniforms; profile one step; serve the trained model
   exact on a 64-sample ladder, the forward's launches counted.
4. Serving: write a full-width (flagship preset) run directory in the JAX
   layout: seeded random weights, config JSON, bounds, and an occupancy
   grid whose mask is a seeded ball around the subject.  Restore it
   through the port's server and answer a 400x400 frame on the
   128-sample ladder, one at eval_guided 64, a 4-pose orbit batch and a
   health request, with every kernel's launch count reset just before.
5. Hold each forward kernel against its plain PyTorch version on the card
   at the serving shape, on a 16384-ray chunk of a 400x400 frame's
   128-sample ladder (2,097,152 points; the dense kernel writing the
   column block of the encoder's (N, 129) matrix, as the encoder does) and
   on as many uniform random points (about 70% of them outside the unit
   box of normalised coordinates), and a whole frame rendered through the
   kernels against the same frame through the plain versions (on the
   CPU).

Each kernel's bound is the larger of the bytes its call must move (each
input read once, each output written once) over 3.35 TB/s and its scalar
operations over the card's rate for them (67 TFLOP/s f32; 33.5 TOP/s for
the integer Philox rounds, which an H100 SM issues on 64 of its 128 lanes a
clock), from this run's shapes.  ``library_ms`` is one PyTorch call that
computes the same function: ``torch.rand`` for the Philox kernel;
``F.grid_sample`` (trilinear, ``align_corners=True``, f32, one call a
level) for the dense forward and its ``grid_sampler_3d_backward`` (the
volume's gradient) for the dense backward; none for the CP and hash
encoders.  Kernel times are CUDA events over a run of launches queued
behind a device sleep, so they are the device's time, not the host's
enqueue.

Any failure ends the run with a nonzero exit.  Output: the card's name and
power limit, per-phase, per-request and per-kernel lines, then one JSON line
listing the seven kernels (launches counted on the path that runs each; the
encoder kernels once per shape, named for it and with a "shape" key:
{cp,dense}_forward/serving_path and /random, {cp,dense}_backward/
guided_path, guided_random, unculled_path and unculled_random,
hash_forward/train_path, /random and /serving_path (exact),
hash_backward/train_path and /random, with the launches of the phase that
runs each shape), and last ``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py      (needs one CUDA card; exits 2 without one)
"""

from __future__ import annotations

import base64
import copy
import json
import math
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

SEED = 0
N_POINTS = 16384 * 128          # one ladder chunk: 16384 rays x 128 samples
CP_TOL = 1e-6                   # kernel vs plain: same operations, same order
DENSE_TOL = 1e-6
FRAME_TOL = 1e-3                # card vs CPU: f32 math on two devices, bf16 MLP
TRAIN_STEPS = 200
OCC_WARMUP = 64                 # the preset's 256, cut to fit the time limit
TRAIN_POINTS = (16000 * 48, 16000 * 128)   # guided and unculled steps
# backward kernel vs plain: the same terms, summed by f32 atomics in another
# order, then rounded to bf16: ops/cuda_lib.sum_order_tolerance (one bf16
# ulp of the plain value + 2^-18 of the entry's sum of |terms| + 1e-6)
STEP_LOSS_RTOL = 1e-4           # one step, card vs CPU
STEP_GRAD_RTOL = 1e-2           # per group, ||card - cpu|| / ||cpu||
SOURCE = "human_body_reconstruction_tpu_torch/csrc/encoders.cu"
HASH_STEPS = 150
HASH_POINTS = 16000 * 64        # one step of the hash path: rays x samples
HASH_RUN = 16                   # points a hash backward thread merges (csrc/hash.cu)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 peak
F32_OPS_PER_S = 67e12           # non-tensor f32
INT32_OPS_PER_S = F32_OPS_PER_S / 2


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn: CUDA events around reps calls, queued
    behind a device sleep (about 25 ms) so that the host's enqueue of short
    calls is not what is timed."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least time in ms, "bytes" or "operations") of a call that must move
    n_bytes and do ops scalar operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def write_run_dir(path: str, device: torch.device):
    """Full-width model with seeded random weights, in the JAX layout."""
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.models.nerf import Field
    from human_body_reconstruction_tpu_torch.ops import occupancy, rays
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.utils import config as C

    cfg = C.flagship_config()
    gen = torch.Generator().manual_seed(SEED)
    field = Field(cfg, generator=gen)
    with torch.no_grad():               # lift the tiny init to visible output
        for g in field.dense:
            g.mul_(5000.0)              # U(-1e-4, 1e-4) -> U(-0.5, 0.5)
        for ln in field.lines:
            ln.mul_(6.0)                # U(-0.1, 0.1) -> U(-0.6, 0.6)
        field.mlp.sig[-1].bias[0] += 2.0
    K = torch.tensor([[400.0, 0, 200.0], [0, 400.0, 200.0], [0, 0, 1]],
                     device=device)
    poses = torch.as_tensor(orbit_poses(4), device=device)
    lo, hi = rays.scene_bounds(400, 400, K, poses, cfg.render.near,
                               cfg.render.far)
    g = cfg.render.occupancy_resolution
    sigma = torch.sqrt(torch.sum((hi - lo) ** 2))
    c = (torch.arange(g, device=device) + 0.5) / g
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    radius = 1.2 * (0.9 + 0.2 * torch.rand(
        (g, g, g), generator=torch.Generator(device).manual_seed(SEED + 1),
        device=device))
    mask = (torch.linalg.vector_norm(lo + cells * sigma, dim=-1)
            < radius).to(torch.float32)
    occ = occupancy.OccupancyGrid(mask, mask, torch.tensor(0.01))
    ckpt.save_params(f"{path}/flagship_ckpt.npz", field,
                     extra=ckpt.occ_extras(occ))
    C.to_json(cfg, f"{path}/flagship_config.json")
    ckpt.save_bounds(f"{path}/bounds_model.npy", lo.cpu().numpy(),
                     hi.cpu().numpy())
    return float(mask.mean())


def all_kernels():
    """(name, wrapper) of every kernel of the training path."""
    from human_body_reconstruction_tpu_torch.ops import cp_kernel, dense_kernel

    return [("cp_forward", cp_kernel.cp_encode_kernel),
            ("dense_forward", dense_kernel.dense_encode_kernel),
            ("cp_backward", cp_kernel.cp_encode_backward_kernel),
            ("dense_backward", dense_kernel.dense_encode_backward_kernel)]


def train(run_dir: str, device: torch.device, tag: str):
    """The zero-flag flagship training run through the port's CLI objects.
    Returns (trainer, dataset, launches during training, launches during the
    unculled steps (warm-up included) and the guided ones (the install
    steps included))."""
    from human_body_reconstruction_tpu_torch.cli import train_hash
    from human_body_reconstruction_tpu_torch.ops import occupancy
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer
    from human_body_reconstruction_tpu_torch.utils import config as C

    args = train_hash.build_parser().parse_args([
        "--synthetic", "--synthetic_subject", "textured", "--device", "cuda",
        "--occ_warmup", str(OCC_WARMUP), "--steps", str(TRAIN_STEPS),
        "--out_dir", run_dir, "--model_name", "flagship"])
    cfg = train_hash.make_config(args)
    train_hash.check_supported(args, cfg)
    want = C.flagship_config()
    check(cfg.hash == want.hash and cfg.mlp == want.mlp
          and cfg.render == want.render
          and cfg.train.ray_batch == want.train.ray_batch
          and cfg.train.cp_tv_warmup == OCC_WARMUP + 64,
          "the preset's full width, only the warmups cut")
    t0 = time.perf_counter()
    ds, _ = train_hash.load_dataset(args, device)
    torch.cuda.synchronize()
    print(f"train data: textured, {tuple(ds['images'].shape)} rendered on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    trainer = Trainer(cfg=cfg, ds=ds, out_dir=run_dir, model_name="flagship",
                      total_steps=TRAIN_STEPS, log_fn=print)
    kernels = all_kernels()
    for _, kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    phases, by_phase = {}, {"unculled": {}, "guided": {}}
    for name, n, kind in (("warm", 4, "unculled"),
                          ("unculled", OCC_WARMUP - 4, "unculled"),
                          ("install", 4, "guided"),
                          ("guided", TRAIN_STEPS - OCC_WARMUP - 4, "guided")):
        before = {nm: kern.launches for nm, kern in kernels}
        t0 = time.perf_counter()
        trainer.run(n, log_every=16)
        torch.cuda.synchronize()
        phases[name] = (n, time.perf_counter() - t0)
        for nm, kern in kernels:
            by_phase[kind][nm] = (by_phase[kind].get(nm, 0) + kern.launches
                                  - before[nm])
    launches = {nm: kern.launches for nm, kern in kernels}
    for name in ("unculled", "guided"):
        n, sec = phases[name]
        print(f"train {name}: {n} steps, {1e3 * sec / n:.2f} ms/step, "
              f"{n * cfg.train.ray_batch / sec:.1f} rays/s {tag}")
    hist = trainer.history
    occ_frac = float(occupancy.occupied_fraction(trainer.state.occ))
    print(f"train: {trainer.state.step} steps, occupied fraction "
          f"{occ_frac:.4f}, PSNR {hist[0]['psnr']:.2f} dB (step "
          f"{hist[0]['step']}) -> {hist[-1]['psnr']:.2f} dB (step "
          f"{hist[-1]['step']})")
    print(f"launches while training: {launches}; by phase: {by_phase}")
    check(trainer.state.step == TRAIN_STEPS and trainer.state.occ is not None,
          "trained past the occupancy warmup")
    check(all(math.isfinite(r["loss"]) for r in hist), "finite losses")
    check(hist[-1]["psnr"] > hist[0]["psnr"] + 1.0, "train PSNR rose")
    check(0.0 < occ_frac < 1.0, "the grid culls some cells and keeps some")
    check(all(n > 0 for n in launches.values()), launches)
    return trainer, ds, launches, by_phase


def training_path_points(trainer, device):
    """The points a training step encodes, ray-major as ``render_rays``
    flattens them (a ray's samples consecutive), from one seeded ray batch
    of the trained model: {"guided": the occupancy-guided placement (16000
    rays x 48), "unculled": the jittered 128-sample ladder (16000 x 128)}."""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r, ds = trainer.cfg, trainer.state, trainer.cfg.render, trainer.ds
    gen = torch.Generator(device).manual_seed(SEED + 7)
    o, d = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                 cfg.train.ray_batch, gen)[:2]
    guided, _ = sampling.occupancy_guided_ts(
        o, d, st.occ, trainer.scene["mu"], trainer.scene["sigma"], r.near,
        r.far, r.compact_samples, num_probe=r.occ_probes, dt_mode=r.occ_dt,
        jitter=True, explore_frac=r.occ_explore,
        probe_jitter=r.occ_probe_jitter, stratified=r.occ_stratified,
        generator=gen)
    ladder = sampling.stratified_ts(
        (o.shape[0],), r.near, r.far, r.num_samples, r.log_sampling, device,
        jitter=True, per_ray_jitter=r.per_ray_jitter, generator=gen)
    return {name: (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)
            for name, t in (("guided", guided), ("unculled", ladder))}


def serving_chunk_points(r, K, c2w, device, samples: int):
    """The points of one 16384-ray chunk of a 400x400 frame seen through K
    from c2w on the ``samples`` ladder of render config ``r`` (the frame's
    fifth chunk, through its middle rows), ray-major, as the server encodes
    them."""
    from human_body_reconstruction_tpu_torch.ops import rays, sampling

    o, d, _ = rays.full_image_rays(400, 400, torch.as_tensor(K, device=device),
                                   torch.as_tensor(c2w, device=device))
    o, d = o[4 * 16384:5 * 16384], d[4 * 16384:5 * 16384]
    t = sampling.stratified_ts((o.shape[0],), r.near, r.far, samples,
                               r.log_sampling, device)
    return (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)


def hash_path_points(trainer, device):
    """The points a hash-grid training step encodes: one seeded ray batch
    (16000 rays) on the jittered 64-sample ladder, ray-major as
    ``render_rays`` flattens them (a ray's samples consecutive)."""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, r, ds = trainer.cfg, trainer.cfg.render, trainer.ds
    gen = torch.Generator(device).manual_seed(SEED + 8)
    o, d = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                 cfg.train.ray_batch, gen)[:2]
    t = sampling.stratified_ts((o.shape[0],), r.near, r.far, r.num_samples,
                               r.log_sampling, device, jitter=True,
                               per_ray_jitter=r.per_ray_jitter, generator=gen)
    return (o[:, None, :] + d[:, None, :] * t[..., None]).reshape(-1, 3)


def cells_per_point(pts, scene, scales, run: int):
    """Per level, the cells that the backward's runs of ``run`` consecutive
    points visit, per point: 1.0 when every point enters a new cell; run
    merging leaves this share of the corner adds."""
    xn = (pts - scene["mu"]) / scene["sigma"]
    first = torch.arange(pts.shape[0], device=pts.device) % run == 0
    out = []
    for s in scales:
        c = torch.floor(xn * float(s))
        new = first.clone()
        new[1:] |= (c[1:] != c[:-1]).any(-1)
        out.append(float(new.float().mean()))
    return out


def grid_sample_inputs(grids, x, mu, sigma, cfg):
    """The dense levels as ``F.grid_sample`` takes them, the yardstick of
    the dense kernels (never called by the port): per level the (1, F, G,
    G, G) f32 volume and the (1, 1, 1, N, 3) coordinates, in grid_sample's
    (z, y, x) order, u = 2 x_l / (G - 1) - 1 with x_l = xn * scale, which
    ``align_corners=True`` maps back to x_l."""
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise
    from human_body_reconstruction_tpu_torch.utils.config import level_scales

    xn = normalise(x, mu, sigma)
    scales = np.float32(level_scales(cfg)[:cfg.dense_levels])
    return [(grid.detach().to(torch.float32).permute(3, 0, 1, 2)[None]
             .contiguous(),
             (2.0 * (xn * float(s)) / (grid.shape[0] - 1) - 1.0)
             .flip(-1).reshape(1, 1, 1, -1, 3))
            for grid, s in zip(grids, scales)]


def grid_sample_levels(inputs):
    """One ``F.grid_sample`` call a level (trilinear): (1, F, 1, 1, N)
    each."""
    return [torch.nn.functional.grid_sample(vol, u, mode="bilinear",
                                            align_corners=True)
            for vol, u in inputs]


def grid_sample_backward_levels(inputs, grad):
    """The volumes' gradients of ``grid_sample_levels`` given the (N, D*F)
    gradient of the features: one ``grid_sampler_3d_backward`` a level, from
    its (1, F, 1, 1, N) gradient (made before the call)."""
    f = inputs[0][0].shape[1]
    gos = [grad[:, l * f:(l + 1) * f].t().contiguous().reshape(1, f, 1, 1, -1)
           for l in range(len(inputs))]
    return lambda: [torch.ops.aten.grid_sampler_3d_backward(
        go, vol, u, 0, 0, True, [True, False])[0]
        for go, (vol, u) in zip(gos, inputs)]


def backward_checks(trainer, device, tag, paths):
    """Each backward kernel against its plain version at both training
    shapes, from a seeded (N, 129) cotangent read through a row stride, on
    the path's own points (``paths``, from ``training_path_points``) and on
    uniform random points.  Returns {kernel name: {(phase, points kind):
    record}}, a record being (max_abs_err, ms, plain_ms, library_ms,
    bound)."""
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, cuda_lib, dense_kernel)

    field, scene, h = trainer.state.field, trainer.scene, trainer.cfg.hash
    d = h.dense_levels * h.features_per_level
    gen = torch.Generator(device).manual_seed(SEED + 3)
    out = {"cp_backward": {}, "dense_backward": {}}
    for n, (phase, path_pts) in zip(TRAIN_POINTS, (("guided", paths["guided"]),
                                                   ("unculled",
                                                    paths["unculled"]))):
        check(path_pts.shape == (n, 3), ("path points", phase, path_pts.shape))
        xn = torch.rand((n, 3), generator=gen, device=device) * 1.5 - 0.25
        pts = scene["mu"] + xn * scene["sigma"]
        g = torch.randn((n, h.out_dim + 3), generator=gen, device=device)
        g = g[:, 3:]
        n_cp, rank = len(field.lines), h.cp_rank
        cp_ops = n * n_cp * (rank * 26 + 3 * 6)
        dense_ops = n * h.dense_levels * (28 + 18 * h.features_per_level)
        for nm, kern, plain, tables, cols, ops in (
                ("cp_backward", cp_kernel.cp_encode_backward_kernel,
                 cp_kernel.cp_encode_plain_backward, list(field.lines),
                 g[:, d:], cp_ops),
                ("dense_backward", dense_kernel.dense_encode_backward_kernel,
                 dense_kernel.dense_encode_plain_backward, list(field.dense),
                 g[:, :d], dense_ops)):
            for kind, at in (("path", path_pts), ("random", pts)):
                a = (tables, at, scene["mu"], scene["sigma"], h, cols)
                bnd = bound(nbytes(at, cols, *tables, *tables), ops)
                with torch.no_grad():
                    got, want = kern(*a), plain(*a)
                    abs_sum = plain([t.abs() for t in tables], *a[1:-1],
                                    cols.abs())
                    torch.cuda.synchronize()
                    err = max(float((x - y).abs().max())
                              for x, y in zip(got, want))
                    ulps = max(float(((x - y).abs() / (cuda_lib.bf16_ulp(y)
                                                       + 1e-6)).max())
                               for x, y in zip(got, want))
                    ratio = max(float(((x - y).abs()
                                       / cuda_lib.sum_order_tolerance(
                                           y, s, True)).max())
                                for x, y, s in zip(got, want, abs_sum))
                    check(all(x.shape == y.shape
                              and bool(torch.isfinite(x).all())
                              for x, y in zip(got, want)),
                          f"{nm} gradients finite, of the plain version's "
                          "shapes")
                    ms = time_ms(lambda: kern(*a))
                    plain_ms = time_ms(lambda: plain(*a), reps=5)
                    lib_ms = None
                    if nm == "dense_backward":
                        lib_ms = time_ms(grid_sample_backward_levels(
                            grid_sample_inputs(tables, at, scene["mu"],
                                               scene["sigma"], h), cols))
                lib = "" if lib_ms is None else (
                    f", grid_sampler_3d_backward {lib_ms:.4f} ms")
                print(f"kernel {nm}: {n} {kind} points ({phase}), max_abs_err "
                      f"{err:.3e}, worst |err| / tolerance {ratio:.3f} (tol 1;"
                      f" / (bf16 ulp + 1e-6) {ulps:.3f}), {ms:.4f} ms vs plain "
                      f"{plain_ms:.4f} ms{lib}, bound {bnd[0]:.4f} ms "
                      f"({bnd[1]}) {tag}")
                check(ratio <= 1.0, (nm, kind, n, err, ratio))
                out[nm][(phase, kind)] = (err, ms, plain_ms, lib_ms, bnd)
    return out


def step_on_card_vs_cpu(trainer, ds, device):
    """One guided training step's loss and gradients from the same params,
    batch and sample positions: kernels on the card, plain on the CPU.
    (Placed on each device from the same draws, t differs by a few f32 ulps
    through the order of the CDF sums, and that alone moves the gradient by
    about 5e-3 of its norm.)"""
    from human_body_reconstruction_tpu_torch.ops import sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r = trainer.cfg, trainer.state, trainer.cfg.render
    gen = torch.Generator(device).manual_seed(SEED + 4)
    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, gen)
    placement = sampling.occupancy_guided_ts(
        *batch[:2], st.occ, trainer.scene["mu"], trainer.scene["sigma"],
        r.near, r.far, r.compact_samples, num_probe=r.occ_probes,
        dt_mode=r.occ_dt, jitter=True, explore_frac=r.occ_explore,
        probe_jitter=r.occ_probe_jitter, stratified=r.occ_stratified,
        generator=gen)

    def loss_and_grads(field, dev):
        move = (lambda t: t.to(dev))
        field.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(
            field, {k: move(v) for k, v in trainer.scene.items()},
            [move(t) for t in batch], cfg,
            type(st.occ)(*(move(t) for t in st.occ)), torch.bfloat16,
            step=st.step, placement=[move(t) for t in placement])
        loss.backward()
        groups = {"dense": field.dense, "lines": field.lines,
                  "mlp": list(field.mlp.parameters())}
        grads = {k: torch.cat([p.grad.reshape(-1) for p in ps]).cpu()
                 for k, ps in groups.items()}
        field.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    card_loss, card = loss_and_grads(st.field, device)
    cpu = torch.device("cpu")
    cpu_loss, ref = loss_and_grads(copy.deepcopy(st.field).to(cpu), cpu)
    rel = {k: float(torch.linalg.vector_norm(card[k] - ref[k])
                    / torch.linalg.vector_norm(ref[k])) for k in ref}
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"step {st.step} card vs CPU ({cfg.train.ray_batch} rays x "
          f"{cfg.render.compact_samples} guided samples): loss "
          f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:g}); gradient rel norm "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {STEP_GRAD_RTOL:g})")
    check(loss_rel <= STEP_LOSS_RTOL, ("step loss", card_loss, cpu_loss))
    check(all(v <= STEP_GRAD_RTOL for v in rel.values()), ("step grads", rel))


def profile_step(trainer, label, tag):
    """torch.profiler over one training step, forward and backward +
    optimizer profiled separately: device kernel time by kind and the
    device's idle share (1 - busy / wall, wall ending in a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, ds = trainer.cfg, trainer.state, trainer.ds
    kinds = (("encoder fwd", ("cp_forward_kernel", "dense_forward_kernel",
                              "hash_forward_kernel")),
             ("encoder bwd", ("cp_backward_kernel", "dense_backward_kernel",
                              "hash_backward_kernel")),
             ("philox", ("uniform_bits_kernel",)),
             ("optimizer", ("multi_tensor", "adam")),
             ("gemm", ("gemm", "sm90_xmma", "cutlass", "ampere")))

    def kind(name):
        low = name.lower()
        return next((k for k, keys in kinds if any(s in low for s in keys)),
                    "other")

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, by_kind = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + (b - a)
        busy, end = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        return res, wall * 1e3, busy / 1e3, {k: v / 1e3 for k, v in by_kind.items()}

    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, trainer.generator)
    st.opt.zero_grad()
    (loss, _), wall_f, busy_f, fwd = window(lambda: step.loss_fn(
        st.field, trainer.scene, batch, cfg, st.occ, torch.bfloat16,
        step=st.step, generator=trainer.generator))
    _, wall_b, busy_b, bwd = window(
        lambda: (loss.backward(), st.opt.step(st.step)))
    st.step += 1
    if busy_f + busy_b == 0.0:
        print("profile: the profiler recorded no device time: not measured")
        return
    fmt = (lambda d: ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items())))
    print(f"profile {label} step {st.step}: forward wall {wall_f:.3f} ms, "
          f"device {busy_f:.3f} ms [{fmt(fwd)}]; backward+optimizer wall "
          f"{wall_b:.3f} ms, device {busy_b:.3f} ms [{fmt(bwd)}]; idle share "
          f"{1.0 - (busy_f + busy_b) / (wall_f + wall_b):.3f} {tag}")


def decode_png(data: bytes) -> np.ndarray:
    """The server's own PNG (8-bit RGB, one IDAT, no filtering)."""
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    n = int.from_bytes(data[33:37], "big")
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    return rows.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def serve_trained(trainer, ds, run_dir, samples, tag):
    """Save the trained model, restore it through RenderServer, render a
    training view exact on a ``samples`` ladder and score it."""
    from human_body_reconstruction_tpu_torch.cli import serve

    trainer.save()
    occ = trainer.state.occ
    args = serve.build_parser().parse_args(
        ["--ckpt_dir", run_dir, "--model_name", trainer.model_name,
         "--device", "cuda"] + (["--use_occ"] if occ is not None else []))
    server = serve.RenderServer(args)
    check(all(torch.equal(a, b) for a, b in zip(
        server.field.parameters(), trainer.state.field.parameters()))
          and (occ is None or torch.equal(server.occ.mask, occ.mask)),
          "restored params and grid equal the trained ones")
    pose, W = 1, ds["W"]
    cax = 2.0 * math.atan(W / (2.0 * float(ds["K"][0, 0])))
    req = {"c2w": ds["c2ws"][pose].tolist(), "height": ds["H"], "width": W,
           "camera_angle_x": cax, "num_samples": samples}
    server.handle(req)                       # first use at this shape
    resp = server.handle(req)
    check(resp["ok"], resp)
    img = decode_png(base64.b64decode(resp["image_b64"])) / 255.0
    gt = ds["images"][pose].cpu().numpy()
    psnr = 10.0 * math.log10(1.0 / max(float(np.mean((img - gt) ** 2)), 1e-12))
    print(f"served trained {trainer.model_name} model: view {pose} "
          f"{ds['H']}x{W} ladder {samples} in "
          f"{resp['wall_s']} s ({resp['rays_per_sec']} rays/s), PSNR "
          f"{psnr:.2f} dB against the ground truth {tag}")
    check(np.isfinite(img).all() and psnr > 12.0, ("served PSNR", psnr))


def entry(name, source, replaces, launches, err, ms, plain_ms, library_ms,
          bnd, shape=None) -> dict:
    """One kernel's record of the JSON line (``shape``: which points, for
    the kernels timed at more than one)."""
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
           "bound_by": bnd[1], "library_ms": library_ms}
    return rec if shape is None else {**rec, "shape": shape}


def train_hash_grid(run_dir: str, ds, device: torch.device, tag: str):
    """``train_hash --stochastic --hw_rng`` at full width through the port's
    CLI objects, on the dataset rendered for the flagship run.  Returns
    (trainer, launches during the timed run)."""
    from human_body_reconstruction_tpu_torch.cli import train_hash
    from human_body_reconstruction_tpu_torch.ops import hash_kernel, rng_kernel
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    args = train_hash.build_parser().parse_args([
        "--synthetic", "--synthetic_subject", "textured", "--stochastic",
        "--hw_rng", "--device", "cuda", "--steps", str(HASH_STEPS),
        "--out_dir", run_dir, "--model_name", "hash"])
    cfg = train_hash.make_config(args)
    train_hash.check_supported(args, cfg)
    h, r = cfg.hash, cfg.render
    check((h.variant, h.num_levels, h.features_per_level, h.table_size,
           h.n_max, h.dense_levels, h.stochastic_train, h.hw_rng,
           r.num_samples, r.occupancy, cfg.train.ray_batch)
          == ("corner", 16, 2, 2 ** 16, 2048, 0, True, True, 64, False, 16000),
          "--stochastic --hw_rng resolves to the reference hash grid")
    trainer = Trainer(cfg=cfg, ds=ds, out_dir=run_dir, model_name="hash",
                      total_steps=HASH_STEPS, log_fn=print)
    warm = 5                         # first-use costs, and the first log
    trainer.run(warm, log_every=warm)
    kernels = [("uniform_bits", rng_kernel.uniform_kernel),
               ("hash_forward", hash_kernel.hash_encode_kernel),
               ("hash_backward", hash_kernel.hash_encode_backward_kernel)]
    for _, kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(HASH_STEPS - warm, log_every=29)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {nm: kern.launches for nm, kern in kernels}
    n = HASH_STEPS - warm
    hist = trainer.history
    print(f"hash train: {n} steps, {1e3 * sec / n:.2f} ms/step, "
          f"{n * cfg.train.ray_batch / sec:.1f} rays/s {tag}")
    print(f"hash train: PSNR {hist[0]['psnr']:.2f} dB (step "
          f"{hist[0]['step']}) -> {hist[-1]['psnr']:.2f} dB (step "
          f"{hist[-1]['step']})")
    print(f"launches while training the hash grid: {launches}")
    check(trainer.state.step == HASH_STEPS, "trained every step")
    check(all(math.isfinite(r["loss"]) for r in hist), "finite losses")
    check(hist[-1]["psnr"] >= hist[0]["psnr"] + 1.0, "hash train PSNR rose")
    check(all(v > 0 for v in launches.values()), launches)
    return trainer, launches


def hash_kernel_checks(trainer, device, tag, train_pts, serve_pts):
    """The Philox kernel bit for bit, and the hash forward and backward
    kernels against their plain versions on three point sets: the training
    path's (``hash_path_points``), as many uniform random points, and a
    served frame's chunk (exact forward only, the serving path's one
    kernel).  The forward and the stochastic corner bits bit for bit, the
    backward (stochastic from the kernel's bits) within the sum-order
    tolerance.  Returns {record name: (max_abs_err, ms, plain_ms, library_ms,
    bound)}: uniform_bits, and the hash kernels per point set in the path's
    mode (stochastic on training and random points, exact serving), the
    error over both modes."""
    from human_body_reconstruction_tpu_torch.ops import (
        cuda_lib, hash_kernel, rng_kernel)
    from human_body_reconstruction_tpu_torch.utils.config import fine_scales

    h, scene = trainer.cfg.hash, trainer.scene
    table = trainer.state.field.table.detach()
    L, F, n = h.num_hashed_levels, h.features_per_level, HASH_POINTS
    gen = torch.Generator(device).manual_seed(SEED + 5)
    xn = torch.rand((n, 3), generator=gen, device=device) * 1.5 - 0.25
    pts = scene["mu"] + xn * scene["sigma"]
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device,
                         dtype=torch.int32)
    shape = (3, L, n)
    out = {}
    with torch.no_grad():
        bits = rng_kernel.uniform_bits(seed, shape)
        u = rng_kernel.uniform(seed, shape)
        same = (torch.equal(bits, rng_kernel.uniform_plain(seed, shape, False))
                and torch.equal(u, rng_kernel.uniform_plain(seed, shape)))
        m = u.numel()
        mean = float(u.double().mean())
        counts = torch.bincount((u * 256).long().reshape(-1),
                                minlength=256).double()
        chi2 = float(((counts - m / 256) ** 2 / (m / 256)).sum())
        ms = time_ms(lambda: rng_kernel.uniform(seed, shape))
        plain_ms = time_ms(lambda: rng_kernel.uniform_plain(seed, shape),
                           reps=5)
        lib_ms = time_ms(lambda: torch.rand(shape, device=device))
        del bits
    bnd = bound(nbytes(seed, u), m * 28, INT32_OPS_PER_S)
    print(f"kernel uniform_bits: {m} values, bit for bit {same}, mean "
          f"{mean:.6f} (|mean - 0.5| bound {6 / math.sqrt(12 * m):.2e}), "
          f"chi2 {chi2:.1f} (256 bins, bound {255 + 6 * math.sqrt(510):.1f}), "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, torch.rand {lib_ms:.4f} "
          f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}) {tag}")
    check(same, "Philox kernel equals its plain version bit for bit")
    check(abs(mean - 0.5) < 6 / math.sqrt(12 * m)
          and chi2 < 255 + 6 * math.sqrt(510), ("Philox mean, chi2", mean, chi2))
    out["uniform_bits"] = (0.0, ms, plain_ms, lib_ms, bnd)

    check(train_pts.shape == (n, 3), ("hash train path", train_pts.shape))
    visits = cells_per_point(train_pts, scene, fine_scales(h), HASH_RUN)
    print("hash train path: cells a point visits per level (runs of "
          f"{HASH_RUN}), levels 0-{L - 1}: "
          + " ".join(f"{v:.3f}" for v in visits)
          + f"; mean {sum(visits) / L:.3f}")
    g = torch.randn((n, L * F + 3), generator=gen, device=device)[:, 3:]
    for kind, at in (("train_path", train_pts), ("random", pts),
                     ("serving_path", serve_pts)):
        a = (table, at, scene["mu"], scene["sigma"], h)
        xa = (at - scene["mu"]) / scene["sigma"]
        outside = float(((xa < 0) | (xa > 1)).any(-1).float().mean())
        errs, rec = [], {}
        for mode in (("exact",) if kind == "serving_path"
                     else ("exact", "stochastic")):
            stoch = mode == "stochastic"
            uu = u if stoch else None
            ops_f = at.shape[0] * L * (15 + (11 if stoch else 8 * (10 + 2 * F)))
            with torch.no_grad():
                got = hash_kernel.hash_encode_kernel(*a, u=uu)
                want = hash_kernel.hash_encode_plain(*a, u=uu)
                torch.cuda.synchronize()
                (feats, cb), (wf, wb) = ((got, want) if stoch
                                         else ((got, None), (want, None)))
                same = torch.equal(feats, wf) and (not stoch
                                                   or torch.equal(cb, wb))
                err_f = float((feats - wf).abs().max())
                check(bool(torch.isfinite(feats).all()),
                      "hash forward output finite")
                ms_f = time_ms(lambda: hash_kernel.hash_encode_kernel(*a, u=uu))
                plain_f = time_ms(lambda: hash_kernel.hash_encode_plain(*a, u=uu),
                                  reps=3)
                bnd_f = bound(nbytes(at, table, feats, *((uu, cb) if stoch
                                                         else ())), ops_f)
            print(f"kernel hash_forward ({mode}): {at.shape[0]} {kind} points "
                  f"({outside:.3f} outside the box), out {tuple(feats.shape)}"
                  f"{', bits ' + str(tuple(cb.shape)) if stoch else ''}, bit "
                  f"for bit {same} (max_abs_err {err_f:.3e}), {ms_f:.4f} ms vs "
                  f"plain {plain_f:.4f} ms, bound {bnd_f[0]:.4f} ms "
                  f"({bnd_f[1]}) {tag}")
            check(same, ("hash_forward bit for bit", kind, mode, err_f))
            errs.append(err_f)
            rec["hash_forward"] = (max(errs), ms_f, plain_f, None, bnd_f)
            if kind == "serving_path":
                continue
            with torch.no_grad():
                gb = hash_kernel.hash_encode_backward_kernel(*a, g, bits=cb)
                want_b = hash_kernel.hash_encode_plain_backward(*a, g,
                                                                bits=wb)
                abs_sum = hash_kernel.hash_encode_plain_backward(
                    *a, g.abs(), bits=wb)
                torch.cuda.synchronize()
                err_b = float((gb - want_b).abs().max())
                ratio = float(((gb - want_b).abs()
                               / cuda_lib.sum_order_tolerance(
                                   want_b, abs_sum, False)).max())
                ms_b = time_ms(lambda: hash_kernel.hash_encode_backward_kernel(
                    *a, g, bits=cb))
                plain_b = time_ms(
                    lambda: hash_kernel.hash_encode_plain_backward(
                        *a, g, bits=wb), reps=3)
                bnd_b = bound(nbytes(at, g, gb, *((cb,) if stoch else ())),
                              ops_f + at.shape[0] * L * F)
            print(f"kernel hash_backward ({mode}): {at.shape[0]} {kind} "
                  f"points{', from the bits' if stoch else ''}, max_abs_err "
                  f"{err_b:.3e}, worst |err| / tolerance {ratio:.3f} (tol 1), "
                  f"{ms_b:.4f} ms vs plain {plain_b:.4f} ms, bound "
                  f"{bnd_b[0]:.4f} ms ({bnd_b[1]}) {tag}")
            check(bool(torch.isfinite(gb).all()) and ratio <= 1.0,
                  ("hash_backward", kind, mode, err_b, ratio))
            prev = rec.get("hash_backward", (0.0,))[0]
            rec["hash_backward"] = (max(prev, err_b), ms_b, plain_b, None,
                                    bnd_b)
        for nm, r in rec.items():
            out[f"{nm}/{kind}"] = r
    return out


def hash_step_on_card_vs_cpu(trainer, ds, device):
    """One stochastic training step's loss and gradients from the same
    params, batch, ladder t and encoder uniforms: kernels on the card,
    plain versions on the CPU."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding, sampling
    from human_body_reconstruction_tpu_torch.train import step

    cfg, st, r = trainer.cfg, trainer.state, trainer.cfg.render
    gen = torch.Generator(device).manual_seed(SEED + 6)
    batch = step.sample_ray_batch(ds["images"], ds["c2ws"], ds["K"],
                                  cfg.train.ray_batch, gen)
    t = sampling.stratified_ts((cfg.train.ray_batch,), r.near, r.far,
                               r.num_samples, r.log_sampling, device,
                               jitter=True, per_ray_jitter=r.per_ray_jitter,
                               generator=gen)
    enc_u = hash_encoding.stoch_uniform(
        (3, cfg.hash.num_hashed_levels, t.numel()), cfg.hash, device, gen)

    def loss_and_grads(field, dev):
        move = (lambda v: v.to(dev))
        field.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(
            field, {k: move(v) for k, v in trainer.scene.items()},
            [move(v) for v in batch], cfg, None, torch.bfloat16,
            step=st.step, draws={"enc_u": move(enc_u)},
            placement=(move(t), None))
        loss.backward()
        grads = {"table": field.table.grad.reshape(-1).cpu(),
                 "mlp": torch.cat([p.grad.reshape(-1)
                                   for p in field.mlp.parameters()]).cpu()}
        field.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    card_loss, card = loss_and_grads(st.field, device)
    cpu = torch.device("cpu")
    cpu_loss, ref = loss_and_grads(copy.deepcopy(st.field).to(cpu), cpu)
    rel = {k: float(torch.linalg.vector_norm(card[k] - ref[k])
                    / torch.linalg.vector_norm(ref[k])) for k in ref}
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"hash step {st.step} card vs CPU ({cfg.train.ray_batch} rays x "
          f"{r.num_samples} samples, stochastic corners): loss "
          f"{card_loss:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:g}); gradient rel norm "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {STEP_GRAD_RTOL:g})")
    check(loss_rel <= STEP_LOSS_RTOL, ("hash step loss", card_loss, cpu_loss))
    check(all(v <= STEP_GRAD_RTOL for v in rel.values()),
          ("hash step grads", rel))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, cuda_lib, dense_kernel, hash_kernel)
    from human_body_reconstruction_tpu_torch.train import step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    gpu = gpu_line()
    print(gpu)
    name = torch.cuda.get_device_name(0)
    tag = f"[{gpu}]"

    t0 = time.perf_counter()
    lib_path, log = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as train_dir:
        trainer, ds, train_launches, phase_launches = train(train_dir, device,
                                                            tag)
        bwd = backward_checks(trainer, device, tag,
                              training_path_points(trainer, device))
        step_on_card_vs_cpu(trainer, ds, device)
        profile_step(trainer, "guided", tag)
        serve_trained(trainer, ds, train_dir, 128, tag)
        del trainer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as hash_dir:
        trainer, hash_launches = train_hash_grid(hash_dir, ds, device, tag)
        hash_report = hash_kernel_checks(
            trainer, device, tag, hash_path_points(trainer, device),
            serving_chunk_points(trainer.cfg.render, ds["K"], ds["c2ws"][1],
                                 device, 64))
        hash_step_on_card_vs_cpu(trainer, ds, device)
        profile_step(trainer, "stochastic hash", tag)
        hash_kernel.hash_encode_kernel.launches = 0
        torch.cuda.synchronize()
        serve_trained(trainer, ds, hash_dir, 64, tag)
        torch.cuda.synchronize()
        hash_launches["hash_forward/serving_path"] = (
            hash_kernel.hash_encode_kernel.launches)
        print("launches while serving the trained hash model (exact "
              f"forward): {hash_launches['hash_forward/serving_path']}")
        check(hash_launches["hash_forward/serving_path"] > 0,
              "the served hash frames went through the forward kernel")
        del trainer, ds
    torch.cuda.empty_cache()

    kernels = [
        ("cp_forward", cp_kernel.cp_encode_kernel, cp_kernel.cp_encode_plain,
         "lines", "human_body_reconstruction_tpu/ops/cp_pallas.py:143", CP_TOL),
        ("dense_forward", dense_kernel.dense_encode_kernel,
         dense_kernel.dense_encode_plain, "dense",
         "human_body_reconstruction_tpu/ops/dense_pallas.py:125", DENSE_TOL),
    ]
    with tempfile.TemporaryDirectory() as run_dir:
        occ_frac = write_run_dir(run_dir, device)
        args = serve.build_parser().parse_args([
            "--ckpt_dir", run_dir, "--model_name", "flagship", "--use_occ",
            "--device", "cuda"])
        server = serve.RenderServer(args)
    cfg = server.base_cfg
    print(f"restored: levels {cfg.hash.num_levels}, n_max {cfg.hash.n_max}, "
          f"rank {cfg.hash.cp_rank}, dense levels {cfg.hash.dense_levels}, "
          f"MLP inputs {cfg.hash.out_dim}, occupied cells {occ_frac:.4f}")
    check((cfg.hash.num_levels, cfg.hash.n_max, cfg.hash.cp_rank,
           cfg.hash.dense_levels, cfg.hash.out_dim) == (7, 1448, 25, 2, 129),
          "full-width model")
    for guided in (0, 64):          # first-use costs (allocator, cuBLAS)
        warm = server.handle({"orbit": {"index": 2, "count": 4},
                              "eval_guided": guided, "no_image": True})
        check(warm["ok"], warm)

    requests = [
        {"id": "ladder128", "orbit": {"index": 0, "count": 4},
         "num_samples": 128, "eval_guided": 0},
        {"id": "guided64", "orbit": {"index": 1, "count": 4},
         "num_samples": 128, "eval_guided": 64},
        {"id": "orbit4", "batch": True, "orbit": {"count": 4},
         "num_samples": 128, "eval_guided": 64},
        {"id": "health", "cmd": "health"},
    ]
    for _, kern, *_ in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    responses = [server.handle(r) for r in requests]
    torch.cuda.synchronize()
    launches = {nm: kern.launches for nm, kern, *_ in kernels}
    for req, resp in zip(requests, responses):
        check(resp["ok"], resp)
        if "wall_s" in resp:
            pngs = resp.get("images_b64") or [resp["image_b64"]]
            check(all(base64.b64decode(p)[:8] == b"\x89PNG\r\n\x1a\n"
                      for p in pngs), "PNG payloads")
            print(f"request {req['id']}: {resp.get('frames', 1)} x "
                  f"{resp['H']}x{resp['W']}, samples {resp['num_samples']}, "
                  f"eval_guided {resp['eval_guided']}: wall {resp['wall_s']} s,"
                  f" {resp['rays_per_sec']} rays/s {tag}")
    print(f"health: {json.dumps(responses[-1])}")
    print(f"launches while serving (forward kernels): {launches}")
    check(all(n > 0 for n in launches.values()), launches)

    # each kernel against its plain version at the serving shape, on a chunk
    # of a frame's ladder and on uniform random points
    field, scene = server.field, server.scene
    gen = torch.Generator(device).manual_seed(SEED + 2)
    xn = torch.rand((N_POINTS, 3), generator=gen, device=device) * 1.5 - 0.25
    pts = scene["mu"] + xn * scene["sigma"]
    chunk = serving_chunk_points(
        cfg.render, [[400.0, 0, 200.0], [0, 400.0, 200.0], [0, 0, 1]],
        orbit_poses(4)[0], device, 128)
    check(chunk.shape == (N_POINTS, 3), ("serving chunk", chunk.shape))
    report = []
    h = cfg.hash
    d = h.dense_levels * h.features_per_level
    fwd_ops = {"cp_forward": N_POINTS * len(field.lines)
               * (h.cp_rank * 11 + 3 * 6),
               "dense_forward": N_POINTS * h.dense_levels
               * (28 + 17 * h.features_per_level)}
    for nm, kern, plain, attr, replaces, tol in kernels:
        tables = list(getattr(field, attr))
        for kind, at in (("path", chunk), ("random", pts)):
            a = (tables, at, scene["mu"], scene["sigma"], cfg.hash)
            xa = (at - scene["mu"]) / scene["sigma"]
            outside = float(((xa < 0) | (xa > 1)).any(-1).float().mean())
            # the dense kernel on the path writes its columns of the
            # encoder's (N, 129) matrix, as encode_params hands it them
            kw, where = {}, ""
            if nm == "dense_forward" and kind == "path":
                mat = torch.full((N_POINTS, h.out_dim), float("nan"),
                                 device=device)
                kw = {"out": mat[:, :d]}
                where = "into the (N, 129) matrix's first columns"
            lib = ""
            with torch.no_grad():
                got, want = kern(*a, **kw), plain(*a)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(bool(torch.isfinite(got).all())
                      and got.shape == want.shape,
                      f"{nm} output finite, of the plain version's shape")
                if kw:
                    check(bool(mat[:, d:].isnan().all()),
                          "the matrix's other columns untouched")
                ms = time_ms(lambda: kern(*a, **kw))
                plain_ms = time_ms(lambda: plain(*a))
                lib_ms = None
                if nm == "dense_forward":
                    lib_ms = time_ms(lambda gs=grid_sample_inputs(
                        tables, at, scene["mu"], scene["sigma"], h):
                        grid_sample_levels(gs))
                    lib = f", grid_sample {lib_ms:.4f} ms"
                if kw:
                    lib += (f", contiguous (N, {d}) "
                            f"{time_ms(lambda: kern(*a)):.4f} ms")
            bnd = bound(nbytes(at, got, *tables), fwd_ops[nm])
            print(f"kernel {nm}: {N_POINTS} {kind} points ({outside:.3f} "
                  f"outside the box) {where}, out {tuple(got.shape)}, "
                  f"max_abs_err {err:.3e} (tol {tol:g}), {ms:.4f} ms vs plain "
                  f"{plain_ms:.4f} ms{lib}, bound {bnd[0]:.4f} ms ({bnd[1]}) "
                  f"{tag}")
            check(err <= tol, (nm, kind, err))
            if kind == "path":
                shape = (f"{N_POINTS} points: a 16384-ray chunk of a 400x400 "
                         f"frame's 128-sample ladder{', ' + where if kw else ''}"
                         "; launches while serving")
                rec = (f"{nm}/serving_path", launches[nm])
            else:
                shape = (f"{N_POINTS} uniform random points; launches while "
                         "training")
                rec = (f"{nm}/random", train_launches[nm])
            report.append(entry(rec[0], SOURCE, replaces, rec[1], err, ms,
                                plain_ms, lib_ms, bnd, shape))
    for nm, replaces in (
            ("cp_backward", "human_body_reconstruction_tpu/ops/cp_pallas.py:173"),
            ("dense_backward",
             "human_body_reconstruction_tpu/ops/dense_pallas.py:152")):
        for (phase, kind), (err, ms, plain_ms, lib_ms, bnd) in bwd[nm].items():
            n = TRAIN_POINTS[0] if phase == "guided" else TRAIN_POINTS[1]
            report.append(entry(
                f"{nm}/{phase}_{kind}", SOURCE, replaces,
                phase_launches[phase][nm], err, ms, plain_ms, lib_ms, bnd,
                f"{n} {'path' if kind == 'path' else 'uniform random'} points "
                f"of a {phase} step; launches in the {phase} training steps"))
    report.append(entry(
        "uniform_bits", "human_body_reconstruction_tpu_torch/csrc/rng.cu",
        "human_body_reconstruction_tpu/ops/pallas_rng.py:30",
        hash_launches["uniform_bits"], *hash_report["uniform_bits"]))
    hash_src = "human_body_reconstruction_tpu_torch/csrc/hash.cu"
    shapes = {"train_path": f"{HASH_POINTS} points of a hash-grid training "
                            "step's ray batch, stochastic; launches in the "
                            "timed hash training steps",
              "random": f"{HASH_POINTS} uniform random points, stochastic; "
                        "launches in the timed hash training steps",
              "serving_path": f"{16384 * 64} points: a 16384-ray chunk of a "
                              "served 400x400 frame's 64-sample ladder, "
                              "exact; launches while serving the trained "
                              "hash model"}
    for nm, replaces in (
            ("hash_forward", "none (no TPU kernel: human_body_reconstruction_"
             "tpu/ops/hash_encoding.py:232,259 gather in jnp)"),
            ("hash_backward", "none (no TPU kernel: the autodiff scatter of "
             "human_body_reconstruction_tpu/ops/hash_encoding.py:232,259)")):
        for kind, shape in shapes.items():
            key = f"{nm}/{kind}"
            if key in hash_report:
                report.append(entry(
                    key, hash_src, replaces,
                    hash_launches.get(key, hash_launches[nm]),
                    *hash_report[key], shape))

    # a whole frame through the kernels (card) vs the plain versions (CPU)
    K = torch.tensor([[185.0, 0, 64.0], [0, 185.0, 64.0], [0, 0, 1]])

    c2w = torch.as_tensor(orbit_poses(4)[3])
    frame_cfg = server._cfg_for(64)
    img = step.render_image(field, scene, 128, 128, K.to(device),
                            c2w.to(device), frame_cfg, occ=server.occ,
                            num_samples=128, bf16=True).cpu()
    cpu = torch.device("cpu")
    field_cpu = copy.deepcopy(field).to(cpu)
    ref = step.render_image(
        field_cpu, {k: v.to(cpu) for k, v in scene.items()}, 128, 128, K,
        c2w, frame_cfg, occ=type(server.occ)(*(t.to(cpu) for t in server.occ)),
        num_samples=128, bf16=True)
    frame_err = float((img - ref).abs().max())
    print(f"frame 128x128 eval_guided 64: kernels (card) vs plain (CPU) "
          f"max_abs_err {frame_err:.3e} mean {float((img - ref).abs().mean()):.3e}"
          f" (tol {FRAME_TOL:g}); image range [{float(img.min()):.4f}, "
          f"{float(img.max()):.4f}]")
    check(bool(torch.isfinite(img).all()) and img.shape == (128, 128, 3),
          "frame finite and (128, 128, 3)")
    check(float(img.std()) > 1e-3, "frame not blank")
    check(frame_err <= FRAME_TOL, ("frame", frame_err))

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
