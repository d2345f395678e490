"""Time the parallel paths on 1, 2 and 4 cards of one host.

For each world size W (one process a card, NCCL, started by
``parallel.comm.spawn``): the flagship's data-parallel step at 16,000
global rays (16,000 / W a rank; the step alone, after an unculled warm-up
that installs the occupancy grid, then guided) with the all-reduce of its
gradient buffer; the hash grid's (``--stochastic --hw_rng``) level-parallel
step at extent W (W = 1: the single-device step) with the gather of one
rank's feature block; the ``--cp_rank 32`` flagship ladder's
rank-parallel step at extent W (C 160 / W a rank, the speedrun's TV on,
unculled, from one seeded field; W = 1 too through ``make_lp_train_step``)
with its first steps' losses, which every extent must take alike (held
within CP_LOSS_RTOL of one card's after the worlds have run); and the
sample-split render of a 400x400 frame at 1,024 samples over W sample
ranks.  The level-parallel steps count their kernels' launches a step.
Each of the three steps is also timed eager and as 25-step windows
(``steps_per_call`` 25: on the card one captured step, its NCCL
collectives inside, replayed a step): ms a step, and by the profiler the
host wall, device busy, NCCL ms and kernels a step of each.  Step and frame times are host clocks
around work that ends in a synchronise; collective times are CUDA events
over 20 calls; a torch.profiler window of 10 steps gives each step's host
wall, device busy and NCCL time and its largest kernels.  Every rank
renders the synthetic textured scene itself.
Writes one JSON record (each world's numbers from rank 0, with each card's
``nvidia-smi`` name and power limit) to ``--out``.

Run:  python tools/parallel_bench.py --worlds 1 2 4 \\
          --out chiprun_out/parallel_bench.json
      (``--device cpu --tiny`` rehearses it on the CPU over gloo)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from human_body_reconstruction_tpu_torch.parallel import comm  # noqa: E402

GLOBAL_RAYS = 16000
WARM, INSTALL_AT, TIMED = 40, 32, 40     # flagship steps: warm-up, grid, timed
HASH_WARM, HASH_TIMED = 5, 30
CP_RANK, CP_TV, CP_WARM, CP_TIMED = 32, 1e-2, 5, 20
CP_LOSS_RTOL = 1e-3     # the float-atomic backwards: steps differ in bits
SP_HW, SP_SAMPLES, SP_CHUNK = 400, 1024, 1024
REPS = 20
WINDOW, WINDOW_REPS = 25, 4     # --steps_per_call windows: steps, timed calls


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, device, reps: int = REPS) -> float:
    """Mean ms of fn over reps calls: CUDA events on the card, the host
    clock on the CPU (the rehearsal)."""
    for _ in range(3):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync(device)
    return start.elapsed_time(stop) / reps


def timed_steps(step, n: int, device) -> float:
    """ms a step over n calls of step(), host clock, synchronised."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def profiled(step, n: int, device, per: int = 1) -> dict:
    """torch.profiler over n calls of step(), each ``per`` steps (a window):
    per step, the host's wall ms, the device's busy ms (the union of its
    kernels' spans), the NCCL kernels' ms, the kernel count, and the
    kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync(device)
        wall = 1e3 * (time.perf_counter() - t0) / n / per
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    nccl = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    n *= per
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3 / n,
            "nccl_ms": nccl / 1e3 / n, "kernels_per_step": len(spans) / n,
            "top": [(k, v / 1e3 / n) for k, v in top]}


def eager_and_window(make, state, data, device, tiny: bool) -> dict:
    """One parallel step, eager and as a WINDOW-step window
    (``make(steps_per_call)``: on the card one captured step, its
    collectives inside, replayed): ms a step by the host clock over whole
    calls ending in a synchronise, and the profile of each (per step); and
    the ms of the ranks' agreement that opens each window
    (``comm.mesh_any``)."""
    n = 2 if tiny else WINDOW
    one, win = make(1), make(n)
    for _ in range(2):
        one(state, *data)
    win(state, *data)                   # the capture (warm-up step included)
    reps = 2 if tiny else WINDOW_REPS
    return {"window": n,
            "agree_ms": timed_steps(
                lambda: comm.mesh_any(False, win.mesh, device), REPS,
                device),
            "eager_ms": timed_steps(lambda: one(state, *data), reps * n,
                                    device),
            "window_ms": timed_steps(lambda: win(state, *data), reps,
                                     device) / n,
            "captures": win.graph.captures,
            "eager_profile": profiled(lambda: one(state, *data), 10, device),
            "window_profile": profiled(lambda: win(state, *data), 2, device,
                                       per=n)}


def counted_steps(step, n: int, device):
    """(ms a step over n calls of step(), each kernel's launches a step)."""
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, dense_kernel, hash_kernel, rng_kernel)

    kernels = {"cp_forward": cp_kernel.cp_encode_kernel,
               "cp_backward": cp_kernel.cp_encode_backward_kernel,
               "dense_forward": dense_kernel.dense_encode_kernel,
               "dense_backward": dense_kernel.dense_encode_backward_kernel,
               "hash_forward": hash_kernel.hash_encode_kernel,
               "hash_backward": hash_kernel.hash_encode_backward_kernel,
               "uniform_bits": rng_kernel.uniform_kernel}
    for k in kernels.values():
        k.launches = 0
    ms = timed_steps(step, n, device)
    return ms, {nm: k.launches / n for nm, k in kernels.items()
                if k.launches}


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index}"], capture_output=True, text=True,
        check=True).stdout.strip()


def dataset(device, tiny: bool):
    from human_body_reconstruction_tpu_torch.data import synthetic

    if tiny:
        return synthetic.make_dataset(n_views=3, H=16, W=16, focal=20.0,
                                      gt_samples=32, device=device)
    return synthetic.make_dataset(
        n_views=20, H=400, W=400, focal=440.0, field=synthetic.textured_field,
        radius=4.0, elevation=0.35, gt_samples=384, device=device)


def bench(device, tiny: bool):
    """One world's numbers (rank 0's; the others return None)."""
    import torch.distributed as dist

    from human_body_reconstruction_tpu_torch.parallel import (
        data_parallel as dp, level_parallel as lp, sample_parallel as sp)
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer
    from human_body_reconstruction_tpu_torch.utils import config as C

    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    rays = 256 if tiny else GLOBAL_RAYS
    warm, install_at, timed = (4, 2, 2) if tiny else (WARM, INSTALL_AT, TIMED)
    hash_warm, hash_timed = (1, 2) if tiny else (HASH_WARM, HASH_TIMED)
    if tiny:
        torch.set_num_threads(1)
    ds = dataset(device, tiny)
    out = {"world": world, "cards": [None] * world}
    dist.all_gather_object(out["cards"], card(device))

    # the flagship's data-parallel step
    base = C.flagship_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, ray_batch=rays, occ_warmup_steps=install_at,
        cp_tv_warmup=install_at + 64))
    if tiny:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, occupancy_resolution=16))
    work = tempfile.mkdtemp(prefix="hbr_bench_")
    tr = Trainer(cfg=cfg, ds=ds, out_dir=work,
                 model_name=f"bench_dp{world}", total_steps=warm + timed,
                 log_fn=lambda line: None, data_parallel=True)
    t0 = time.perf_counter()
    tr.run(warm, log_every=0)
    sync(device)
    warm_s = time.perf_counter() - t0
    data = (tr.scene, ds["images"], ds["c2ws"], ds["K"])
    step_ms = timed_steps(lambda: tr._step_fn(tr.state, *data), timed, device)
    grads = [p.grad for p in tr.state.field.parameters() if p.grad is not None]
    n_grad = sum(g.numel() for g in grads)
    buf = [torch.zeros(n_grad, device=device)]
    ar_ms = event_ms(lambda: comm.all_reduce_mean_(buf, tr.mesh.data_group,
                                                   world), device)
    out["dp_flagship"] = {
        "global_rays": rays, "rays_per_rank": rays // world,
        "guided_step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
        "grad_bytes": 4 * n_grad, "all_reduce_ms": ar_ms,
        "warmup_s": warm_s,
        "profile": profiled(lambda: tr._step_fn(tr.state, *data), 10, device),
        "windows": eager_and_window(
            lambda n: dp.make_dp_train_step(cfg, rays, tr.mesh,
                                            steps_per_call=n),
            tr.state, data, device, tiny)}
    out["host"] = {"cpus": os.cpu_count(), "torch_threads":
                   torch.get_num_threads(), "loadavg": os.getloadavg()}
    field = tr.state.field

    # the hash grid's level-parallel step at extent W
    hcfg = C.PipelineConfig(
        hash=C.HashConfig(num_levels=16 if not tiny else 4, n_max=2048,
                          log2_table_size=16 if not tiny else 10,
                          stochastic_train=True, hw_rng=True),
        render=C.RenderConfig(num_samples=64 if not tiny else 16),
        train=C.TrainConfig(ray_batch=rays))
    htr = Trainer(cfg=hcfg, ds=ds, out_dir=work,
                  model_name=f"bench_lp{world}", total_steps=100,
                  log_fn=lambda line: None, level_parallel=world)
    htr.run(hash_warm, log_every=0)
    if htr._step_fn is None:
        from human_body_reconstruction_tpu_torch.train import step as step_lib

        def hstep():
            step_lib.train_step(htr.state, htr.scene, ds["images"],
                                ds["c2ws"], ds["K"], hcfg, rays,
                                htr.generator)
    else:
        def hstep():
            htr._step_fn(htr.state, htr.scene, ds["images"], ds["c2ws"],
                         ds["K"])
    h_ms, h_launches = counted_steps(hstep, hash_timed, device)
    h_prof = profiled(hstep, 10, device)
    n_pts = rays * hcfg.render.num_samples
    block = torch.zeros((n_pts, hcfg.hash.out_dim // world), device=device)
    gather_ms = 0.0
    if htr.mesh is not None:
        gather_ms = event_ms(
            lambda: comm.gather_cols(block, htr.mesh.inner_group), device)
    # its windows: the level-parallel step at extent W (W = 1 too, on this
    # state cut to a (1, 1) layout)
    hmesh = htr.mesh or lp.make_lp_mesh(1, 1)
    hst = (htr.state if htr.mesh is not None
           else lp.shard_lp_state(htr.state, hcfg, hmesh, 100))
    out["lp_hash"] = {
        "extent": world, "levels_per_rank": hcfg.hash.num_levels // world,
        "points": n_pts, "step_ms": h_ms, "rays_per_s": rays / h_ms * 1e3,
        "gather_bytes_per_rank": 4 * block.numel(), "gather_ms": gather_ms,
        "launches_per_step": h_launches, "profile": h_prof,
        "windows": eager_and_window(
            lambda n: lp.make_lp_train_step(hcfg, rays, hmesh,
                                            steps_per_call=n),
            hst, (htr.scene, ds["images"], ds["c2ws"], ds["K"]), device,
            tiny)}
    del hst

    # the --cp_rank 32 ladder's rank-parallel step at extent W
    from human_body_reconstruction_tpu_torch.models import nerf
    from human_body_reconstruction_tpu_torch.train import state as state_lib

    ccfg = dataclasses.replace(
        base, hash=dataclasses.replace(base.hash, cp_rank=CP_RANK),
        train=dataclasses.replace(base.train, ray_batch=rays,
                                  cp_tv_weight=CP_TV, cp_tv_warmup=0))
    cp_warm, cp_timed = (2, 2) if tiny else (CP_WARM, CP_TIMED)
    lmesh = lp.make_lp_mesh(1, world)
    whole = state_lib.create_train_state(
        nerf.Field(ccfg, generator=torch.Generator(device).manual_seed(0)),
        ccfg.train, cp_warm + cp_timed)
    cst = lp.shard_lp_state(whole, ccfg, lmesh, cp_warm + cp_timed)
    cstep = lp.make_lp_train_step(ccfg, rays, lmesh)
    losses = [float(cstep(cst, *data)["loss"]) for _ in range(cp_warm)]
    c_ms, c_launches = counted_steps(lambda: cstep(cst, *data), cp_timed,
                                     device)
    c_pts = rays * ccfg.render.num_samples
    cols = len(cst.field.lines) * cst.field.lines[0].shape[-1]
    cblock = torch.zeros((c_pts, cols), device=device)
    out["lp_cp"] = {
        "extent": world, "rank_per_rank": CP_RANK // world,
        "columns_per_rank": cols, "points": c_pts, "step_ms": c_ms,
        "rays_per_s": rays / c_ms * 1e3, "losses": losses,
        "gather_bytes_per_rank": 4 * cblock.numel(),
        "gather_ms": event_ms(lambda: comm.gather_cols(
            cblock, lmesh.inner_group), device),
        "launches_per_step": c_launches,
        "windows": eager_and_window(
            lambda n: lp.make_lp_train_step(ccfg, rays, lmesh,
                                            steps_per_call=n),
            cst, data, device, tiny)}
    del cst, whole, cblock

    # the sample-split render over W sample ranks
    mesh = sp.make_sp_mesh(1, world)
    hw, samples = (16, 64) if tiny else (SP_HW, SP_SAMPLES)
    rcfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, eval_guided=0))
    render = sp.make_sp_render(rcfg, mesh, samples, compute_dtype=None)
    from human_body_reconstruction_tpu_torch.ops import rays as rays_lib

    K = torch.tensor([[float(hw), 0, hw / 2], [0, float(hw), hw / 2],
                      [0, 0, 1]], device=device)
    o, d, n = (t.reshape(-1, t.shape[-1]) for t in rays_lib.full_image_rays(
        hw, hw, K, ds["c2ws"][0]))

    def frame():
        return torch.cat([render(field, tr.scene, o[s:s + SP_CHUNK],
                                 d[s:s + SP_CHUNK], n[s:s + SP_CHUNK],
                                 occ=tr.state.occ)
                          for s in range(0, o.shape[0], SP_CHUNK)])

    img = frame()
    frame_ms = timed_steps(frame, 1 if not tiny else 2, device)
    out["sample_split"] = {
        "ranks": world, "frame": f"{hw}x{hw}", "samples": samples,
        "samples_per_rank": samples // world, "frame_ms": frame_ms,
        "finite": bool(torch.isfinite(img).all())}
    shutil.rmtree(work, ignore_errors=True)
    return out if rank == 0 else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tiny", action="store_true",
                   help="tiny shapes, for a rehearsal on the CPU")
    p.add_argument("--out", default="chiprun_out/parallel_bench.json")
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < max(args.worlds):
        raise SystemExit(f"{max(args.worlds)} cards asked for, "
                         f"{torch.cuda.device_count()} visible")
    records = []
    for w in args.worlds:
        t0 = time.perf_counter()
        rec = comm.spawn(bench, w, (args.tiny,), args.device)[0]
        rec["wall_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        records.append(rec)
    first = records[0]["lp_cp"]["losses"]
    worst = max(abs(a / b - 1.0) for rec in records
                for a, b in zip(rec["lp_cp"]["losses"], first))
    print(f"lp_cp: the extents' first {len(first)} losses within "
          f"{worst:.2e} of extent {records[0]['world']}'s (tol "
          f"{CP_LOSS_RTOL:g})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": args.device, "records": records,
                   "lp_cp_worst_loss_rel": worst}, f, indent=1)
    if worst > CP_LOSS_RTOL:
        raise SystemExit("the extents' rank-parallel steps differ")


if __name__ == "__main__":
    main()
