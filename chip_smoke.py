#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

1. Build the port's CUDA kernels from csrc/ with nvcc.
2. Write a full-width (flagship preset) run directory in the JAX layout:
   seeded random weights, config JSON, bounds, and an occupancy grid whose
   mask is a seeded ball around the subject.
3. Restore it through the port's server and answer a 400x400 frame on the
   128-sample ladder, one at eval_guided 64, a 4-pose orbit batch and a
   health request, with every kernel's launch count reset just before.
4. Hold each kernel against its plain PyTorch version on the card at the
   serving shapes (2,097,152 points, about 70% of them outside the unit
   box of normalised coordinates), and a whole frame rendered through the
   kernels against the same frame through the plain versions (on the CPU).

Any failure ends the run with a nonzero exit.  Output: the card's name and
power limit, per-request and per-kernel lines, then one JSON line listing
the kernels, and last ``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py      (needs one CUDA card; exits 2 without one)
"""

from __future__ import annotations

import base64
import copy
import json
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
N_POINTS = 16384 * 128          # one ladder chunk: 16384 rays x 128 samples
CP_TOL = 1e-6                   # kernel vs plain: same operations, same order
DENSE_TOL = 1e-6
FRAME_TOL = 1e-3                # card vs CPU: f32 math on two devices, bf16 MLP


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from human_body_reconstruction_tpu_torch.cli import serve
    from human_body_reconstruction_tpu_torch.ops import (
        cp_kernel, cuda_lib, dense_kernel)
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
    print(f"launches while serving: {launches}")
    check(all(n > 0 for n in launches.values()), launches)

    # each kernel against its plain version at the serving shapes
    field, scene = server.field, server.scene
    gen = torch.Generator(device).manual_seed(SEED + 2)
    xn = torch.rand((N_POINTS, 3), generator=gen, device=device) * 1.5 - 0.25
    pts = scene["mu"] + xn * scene["sigma"]
    outside = float(((xn < 0) | (xn > 1)).any(-1).float().mean())
    report = []
    for nm, kern, plain, attr, replaces, tol in kernels:
        tables = list(getattr(field, attr))
        a = (tables, pts, scene["mu"], scene["sigma"], cfg.hash)
        with torch.no_grad():
            got, want = kern(*a), plain(*a)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                  f"{nm} output finite, of the plain version's shape")
            ms = time_ms(lambda: kern(*a))
            plain_ms = time_ms(lambda: plain(*a))
        print(f"kernel {nm}: {N_POINTS} points ({outside:.3f} outside the "
              f"box), out {tuple(got.shape)}, max_abs_err {err:.3e} (tol "
              f"{tol:g}), {ms:.4f} ms vs plain {plain_ms:.4f} ms {tag}")
        check(err <= tol, (nm, err))
        report.append({"name": nm, "route": "cuda",
                       "source": "human_body_reconstruction_tpu_torch/csrc/encoders.cu",
                       "replaces": replaces, "launches": launches[nm],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # a whole frame through the kernels (card) vs the plain versions (CPU)
    K = torch.tensor([[185.0, 0, 64.0], [0, 185.0, 64.0], [0, 0, 1]])
    from human_body_reconstruction_tpu_torch.data.synthetic import orbit_poses

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
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
