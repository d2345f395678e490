"""Served-frame traffic: one viewer in a closed loop against the program's
``RenderServer.handle``.

Set-up makes the configuration's weights from the seed (at the traffic's
``weights_scale``, with ``density_bias`` added to the density output, so
that the subject is opaque and every layer shapes the frame's colours, as
in a trained field) and an occupancy grid occupied inside
``subject_radius`` of the subject, saves them as a run directory (the
checkpoint with its grid, the scene's bounds, the config), starts the
server on it, and renders the cell's frame shape ``warm_frames`` times (the
first captures the frame's graph).  The window sends requests one after
another, each a pose on the orbit drawn from the seed with the cell's
size and guided sample count, the image returned as PNG in base64; each
frame is timed from sending the request to holding the response.  A traced
run profiles ``trace_frames`` frames from frame ``trace_from_frame``.  After
the window, a sample of ``check_frames`` served frames drawn from the seed
is decoded and compared with the reference's render of its pose.
"""

from __future__ import annotations

import base64
import math
import os
import statistics
import time
import types

import numpy as np
import torch

from benchmark import cells, correct, inputs
from benchmark import trace as trace_lib
from benchmark.reference import field as ref
from benchmark.traffic.train import CONTROL, sync


def _run_dir(cfg, p, weights, tr, lo, hi, d: str, device) -> dict:
    """Write the served run directory into ``d``; returns the grid."""
    from human_body_reconstruction_tpu_torch.models.nerf import Field
    from human_body_reconstruction_tpu_torch.ops.occupancy import OccupancyGrid
    from human_body_reconstruction_tpu_torch.train import checkpoint as ckpt
    from human_body_reconstruction_tpu_torch.utils import config as C

    res = p["render"]["occupancy_resolution"]
    density, mask, _ = inputs.subject_grid(res, lo, hi, tr["subject_radius"],
                                           device)
    field = Field(cfg, device=device)
    inputs.load_into(field, weights)
    thr = torch.tensor(p["render"]["occ_threshold"], device=device)
    ckpt.save_params(os.path.join(d, "bench_ckpt.npz"), field,
                     extra=ckpt.occ_extras(OccupancyGrid(density, mask, thr)))
    ckpt.save_bounds(os.path.join(d, "bounds_model.npy"), lo.cpu().numpy(),
                     hi.cpu().numpy())
    C.to_json(cfg, os.path.join(d, "bench_config.json"))
    return {"density": density, "mask": mask}


def _request(pose, tr, k: int) -> dict:
    return {"c2w": pose.tolist(), "height": tr["height"],
            "width": tr["width"], "eval_guided": tr["eval_guided"],
            "camera_angle_x": tr["camera_angle_x"], "id": k}


def run(cell, seed: int, seconds: float, trace: bool, device,
        extra_readings: bool = False) -> dict:
    t0 = time.perf_counter()
    from human_body_reconstruction_tpu_torch.cli import serve

    tr, p = cell.traffic, cell.config["pipeline"]
    cfg = cells.program_config(p)
    sc = tr["scene"]
    cameras = {"H": sc["H"], "W": sc["W"],
               "K": inputs.intrinsics(sc["H"], sc["W"], sc["focal"], device),
               "c2ws": torch.as_tensor(np.stack([
                   inputs.orbit_pose(2 * math.pi * k / sc["n_views"],
                                     sc["radius"], sc["elevation"])
                   for k in range(sc["n_views"])]), device=device)}
    lo, hi = ref.bounds_of(cameras, sc["near"], sc["far"])
    weights = inputs.make_weights(p, seed, device, tr["weights_scale"])
    density_out = f"mlp.sig.{p['mlp']['num_sig']}.b"
    weights[density_out][0] += tr["density_bias"]
    scratch = cells.scratch()
    run_dir = scratch.name
    grid = _run_dir(cfg, p, weights, tr, lo, hi, run_dir, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    args = serve.build_parser().parse_args([
        "--ckpt_dir", run_dir, "--model_name", "bench",
        "--bound_pth", os.path.join(run_dir, "bounds_model.npy"),
        "--use_occ", "--eval_guided", str(tr["eval_guided"]),
        "--device", device.type])
    server = serve.RenderServer(args)
    scratch.cleanup()
    rng = np.random.default_rng(seed)

    def pose():
        th, el = rng.uniform(0, 2 * math.pi), rng.uniform(*tr["elevation"])
        return inputs.orbit_pose(th, tr["radius"], el)

    for k in range(tr["warm_frames"]):
        resp = server.handle(_request(pose(), tr, -1 - k))
        if not resp.get("ok"):
            raise RuntimeError(f"warm-up frame refused: {resp}")
    sync(device)
    setup_s = time.perf_counter() - t0

    poses, lat, walls, images, failed = [], [], [], [], 0
    seg, seg_done, seg_frames = None, None, None
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        k = len(poses)
        if trace and seg is None and seg_done is None and (
                k == tr["trace_from_frame"]):
            seg = trace_lib.Segment()
        poses.append(pose())
        req = _request(poses[-1], tr, k)
        a = time.perf_counter()
        with trace_lib.span("RenderServer.handle"):
            resp = server.handle(req)
        lat.append(time.perf_counter() - a)
        ok = resp.get("ok") and "image_b64" in resp
        failed += not ok
        walls.append(resp.get("wall_s", math.nan))
        images.append(resp.get("image_b64") if ok else None)
        if seg is not None and k + 1 == tr["trace_from_frame"] + tr[
                "trace_frames"]:
            seg.close()
            seg_done, seg, seg_frames = seg, None, tr["trace_frames"]
    if seg is not None:
        seg.close()
        seg_done, seg_frames = seg, len(poses) - tr["trace_from_frame"]
    sync(device)
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()

    n = len(poses)
    segment = None
    if seg_done is not None:
        segment = trace_lib.reduce(seg_done)
        del seg_done
        segment["run"] = types.SimpleNamespace(
            kind="serve", p=p, frames=seg_frames,
            rays=tr["height"] * tr["width"], samples=tr["eval_guided"],
            chunk=args.chunk,
            host_s=[la - wa for la, wa in zip(lat, walls)])
    pick = np.random.default_rng(seed + 1).choice(
        n, size=min(tr["check_frames"], n), replace=False)
    readings = _readings(p, tr, weights, grid, lo, hi, poses, images, pick,
                         device, extra_readings)
    p95 = statistics.quantiles(lat, n=20)[-1] if n >= 2 else math.nan
    return {"setup_s": setup_s, "attempted": n, "failed": failed,
            "metrics": {"frames_per_s": (n / window_s, "frames/s"),
                        "frame_p95_ms": (p95 * 1e3, "ms")},
            "memory_peak_bytes": peak, "segment": segment,
            "readings": readings}


def _readings(p, tr, weights, grid, lo, hi, poses, images, pick, device,
              extra: bool) -> dict:
    """The sampled frames' widest gap and mismatched share (a frame that
    never came reads infinite); with ``extra``, the control's and those of
    an answer altered in one pixel."""
    H, W = tr["height"], tr["width"]
    focal = W / (2.0 * math.tan(tr["camera_angle_x"] / 2.0))
    K = torch.tensor([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    scene = ref.scene_of(lo, hi)
    rounds = {"": torch.bfloat16}
    if extra:
        rounds["control."] = CONTROL
    worst = {}

    def note(tag, png8, frame):
        g = correct.frame_gaps(png8, frame)
        old = worst.get(tag, (0.0, 0.0))
        worst[tag] = (max(old[0], g[0]), max(old[1], g[1]))

    with ref.no_tf32():
        for i in pick:
            c2w = torch.as_tensor(poses[i], device=device)
            frames = {tag: ref.frame(weights, p, scene, grid, K, c2w, H, W,
                                     tr["eval_guided"], ref.Rounding(dt))
                      for tag, dt in rounds.items()}
            if images[i] is None:
                worst[""] = (math.inf, math.inf)
            else:
                note("", correct.decode_png(base64.b64decode(images[i])),
                     frames[""])
            if extra:
                note("control.", correct.levels(frames["control."]),
                     frames[""])
                altered = correct.levels(frames[""])
                altered[H // 2, W // 2] = 255 - altered[H // 2, W // 2]
                note("altered.", altered, frames[""])
    out = {}
    for tag, (gap, share) in worst.items():
        out[f"{tag}frame_gap"], out[f"{tag}frame_mismatch"] = gap, share
    return out
