"""Novel-view rendering from a run directory (counterpart of the JAX
cli/render.py, same flags and summary JSON).

Restore the checkpoint, its config and bounds (``pipeline/restore.py``),
render a camera set, write one PNG per view (the port's own encoder,
``data/png.py``: no Pillow needed) and ``<tag>_render.json``.

Camera sources (exactly one):
  --data_path transforms.json   every frame of a dataset, with its PSNR
                                against the dataset's image
  --orbit N                     N poses on a circle (--radius, --elevation)
  --poses file.npy              an (M, 4, 4) c2w stack; intrinsics from
                                --height/--width/--camera_angle_x

--use_occ reuses the occupancy grid saved in the checkpoint; with it,
--eval_guided K renders K deterministic guided samples a ray.  --bf16 runs
the MLP in bf16 compute (f32 accumulation), as in training.
--hierarchical adds the second pass, its quantiles drawn from a generator
seeded 0, the same for every chunk (JAX: one fixed key); --use_sdf names
an SDF model when there is no saved config.  --gif writes
a turntable GIF through Pillow, imported only then; without Pillow it
exits with a message.  The port adds ``--device`` (default cuda; without a
card it exits unless given ``--device cpu``).  ``--fused`` renders each
frame as one dispatch (``step.render_image_fused``: on the card the replay
of a captured frame, the same chunks as the eager loop; on the CPU the eager
loop).  Refused: ``--aot_cache`` (the JAX compile cache).

Run:  python -m human_body_reconstruction_tpu_torch.cli.render \\
          --ckpt_dir results --model_name default --orbit 12 \\
          --out_dir renders
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        description="Render novel views from a checkpoint (PyTorch/CUDA)")
    # run directory / model identity (shared with cli/nerf2mesh.py)
    p.add_argument("--ckpt_dir", type=str, default="results")
    p.add_argument("--model_name", type=str, default="default")
    p.add_argument("--bound_pth", type=str, default="bounds_model.npy")
    p.add_argument("--ckpt_name", type=str, default="N_2048_T_16")
    p.add_argument("--use_sdf", action="store_true")
    p.add_argument("--max_res", type=float, default=2048)
    p.add_argument("--hash_size", type=float, default=16)
    p.add_argument("--encoder_variant", type=str, default=None,
                   choices=["corner", "cell", "cp"])
    p.add_argument("--rgb_elu", action="store_true")
    p.add_argument("--normalization", type=str, default=None,
                   choices=["diagonal", "unit_box"],
                   help="override the saved config's normalization")
    # render-time choices
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--num_samples", type=int, default=256)
    p.add_argument("--hierarchical", action="store_true")
    p.add_argument("--chunk", type=int, default=16384)
    p.add_argument("--fused", action="store_true",
                   help="whole-frame one-dispatch render "
                        "(render_image_fused: a captured CUDA graph a frame "
                        "shape); mutually exclusive with --aot_cache")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 MLP compute during render (as in "
                        "training)")
    p.add_argument("--use_occ", action="store_true",
                   help="reuse the trained occupancy grid saved in the "
                        "checkpoint for empty-space culling")
    p.add_argument("--eval_guided", type=int, default=0,
                   help="render each ray with this many deterministic "
                        "occupancy-guided samples instead of the full "
                        "--num_samples ladder (requires --use_occ; "
                        "--num_samples becomes the probe count)")
    p.add_argument("--aot_cache", type=str, default="",
                   help="not ported (the JAX compile cache); refused")
    # camera sources
    p.add_argument("--data_path", type=str, default=None,
                   help="transforms*.json: render its frames, report "
                        "PSNR vs the GT images")
    p.add_argument("--orbit", type=int, default=0,
                   help="render N synthesized orbit poses")
    p.add_argument("--poses", type=str, default=None,
                   help=".npy with an (M, 4, 4) c2w stack")
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--elevation", type=float, default=0.5)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--camera_angle_x", type=float, default=0.6911112,
                   help="horizontal FoV for orbit/poses intrinsics "
                        "(default = blender-synthetic lego)")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--max_views", type=int, default=None,
                   help="cap the number of rendered views")
    p.add_argument("--stride", type=int, default=1,
                   help="render every k-th view of the camera set")
    # output
    p.add_argument("--out_dir", type=str, default="renders")
    p.add_argument("--tag", type=str, default=None,
                   help="output filename prefix (default: model_name)")
    p.add_argument("--gif", action="store_true",
                   help="also write an animated turntable GIF of the "
                        "rendered views (needs Pillow)")
    p.add_argument("--gif_fps", type=float, default=8.0)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def check_supported(args):
    """Refuse what the port cannot run, before any work starts."""
    if args.aot_cache:
        raise SystemExit("--aot_cache (the JAX compile cache) is not ported "
                         "to the PyTorch package")


def cameras_from_args(args):
    """The camera set: (c2ws (M, 4, 4), K (3, 3), H, W, gt images or None),
    numpy float32."""
    sources = [args.data_path is not None, args.orbit > 0,
               args.poses is not None]
    if sum(sources) != 1:
        raise SystemExit("pass exactly one of --data_path / --orbit N / "
                         "--poses")
    if args.data_path:
        from human_body_reconstruction_tpu_torch.data import datasets

        ds = datasets.load_nerf_json(args.data_path,
                                     white_background=args.white_background,
                                     downscale=args.downscale)
        return (np.asarray(ds["c2ws"], np.float32),
                np.asarray(ds["K"], np.float32), ds["H"], ds["W"],
                np.asarray(ds["images"], np.float32))
    H, W = args.height, args.width
    focal = W / (2.0 * np.tan(args.camera_angle_x / 2.0))
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    if args.orbit:
        from human_body_reconstruction_tpu_torch.data import synthetic

        c2ws = synthetic.orbit_poses(args.orbit, radius=args.radius,
                                     elevation=args.elevation)
    else:
        c2ws = np.load(args.poses).astype(np.float32)
        if c2ws.ndim == 2:
            c2ws = c2ws[None]
        if c2ws.shape[-2:] != (4, 4):
            raise SystemExit(f"--poses must hold (M, 4, 4) c2w matrices, "
                             f"got {c2ws.shape}")
    return (c2ws, K, H, W, None)


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_supported(args)

    import torch

    from human_body_reconstruction_tpu_torch.cli import device_from_flag, psnr
    from human_body_reconstruction_tpu_torch.data import png
    from human_body_reconstruction_tpu_torch.pipeline import restore
    from human_body_reconstruction_tpu_torch.train import step as step_lib

    device = device_from_flag(args.device)
    if args.gif:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit("--gif needs Pillow, which is not installed; "
                             "the PNGs need nothing") from None
    # a bad camera spec fails before the restore
    c2ws, K, H, W, gt = cameras_from_args(args)

    res = restore.restore(
        args.ckpt_dir, args.model_name, device=device,
        bound_pth=args.bound_pth, ckpt_name=args.ckpt_name, near=args.near,
        far=args.far, hierarchical=args.hierarchical, use_sdf=args.use_sdf,
        max_res=args.max_res, hash_size=args.hash_size,
        encoder_variant=args.encoder_variant, rgb_elu=args.rgb_elu,
        normalization=args.normalization, with_occ=args.use_occ)
    occ = res.occ
    if args.use_occ and occ is None:
        print("--use_occ: checkpoint carries no occupancy grid; "
              "rendering unculled")
    cfg = res.cfg
    if args.eval_guided > 0:
        if occ is None:
            raise SystemExit("--eval_guided needs the trained occupancy "
                             "grid: pass --use_occ (and train with "
                             "occupancy enabled)")
        cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render,
                                            eval_guided=args.eval_guided))

    idx = list(range(0, len(c2ws), max(1, args.stride)))
    if args.max_views is not None:
        idx = idx[:args.max_views]

    os.makedirs(args.out_dir, exist_ok=True)
    tag = args.tag or args.model_name
    K_t = torch.as_tensor(K, device=device)
    views, psnrs, frames = [], [], []
    graphs = step_lib.FrameGraphs()
    t0 = time.perf_counter()
    for i in idx:
        if args.fused:
            img = step_lib.render_image_fused(
                res.field, res.scene, H, W, K_t,
                torch.as_tensor(c2ws[i], device=device), cfg, occ=occ,
                num_samples=args.num_samples, hierarchical=args.hierarchical,
                chunk=min(args.chunk, H * W), bf16=args.bf16,
                graphs=graphs).cpu().numpy()
        else:
            img = step_lib.render_image(
                res.field, res.scene, H, W, K_t,
                torch.as_tensor(c2ws[i], device=device), cfg, occ=occ,
                num_samples=args.num_samples,
                hierarchical=args.hierarchical, chunk=args.chunk,
                bf16=args.bf16).cpu().numpy()
        path = os.path.join(args.out_dir, f"{tag}_{i:04d}.png")
        frame = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        png.write_png(path, frame)
        if args.gif:
            frames.append(Image.fromarray(frame))
        rec = {"view": i, "path": path}
        if gt is not None:
            rec["psnr"] = psnr(img, gt[i])
            psnrs.append(rec["psnr"])
            print(f"view {i:4d}: PSNR {rec['psnr']:.2f} dB -> {path}")
        else:
            print(f"view {i:4d} -> {path}")
        views.append(rec)
    wall = time.perf_counter() - t0

    summary = {
        "model_name": args.model_name,
        "num_views": len(views),
        "H": H, "W": W,
        "num_samples": args.num_samples,
        "eval_guided": args.eval_guided,
        "use_occ": bool(args.use_occ and occ is not None),
        "wall_s": round(wall, 2),
        "rays_per_sec": round(len(views) * H * W / max(wall, 1e-9), 1),
        "views": views,
    }
    if psnrs:
        summary["mean_psnr"] = float(np.mean(psnrs))
    if args.gif and frames:
        gif_path = os.path.join(args.out_dir, f"{tag}_turntable.gif")
        frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / max(args.gif_fps, 0.1)), loop=0)
        summary["gif"] = gif_path
        print(f"wrote {gif_path}")
    out_json = os.path.join(args.out_dir, f"{tag}_render.json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{len(views)} views in {wall:.1f}s "
          f"({summary['rays_per_sec']/1e3:.1f}k rays/s)"
          + (f", mean PSNR {summary['mean_psnr']:.2f} dB" if psnrs else "")
          + f"; wrote {out_json}")
    return summary


if __name__ == "__main__":
    main()
