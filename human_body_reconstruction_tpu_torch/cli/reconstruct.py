"""One-command video -> mesh reconstruction pipeline.

Chains the four stages a user of the reference repo runs by hand
(README workflow: colmap2nerf.py -> Segment.py -> train_hash2.py ->
nerf2mesh.py):

  1. frames + poses: ffmpeg + COLMAP -> transforms.json,
  2. segmentation: mask the subject in every frame,
  3. training: hash-NeRF on the masked frames,
  4. export: density sweep + marching cubes -> .ply.

Run:  python -m human_body_reconstruction_tpu_torch.cli.reconstruct \
          --video_in capture.mp4 --workdir run1 --steps 30000

Stages can be skipped (--skip_poses --skip_segment ...) to resume a
partially-finished reconstruction.

The port's copy of the JAX CLI: its flags plus ``--device`` (default cuda;
without a card the run exits with a message naming ``--device cpu``),
which it hands to the port's ``train_hash`` and ``nerf2mesh``; apart from
that flag each stage's argv is the JAX one.  Training and meshing run at
the trainer's zero-flag flagship preset with 64 samples.  On a machine
without cv2, Pillow, ffmpeg or COLMAP (the card's): start from a COLMAP
text model and PNG frames (``colmap2nerf --text``, then ``--skip_poses``)
and segment with ``--segment_backend threshold``.  ``main`` returns each
stage's seconds, the trainer and the mesh's statistics.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="video -> mesh reconstruction")
    p.add_argument("--video_in", type=str, default="")
    p.add_argument("--images", type=str, default=None,
                   help="existing frame directory (skips ffmpeg)")
    p.add_argument("--workdir", type=str, default="reconstruction")
    p.add_argument("--video_fps", type=float, default=2.0)
    p.add_argument("--colmap_matcher", type=str, default="sequential")
    p.add_argument("--segment_backend", type=str, default="grabcut",
                   choices=["grabcut", "threshold", "deeplab", "sam",
                            "none"])
    p.add_argument("--steps", type=int, default=30000)
    p.add_argument("--num_batch", type=int, default=16000)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--packed", action="store_true")
    p.add_argument("--occupancy", action="store_true")
    p.add_argument("--normalization", type=str, default="diagonal",
                   choices=["diagonal", "unit_box"])
    p.add_argument("--iso", type=float, default=30.0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--skip_poses", action="store_true")
    p.add_argument("--skip_segment", action="store_true")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_mesh", action="store_true")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def main(argv=None):
    from human_body_reconstruction_tpu_torch.cli import device_from_flag

    args = build_parser().parse_args(argv)
    device_from_flag(args.device)
    seconds, trainer, mesh = {}, None, None
    t0 = time.perf_counter()
    os.makedirs(args.workdir, exist_ok=True)
    images_dir = args.images or os.path.join(args.workdir, "images")
    transforms = os.path.join(args.workdir, "transforms.json")

    # 1. poses ------------------------------------------------------------
    if not args.skip_poses:
        from human_body_reconstruction_tpu_torch.pipeline import capture

        if args.video_in:
            capture.run_ffmpeg(args.video_in, images_dir,
                               fps=args.video_fps)
        text = capture.run_colmap(
            images_dir, db=os.path.join(args.workdir, "colmap.db"),
            matcher=args.colmap_matcher)
        out = capture.build_transforms(text, images_dir,
                                       json_dir=args.workdir)
        capture.write_transforms(out, transforms)
        print(f"[poses] {len(out['frames'])} registered -> {transforms}")
        seconds["poses"] = time.perf_counter() - t0

    # 2. segmentation -----------------------------------------------------
    if not args.skip_segment and args.segment_backend != "none":
        import json

        from human_body_reconstruction_tpu_torch.pipeline import segment

        seg_dir = os.path.join(args.workdir, "SegmentedImages")
        written = segment.segment_images(
            os.path.join(images_dir, "*"), seg_dir,
            backend=args.segment_backend)
        # retarget transforms at the masked frames; file_path is resolved
        # relative to the json's own directory by the dataset reader
        with open(transforms) as f:
            meta = json.load(f)
        masked_dir = os.path.relpath(
            os.path.join(seg_dir, args.segment_backend.upper()),
            start=args.workdir)
        for fr in meta["frames"]:
            fr["file_path"] = os.path.join(
                f"./{masked_dir}", os.path.basename(fr["file_path"]))
        transforms_masked = os.path.join(args.workdir,
                                         "transforms_masked.json")
        with open(transforms_masked, "w") as f:
            json.dump(meta, f, indent=2)
        transforms = transforms_masked
        print(f"[segment] {len(written)} masked frames")
        seconds["segment"] = time.perf_counter() - t0 - sum(seconds.values())

    # 3. training ---------------------------------------------------------
    results = os.path.join(args.workdir, "results")
    if not args.skip_train:
        import shutil

        from human_body_reconstruction_tpu_torch.cli import train_hash

        # the trainer reads <data_path>/transforms_train.json
        data_dir = os.path.dirname(transforms) or "."
        train_json = os.path.join(data_dir, "transforms_train.json")
        if os.path.abspath(train_json) != os.path.abspath(transforms):
            shutil.copyfile(transforms, train_json)
        argv_train = ["--data_path", data_dir, "--steps", str(args.steps),
                      "--num_batch", str(args.num_batch),
                      "--num_samples", str(args.num_samples),
                      "--near", str(args.near), "--far", str(args.far),
                      "--out_dir", results, "--model_name", "recon",
                      "--normalization", args.normalization, "--write"]
        for flag, on in (("--stochastic", args.stochastic),
                         ("--packed", args.packed),
                         ("--occupancy", args.occupancy)):
            if on:
                argv_train.append(flag)
        trainer = train_hash.main(argv_train + ["--device", args.device])
        seconds["train"] = time.perf_counter() - t0 - sum(seconds.values())

    # 4. mesh -------------------------------------------------------------
    if not args.skip_mesh:
        from human_body_reconstruction_tpu_torch.cli import nerf2mesh

        mesh_out = os.path.join(args.workdir, "mesh.ply")
        mesh = nerf2mesh.main([
            "--ckpt_dir", results, "--model_name", "recon",
            "--bound_pth", os.path.join(results, "bounds_model.npy"),
            "--near", str(args.near), "--far", str(args.far),
            "--iso", str(args.iso), "--resolution", str(args.resolution),
            "--normalization", args.normalization,
            "--cache", os.path.join(args.workdir, "density_grid_w_rgb.npy"),
            "--out", mesh_out, "--device", args.device])
        print(f"[mesh] {mesh_out}")
        seconds["mesh"] = time.perf_counter() - t0 - sum(seconds.values())
    return {"seconds": seconds, "trainer": trainer, "mesh": mesh}


if __name__ == "__main__":
    main()
