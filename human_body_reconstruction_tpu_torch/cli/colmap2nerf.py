"""COLMAP -> transforms.json CLI, flag-compatible with the reference
(colmap2nerf.py:27-48): --video_in --video_fps --time_slice --run_colmap
--colmap_matcher --colmap_db --colmap_camera_model --colmap_camera_params
--images --text --aabb_scale --skip_early --keep_colmap_coords --out
--vocab_path --overwrite --mask_categories.

The port's copy of the JAX CLI, flag for flag, over the port's
``pipeline/capture.py`` and ``pipeline/masking.py``: PNG frames need neither
cv2 nor Pillow (the per-frame sharpness of another format needs cv2, else
``--no_sharpness``); ``--video_in`` needs ffmpeg, ``--run_colmap`` COLMAP
and ``--mask_categories`` torchvision's Mask R-CNN weights.

Run: python -m human_body_reconstruction_tpu_torch.cli.colmap2nerf \
         --text colmap_text --images images --out transforms.json
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(
        description="Convert a COLMAP text export to nerf-format "
                    "transforms.json; optionally extract video frames and "
                    "run COLMAP first.")
    p.add_argument("--video_in", default="")
    p.add_argument("--video_fps", default=2, type=float)
    p.add_argument("--time_slice", default="",
                   help="t1,t2 seconds range of the video to use")
    p.add_argument("--run_colmap", action="store_true")
    p.add_argument("--colmap_matcher", default="sequential",
                   choices=["exhaustive", "sequential", "spatial",
                            "transitive", "vocab_tree"])
    p.add_argument("--colmap_db", default="colmap.db")
    p.add_argument("--colmap_camera_model", default="OPENCV",
                   choices=["SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL",
                            "RADIAL", "OPENCV", "SIMPLE_RADIAL_FISHEYE",
                            "RADIAL_FISHEYE", "OPENCV_FISHEYE"])
    p.add_argument("--colmap_camera_params", default="")
    p.add_argument("--images", default="images")
    p.add_argument("--text", default="colmap_text")
    p.add_argument("--aabb_scale", default=32,
                   choices=["1", "2", "4", "8", "16", "32", "64", "128"])
    p.add_argument("--skip_early", default=0, type=int)
    p.add_argument("--keep_colmap_coords", action="store_true")
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--vocab_path", default="")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--mask_categories", nargs="*", type=str, default=[],
                   help="COCO categories to mask out: writes a "
                        "dynamic_mask_<frame>.png per frame (Mask R-CNN) "
                        "and records mask_path in the transforms "
                        "(reference colmap2nerf.py:394-440)")
    p.add_argument("--mask_score_thresh", type=float, default=0.5,
                   help="detector score threshold for --mask_categories")
    p.add_argument("--no_sharpness", action="store_true",
                   help="skip per-frame Laplacian sharpness")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.pipeline import capture

    if args.video_in:
        capture.run_ffmpeg(args.video_in, args.images, fps=args.video_fps,
                           time_slice=args.time_slice)
    text = args.text
    if args.run_colmap:
        text = capture.run_colmap(
            args.images, db=args.colmap_db, matcher=args.colmap_matcher,
            camera_model=args.colmap_camera_model,
            camera_params=args.colmap_camera_params,
            vocab_path=args.vocab_path,
            text=args.text if args.text != "colmap_text" else None)
    out = capture.build_transforms(
        text, args.images, aabb_scale=int(args.aabb_scale),
        skip_early=args.skip_early,
        keep_colmap_coords=args.keep_colmap_coords,
        compute_sharpness=not args.no_sharpness,
        json_dir=os.path.dirname(args.out) or ".")
    if args.mask_categories:
        from human_body_reconstruction_tpu_torch.pipeline import masking

        masking.apply_mask_categories(
            out, args.mask_categories,
            json_dir=os.path.dirname(args.out) or ".",
            score_thresh=args.mask_score_thresh)
        print(f"wrote dynamic masks for {len(out['frames'])} frames "
              f"({' '.join(args.mask_categories)})")
    capture.write_transforms(out, args.out)
    print(f"{len(out['frames'])} frames -> {args.out}")


if __name__ == "__main__":
    main()
