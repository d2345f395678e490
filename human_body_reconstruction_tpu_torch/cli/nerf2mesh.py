"""Mesh-export CLI (counterpart of the JAX cli/nerf2mesh.py, same flags).

Restores a run directory through ``pipeline/restore.py`` (the trainer's
``<model_name>_config.json`` preferred, flags as fallback), sweeps the
field over a ``--resolution``^3 lattice on the device, extracts the
``--iso`` level set with the native marching-tetrahedra extension and
writes PLY (per-vertex colour) or OBJ.  The density cache (``--cache``,
'' disables) has the JAX layout, so either package reads the other's.
The port adds ``--device`` (default cuda; without a card it exits unless
given ``--device cpu``).  An SDF model sweeps its 2·sigmoid−1 head, whose
zero level drifts in training (``mesh_export.export_mesh(iso="auto")``
reads a level from the sweep).  Refused:
``--aot_cache`` (the JAX compile cache is not ported).

Run:  python -m human_body_reconstruction_tpu_torch.cli.nerf2mesh \\
          --ckpt_dir results --model_name default --out mesh.ply
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="NeRF -> mesh (PyTorch/CUDA)")
    # reference surface
    p.add_argument("--use_sdf", action="store_true")
    p.add_argument("--hierarchical", action="store_true")
    p.add_argument("--max_res", type=float, default=2048)
    p.add_argument("--hash_size", type=float, default=16)
    p.add_argument("--model_name", type=str, default="default")
    p.add_argument("--bound_pth", type=str, default="bounds.npy")
    p.add_argument("--ckpt_name", type=str, default="N_2048_T_16")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    # extensions
    p.add_argument("--iso", type=float, default=30.0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--out", type=str, default="mesh.ply")
    p.add_argument("--color_mode", type=str, default="rgb",
                   choices=["rgb", "xyz"])
    p.add_argument("--cache", type=str, default="density_grid_w_rgb.npy",
                   help="density grid cache path ('' disables)")
    p.add_argument("--ckpt_dir", type=str, default="results")
    p.add_argument("--normalization", type=str, default=None,
                   choices=["diagonal", "unit_box"],
                   help="must match the trainer's --normalization "
                        "(auto-restored from <model_name>_config.json "
                        "when present; 'diagonal' otherwise)")
    p.add_argument("--chunk", type=int, default=262144)
    p.add_argument("--aot_cache", type=str, default="",
                   help="not ported (the JAX compile cache); refused")
    p.add_argument("--encoder_variant", type=str, default=None,
                   choices=["corner", "cell", "cp"],
                   help="hash layout used at training time (auto-restored "
                        "from <model_name>_config.json when present)")
    p.add_argument("--rgb_elu", action="store_true",
                   help="checkpoint was trained with --rgb_elu")
    p.add_argument("--view", action="store_true",
                   help="open the mesh in an open3d viewer; needs open3d "
                        "and a display")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def check_supported(args):
    """Refuse what the port cannot run, before any work starts."""
    if args.aot_cache:
        raise SystemExit("--aot_cache is not ported: the JAX compile cache "
                         "has no PyTorch counterpart")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_supported(args)

    from human_body_reconstruction_tpu_torch.cli import device_from_flag
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export, restore

    device = device_from_flag(args.device)
    res = restore.restore(
        args.ckpt_dir, args.model_name, device=device,
        bound_pth=args.bound_pth, ckpt_name=args.ckpt_name, near=args.near,
        far=args.far, hierarchical=args.hierarchical, use_sdf=args.use_sdf,
        max_res=args.max_res, hash_size=args.hash_size,
        encoder_variant=args.encoder_variant, rgb_elu=args.rgb_elu,
        normalization=args.normalization)
    stats = mesh_export.export_mesh(
        res.field, res.scene, res.cfg, resolution=args.resolution,
        iso=args.iso, chunk=args.chunk, cache_path=args.cache or None,
        out_path=args.out, color_mode=args.color_mode)
    print(f"wrote {stats['out_path']}: {stats['num_verts']} verts, "
          f"{stats['num_faces']} faces")
    if args.view:
        try:
            mesh_export.view_mesh(stats["verts"], stats["faces"],
                                  stats["colors"])
        except ImportError:
            print("--view requested but open3d is not installed; "
                  f"open {stats['out_path']} in any mesh viewer instead")
    return stats


if __name__ == "__main__":
    main()
