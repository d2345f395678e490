"""Hash-NeRF training CLI of the port (counterpart of the JAX
cli/train_hash.py).

The flag surface and the preset resolution are the JAX module's own
(``build_parser`` and ``resolve_preset``, which import no JAX), plus
``--device``.  The zero-flag run is the flagship: CP factor lines at rank
25 over 7 levels up to n_max 1448 with two dense coarse grids, a
256^3 occupancy grid engaged after 256 warmup steps, then guided mass-dt
stratified placement of 48 samples from 32 probes, and factor-line TV 1e-2
from step 320.  What the port does not run yet is refused with a message:
the hashed encoders, SDF mode, hierarchical sampling, data/level
parallelism, fused multi-step dispatches, the compiled-executable cache,
resume, gradient-norm logging, the live preview and the humanoid/tangle
synthetic subjects.

Run:  python -m human_body_reconstruction_tpu_torch.cli.train_hash \\
          --synthetic --synthetic_subject textured --steps 500 --device cuda
"""

from __future__ import annotations

import dataclasses
import os

import torch

from human_body_reconstruction_tpu.cli.train_hash import (
    build_parser as _jax_parser, resolve_preset)


def build_parser():
    p = _jax_parser()
    p.description = "Train Hashing (PyTorch port)"
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda when available, "
                        "else cpu)")
    return p


def make_config(args):
    from human_body_reconstruction_tpu_torch.ops import dense_grid
    from human_body_reconstruction_tpu_torch.utils import config as C

    r = resolve_preset(args)
    hcfg = C.HashConfig(n_max=int(r["max_res"]),
                        log2_table_size=int(args.hash_size),
                        num_levels=r["num_levels"],
                        features_per_level=args.features_per_level,
                        variant=r["variant"],
                        cp_rank=r["cp_rank"],
                        stochastic_train=args.stochastic,
                        packed=args.packed or args.packed_exact,
                        packed_exact_train=args.packed_exact,
                        pack_format=args.pack_format,
                        grad_subsample=args.grad_subsample,
                        grad_level_subsample=args.grad_level_subsample,
                        grad_level_pair=args.grad_level_pair,
                        hw_rng=args.hw_rng,
                        scatter_strategy=args.scatter_strategy,
                        dense_levels=max(r["dense_levels"], 0))
    if r["dense_levels"] < 0:
        hcfg = dataclasses.replace(
            hcfg, dense_levels=dense_grid.auto_dense_levels(hcfg))
    return C.PipelineConfig(
        hash=hcfg,
        mlp=C.MLPConfig(
            density_activation="sdf" if args.use_sdf else "leaky_relu",
            rgb_activation="elu" if args.rgb_elu else "sigmoid"),
        render=C.RenderConfig(
            near=args.near, far=args.far, num_samples=r["num_samples"],
            hierarchical=args.hierarchical, use_sdf=args.use_sdf,
            white_background=args.white_bg, occupancy=r["occupancy"],
            compact_samples=r["compact"], occ_guided=r["occ_guided"],
            occ_probes=r["occ_probes"], occ_explore=args.occ_explore,
            occ_probe_jitter=args.occ_probe_jitter, occ_dt=args.occ_dt,
            occ_stratified=r["occ_stratified"],
            occ_threshold=args.occ_threshold,
            eval_guided=args.eval_guided,
            normalization=args.normalization),
        train=C.TrainConfig(
            num_epochs=args.num_epochs, ray_batch=args.num_batch,
            update_rate=args.update_rate, seed=args.seed,
            occ_warmup_steps=args.occ_warmup,
            cp_tv_weight=r["cp_tv"],
            cp_tv_warmup=r["cp_tv_warmup"],
            sigma_l1_weight=args.sigma_l1,
            eikonal_subsample=r["eikonal_subsample"]),
    )


_NOT_PORTED = (("load", "resume"), ("data_parallel", "--data_parallel"),
               ("level_parallel", "--level_parallel"),
               ("aot_cache", "--aot_cache"), ("plot_grads", "--plot_grads"),
               ("display", "--display"), ("use_sdf", "SDF mode"),
               ("hierarchical", "hierarchical sampling"))


def check_supported(args, cfg):
    """Refuse what the port cannot run yet, before any work starts."""
    for flag, what in _NOT_PORTED:
        if getattr(args, flag):
            raise SystemExit(f"{what} is not ported to the PyTorch trainer yet")
    if args.steps_per_call != 1:
        raise SystemExit("--steps_per_call is not ported (PyTorch runs "
                         "eagerly, one step per call)")
    if cfg.hash.variant != "cp":
        raise SystemExit(f"encoder variant {cfg.hash.variant!r} is not ported; "
                         "only 'cp' (the flagship preset) is")
    if cfg.render.occupancy and not cfg.render.occ_guided and \
            0 < cfg.render.compact_samples < cfg.render.num_samples:
        raise SystemExit("top-K sample compaction (--occupancy --compact "
                         "without --occ_guided) is not ported yet")


def load_dataset(args, device):
    """-> (train_ds, eval_ds-or-None) on ``device``."""
    from human_body_reconstruction_tpu_torch.data import datasets, synthetic

    if args.synthetic or args.data_path == "synthetic":
        if args.synthetic_subject == "textured":
            # the hard benchmark scene; texture wavelengths land at ~6-13 px
            return synthetic.make_dataset(
                n_views=20, H=400, W=400, focal=440.0, near=args.near,
                far=args.far, field=synthetic.textured_field, radius=4.0,
                elevation=0.35, gt_samples=384, device=device), None
        if args.synthetic_subject == "blobs":
            return synthetic.make_dataset(n_views=12, H=96, W=96,
                                          near=args.near, far=args.far,
                                          device=device), None
        raise SystemExit(f"synthetic subject {args.synthetic_subject!r} is "
                         "not ported yet (textured, blobs are)")
    data_path = args.data_path or "data/lego/"
    json_path = os.path.join(data_path, "transforms_train.json")
    if not os.path.exists(json_path):
        json_path = os.path.join(data_path, "transforms.json")
    ds = datasets.load_nerf_json(json_path, white_background=args.white_bg,
                                 downscale=args.downscale)
    eval_ds = None
    for name in ("transforms_tmp.json", "transforms_test.json",
                 "transforms_val.json"):
        p = os.path.join(data_path, name)
        if os.path.exists(p):
            eval_ds = datasets.to_device(datasets.load_nerf_json(
                p, white_background=args.white_bg,
                downscale=args.downscale), device)
            break
    return datasets.to_device(ds, device), eval_ds


def main(argv=None):
    args = build_parser().parse_args(argv)
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    cfg = make_config(args)
    check_supported(args, cfg)
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))
    ds, eval_ds = load_dataset(args, device)

    n_pixels = int(ds["images"].shape[0]) * ds["H"] * ds["W"]
    steps_per_epoch = max(1, n_pixels // args.num_batch)
    steps = args.steps if args.steps else args.num_epochs * steps_per_epoch

    trainer = Trainer(cfg=cfg, ds=ds, out_dir=args.out_dir,
                      model_name=args.model_name, eval_ds=eval_ds,
                      total_steps=steps)
    # ~100 eval renders over a long run, never more often than every 100
    # steps (an eval render costs many training steps)
    eval_every = args.eval_every or (max(100, steps // 100) if args.write
                                     else 0)
    trainer.run(steps, log_every=args.log_every, eval_every=eval_every)
    trainer.save()
    if args.write:
        trainer.eval_render(tag="final")
    print(f"checkpoint: {trainer.ckpt_path()}")
    return trainer


if __name__ == "__main__":
    main()
