"""Hash-NeRF training CLI of the port (counterpart of the JAX
cli/train_hash.py).

The flag surface (``build_parser``) and the preset resolution
(``resolve_preset``) are copies of the JAX module's (tests hold them equal),
plus ``--device``, which defaults to ``cuda``: without a card the CLI exits
unless given ``--device cpu``.  The zero-flag run is the flagship: CP
factor lines at rank 25 over 7 levels up to n_max 1448 with two dense
coarse grids, a 256^3 occupancy grid engaged after 256 warmup steps, then
guided mass-dt stratified placement of 48 samples from 32 probes, and
factor-line TV 1e-2 from step 320.  Any hash-path flag (``--stochastic``,
``--hw_rng``, ...) switches the preset to the reference's ``corner`` hash
grid (L 16, F 2, T 2^16, n_max 2048, 64 samples, no culling); the port runs
it exact or with ``--stochastic`` (single-corner training, exact eval),
with or without ``--hw_rng``, and every variant of the JAX trainer:
``--encoder_variant cell``, ``--packed`` (bf16 pairs, or ``--pack_format
int8`` words; evaluated through the packed-exact read), ``--packed_exact``,
``--grad_subsample``, ``--grad_level_subsample``, ``--grad_level_pair``
and ``--scatter_strategy sorted|segsum`` (ops/hash_variants.py).  ``--use_sdf`` trains the SDF head with its
eikonal term, ``--hierarchical`` adds the second pass, and ``--load``
continues the run in ``--out_dir`` (``<ckpt_name>_ckpt.npz``, else
``<model_name>_ckpt.npz``, written by either package) for ``--steps``
more steps.  ``--plot_grads`` logs each group's gradient norm on a probe
batch, ``--display`` writes every eval render to ``<model>_preview.png``
too (and shows it where cv2 and a display exist).  ``--data_parallel``
splits the ray batch over a world of processes, one a card, joined by NCCL
(gloo with ``--device cpu``); ``--level_parallel k`` splits the hash
table's levels, or the CP lines' rank, over k of them (parallel/); under
torchrun the world is torchrun's, otherwise the CLI starts it itself: one
process a visible card with ``--data_parallel`` (k with ``--level_parallel
k`` alone; on the CPU, k or 1), in this process when that is one.  ``--steps_per_call n`` runs
the steps in windows of n (the trainer's ``steps_per_call``: on the card n
replays of one captured step, on the CPU an eager loop).  What the port does
not run is refused with a message: the compiled-executable cache, and
``--steps_per_call`` under ``--data_parallel`` or ``--level_parallel``
(the next slice); a layout the model cannot split is
refused as JAX refuses it (``cp_rank``, the hashed level count or the batch
not divisible), and one whose level slice holds an odd number of levels
under ``--grad_level_pair``.  ``--synthetic_subject tangle`` is
the held-back scene, its capsules and texture drawn from ``--seed``.
``--preset neuralangelo`` (the port's own preset; the JAX trainer has no
such choice) trains Neuralangelo at its published widths
(``config.neuralangelo_config``: the 16 x 8 hash grid in 2^22-entry
tables, the SDF and colour MLPs 256 wide, six-tap normals and curvature,
NeuS up-sampling to 128 samples, 1,024 rays a step, its coarse-to-fine and
two-step schedules); the flags that size a run (``--num_batch``,
``--hash_size``, ``--num_levels``, ``--max_res``, ``--num_samples``,
``--features_per_level``) override it where they differ from their
defaults, and ``nerf2mesh --iso 0`` meshes its zero level set.

Run:  python -m human_body_reconstruction_tpu_torch.cli.train_hash \\
          --synthetic --synthetic_subject textured --stochastic --hw_rng
      torchrun --nproc_per_node 4 -m \\
          human_body_reconstruction_tpu_torch.cli.train_hash --data_parallel
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os


def build_parser():
    p = argparse.ArgumentParser(description="Train Hashing (PyTorch port)")
    # -- reference flag surface (train_hash2.py:20-42) --
    p.add_argument("--display", action="store_true",
                   help="live preview: overwrite <model>_preview.png each "
                        "eval render and show a cv2 window when a display "
                        "is available (reference train_hash2.py:247-268)")
    p.add_argument("--compile", action="store_true",
                   help="accepted for parity; everything is jit-compiled")
    p.add_argument("--load", action="store_true", help="Continue from checkpoint")
    p.add_argument("--update_rate", type=int, default=15,
                   help="Update rate for Occupancy grid")
    p.add_argument("--write", action="store_true", help="Write the output")
    p.add_argument("--num_epochs", type=int, default=1000, help="Number of epochs")
    p.add_argument("--num_batch", type=int, default=16000, help="Ray batch size")
    p.add_argument("--num_imgs", type=int, default=2,
                   help="accepted for parity (images per host batch)")
    p.add_argument("--num_samples", type=int, default=None,
                   help="Number of samples along ray (default 128 "
                        "flagship / 64 reference)")
    p.add_argument("--near", type=float, default=2.0, help="Near point")
    p.add_argument("--far", type=float, default=6.0, help="Far point")
    p.add_argument("--plot_grads", action="store_true",
                   help="Log gradient norms each log interval")
    p.add_argument("--use_sdf", action="store_true",
                   help="Use sdf formulation while training")
    p.add_argument("--eikonal_subsample", type=int, default=None,
                   help="eikonal point budget per step (0 = all B*S "
                        "points, reference semantics; flagship preset "
                        "default 16384 — the full-points SDF HLO is "
                        "~100x larger and crashes the remote compile "
                        "helper on TPU)")
    p.add_argument("--hierarchical", action="store_true",
                   help="Use hierarchical sampling")
    p.add_argument("--max_res", type=float, default=None,
                   help="Max resolution of the grid (default: 1448 "
                        "under the flagship preset — the round-5 "
                        "sum-G-cut ladder; 2048 reference)")
    p.add_argument("--hash_size", type=float, default=16,
                   help="Log Size of the hash table")
    p.add_argument("--model_name", type=str, default="default",
                   help="Name of saved model")
    p.add_argument("--data_path", type=str, default=None, help="Path to data")
    p.add_argument("--ckpt_name", type=str, default="N_2048_T_16",
                   help="Name of checkpoint")
    # -- TPU-rebuild extensions --
    p.add_argument("--steps", type=int, default=None,
                   help="explicit total step count (overrides epochs)")
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=0,
                   help="steps between eval renders (0: only with --write)")
    p.add_argument("--preset", type=str, default="flagship",
                   choices=["flagship", "reference", "neuralangelo"],
                   help="defaults for flags you do NOT pass: 'flagship' "
                        "is the quality/speed operating point from the "
                        "quality matrix (CP rank-21 factor lines, dense "
                        "coarse levels, occupancy-guided mass-dt "
                        "stratified placement, TV 1e-2 after warmup, "
                        "128 samples); 'reference' matches "
                        "the reference repo's hash defaults (corner "
                        "hash, L=16/F=2, 64 samples, no culling).  Any "
                        "explicit flag overrides its preset value, and "
                        "hash-path flags (--stochastic/--packed/...) "
                        "imply the hash encoder")
    p.add_argument("--occupancy", action="store_true",
                   help="enable occupancy-grid culling")
    p.add_argument("--no_occupancy", action="store_true",
                   help="force culling OFF (overrides the flagship "
                        "preset's default-on occupancy)")
    p.add_argument("--encoder_variant", type=str, default=None,
                   choices=["corner", "cell", "cp"],
                   help="encoder: reference-exact 'corner' hash, TPU-fast "
                        "'cell' hash, or 'cp' rank-decomposed factor "
                        "lines (no hash table; all-MXU, zero gathers/"
                        "scatters — ops/lowrank.py).  Default: preset")
    p.add_argument("--cp_rank", type=int, default=None,
                   help="with --encoder_variant cp: features per level "
                        "(rank of each level's CP factorisation); "
                        "default 21 (flagship; pad-free — costs rank "
                        "16's FLOPs) / 16")
    p.add_argument("--cp_tv", type=float, default=None,
                   help="with --encoder_variant cp: 1-D total-variation "
                        "weight on the factor lines (TensoRF-style "
                        "smoothness; elementwise, no gathers; 0 = off). "
                        "Default 1e-2 under the flagship preset — TV is "
                        "what makes CP generalise OFF the training orbit "
                        "(+6.9 dB on the 4-pose holdout mean, "
                        "qm_r3_textured2.json)")
    p.add_argument("--cp_tv_warmup", type=int, default=None,
                   help="steps to hold --cp_tv at zero before enabling "
                        "it (flagship default: --occ_warmup + 64).  TV "
                        "smoothing during the early fit flattens the "
                        "density the occupancy warmup refresh reads, "
                        "wrongly culls the subject and starves guided "
                        "placement (qm_r3_humanoid3.json)")
    p.add_argument("--stochastic", action="store_true",
                   help="unbiased single-corner hash sampling during "
                        "training (8x fewer gathers)")
    p.add_argument("--packed", action="store_true",
                   help="with --stochastic: packed bf16-pair gathers "
                        "(one lookup per point-level)")
    p.add_argument("--pack_format", type=str, default="bf16",
                   choices=["bf16", "int8"],
                   help="with --packed: bf16 pairs (F=2) or dynamically "
                        "quantised int8 (up to 4 features per lookup)")
    p.add_argument("--packed_exact", action="store_true",
                   help="train the EXACT (non-stochastic) trilerp "
                        "through packed word reads — exact 8-corner "
                        "interpolation + exact scatter backward over "
                        "bf16/int8-rounded features (the reference's "
                        "fp16-autocast analog; the fastest exact-"
                        "semantics trainable mode, bench 'exact_packed'"
                        "); implies --packed")
    p.add_argument("--num_levels", type=int, default=None,
                   help="resolution levels L (reference hard-codes 16, "
                        "train_hash2.py:46; flagship CP uses 8)")
    p.add_argument("--features_per_level", type=int, default=2,
                   help="features per level F (reference hard-codes 2); "
                        "L=8/F=4 --packed --pack_format int8 halves "
                        "lookups twice at the same 32-dim output")
    p.add_argument("--dense_levels", type=int, default=None,
                   help="store the first D coarse levels as DENSE grids "
                        "evaluated by MXU matmuls (collision-free, no "
                        "gather/scatter); -1 picks D automatically "
                        "(default: auto flagship / 0 reference)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the ray batch over all visible devices")
    p.add_argument("--level_parallel", type=int, default=0,
                   help="shard the hash table's level axis over this many "
                        "chips (tensor parallelism; per-chip lookups "
                        "divide by the extent); composes with "
                        "--data_parallel on a 2-D (data, level) mesh")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="run this many optimizer steps a window (on the "
                        "card one captured step replayed n times); the "
                        "refresh, log and eval fire on window crossings")
    p.add_argument("--aot_cache", type=str, default="",
                   help="directory for the disk-backed compiled-executable "
                        "cache (utils/aot.py): re-runs with an identical "
                        "HLO skip the minutes-long remote TPU compile")
    p.add_argument("--grad_level_subsample", action="store_true",
                   help="with --grad_subsample + int8: also route each "
                        "point's gradient to one random level (scaled Lx, "
                        "unbiased) — one scatter contribution per point")
    p.add_argument("--grad_level_pair", action="store_true",
                   help="with --grad_subsample + int8: route each point's "
                        "gradient to one random level of every consecutive "
                        "level pair (scaled 2x, unbiased) — halves the "
                        "backward scatter, gentler than "
                        "--grad_level_subsample")
    p.add_argument("--grad_subsample", action="store_true",
                   help="with --packed: unbiased single-feature gradient "
                        "scatter (halves backward scatter volume)")
    p.add_argument("--hw_rng", action="store_true",
                   help="stochastic-corner uniforms from the Philox "
                        "kernel (ops/rng_kernel.py) instead of torch.rand")
    p.add_argument("--scatter_strategy", type=str, default="random",
                   choices=["random", "sorted", "segsum"],
                   help="backward table-gradient scatter: plain random "
                        "scatter-add, pre-sorted scatter, or sort + "
                        "segment-sum (exact in all cases)")
    p.add_argument("--compact", type=int, default=None,
                   help="with --occupancy: keep only this many occupied "
                        "samples per ray (static compaction; flagship "
                        "default 48 guided)")
    p.add_argument("--occ_guided", action="store_true",
                   help="with --occupancy: inverse-CDF sample placement "
                        "over occupied intervals instead of top-K "
                        "truncation (budget = --compact or --num_samples)")
    p.add_argument("--occ_warmup", type=int, default=256,
                   help="steps trained WITHOUT culling before the "
                        "occupancy grid engages (premature culling from "
                        "a near-random field is self-reinforcing)")
    p.add_argument("--occ_explore", type=float, default=0.05,
                   help="with --occ_guided: fraction of sample mass "
                        "routed to empty-marked intervals so "
                        "wrongly-culled cells can recover")
    p.add_argument("--occ_probes", type=int, default=None,
                   help="with --occ_guided: probe-interval count "
                        "(0 = --num_samples); fewer probes cut the "
                        "per-step occupancy-lookup cost (flagship "
                        "default 64)")
    p.add_argument("--occ_threshold", type=float, default=0.01,
                   help="density threshold below which occupancy cells "
                        "are culled (RenderConfig.occ_threshold)")
    p.add_argument("--sigma_l1", type=float, default=0.0,
                   help="L1 sparsity weight on sampled densities "
                        "(TensoRF-style fog suppression; lets the "
                        "occupancy grid converge on CP fields)")
    p.add_argument("--occ_probe_jitter", action="store_true",
                   help="with --occ_guided: randomise each probe's "
                        "position within its interval per step (fixed "
                        "midpoints repeat the same classification "
                        "misses every step)")
    p.add_argument("--eval_guided", type=int, default=0,
                   help="with --occupancy: render in-training evals with "
                        "deterministic occupancy-guided placement at this "
                        "sample budget (2.5x cheaper at 48, -0.09 dB; "
                        "serving A/B in docs/PERF_NOTES.md); 0 = exact "
                        "full ladder")
    p.add_argument("--occ_dt", type=str, default="mass",
                   choices=["clip", "mass"],
                   help="with --occ_guided: dt estimator — 'clip' at "
                        "probe-interval ends (biased low when samples "
                        "are sparser than probe intervals) or 'mass' "
                        "(unbiased importance weights)")
    p.add_argument("--occ_stratified", action="store_true", default=None,
                   help="with --occ_guided: stratified (one jittered "
                        "draw per 1/K CDF stratum) instead of iid "
                        "inverse-CDF u's — lower-variance placement "
                        "(+1.5 dB, qm_r3_textured4.json) and skips the "
                        "per-ray sample sort.  Default ON under the "
                        "flagship preset")
    p.add_argument("--no_occ_stratified", dest="occ_stratified",
                   action="store_false",
                   help="force iid inverse-CDF placement (overrides the "
                        "flagship preset's default-on stratification)")
    p.add_argument("--normalization", type=str, default="diagonal",
                   choices=["diagonal", "unit_box"],
                   help="scene->hash normalisation: reference 'diagonal' "
                        "or per-axis 'unit_box' (full table utilisation)")
    p.add_argument("--rgb_elu", action="store_true",
                   help="reference-parity ELU colour activation")
    p.add_argument("--white_bg", action="store_true")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--synthetic", action="store_true",
                   help="procedural demo scene instead of a dataset dir")
    p.add_argument("--synthetic_subject", type=str, default="blobs",
                   choices=["blobs", "human", "textured", "tangle"],
                   help="procedural subject for --synthetic ('tangle' "
                        "is the seed-randomized held-back family; "
                        "geometry/texture derive from --seed)")
    p.add_argument("--seed", type=int, default=0)
    # -- the port's own --
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def resolve_preset(args):
    """Fill unset flags from the preset (VERDICT r2 item 4).

    Explicit flags always win.  Hash-path flags (--stochastic/--packed/
    --grad_*/--hw_rng) without --encoder_variant imply the 'corner'
    hash encoder so every reference-style invocation keeps its
    semantics; the bare zero-flag run gets the quality-matrix flagship
    (CP rank-32, dense coarse levels, occupancy-guided mass-dt).
    """
    hash_flags = (args.stochastic or args.packed or args.grad_subsample
                  or args.grad_level_subsample or args.grad_level_pair
                  or args.hw_rng or args.packed_exact)
    variant = args.encoder_variant
    if variant is None:
        variant = ("cp" if args.preset == "flagship" and not hash_flags
                   else "corner")
    flagship = args.preset == "flagship" and variant == "cp"
    out = dict(
        variant=variant,
        # round-5 flagship ladder: the CP kernel anatomy probe showed
        # the encode cost is the contraction width sum_G (the W build
        # has no rank dependence and the matmul pays a 128-lane floor),
        # so a 7-level n_max=1448 ladder (-33% sum_G, finest line 1450)
        # at rank 25 (C=125, pad-free) is +16% rate AND the quality
        # record: 33.84 dB textured / 42.10 humanoid 4-pose holdout,
        # 251.5k rays/s bench (qm_r5_n1448*.json, BENCH_local_r5.json)
        num_levels=(args.num_levels if args.num_levels is not None
                    else (7 if flagship else 16)),
        max_res=(args.max_res if args.max_res is not None
                 else (1448 if flagship else 2048)),
        cp_rank=(args.cp_rank if args.cp_rank is not None
                 else (25 if flagship else 16)),
        dense_levels=(args.dense_levels if args.dense_levels is not None
                      else (-1 if flagship else 0)),
        num_samples=(args.num_samples if args.num_samples is not None
                     else (128 if flagship else 64)),
        occupancy=(args.occupancy or flagship) and not args.no_occupancy,
        compact=(args.compact if args.compact is not None
                 else (48 if flagship else 0)),
        # 32 probes match 64's quality (33.58 dB mean 4-pose textured
        # holdout at p32/K=32, qm_r4_kprobe.json, vs the p64 record's
        # 33.43) and save ~7 ms/step of tile-priced occupancy gathers
        # (step_ablate_r4.json) — round-4 flip
        occ_probes=(args.occ_probes if args.occ_probes is not None
                    else (32 if flagship else 0)),
        # factor-line TV: the off-orbit generalisation fix for CP
        # (separable factor ripple in never-sampled space collapses
        # exterior/steep holdout poses by 7-13 dB without it —
        # qm_r3_textured2.json)
        cp_tv=(args.cp_tv if args.cp_tv is not None
               else (1e-2 if flagship else 0.0)),
        # TV sits out until culling locks onto the subject — smoothing
        # the early fit flattens the density the warmup-end occupancy
        # refresh reads, wrongly culls the subject, and guided
        # placement starves (the humanoid collapse,
        # qm_r3_humanoid3.json).  occ_warmup + one update cadence.
        cp_tv_warmup=(args.cp_tv_warmup if args.cp_tv_warmup is not None
                      else (args.occ_warmup + 64 if flagship else 0)),
        # subsampled eikonal (ADVICE r4): variant-qualified like every
        # other flagship default — a reference-leaning config (hash
        # flags set) keeps the all-points reference semantics
        eikonal_subsample=(args.eikonal_subsample
                           if args.eikonal_subsample is not None
                           else (16384 if flagship else 0)),
    )
    if out["eikonal_subsample"] < 0:
        raise SystemExit("--eikonal_subsample must be >= 0 "
                         "(0 = all points, reference semantics)")
    out["occ_guided"] = (args.occ_guided or flagship) and out["occupancy"]
    # stratified inverse-CDF placement: lower-variance, makes mass-dt's
    # 1/K assumption structural, and skips the per-ray sort — +1.5 dB
    # AND +10% rate on the textured gate (qm_r3_textured4.json)
    out["occ_stratified"] = (args.occ_stratified
                             if args.occ_stratified is not None
                             else flagship)
    if not out["occupancy"]:
        out["compact"] = args.compact or 0
    return out


def neuralangelo_config(args):
    """``--preset neuralangelo``: ``config.neuralangelo_config`` with the
    run's seed, epochs, near and far, background and normalisation, and
    each sizing flag that differs from its parser default."""
    from human_body_reconstruction_tpu_torch.utils import config as C

    cfg = C.neuralangelo_config()
    defaults = build_parser().parse_args([])
    sized = {k: getattr(args, k) for k in (
        "num_batch", "hash_size", "num_levels", "max_res", "num_samples",
        "features_per_level") if getattr(args, k) != getattr(defaults, k)}
    h = cfg.hash
    return dataclasses.replace(
        cfg,
        hash=dataclasses.replace(
            h, log2_table_size=int(sized.get("hash_size",
                                             h.log2_table_size)),
            num_levels=sized.get("num_levels", h.num_levels),
            n_max=int(sized.get("max_res", h.n_max)),
            features_per_level=sized.get("features_per_level",
                                         h.features_per_level)),
        render=dataclasses.replace(
            cfg.render, near=args.near, far=args.far,
            num_samples=sized.get("num_samples", cfg.render.num_samples),
            white_background=args.white_bg,
            normalization=args.normalization),
        train=dataclasses.replace(
            cfg.train, num_epochs=args.num_epochs, seed=args.seed,
            ray_batch=sized.get("num_batch", cfg.train.ray_batch)))


def make_config(args):
    from human_body_reconstruction_tpu_torch.ops import dense_grid
    from human_body_reconstruction_tpu_torch.utils import config as C

    if args.preset == "neuralangelo":
        return neuralangelo_config(args)
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


_NOT_PORTED = (("aot_cache", "--aot_cache"),)


def check_supported(args, cfg):
    """Refuse what the port cannot run yet, and a level extent that the
    model cannot split (JAX ``_validate``'s message), before any work
    starts."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding
    from human_body_reconstruction_tpu_torch.parallel import level_parallel

    for flag, what in _NOT_PORTED:
        if getattr(args, flag):
            raise SystemExit(f"{what} is not ported to the PyTorch trainer yet")
    if args.steps_per_call < 1:
        raise SystemExit("--steps_per_call must be at least 1")
    from human_body_reconstruction_tpu_torch.models import sdf_head

    unported = (hash_encoding.unported(cfg.hash)
                or sdf_head.unported(cfg, args.level_parallel))
    if unported:
        raise SystemExit(unported)
    if args.level_parallel > 1:
        try:
            level_parallel.validate(cfg, (1, args.level_parallel), None)
        except ValueError as e:
            raise SystemExit(str(e)) from None


def world_layout(args, devices: int) -> tuple:
    """(n_data, n_level) over ``devices`` ranks (``comm.layout``), refused
    before any work when the devices cannot hold it or the batch does not
    divide."""
    from human_body_reconstruction_tpu_torch.parallel import comm

    try:
        return comm.layout(devices, args.data_parallel, args.level_parallel,
                           args.num_batch)
    except ValueError as e:
        raise SystemExit(str(e)) from None


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
        if args.synthetic_subject == "human":
            # closer orbit + longer focal so the 1.6-unit figure fills
            # the frame
            return synthetic.make_dataset(
                n_views=12, H=96, W=96, focal=110.0, near=args.near,
                far=args.far, field=synthetic.humanoid_field, radius=3.0,
                elevation=0.1, device=device), None
        if args.synthetic_subject == "tangle":
            # the held-back family: the textured scene's regime, its
            # geometry and texture drawn from --seed (seeds >= 100 are the
            # held-back evaluations)
            return synthetic.make_dataset(
                n_views=20, H=400, W=400, focal=440.0, near=args.near,
                far=args.far,
                field=functools.partial(synthetic.tangle_field,
                                        seed=args.seed),
                radius=4.0, elevation=0.35, gt_samples=384,
                device=device), None
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
    """Train; returns the trainer (None when the run was spread over
    processes this one started)."""
    import sys

    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    from human_body_reconstruction_tpu_torch.cli import device_from_flag
    from human_body_reconstruction_tpu_torch.parallel import comm

    cfg = make_config(args)
    check_supported(args, cfg)
    device = device_from_flag(args.device)
    if not (args.data_parallel or args.level_parallel > 1):
        return train(args, cfg, device)
    if comm.torchrun_env():
        return _joined(device.type, argv, None)
    # the cards, or on the CPU a process for each level rank
    n_data, n_level = world_layout(args, (
        torch.cuda.device_count() if device.type == "cuda"
        else max(args.level_parallel, 1)))
    world = n_data * n_level
    if world == 1:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="hbr_rdzv_") as tmp:
            return _joined(device.type, argv,
                           f"file://{os.path.join(tmp, 'rendezvous')}")
    comm.spawn(_rank_main, world, (argv,), device.type)
    return None


def _joined(device_type: str, argv, init_method):
    """Join the world (torchrun's, or a world of one at ``init_method``),
    train, leave."""
    import torch.distributed as dist

    from human_body_reconstruction_tpu_torch.parallel import comm

    kw = {} if init_method is None else dict(rank=0, world_size=1,
                                             init_method=init_method)
    device = comm.init(device_type, **kw)
    try:
        args = build_parser().parse_args(argv)
        world_layout(args, dist.get_world_size())
        return train(args, make_config(args), device)
    finally:
        dist.destroy_process_group()


def _rank_main(device, argv):
    """One spawned rank's run; returns its step count."""
    args = build_parser().parse_args(argv)
    return train(args, make_config(args), device).state.step


def train(args, cfg, device):
    """Load the data and run the trainer on ``device`` (one rank of a
    joined world under ``--data_parallel``/``--level_parallel``)."""
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    ds, eval_ds = load_dataset(args, device)

    n_pixels = int(ds["images"].shape[0]) * ds["H"] * ds["W"]
    steps_per_epoch = max(1, n_pixels // args.num_batch)
    steps = args.steps if args.steps else args.num_epochs * steps_per_epoch

    trainer = Trainer(cfg=cfg, ds=ds, out_dir=args.out_dir,
                      model_name=args.model_name, eval_ds=eval_ds,
                      total_steps=steps, log_grad_norms=args.plot_grads,
                      display=args.display,
                      data_parallel=args.data_parallel,
                      level_parallel=args.level_parallel,
                      steps_per_call=args.steps_per_call)
    if args.load:
        path = os.path.join(args.out_dir, f"{args.ckpt_name}_ckpt.npz")
        if not os.path.exists(path):
            path = trainer.ckpt_path()
        trainer.load(path)
        trainer.log_fn(f"resumed from {path} at step {trainer.state.step}")
    # ~100 eval renders over a long run, never more often than every 100
    # steps (an eval render costs many training steps)
    eval_every = args.eval_every or (max(100, steps // 100) if args.write
                                     else 0)
    trainer.run(steps, log_every=args.log_every, eval_every=eval_every)
    trainer.save()
    if args.write:
        trainer.eval_render(tag="final")
    trainer.log_fn(f"checkpoint: {trainer.ckpt_path()}")
    return trainer


if __name__ == "__main__":
    main()
