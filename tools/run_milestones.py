"""The port's quality milestones on the card, through its CLIs, in one
process: each run's JSON under ``--out_dir`` and one summary line per run.

Groups (``--only``, comma-separated; default all):
  tangle    quality_holdout --scene tangle --scene_seed 101
            --mode cp_r21_guided_k32_p32_tv1e2_strat, 6000 steps
            (qm_r5_heldback_720.json), port seeds 0 and 1
  n1024     quality_holdout cp_n1024_r25_... --steps 3136 and
            cp_n1024_r50_... --steps 1952 (qm_r5_n1024.json), seeds 0, 1
  speedrun  speedrun --encoder cp --cp_rank 32 --eval_every 125
            --eval_guided 48 (speedrun_30db_cp.json), seeds 0, 1
  sdf       cp_r21_sdf_guided_xla_es16k 512 steps on seeds 0-3
            (qm_r5_sdf_xla_textured.json); cp_r21_sdf_guided_es16k 1984
            steps (qm_r5_sdf_pallas_textured.json) and
            cp_r21_sdf_guided_xla_es16k 896 steps on the humanoid
            (qm_r5_sdf_xla_humanoid.json), seeds 0, 1
  eikonal   the three SDF modes whose eikonal term covers every sample
            (cp_r21_sdf_plain, cp_r21_sdf_guided_k32_tv1e2_strat,
            cp_r21_sdf_guided_xla), 64 steps each, seed 0, with the card's
            peak memory (no record: the TPU's compile helper died on them)
  hashvar   the 16 hash-variant modes (cell, packed*, int8*) at their
            records' step counts (quality_matrix.json, qm_lvl.json,
            qm_mass.json, qm_lpair_ab.json, qm_g256.json; the k32_mass mode
            at both of its records' counts), the ``stochastic`` mode at
            packed_gsub's count (its step time beside the packed one's), and
            ``speedrun --encoder int8`` at the record's defaults
            (speedrun_30db.json), seeds 0, 1
``--seeds`` replaces the port seeds 0 and 1 of every run but the xla
512-step spread; ``--modes`` keeps only the quality runs of the modes
named.  ``--dense_impl xla`` runs only the quality modes with dense coarse
levels, those levels on the JAX XLA path's numerics (``ops/xla_encoders.py``)
in place of the dense kernel's: the TPU records of the int8 modes were
trained before the JAX package's dense Pallas kernel existed, on that path.

Run:  python tools/run_milestones.py --out_dir results/milestones
      python tools/run_milestones.py --only hashvar --dense_impl xla \
          --modes int8_dense,int8_dense_guided,int8_dense_guided_k32_mass,\
int8_dense_guided_k32_mass_lpair --out_dir results/int8_xla_dense
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TANGLE = "cp_r21_guided_k32_p32_tv1e2_strat"
N1024 = "cp_n1024_r{}_guided_k32_p32_tv1e2_strat"
# the hash-variant modes and their records' step counts
HASHVAR = (("cell", 128), ("packed", 400), ("packed_gsub", 544),
           ("stochastic", 544), ("packed_compact", 640),
           ("packed_guided", 672), ("packed_dense", 704),
           ("int8_dense", 768), ("int8_dense_guided", 960),
           ("int8_dense_guided_k32", 576), ("int8_dense_guided_k24", 576),
           ("int8_dense_guided_k16", 768), ("int8_dense_guided_k32_p128", 768),
           ("int8_dense_guided_lvl", 928), ("int8_dense_guided_k32_mass", 576),
           ("int8_dense_guided_k32_mass", 2880),
           ("int8_dense_guided_k32_mass_lpair", 3296),
           ("int8_dense_guided_k32_mass_g256", 384))
XLA, ES16K = "cp_r21_sdf_guided_xla_es16k", "cp_r21_sdf_guided_es16k"
FULL_EIKONAL = ("cp_r21_sdf_plain", "cp_r21_sdf_guided_k32_tv1e2_strat",
                "cp_r21_sdf_guided_xla")


def runs(seeds=(0, 1)):
    """(group, tag, "quality" or "speedrun", argv) of every milestone, on
    the port seeds ``seeds`` (the xla 512-step spread: seeds 0-3)."""
    out = []
    for seed in seeds:
        out.append(("tangle", f"tangle101_seed{seed}", "quality",
                    ["--scene", "tangle", "--scene_seed", "101", "--mode",
                     TANGLE, "--max_steps", "6000", "--seed", str(seed)]))
    for rank, steps in ((25, 3136), (50, 1952)):
        for seed in seeds:
            out.append(("n1024", f"n1024_r{rank}_seed{seed}", "quality",
                        ["--mode", N1024.format(rank), "--steps", str(steps),
                         "--seed", str(seed)]))
    for seed in seeds:
        out.append(("speedrun", f"speedrun_cp_r32_seed{seed}", "speedrun",
                    ["--encoder", "cp", "--cp_rank", "32", "--eval_every",
                     "125", "--eval_guided", "48", "--seed", str(seed)]))
    for seed in (0, 1, 2, 3):
        out.append(("sdf", f"sdf_xla_512_seed{seed}", "quality",
                    ["--mode", XLA, "--steps", "512", "--budget", "100000",
                     "--seed", str(seed)]))
    for seed in seeds:
        out.append(("sdf", f"sdf_es16k_1984_seed{seed}", "quality",
                    ["--mode", ES16K, "--steps", "1984", "--budget",
                     "100000", "--seed", str(seed)]))
        out.append(("sdf", f"sdf_xla_humanoid_896_seed{seed}", "quality",
                    ["--scene", "humanoid", "--mode", XLA, "--steps", "896",
                     "--budget", "100000", "--seed", str(seed)]))
    for seed in seeds:
        for mode, steps in HASHVAR:
            out.append(("hashvar", f"{mode}_{steps}_seed{seed}", "quality",
                        ["--mode", mode, "--steps", str(steps), "--budget",
                         "100000", "--seed", str(seed)]))
        out.append(("hashvar", f"speedrun_int8_seed{seed}", "speedrun",
                    ["--encoder", "int8", "--seed", str(seed)]))
    for mode in FULL_EIKONAL:
        out.append(("eikonal", f"{mode}_64", "quality",
                    ["--mode", mode, "--steps", "64", "--budget", "100000"]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default=os.path.join("results",
                                                      "milestones"))
    ap.add_argument("--only",
                    default="tangle,n1024,speedrun,sdf,eikonal,hashvar")
    ap.add_argument("--seeds", default="0,1",
                    help="port seeds of every run but the xla spread's")
    ap.add_argument("--modes", default=None,
                    help="comma-separated: only these modes' quality runs")
    ap.add_argument("--dense_impl", choices=("xla",), default=None,
                    help="only the modes with dense levels, those on the "
                         "JAX XLA path's numerics")
    args = ap.parse_args()
    from human_body_reconstruction_tpu_torch.cli import (
        card_line, quality_holdout, speedrun)
    import torch

    os.makedirs(args.out_dir, exist_ok=True)
    card = card_line(torch.device("cuda"))
    print(card, flush=True)
    groups = set(args.only.split(","))
    seeds = tuple(int(v) for v in args.seeds.split(","))
    modes = None if args.modes is None else set(args.modes.split(","))
    edit = None
    if args.dense_impl is not None:
        def edit(cfg):
            return dataclasses.replace(cfg, hash=dataclasses.replace(
                cfg.hash, dense_impl=args.dense_impl))
    for group, tag, cli, argv in runs(seeds):
        mode = argv[argv.index("--mode") + 1] if "--mode" in argv else None
        if group not in groups or (modes is not None and mode not in modes):
            continue
        if edit is not None:
            if cli != "quality" or not (
                    quality_holdout.make_modes()[mode].hash.dense_levels):
                continue
            tag = f"{tag}_{args.dense_impl}_dense"
        out = os.path.join(args.out_dir, f"{tag}.json")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cli == "quality":
            row = quality_holdout.main(argv + ["--out", out],
                                       log=lambda s: None, edit=edit)
            line = (f"{row['mode']} {row['scene']}: {row['steps']} steps, "
                    f"holdout mean {row['holdout_psnr']} min "
                    f"{row['holdout_min']} per pose "
                    f"{json.dumps(row['holdout_per_pose'])}, train "
                    f"{row['train_psnr']}, occ_frac {row.get('occ_frac')}, "
                    f"{row['rays_per_sec']} rays/s over {row['budget_s']} s")
        else:
            res = speedrun.main(argv + ["--out", out], log=lambda s: None)
            line = (f"crossed {json.dumps(res['crossed'])}; evals "
                    f"{json.dumps(res['evals'])}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{tag}] {line}; {time.perf_counter() - t0:.1f} s wall, peak "
              f"memory {peak:.2f} GiB [{card}]", flush=True)


if __name__ == "__main__":
    main()
