"""Train an SDF mode of the quality protocol under four numerics and score
each run's holdout: the mode as configured (bf16 encoder roundings, the
MLP in bf16 compute), f32 encoders, an f32 MLP, and both in f32; two seeds
each, through ``cli/quality_holdout.run_mode`` on one card.

Run:  PYTHONPATH=. python tools/sdf_numerics_diag.py \\
          [--mode cp_r21_sdf_guided_xla_es16k] [--steps 512] \\
          [--out results/sdf_numerics_diag.json]
"""

import argparse
import dataclasses
import json
import os

import torch

from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh

NUMERICS = (("as configured", True, "bfloat16"),
            ("f32 encoders", False, "bfloat16"),
            ("f32 MLP", True, "float32"),
            ("all f32", False, "float32"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="cp_r21_sdf_guided_xla_es16k")
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--out", default="results/sdf_numerics_diag.json")
    args = ap.parse_args()
    device = torch.device("cuda")
    data = qh.protocol_data(400, 400, 20, "textured", device)
    base = qh.make_modes()[args.mode]
    out = {}
    for name, enc_bf16, dtype in NUMERICS:
        cfg = dataclasses.replace(
            base, hash=dataclasses.replace(base.hash, dense_bf16=enc_bf16),
            train=dataclasses.replace(base.train, compute_dtype=dtype))
        for seed in (0, 1):
            run = argparse.Namespace(
                batch=16384, max_steps=6000, steps=args.steps, budget=1e9,
                height=400, scene="textured", seed=seed, save_params=False,
                out=args.out)
            row = qh.run_mode(args.mode, cfg, run, data, device,
                              log=lambda s: None)
            out[f"{name} seed {seed}"] = row
            print(name, seed, row["holdout_psnr"], row["holdout_min"],
                  row["holdout_per_pose"], row["train_psnr"],
                  row.get("eikonal"), row.get("var_b"), row.get("occ_frac"),
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
