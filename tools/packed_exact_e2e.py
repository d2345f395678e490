"""End-to-end runs through the packed-exact read, for one checkout of the port.

With ``--root DIR`` the port is imported from DIR (an earlier tree unpacked
by ``git archive``, or ``.``), so running this script once per checkout in
turns (parent, tree, tree, parent) compares two trees on one card.  Each run
prints one JSON line:

  train_hash   ``train_hash --synthetic --synthetic_subject textured
               --packed_exact`` for ``--steps`` steps (bf16 words, one
               packed-exact launch a step): the trainer's rays/s at each
               log after the first, and their median
  serve        a frame of the int8 run (``int8_dense_guided_k32_mass_lpair``)
               served through ``cli/serve.py`` (400x400, its guided first
               pass through the packed-exact read): ``wall_s`` of
               ``--frames`` orbit poses after one warm-up frame
  nerf2mesh    the int8 run meshed at 256^3 (64 sweep chunks, each one
               packed-exact launch): sweep and marching seconds

``--train`` first trains the int8 run (``cli/quality_holdout.py --mode
int8_dense_guided_k32_mass_lpair --steps 288 --save_params``, past its
grid's install at 256) into ``--work``, for the runs that follow to read.
Run on the card (about 4 minutes of command time for the five runs):

  mkdir -p local/parent_tree && git archive <commit> | tar -x -C local/parent_tree
  python tools/packed_exact_e2e.py --root . --work local/e2e --train --out chiprun_out/e2e_train.json
  for r in local/parent_tree . . local/parent_tree; do \\
      python tools/packed_exact_e2e.py --root $r --work local/e2e; done
"""

import argparse
import json
import os
import statistics
import sys
import time

MODE = "int8_dense_guided_k32_mass_lpair"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to import")
    ap.add_argument("--work", required=True, help="the int8 run's directory")
    ap.add_argument("--train", action="store_true",
                    help="train the int8 run into --work first")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    root, work = os.path.abspath(args.root), os.path.abspath(args.work)
    sys.path.insert(0, root)

    import torch

    from human_body_reconstruction_tpu_torch.cli import (
        card_line, nerf2mesh, quality_holdout, serve, train_hash)

    device = torch.device("cuda")
    rec = {"root": args.root, "card": card_line(device)}
    os.makedirs(work, exist_ok=True)
    if args.train:
        t0 = time.perf_counter()
        row = quality_holdout.main(
            ["--mode", MODE, "--steps", "288", "--device", "cuda", "--out",
             f"{work}/{MODE}.json", "--save_params"], log=lambda s: None)
        rec["trained"] = {"steps": row["steps"], "holdout_psnr":
                          row["holdout_psnr"],
                          "seconds": time.perf_counter() - t0}
    tr = train_hash.main([
        "--synthetic", "--synthetic_subject", "textured", "--packed_exact",
        "--steps", str(args.steps), "--log_every", str(args.log_every),
        "--device", "cuda", "--out_dir", f"{work}/packed_exact_{os.getpid()}",
        "--model_name", "px"])
    rates = [h["rays_per_sec"] for h in tr.history[1:]]
    rec["train_hash"] = {"steps": tr.state.step, "rays_per_sec": rates,
                         "median_rays_per_sec": statistics.median(rates),
                         "psnr": tr.history[-1]["psnr"]}
    del tr
    torch.cuda.empty_cache()
    server = serve.RenderServer(serve.build_parser().parse_args([
        "--ckpt_dir", f"{work}/{MODE}", "--model_name", MODE, "--device",
        "cuda"]))
    walls = []
    for i in range(args.frames + 1):
        resp = server.handle({"orbit": {"index": i % 4, "count": 4},
                              "no_image": True})
        if not resp["ok"]:
            raise RuntimeError(resp)
        walls.append(resp["wall_s"])
    rec["serve"] = {"wall_s": walls[1:], "warm_up_wall_s": walls[0]}
    del server
    torch.cuda.empty_cache()
    stats = nerf2mesh.main([
        "--ckpt_dir", f"{work}/{MODE}", "--model_name", MODE, "--resolution",
        "256", "--cache", "", "--out", f"{work}/{MODE}_{os.getpid()}.ply",
        "--device", "cuda"])
    rec["nerf2mesh"] = {k: stats[k] for k in ("sweep_seconds",
                                              "marching_seconds",
                                              "num_faces")}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
