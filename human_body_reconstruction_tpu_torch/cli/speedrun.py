"""Wall clock to a holdout PSNR target (counterpart of
``scripts/speedrun_30db.py``): how long the trainer takes to reach
``--target_db`` (30 dB) on the quality protocol's textured scene.

Data and occupancy rules are the protocol's (``quality_holdout``:
``protocol_data``, ``ModeRun``): 400x400, 20 training views; the grid is
installed once the step count reaches the warm-up, then refreshed whenever
``steps // 64`` advances, drawing ``max(2^20, cells // 8)`` cells.  The
model is the CP factor-line encoder at ``--cp_rank`` (8 levels up to n_max
2048, two dense coarse levels) with factor-line TV 1e-2, guided mass-dt
placement of 32 samples from 64 probes.

Evaluation: every ``--eval_every`` steps once the training PSNR exceeds
``--eval_after_train_db``, a render of the interior holdout pose (the
orbit's next pose): exact, 128 samples, no culling; with ``--eval_guided
K`` the gate render is the deterministic guided one (K samples placed on
the grid's CDF from 128 probes), and a crossing counts only when an exact
confirmation render of the same pose also reaches the target (asked for
once the gate reads within 0.25 dB of it).

Clock: it starts before the first step, which builds and first launches
the CUDA kernels.  ``compile_s`` holds the warm-up seconds that a warm
process would not pay, as the JAX record holds its compiles: the first
step, the grid's install (its refresh and the first step on it) and the
first evaluation.  ``wall_s_excl_compile`` leaves out the first two, as
JAX's does, and ``train_s_excl_evals`` also every evaluation's seconds.

Output: the JAX record's keys (``target_db``, ``crossed`` with its
``steps``, ``holdout_db``, ``gate``, wall seconds and ``compile_s``, and
``protocol``) plus ``evals`` (every gate render: steps, gate, train and
gate dB, the exact confirmation's dB or None, the wall second), ``steps`` run,
``seed`` and ``card`` (the card's name and power limit), by default under
``results/`` (git-ignored).  The flags are the JAX script's, plus
``--device`` (default cuda) and ``--seed`` (the generator of init and
sampling; JAX fixes its keys).  ``--encoder int8`` is the hash flagship of
the JAX record ``speedrun_30db.json``: 8 levels (2 dense, 6 hashed at F 4,
T 2^16), int8 packed gathers with the Philox uniforms and 1-of-F gradient
subsampling.  ``--steps_per_call n`` (which must divide ``--eval_every``,
as JAX requires) runs the steps in windows of n (``ModeRun.window``: on the
card n replays of one captured step, on the CPU an eager loop), the
install, refresh and evaluations at window boundaries as the JAX script
places them.  Refused by name: ``--aot_cache`` (the JAX compiled-executable
cache).

Run:  python -m human_body_reconstruction_tpu_torch.cli.speedrun \\
          --encoder cp --cp_rank 32 --eval_every 125 --eval_guided 48
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from human_body_reconstruction_tpu_torch.utils import config as C

CONFIRM_MARGIN_DB = 0.25        # a gate this close to the target asks for the
                                # exact confirmation render
GUIDED_PROBES = 128


def build_parser():
    p = argparse.ArgumentParser(
        description="wall clock to a holdout PSNR target (PyTorch/CUDA)")
    p.add_argument("--target_db", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--max_steps", type=int, default=6000)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--eval_after_train_db", type=float, default=27.0)
    p.add_argument("--out", type=str,
                   default=os.path.join("results", "speedrun_30db.json"))
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="run N optimizer steps a window (on the card one "
                        "captured step replayed N times); must divide "
                        "eval_every")
    p.add_argument("--aot_cache", type=str, default="",
                   help="not ported: the JAX compiled-executable cache")
    p.add_argument("--eval_guided", type=int, default=0,
                   help="gate the evaluations with the deterministic guided "
                        "render of this many samples; a crossing counts only "
                        "on the exact confirmation render")
    p.add_argument("--encoder", type=str, default="cp",
                   choices=["int8", "cp"],
                   help="int8: the hash flagship (int8 packed gathers + "
                        "dense coarse levels); cp: the CP factor-line "
                        "encoder")
    p.add_argument("--cp_rank", type=int, default=32)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator for init and sampling")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; without a CUDA card pass --device cpu")
    return p


def make_config(args) -> C.PipelineConfig:
    """The JAX script's config, built as it builds it."""
    from human_body_reconstruction_tpu_torch.ops import dense_grid

    if args.encoder == "cp":
        enc = C.HashConfig(num_levels=8, n_min=16, n_max=2048,
                           variant="cp", cp_rank=args.cp_rank)
    else:
        enc = C.HashConfig(num_levels=8, features_per_level=4, n_min=16,
                           n_max=2048, log2_table_size=16,
                           stochastic_train=True, packed=True,
                           pack_format="int8", grad_subsample=True,
                           hw_rng=True)
    enc = dataclasses.replace(
        enc, dense_levels=dense_grid.auto_dense_levels(enc))
    return C.PipelineConfig(
        hash=enc,
        render=C.RenderConfig(num_samples=128, occupancy=True,
                              occupancy_resolution=128,
                              compact_samples=32, occ_guided=True,
                              occ_probes=64, occ_dt="mass"),
        train=C.TrainConfig(ray_batch=args.batch,
                            cp_tv_weight=(1e-2 if args.encoder == "cp"
                                          else 0.0)))


def check_supported(args, cfg):
    """Refuse what the port does not run, before any work starts."""
    from human_body_reconstruction_tpu_torch.ops import hash_encoding

    if args.steps_per_call < 1:
        raise SystemExit("--steps_per_call must be at least 1")
    if args.eval_every % args.steps_per_call:
        raise SystemExit("--steps_per_call must divide --eval_every")
    if args.aot_cache:
        raise SystemExit("--aot_cache is not ported (the JAX compiled-"
                         "executable cache)")
    why = hash_encoding.unported(cfg.hash)
    if why:
        raise SystemExit(f"--encoder {args.encoder}: {why}")


def run(args, log=print) -> dict:
    """The timed run; returns the result record."""
    from human_body_reconstruction_tpu_torch.cli import card_line, device_from_flag
    from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh

    cfg = make_config(args)
    check_supported(args, cfg)
    device = device_from_flag(args.device)
    H = W = args.height
    t0 = time.perf_counter()
    data = qh.protocol_data(H, W, args.views, "textured", device)
    log(f"ground truth: {args.views}+{len(qh.HOLDOUT_NAMES)} views at "
        f"{H}x{W} in {time.perf_counter() - t0:.1f}s")
    mode_run = qh.ModeRun("speedrun", cfg, data, H, W, batch=args.batch,
                      max_steps=args.max_steps, seed=args.seed, device=device,
                      log=log)
    eval_cfg = qh.eval_config(mode_run.cfg)
    guided_cfg = dataclasses.replace(eval_cfg, render=dataclasses.replace(
        eval_cfg.render, eval_guided=args.eval_guided,
        occ_probes=GUIDED_PROBES))
    hold_pose, hold_img = data["hold_poses"][0], data["hold_imgs"][0]

    def holdout_db(guided: bool) -> float:
        return mode_run.holdout_psnr(
            hold_pose, hold_img, guided_cfg if guided else eval_cfg,
            occ=mode_run.state.occ if guided else None)

    spc = args.steps_per_call
    run_steps = mode_run.step if spc == 1 else (lambda: mode_run.window(spc))
    t_wall0 = time.perf_counter()
    m = run_steps()                              # builds and first launches
    float(m["loss"])
    t_compiled = time.perf_counter()
    compile_extra = eval_time = first_eval_s = 0.0
    steps, crossed, evals = spc, None, []
    while steps < args.max_steps:
        if mode_run.pending is not None and steps >= mode_run.warmup:
            tc = time.perf_counter()
            mode_run.refresh(steps, True)
            m = run_steps()                      # the first steps on the grid
            float(m["loss"])
            steps += spc
            compile_extra += time.perf_counter() - tc
            continue
        m = run_steps()
        steps += spc
        if (mode_run.state.occ is not None and steps // qh.REFRESH_EVERY
                > (steps - spc) // qh.REFRESH_EVERY):
            mode_run.refresh(steps, False)
        if steps % args.eval_every:
            continue
        te = time.perf_counter()
        train_db = float(m["psnr"])          # syncs the queue too
        if train_db < args.eval_after_train_db:
            log(f"step {steps}: train {train_db:.2f} dB (eval skipped)")
            continue
        use_g = args.eval_guided > 0 and mode_run.state.occ is not None
        db = holdout_db(use_g)
        exact_db = None
        if use_g and db >= args.target_db - CONFIRM_MARGIN_DB:
            exact_db = holdout_db(False)
        dte = time.perf_counter() - te
        if not evals:
            first_eval_s = dte
        eval_time += dte
        now = time.perf_counter()
        tag = f"guided{args.eval_guided}" if use_g else "holdout"
        evals.append({"steps": steps, "gate": tag,
                      "train_db": round(train_db, 2),
                      "gate_db": round(db, 2),
                      "exact_db": None if exact_db is None
                      else round(exact_db, 2),
                      "wall_s": round(now - t_wall0, 1)})
        log(f"step {steps}: train {train_db:.2f} dB, {tag} {db:.2f} dB"
            + ("" if exact_db is None else f", exact {exact_db:.2f} dB")
            + f" at wall {now - t_wall0:.1f}s")
        final_db = exact_db if use_g else db
        if final_db is not None and final_db >= args.target_db:
            crossed = {
                "steps": steps,
                "holdout_db": round(final_db, 2),
                "gate": tag,
                "wall_s_incl_compile": round(now - t_wall0, 1),
                "wall_s_excl_compile": round(
                    now - t_compiled - compile_extra, 1),
                "train_s_excl_evals": round(
                    now - t_compiled - compile_extra - eval_time, 1),
                "compile_s": {"first_step": round(t_compiled - t_wall0, 1),
                              "occ_install": round(compile_extra, 1),
                              "first_eval": round(first_eval_s, 1)},
            }
            break
    enc_tag = (f"cp_r{args.cp_rank}" if args.encoder == "cp"
               else "int8") + "+dense"
    return {"target_db": args.target_db, "crossed": crossed,
            "protocol": f"textured {H}x{W}, {args.views} views, batch "
                        f"{args.batch}, {enc_tag}+guided K=32 mass-dt"
                        + (f", {spc} steps/dispatch" if spc > 1 else "")
                        + (f", guided{args.eval_guided}-gated evals "
                           "(exact-confirmed crossing)"
                           if args.eval_guided else ""),
            "evals": evals, "steps": steps, "seed": args.seed,
            "card": card_line(device)}


def main(argv=None, log=print) -> dict:
    args = build_parser().parse_args(argv)
    result = run(args, log=log)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    log(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
