"""Seed spreads of training quality, the JAX trainer's and the port's, at one
cut size: whether the port's holdout PSNR (and, for the int8 speedrun, its
crossing step) differs in distribution from the JAX package's.

The JAX side (``--side jax``, on the CPU) drives the JAX scripts' own loops,
imported as modules and not copied: ``scripts/quality_matrix.py``
``_run_mode`` for a quality mode, ``scripts/speedrun_30db.py`` ``main`` for
the speedrun.  Its seed enters through the keys those loops make: seed 0 is
the scripts' own ``PRNGKey(0)`` (init), ``PRNGKey(1)`` (the step, folded
with the step count inside the step) and ``PRNGKey(steps)`` (a refresh);
seed s >= 1 replaces every ``PRNGKey(k)`` made while the loop trains by
``fold_in(PRNGKey(k), s)``.  The ground-truth render and every holdout
render keep their own keys.  The port side (``--side port``, on the card by
default) runs ``cli/quality_holdout.py``'s ``run_mode`` and
``cli/speedrun.py``'s ``run`` with ``--seed s``.  ``--draws_seed d`` splits
the init from the training draws: JAX folds d into the step and refresh
keys and s into the init key; the port reseeds its generator to d once the
field is drawn.

Both sides train the same scene, pose split, ray batch and step count, and
give the optimizer the same cosine horizon: ``--max_steps`` is both the
horizon and the cap, as in the JAX scripts; the wall budget never binds.
The speedrun (mode ``speedrun_int8``, ``--encoder int8``) evaluates the
interior holdout pose every ``--eval_every`` steps, ungated (its
target is set out of reach, so every run reaches the cap), and its crossing
steps are read from those evaluations afterwards.  The ground truth is
rendered afresh on each side and cached nowhere.

A row holds, on both sides, the same keys: the mode, side, seed, the cut
(``height``, ``views``, ``batch``, ``max_steps``), ``steps``, the holdout
(mean and per pose; for the speedrun its evaluations), the per-step
``loss`` and ``psnr``, ``occ_trace`` (the step and occupied fraction of
every refresh), ``draws`` (JAX: the keys the loop used; port: the
generator's seed), ``card`` and ``seconds``.

``--report`` reads row files of both sides and prints, a mode at a time,
each side's mean and standard deviation across seeds, Δ = port − JAX and
the verdict of the decision rule (PERF.md §6): the sides differ when |Δ| >
2·sqrt(s_port²/n_port + s_jax²/n_jax) and |Δ| > 0.3 dB (one evaluation
interval for a crossing step); then the loss curves (mean and spread every
``--curve_every`` steps), the occupied fraction at each refresh, and the
seeds that never trained (the last 16 steps' mean loss at least 0.9 of the
first 16's).

Run:  python tools/c2_spread.py --side jax --modes int8_dense_guided \\
          --seeds 0-3 --out results/c2_spread/jax.json
      python tools/c2_spread.py --side port --device cuda \\
          --modes int8_dense_guided --seeds 0-7 --out results/c2_spread/port.json
      python tools/c2_spread.py --report results/c2_spread/jax.json \\
          results/c2_spread/port.json
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, REPO)

SPEEDRUN = "speedrun_int8"      # the int8 speedrun, run as a mode
UNREACHED_DB = 99.0             # the speedrun's target: never crossed
# crossing targets, highest first: the protocol's 30 dB, then lower ones
# for cut runs that reach no higher
TARGETS_DB = (30.0, 29.0, 28.0, 27.0, 26.0, 25.0)
DIFF_DB = 0.3                   # the decision rule's floor on |Δ| in dB
FLAT_RATIO = 0.9                # a run "never trained": its last 16 steps'
                                # mean loss >= this share of its first 16's


def parse_seeds(text: str) -> list:
    """"0-3" or "0,2,5" as a list of ints."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def db(img, ref) -> float:
    mse = float(np.mean((np.asarray(img) - np.asarray(ref)) ** 2))
    return 10 * math.log10(1.0 / max(mse, 1e-12))


# ----------------------------------------------------------------- JAX side

def _load_script(name: str):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class JaxKeys:
    """``jax.random.PRNGKey`` as the loop sees it at ``seed``: the script's
    own key at seed 0, ``fold_in(PRNGKey(k), seed)`` after; with
    ``draws_seed`` the step and refresh keys (k != 0) take that seed and the
    init key (k == 0) ``seed``.  ``live`` is False while a holdout render
    runs, which keeps its own keys."""

    def __init__(self, seed: int, draws_seed=None):
        import jax

        self.seed, self.orig, self.live = seed, jax.random.PRNGKey, True
        self.draws_seed = seed if draws_seed is None else draws_seed

    def __call__(self, k, *a, **kw):
        import jax

        key = self.orig(k, *a, **kw)
        s = self.seed if int(k) == 0 else self.draws_seed
        if self.live and s:
            key = jax.random.fold_in(key, s)
        return key



def _words(key) -> list:
    return [int(w) for w in np.asarray(key).reshape(-1)]


class JaxRecorder:
    """The JAX loop's step, refresh and holdout render, wrapped to record
    the metrics, keys and occupied fractions; ``PRNGKey`` seeded."""

    def __init__(self, seed: int, hold_ref=None, draws_seed=None):
        self.keys = JaxKeys(seed, draws_seed)
        self.hold_ref = hold_ref
        self.metrics, self.refreshes, self.evals = [], [], []
        self.step_key = None
        self.init_key = None

    @contextlib.contextmanager
    def active(self):
        import jax

        from human_body_reconstruction_tpu.ops import occupancy
        from human_body_reconstruction_tpu.train import step as step_lib

        step0, refresh0 = step_lib.train_step, occupancy.update_from_field
        render0 = step_lib.render_image
        keys = self.keys

        def prng_key(k, *a, **kw):
            key = keys(k, *a, **kw)
            if keys.live and self.init_key is None and int(k) == 0:
                self.init_key = key
            return key

        def train_step(*a, **kw):
            if self.step_key is None:
                self.step_key = a[5]
            state, m = step0(*a, **kw)
            self.metrics.append(m)
            return state, m

        def update_from_field(occ, params, scene, key, *a, **kw):
            new = refresh0(occ, params, scene, key, *a, **kw)
            self.refreshes.append((len(self.metrics), _words(key),
                                   occupancy.occupied_fraction(new)))
            return new

        def render_image(*a, **kw):
            keys.live = False
            try:
                img = render0(*a, **kw)
            finally:
                keys.live = True
            if self.hold_ref is not None:
                self.evals.append((len(self.metrics), db(img, self.hold_ref)))
            return img

        with contextlib.ExitStack() as st:
            st.enter_context(_patched(jax.random, "PRNGKey", prng_key))
            st.enter_context(_patched(step_lib, "train_step", train_step))
            st.enter_context(_patched(occupancy, "update_from_field",
                                      update_from_field))
            st.enter_context(_patched(step_lib, "render_image", render_image))
            yield self

    def fields(self) -> dict:
        """The row's per-step curves, refresh trace and keys."""
        import jax

        loss = [float(m["loss"]) for m in self.metrics]
        psnr = [float(m["psnr"]) for m in self.metrics]
        step_keys = ([] if self.step_key is None else
                     [_words(jax.random.fold_in(self.step_key, i))
                      for i in range(4)])
        return {"loss": loss, "psnr": psnr,
                "occ_trace": [[n, round(float(f), 4)]
                              for n, _, f in self.refreshes],
                "draws": {"seed": self.keys.seed,
                          "init": (None if self.init_key is None
                                   else _words(self.init_key)),
                          "step": (None if self.step_key is None
                                   else _words(self.step_key)),
                          "step_0_3": step_keys,
                          "refresh": [[n, w] for n, w, _ in self.refreshes]}}


@contextlib.contextmanager
def _no_gt_cache():
    """The JAX ``load_or_render_gt`` with its /tmp cache neither read nor
    written."""
    exists = os.path.exists
    with _patched(os.path, "exists",
                  lambda p: False if "qm_gt_" in str(p) else exists(p)), \
            _patched(np, "savez_compressed", lambda *a, **k: None):
        yield


def jax_rows(args, log=print) -> list:
    import jax

    jax.config.update("jax_platforms", "cpu")
    qm = _load_script("quality_matrix")
    H = args.height
    with _no_gt_cache():
        gt = qm.load_or_render_gt(H, H, args.views, scene=args.scene,
                                  seed=args.scene_seed)
    rows = []
    for name in args.modes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            row = (jax_speedrun_row(args, seed, gt) if name == SPEEDRUN
                   else jax_mode_row(qm, name, seed, args, gt))
            rows.append(_row(args, name, "jax", seed, row,
                             time.perf_counter() - t0, "cpu"))
            log(_summary(rows[-1]))
            _write(args.out, rows)
    return rows


def jax_mode_row(qm, name, seed, args, gt) -> dict:
    """One seed of a quality mode through the JAX ``_run_mode``, on the
    ground truth ``gt`` (``load_or_render_gt``'s tuple)."""
    import jax.numpy as jnp

    from human_body_reconstruction_tpu.ops import dense_grid
    from human_body_reconstruction_tpu.ops import rays as rays_lib
    from human_body_reconstruction_tpu.utils import config as C

    H = args.height
    K, train_poses, hold_poses, train_imgs, hold_imgs = gt
    train_j, poses_j = jnp.asarray(train_imgs), jnp.asarray(train_poses)
    lo, hi = rays_lib.scene_bounds(H, H, K, poses_j, 2.0, 6.0)
    scene = {"mu": lo, "sigma": jnp.sqrt(jnp.sum((hi - lo) ** 2)),
             "min_bound": lo, "max_bound": hi}
    ns = argparse.Namespace(batch=args.batch, max_steps=args.max_steps,
                            budget=1e9, scene=args.scene, save_params=False)
    rec, results = JaxRecorder(seed, draws_seed=args.draws_seed), {}
    with rec.active():
        qm._run_mode(name, qm.make_modes(C, dense_grid)[name], ns, results,
                     scene, train_j, poses_j, K, hold_poses, hold_imgs, H, H)
    jrow = results[name]
    return {"holdout_psnr": jrow["holdout_psnr"],
            "holdout_per_pose": jrow["holdout_per_pose"],
            "train_psnr": jrow["train_psnr"], "steps": jrow["steps"],
            "evals": None, **rec.fields()}


def _speedrun_argv(args, out: str) -> list:
    return ["--encoder", "int8", "--height", str(args.height), "--views",
            str(args.views), "--batch", str(args.batch), "--max_steps",
            str(args.max_steps), "--eval_every", str(args.eval_every),
            "--eval_after_train_db", "0", "--target_db", str(UNREACHED_DB),
            "--out", out]


def jax_speedrun_row(args, seed, gt) -> dict:
    """One seed of the int8 speedrun through the JAX script's ``main``."""
    sr = _load_script("speedrun_30db")
    rec = JaxRecorder(seed, hold_ref=gt[4][0], draws_seed=args.draws_seed)
    out = os.path.join(os.path.dirname(args.out) or ".",
                       f"speedrun_int8_jax_seed{seed}.json")
    argv = ["speedrun_30db.py"] + _speedrun_argv(args, out)
    with _patched(sr, "load_or_render_gt", lambda *a, **k: gt), \
            _patched(sys, "argv", argv), rec.active():
        sr.main()
    return _speedrun_fields(rec.evals, len(rec.metrics), rec.fields())


# ---------------------------------------------------------------- port side

def port_rows(args, log=print) -> list:
    import torch

    from human_body_reconstruction_tpu_torch.cli import card_line
    from human_body_reconstruction_tpu_torch.cli import device_from_flag
    from human_body_reconstruction_tpu_torch.cli import quality_holdout as qh
    from human_body_reconstruction_tpu_torch.cli import speedrun

    device = device_from_flag(args.device)
    card = card_line(device)
    data = qh.protocol_data(args.height, args.height, args.views, args.scene,
                            device, scene_seed=args.scene_seed)
    made = []

    class Recording(qh.ModeRun):
        """``ModeRun`` recording each step's metrics and each holdout
        score; with ``--draws_seed`` its generator reseeded once the field
        is drawn."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if args.draws_seed is not None:
                self.gen.manual_seed(args.draws_seed)
            self.metrics, self.evals = [], []
            made.append(self)

        def step(self):
            m = super().step()
            self.metrics.append({k: m[k].detach().clone()
                                 for k in ("loss", "psnr")})
            return m

        def holdout_psnr(self, pose, ref, cfg=None, occ=None):
            v = super().holdout_psnr(pose, ref, cfg, occ)
            self.evals.append((len(self.metrics), v))
            return v

        def fields(self) -> dict:
            return {"loss": [float(m["loss"]) for m in self.metrics],
                    "psnr": [float(m["psnr"]) for m in self.metrics],
                    "occ_trace": [[n, round(float(f), 4)]
                                  for n, f in self.trace]}

    rows = []
    for name in args.modes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            made.clear()
            with _patched(qh, "ModeRun", Recording), \
                    _patched(qh, "protocol_data", lambda *a, **k: data):
                if name == SPEEDRUN:
                    out = os.path.join(os.path.dirname(args.out) or ".",
                                       f"speedrun_int8_port_seed{seed}.json")
                    sargs = speedrun.build_parser().parse_args(
                        _speedrun_argv(args, out)
                        + ["--seed", str(seed), "--device", args.device])
                    res = speedrun.run(sargs, log=lambda s: None)
                    run = made[0]
                    row = _speedrun_fields(run.evals, res["steps"],
                                           run.fields())
                else:
                    qargs = qh.build_parser().parse_args(
                        ["--mode", name, "--scene", args.scene,
                         "--scene_seed", str(args.scene_seed), "--height",
                         str(args.height), "--views", str(args.views),
                         "--batch", str(args.batch), "--max_steps",
                         str(args.max_steps), "--budget", "1e9", "--seed",
                         str(seed), "--device", args.device])
                    qrow = qh.run_mode(name, qh.make_modes()[name], qargs,
                                       data, device, log=lambda s: None)
                    row = {"holdout_psnr": qrow["holdout_psnr"],
                           "holdout_per_pose": qrow["holdout_per_pose"],
                           "train_psnr": qrow["train_psnr"],
                           "steps": qrow["steps"], "evals": None,
                           **made[0].fields()}
            row["draws"] = {"seed": seed, "generator": "torch.Generator("
                            f"{device.type}).manual_seed({seed})",
                            "draws_seed": args.draws_seed}
            if device.type == "cuda":
                torch.cuda.synchronize()
            rows.append(_row(args, name, "port", seed, row,
                             time.perf_counter() - t0, card))
            log(_summary(rows[-1]))
            _write(args.out, rows)
    return rows


# ------------------------------------------------------------------ shared

def _speedrun_fields(evals, steps, fields) -> dict:
    """A speedrun's row: its evaluations (steps, dB), the dB at the cap
    as its holdout, and the first step at which each target is reached."""
    evals = [[int(n), float(v)] for n, v in evals]
    return {"holdout_psnr": evals[-1][1] if evals else None,
            "holdout_per_pose": None,
            "train_psnr": round(fields["psnr"][-1], 2) if fields["psnr"]
            else None,
            "steps": steps, "evals": evals,
            "crossing": {str(t): crossing(evals, t) for t in TARGETS_DB},
            **fields}


def crossing(evals, target):
    """The first evaluated step whose dB reaches ``target``, else None."""
    return next((n for n, v in evals if v >= target), None)


def _row(args, name, side, seed, row, seconds, card) -> dict:
    row.setdefault("crossing", None)
    return {"mode": name, "side": side, "seed": seed,
            "draws_seed": seed if args.draws_seed is None else args.draws_seed,
            "scene": args.scene,
            "scene_seed": args.scene_seed, "height": args.height,
            "views": args.views, "batch": args.batch,
            "max_steps": args.max_steps,
            "eval_every": args.eval_every if name == SPEEDRUN else None,
            **row, "card": card, "seconds": round(seconds, 1)}


def _summary(row) -> str:
    return (f"[{row['side']}] {row['mode']} seed {row['seed']}: "
            f"{row['steps']} steps, holdout {row['holdout_psnr']}, "
            f"train {row['train_psnr']}, {row['seconds']} s")


def _write(path, rows):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f)


# ------------------------------------------------------------------ report

def _stats(xs):
    xs = [x for x in xs if x is not None]
    n = len(xs)
    if not n:
        return n, None, None
    m = float(np.mean(xs))
    s = float(np.std(xs, ddof=1)) if n > 1 else 0.0
    return n, m, s


def verdict(port, jax_, floor: float) -> dict:
    """The decision rule on two samples: Δ = mean(port) − mean(jax); they
    differ when |Δ| > 2·sqrt(s_p²/n_p + s_j²/n_j) and |Δ| > ``floor``."""
    np_, mp, sp = _stats(port)
    nj, mj, sj = _stats(jax_)
    out = {"n_port": np_, "mean_port": mp, "s_port": sp, "n_jax": nj,
           "mean_jax": mj, "s_jax": sj, "delta": None, "bar": None,
           "differ": None, "missing_port": len(port) - np_,
           "missing_jax": len(jax_) - nj}
    if np_ and nj:
        delta = mp - mj
        bar = 2 * math.sqrt(sp ** 2 / np_ + sj ** 2 / nj)
        out.update(delta=delta, bar=bar,
                   differ=bool(abs(delta) > bar and abs(delta) > floor))
    return out


def _curve(rows, key, every):
    """Mean and spread across seeds of the per-step ``key`` averaged over
    windows of ``every`` steps."""
    arrs = [np.asarray(r[key], float) for r in rows if r.get(key)]
    if not arrs:
        return []
    n = min(len(a) for a in arrs)
    out = []
    for end in range(every, n + 1, every):
        w = [float(np.mean(a[end - every:end])) for a in arrs]
        out.append([end, float(np.mean(w)), float(np.std(w))])
    return out


def report(paths, every: int = 32) -> dict:
    rows = []
    for p in paths:
        with open(p) as f:
            rows.extend(json.load(f))
    out = {}
    groups = {}
    for r in rows:
        groups.setdefault((r["mode"], r["scene"], r["scene_seed"],
                           r["max_steps"]), []).append(r)
    for (mode, scene, sseed, steps), rs in groups.items():
        side = {s: [r for r in rs if r["side"] == s] for s in ("port", "jax")}
        cuts = {(r["height"], r["views"], r["batch"], r["max_steps"])
                for r in rs}
        tag = (f"{mode}@{scene}{sseed if scene == 'tangle' else ''}"
               f"/{steps}")
        rec = {"cut": sorted(cuts),
               "holdout": verdict([r["holdout_psnr"] for r in side["port"]],
                                  [r["holdout_psnr"] for r in side["jax"]],
                                  DIFF_DB),
               "loss_curve": {s: _curve(v, "loss", every)
                              for s, v in side.items()},
               "psnr_curve": {s: _curve(v, "psnr", every)
                              for s, v in side.items()},
               "occ_trace": {s: _occ(v) for s, v in side.items()},
               "flat": {s: [r["seed"] for r in v if flat(r["loss"])]
                        for s, v in side.items()}}
        if mode == SPEEDRUN:
            gate = max(r["eval_every"] or 1 for r in rs)
            reached = [t for t in TARGETS_DB if all(
                crossing(r["evals"], t) is not None for r in rs)]
            target = reached[0] if reached else None
            rec["target_db"] = target
            if target is not None:
                rec["crossing"] = verdict(
                    [crossing(r["evals"], target) for r in side["port"]],
                    [crossing(r["evals"], target) for r in side["jax"]], gate)
            rec["crossings"] = {s: [[r["seed"], {str(t): crossing(
                r["evals"], t) for t in TARGETS_DB}] for r in v]
                for s, v in side.items()}
        out[tag] = rec
    return out


def flat(loss) -> bool:
    """Whether a run never trained: the mean loss of its last 16 steps is
    at least FLAT_RATIO of its first 16's."""
    return (len(loss) >= 32
            and np.mean(loss[-16:]) >= FLAT_RATIO * np.mean(loss[:16]))


def _occ(rows):
    by_step = {}
    for r in rows:
        for n, f in r.get("occ_trace") or []:
            by_step.setdefault(n, []).append(f)
    return [[n, float(np.mean(v)), float(np.std(v)), len(v)]
            for n, v in sorted(by_step.items())]


def print_report(rep, log=print):
    log("| mode | side | n | mean ± s | Δ (port − JAX) | bar | verdict |")
    log("|---|---|---|---|---|---|---|")
    for tag, rec in rep.items():
        for what in ("holdout", "crossing"):
            v = rec.get(what)
            if not v:
                continue
            unit = " dB" if what == "holdout" else " steps"
            label = tag + ("" if what == "holdout"
                           else f" (crossing {rec['target_db']} dB)")
            for s in ("jax", "port"):
                if v.get(f"n_{s}"):
                    log(f"| {label} | {s} | {v[f'n_{s}']} | "
                        f"{v[f'mean_{s}']:.3f} ± {v[f's_{s}']:.3f}{unit} | | "
                        "| |")
            if v["delta"] is not None:
                log(f"| {label} | Δ | | | {v['delta']:+.3f} | "
                    f"{v['bar']:.3f} | "
                    f"{'differ' if v['differ'] else 'same'} |")
        for s, seeds in rec["flat"].items():
            if seeds:
                log(f"| {tag} | {s} never trained | {len(seeds)} | seeds "
                    f"{seeds} | | | |")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--side", choices=("jax", "port"))
    p.add_argument("--modes", type=str, default="int8_dense_guided",
                   help="comma-separated quality modes, and speedrun_int8 "
                        "for the int8 speedrun")
    p.add_argument("--seeds", type=str, default="0-3",
                   help="seeds, as 0-3 or 0,2,5")
    p.add_argument("--draws_seed", type=int, default=None,
                   help="seed of the training draws (JAX: the step and "
                        "refresh keys; port: the generator, reseeded after "
                        "the init); default each run's --seeds seed")
    p.add_argument("--scene", type=str, default="textured")
    p.add_argument("--scene_seed", type=int, default=0)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--max_steps", type=int, default=512,
                   help="the optimizer's horizon and the cap on steps")
    p.add_argument("--eval_every", type=int, default=32,
                   help="the speedrun's evaluation interval")
    p.add_argument("--device", type=str, default="cuda",
                   help="the port side's torch device")
    p.add_argument("--out", type=str, default=None,
                   help="rows (default results/c2_spread/<side>.json)")
    p.add_argument("--report", nargs="+", default=None,
                   help="row files to compare; prints the verdicts")
    p.add_argument("--curve_every", type=int, default=32)
    return p


def main(argv=None, log=print):
    args = build_parser().parse_args(argv)
    if args.report:
        rep = report(args.report, args.curve_every)
        print_report(rep, log)
        if args.out:
            _write(args.out, rep)
        return rep
    if args.side is None:
        raise SystemExit("give --side jax or --side port, or --report")
    args.modes = args.modes.split(",")
    if SPEEDRUN in args.modes and args.scene != "textured":
        raise SystemExit(f"{SPEEDRUN} runs on the textured scene only")
    args.seeds = parse_seeds(args.seeds)
    if args.out is None:
        args.out = os.path.join("results", "c2_spread", f"{args.side}.json")
    return (jax_rows if args.side == "jax" else port_rows)(args, log)


if __name__ == "__main__":
    main()
