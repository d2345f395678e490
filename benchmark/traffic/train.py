"""Training traffic: a fresh training run of one configuration, driven
through the program's ``Trainer.run`` as ``train_hash`` drives it.

Set-up makes the scene and the weights from the seed, warms the shapes the
window will meet (a throwaway trainer crosses the grid's install when the
configuration has one, so that the guided step's kernels and GEMMs are
loaded before the window), builds the trainer, loads the weights into it,
reseeds its generator, and takes its first ``start_steps`` steps one at a
time through ``Trainer.run`` (the first is the capture of the window's
graph); those steps are compared with the reference.  The window then
calls ``Trainer.run`` in chunks of ``log_every`` steps (whole log
intervals) until ``--seconds`` have passed; the rate is every ray trained
in the window over its length, which ends in a synchronise.  A traced run
profiles ``trace_chunks`` chunks from the first chunk that starts at or
after ``trace_from_step``.  After the window, a configuration with an
occupancy grid takes one more step and one refresh from a snapshot of the
program's state, which the reference follows.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import types

import torch

from benchmark import cells, correct, inputs
from benchmark import trace as trace_lib
from benchmark.reference import field as ref

CONTROL = torch.float8_e4m3fn       # the nearest precision below bf16


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quiet(line: str):
    print(line, file=sys.stderr, flush=True)


def _trainer(cfg, ds, spc: int, horizon: int, out_dir: str):
    from human_body_reconstruction_tpu_torch.train.trainer import Trainer

    return Trainer(cfg=cfg, ds=ds, out_dir=out_dir, model_name="bench",
                   log_fn=_quiet, total_steps=horizon, steps_per_call=spc)


def _warm_installed_path(cfg, ds, spc, horizon, out_dir):
    """Cross the grid's install once in a throwaway trainer: the guided
    step's capture, a refresh and a log, so that the window's install
    loads nothing."""
    warm = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, occ_warmup_steps=1))
    t = _trainer(warm, ds, spc, horizon, out_dir)
    t.run(2, log_every=2)
    t.run(spc + 1, log_every=spc + 1)
    del t


def _crossed(upto: int, n: int, every: int) -> bool:
    return every > 0 and upto // every > (upto - n) // every


def _snapshot(trainer, leaves):
    st = trainer.state
    return {"step": st.step,
            "w": {k: v.detach().clone() for k, v in leaves.items()},
            "m": {k: st.opt.moments(v)[0].clone() for k, v in leaves.items()},
            "occ": None if st.occ is None else {
                "density": st.occ.density.clone(), "mask": st.occ.mask.clone()},
            "gen": trainer.generator.get_state()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        extra_readings: bool = False) -> dict:
    t0 = time.perf_counter()
    tr, conf = cell.traffic, cell.config
    p = conf["pipeline"]
    p = dict(p, train=dict(p["train"], seed=seed))
    cfg = cells.program_config(p)
    spc, chunk = tr["steps_per_call"], tr["log_every"]
    horizon = conf["schedule_horizon_steps"]
    draw_seed = seed + 1
    ds = inputs.make_scene(device, tr["scene"])
    scratch = cells.scratch()
    out_dir = scratch.name
    if cfg.render.occupancy and cfg.train.occ_warmup_steps > 0:
        _warm_installed_path(cfg, ds, spc, horizon, out_dir)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = _trainer(cfg, ds, spc, horizon, out_dir)
    weights = inputs.make_weights(p, seed, device)
    inputs.load_into(trainer.state.field, weights)
    trainer.generator.manual_seed(draw_seed)
    leaves = inputs.program_leaves(trainer.state.field)
    losses, first_grad = [], None
    for k in range(tr["start_steps"]):
        with trace_lib.span("Trainer.run"):
            trainer.run(1, log_every=1)
        losses.append(trainer.history[-1]["loss"])
        if k == 0:
            first_grad = correct.norms({
                n: trainer.state.opt.moments(v)[0] / (1.0 - ref.ADAM_B1)
                for n, v in leaves.items()})
    change = correct.norms({n: v.detach() - weights[n]
                            for n, v in leaves.items()})
    sync(device)
    setup_s = time.perf_counter() - t0

    first = trainer.state.step
    seg, seg_done, seg_steps = None, None, None
    installed = []
    t_start = time.perf_counter()
    while True:
        if (trace and seg is None and seg_done is None
                and trainer.state.step >= tr["trace_from_step"]):
            seg, seg_first, seg_chunks = trace_lib.Segment(), \
                trainer.state.step, 0
            installed.append(trainer.state.occ is not None)
        with trace_lib.span("Trainer.run"):
            trainer.run(chunk, log_every=chunk)
        if seg is not None:
            seg_chunks += 1
            if seg_chunks == tr["trace_chunks"]:
                seg.close()
                installed.append(trainer.state.occ is not None)
                seg_done, seg, seg_steps = seg, None, (seg_first,
                                                       trainer.state.step)
        if time.perf_counter() - t_start >= seconds:
            break
    if seg is not None:
        seg.close()
        installed.append(trainer.state.occ is not None)
        seg_done, seg_steps = seg, (seg_first, trainer.state.step)
    sync(device)
    window_s = time.perf_counter() - t_start
    steps = trainer.state.step - first
    bad = sum(not math.isfinite(r["loss"]) for r in trainer.history)

    stage = None
    if trainer.state.occ is not None:
        if _crossed(trainer.state.step + 1, 1, cfg.train.update_rate):
            trainer.run(1, log_every=1)        # the stage step refreshes none
        stage = {"before": _snapshot(trainer, leaves)}
        trainer.run(1, log_every=1)
        stage["loss"] = trainer.history[-1]["loss"]
        stage["m"] = {n: trainer.state.opt.moments(v)[0].clone()
                      for n, v in leaves.items()}
        stage["w"] = {n: v.detach().clone() for n, v in leaves.items()}
        stage["gen"] = trainer.generator.get_state()
        trainer.update_occupancy()
        stage["density"] = trainer.state.occ.density.clone()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del trainer, leaves
    scratch.cleanup()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    segment = None
    if seg_done is not None:
        if len(set(installed)) != 1:
            raise RuntimeError("the grid was installed inside the traced "
                               "segment: trace_from_step must lie past the "
                               "warmup")
        segment = trace_lib.reduce(seg_done)
        del seg_done
        a, b = seg_steps
        h = p["hash"]
        segment["run"] = types.SimpleNamespace(
            kind="train", p=p, steps=b - a,
            points=p["train"]["ray_batch"] * (
                p["render"]["compact_samples"] if installed[0]
                else p["render"]["num_samples"]),
            refreshes=sum(_crossed(e, spc, p["train"]["update_rate"])
                          for e in range(a + spc, b + 1, spc))
            if installed[0] else 0,
            stochastic=h["variant"] != "cp" and h["stochastic_train"])

    scene = ref.scene_of(*ref.bounds_of(ds, p["render"]["near"],
                                        p["render"]["far"]))
    args = (p, ds, scene, seed, draw_seed, tr["start_steps"], horizon)
    bf16 = ref.Rounding(torch.bfloat16)
    prog = (losses, first_grad, change)
    base = _start_run(*args, bf16)
    readings = _start_gaps("", prog, base)
    if stage is not None:
        snap = stage["before"]
        prog_stage = (stage["loss"], correct.norms({
            n: (stage["m"][n] - ref.ADAM_B1 * snap["m"][n])
            / (1.0 - ref.ADAM_B1) for n in snap["m"]}), stage["density"])
        base_stage = _stage_run(p, ds, scene, stage, bf16)
        readings.update(_stage_gaps("", prog_stage, base_stage))
    if extra_readings:
        control = ref.Rounding(CONTROL)
        readings.update(_start_gaps("control.", _start_run(*args, control),
                                    base))
        readings.update(_start_gaps("half_batch.", _start_run(
            *args, bf16, half_batch=True), base))
        if stage is not None:
            readings.update(_stage_gaps("control.", _stage_run(
                p, ds, scene, stage, control), base_stage))
    return {"setup_s": setup_s, "attempted": steps, "failed": bad,
            "metrics": {"train_rays_per_s": (
                steps * p["train"]["ray_batch"] / window_s, "rays/s")},
            "memory_peak_bytes": peak, "segment": segment,
            "readings": readings}


def _start_run(p, ds, scene, seed, draw_seed, n_steps, horizon, rnd,
               half_batch=False):
    """The reference's first ``n_steps`` steps from the seed's weights and
    draws: (losses, first gradient's leaf norms, leaf norms of the change
    over the steps)."""
    dev = ds["images"].device
    w0 = inputs.make_weights(p, seed, dev)
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in w0.items()}
    gen = torch.Generator(dev).manual_seed(draw_seed)
    losses, grad = [], None
    with ref.no_tf32():
        for k in range(n_steps):
            losses.append(ref.train_step(w, p, ds, scene, k, gen, rnd,
                                         half_batch=half_batch))
            if k == 0:
                grad = correct.norms({n: v.grad for n, v in w.items()})
            ref.adam_update(w, moments, p, k, horizon)
    return losses, grad, correct.norms({n: w[n].detach() - w0[n] for n in w})


def _start_gaps(tag, got, want):
    """The first step's loss (the later steps' losses swing with the card's
    float-atomic sums: a sign flip of Adam's first update on an entry whose
    gradient is rounding moves it by the whole rate), the first gradient,
    and the change over the steps."""
    keep = correct.moving_leaves(want[1])
    return {f"{tag}loss_gap": correct.loss_gap(got[0][:1], want[0][:1]),
            f"{tag}grad_gap": correct.worst_leaf_gap(got[1], want[1])[0],
            f"{tag}change_gap": correct.worst_leaf_gap(got[2], want[2],
                                                       keep)[0]}


def _stage_run(p, ds, scene, stage, rnd):
    """One guided step of the reference from a snapshot of the program's
    state, and one refresh from the program's state after its step: (loss,
    gradient's leaf norms, the refreshed density, the cells the refresh
    drew)."""
    snap = stage["before"]
    dev = ds["images"].device
    w = {k: v.clone().requires_grad_(True) for k, v in snap["w"].items()}
    gen = torch.Generator(dev)
    gen.set_state(snap["gen"])
    with ref.no_tf32():
        loss = ref.train_step(w, p, ds, scene, snap["step"], gen, rnd,
                              snap["occ"])
        grad = correct.norms({n: v.grad for n, v in w.items()})
        gen.set_state(stage["gen"])
        new = ref.refresh(snap["occ"], ref.field_density(stage["w"], p, scene,
                                                         rnd), scene,
                          p["render"]["occ_threshold"], gen)
    return loss, grad, new["density"], new["drawn"]


def _stage_gaps(tag, got, want):
    drawn = want[3]
    return {f"{tag}stage_loss_gap": correct.loss_gap([got[0]], [want[0]]),
            f"{tag}stage_grad_gap": correct.worst_leaf_gap(got[1],
                                                           want[1])[0],
            f"{tag}refresh_gap": correct.relative_gap(
                got[2].reshape(-1)[drawn], want[2].reshape(-1)[drawn])}
