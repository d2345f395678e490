"""SDF training traffic: a fresh run of the neuralangelo configuration,
driven through the program's ``Trainer.run`` as ``train_hash --preset
neuralangelo --steps_per_call 25`` drives it, held to the plain reference
``reference/neuralangelo.py``.

As ``train.py`` (whose pieces it reuses), with three differences: the
weights are the reference's ``init_weights`` (the table, the geometric
init of the SDF MLP, the colour MLP, s_var), loaded into the program's
field by name; the run's schedule is read from the traffic's
``schedule_step`` on (the trainer's step count starts there, and the
reference's counts follow), so that the window meets the stage a long run
spends most of its steps in; and a traced segment starts at the first
chunk ``trace_from_step`` steps or more into the run.  The traced run
records the program's per-step point counts (``sdf_head.step_points``),
which the SDF metrics read.  The control's readings add the reference in
bfloat16 (the precision below the configuration's f32) and its planted
faults: a dropped tap, twice the tap step, the Laplacian left out.
"""

from __future__ import annotations

import math
import sys
import time
import types

import numpy as np
import torch

from benchmark import cells, correct, inputs
from benchmark import trace as trace_lib
from benchmark.reference import neuralangelo as ref
from benchmark.traffic.train import _start_gaps, _trainer, sync

CONTROL = torch.bfloat16


def run(cell, seed: int, seconds: float, trace: bool, device,
        extra_readings: bool = False) -> dict:
    from human_body_reconstruction_tpu_torch.models import sdf_head

    t0 = time.perf_counter()
    tr, conf = cell.traffic, cell.config
    p = conf["pipeline"]
    p = dict(p, train=dict(p["train"], seed=seed))
    cfg = cells.program_config(p)
    spc, chunk = tr["steps_per_call"], tr["log_every"]
    horizon = conf["schedule_horizon_steps"]
    offset = tr["schedule_step"]
    draw_seed = seed + 1
    ds = inputs.make_scene(device, tr["scene"])
    scratch = cells.scratch()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = _trainer(cfg, ds, spc, horizon, scratch.name)
    weights = ref.init_weights(p, seed, device)
    sdf_head.load_leaves(trainer.state.field, weights)
    trainer.state.step = offset
    trainer.generator.manual_seed(draw_seed)
    leaves = sdf_head.named_leaves(trainer.state.field)
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
    seg, seg_done, seg_steps, points = None, None, None, None
    t_start = time.perf_counter()
    while True:
        if (trace and seg is None and seg_done is None
                and trainer.state.step - offset >= tr["trace_from_step"]):
            seg, seg_first, seg_chunks = trace_lib.Segment(), \
                trainer.state.step, 0
        with trace_lib.span("Trainer.run"):
            trainer.run(chunk, log_every=chunk)
        if seg is not None:
            seg_chunks += 1
            if seg_chunks == tr["trace_chunks"]:
                seg.close()
                seg_done, seg, seg_steps = seg, None, (seg_first,
                                                       trainer.state.step)
        if time.perf_counter() - t_start >= seconds:
            break
    if seg is not None:
        seg.close()
        seg_done, seg_steps = seg, (seg_first, trainer.state.step)
    sync(device)
    window_s = time.perf_counter() - t_start
    steps = trainer.state.step - first
    bad = sum(not math.isfinite(r["loss"]) for r in trainer.history)
    points = sdf_head.step_points()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del trainer, leaves
    scratch.cleanup()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    segment = None
    if seg_done is not None:
        segment = trace_lib.reduce(seg_done)
        del seg_done
        a, b = seg_steps
        segment["run"] = types.SimpleNamespace(
            kind="train_sdf", p=p, steps=b - a, points=points,
            refreshes=0, stochastic=False)

    lo, hi = ref.bounds_of(ds, p["render"]["near"], p["render"]["far"])
    scene = ref.scene_of(lo, hi)
    args = (p, ds, scene, seed, draw_seed, tr["start_steps"], offset, horizon)
    prog = (losses, first_grad, change)
    base = _start_run(*args, ref.Rounding(None))
    readings = _start_gaps("", prog, base)
    _worst_leaves(prog, base)
    if extra_readings:
        readings.update(_start_gaps("control.", _start_run(
            *args, ref.Rounding(CONTROL)), base))
        for fault in ref.FAULTS:
            readings.update(_start_gaps(f"{fault}.", _start_run(
                *args, ref.Rounding(None), fault=fault), base))
    return {"setup_s": setup_s, "attempted": steps, "failed": bad,
            "metrics": {"train_rays_per_s": (
                steps * p["train"]["ray_batch"] / window_s, "rays/s")},
            "memory_peak_bytes": peak, "segment": segment,
            "readings": readings}


def _worst_leaves(got, want):
    """Name, on standard error, the leaves whose gradient and change gaps
    are the largest (what the readings compare)."""
    keep = correct.moving_leaves(want[1])
    med = {i: float(np.median(list(want[i].values()))) for i in (1, 2)}
    for i, what in ((1, "gradient"), (2, "change")):
        gaps = {k: abs(got[i][k] - want[i][k]) / max(want[i][k], med[i], 1e-30)
                for k in want[i] if i == 1 or k in keep}
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        print(f"train_sdf: largest {what} gaps: "
              + ", ".join(f"{k} {v:.3g}" for k, v in top), file=sys.stderr)


def _start_run(p, ds, scene, seed, draw_seed, n_steps, offset, horizon, rnd,
               fault=None):
    """The reference's first ``n_steps`` steps from the seed's weights and
    draws at counts ``offset`` on: (losses, first gradient's leaf norms,
    leaf norms of the change over the steps)."""
    dev = ds["images"].device
    w0 = ref.init_weights(p, seed, dev)
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in w0.items()}
    gen = torch.Generator(dev).manual_seed(draw_seed)
    losses, grad = [], None
    with ref.no_tf32():
        for k in range(n_steps):
            losses.append(ref.train_step(w, p, ds, scene, offset + k, horizon,
                                         gen, rnd, fault))
            if k == 0:
                grad = correct.norms({n: v.grad for n, v in w.items()})
            ref.adam_update(w, moments, p, offset + k, horizon)
    out = (losses, grad,
           correct.norms({n: w[n].detach() - w0[n] for n in w}))
    del w, moments, w0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
