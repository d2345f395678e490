"""The benchmark's cells cut to a size a CPU test run holds: every width
as the configuration states it, the batch, the samples, the scene and the
grid small, the grid's install right after the first steps (so that every run,
however short, reaches the stage the check follows) and the TV a few steps
in."""

from __future__ import annotations

import copy

from benchmark import cells

SCENE = {"n_views": 3, "H": 12, "W": 12, "focal": 13.0, "near": 2.0,
         "far": 6.0, "radius": 4.0, "elevation": 0.35, "gt_samples": 32}


def tiny_cell(name: str) -> cells.Cell:
    cell = copy.deepcopy(cells.load(name))
    p = cell.config["pipeline"]
    p["train"].update(ray_batch=48, occ_warmup_steps=3, cp_tv_warmup=5)
    p["render"].update(num_samples=16, compact_samples=8, occ_probes=8,
                       occupancy_resolution=32)
    tr = cell.traffic
    tr["scene"] = dict(SCENE)
    if tr["driver"] == "train":
        tr.update(steps_per_call=4, log_every=4, trace_from_step=8,
                  trace_chunks=1)
    else:
        tr.update(height=10, width=12, eval_guided=8, warm_frames=1,
                  check_frames=2)
    return cell
