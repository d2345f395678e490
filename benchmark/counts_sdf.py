"""The yardstick of the neuralangelo configuration: its two MLPs'
operations and its hash grid's least bytes, as functions of the
configuration's shapes and of the points a step evaluates
(``sdf_head.step_points``: the centre points, their six taps, and the
up-sampling's points, evaluated without gradient).  The peaks are
``counts.py``'s.

MLP FLOPs, 2 d_in d_out a layer and point forward, three times that with
the backward: the SDF MLP's hidden layers at every point; its last layer
whole (1 + 256 outputs) at the centre points and its first output alone at
the taps and the up-sampling's points; the colour MLP at the centre points.
The up-sampling's points take the forward alone.

Hash grid, F features a level, L levels, one 32-byte sector a corner row
(F 8 f32 rows are 32-byte aligned), each row counted once however many
points read it: the forward reads each point (12 bytes), writes its L F
features, and reads the rows its cells' corners need; the backward reads
each point and its L F gradient columns and adds to those rows.  A
position needs 8 rows a level.  A tap lies one cell of the finest level
from its centre (every level is active at the cell's stage), so at level
l it moves s_l / res_L cells (s_l the level's scale, res_L the finest
resolution), crosses into the next cell that share of the time and then
needs the 4 rows of that cell's far face: a centre and its six taps need 8
+ 24 min(1, s_l / res_L) rows, 32 at the finest level.  The distinct
positions are the centre points and the up-sampling's; each level's count
is at most the table's T and the (floor(s_l) + 2)^3 corners of its grid.
The operations are ``counts.encoder_ops``' exact hash counts.
"""

from __future__ import annotations

import numpy as np

from benchmark import counts
from benchmark.inputs import level_scales
from benchmark.reference import neuralangelo as ref

SECTOR = 32


def mlp_flops(p: dict, points: dict) -> float:
    d = ref.layer_dims(p)
    sdf, rgb = d["sdf"], d["rgb"]
    hidden = sum(a * b for a, b in sdf[:-1])
    last_in, last_out = sdf[-1]
    colour = sum(a * b for a, b in rgb)
    c, t, u = points["centre"], points["taps"], points["upsample"]
    with_grad = 2 * (c * (hidden + last_in * last_out + colour)
                     + t * (hidden + last_in))
    return 3 * with_grad + 2 * u * (hidden + last_in)


def _row_bytes(h: dict, positions: int, centres: int) -> int:
    """Bytes of the distinct corner rows that ``positions`` points need,
    ``centres`` of them with their six taps."""
    T = 2 ** h["log2_table_size"]
    scales = level_scales(h)
    res_top = int(np.floor(scales[-1])) + 1
    return SECTOR * sum(
        min(8 * positions + 24 * centres * min(1.0, s / res_top), T,
            (int(np.floor(s)) + 2) ** 3) for s in scales)


def hash_bound_s(p: dict, points: dict) -> float:
    """Least seconds of a step's hash forward (every point) and backward
    (the centre points and taps)."""
    h = p["hash"]
    L, F = h["num_levels"], h["features_per_level"]
    fwd_n = points["centre"] + points["taps"] + points["upsample"]
    bwd_n = points["centre"] + points["taps"]
    ops = counts.encoder_ops({"hash": dict(h, dense_levels=0, variant="corner")},
                             1, False, False)["hash"]
    c = points["centre"]
    fwd = (12 + 4 * L * F) * fwd_n + _row_bytes(h, c + points["upsample"], c)
    bwd = (12 + 4 * L * F) * bwd_n + _row_bytes(h, c, c)
    return (counts.bound_s(fwd, fwd_n * ops)
            + counts.bound_s(bwd, bwd_n * (ops + L * F)))
