"""The yardstick: the card's published peaks and the operations and bytes
each piece of work needs, as functions of a configuration's shapes and of
the points a launch encodes alone.

Peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W): 3.35 TB/s
of HBM3, 67 TFLOP/s of f32 outside the tensor cores (the configurations'
GEMMs are f32 with TF32 off) and half that rate for the integer Philox
rounds.  A bound is the larger of bytes over the bandwidth and operations
over the rate: each input read once, each output written once, a column
block of a wider matrix counted by the 32-byte sectors its rows cover.
The per-point operation counts are the encoder kernels' scalar operations
as the port's own smoke counted them when this benchmark was written,
frozen here so that a later kernel is held to the same counts.
"""

from __future__ import annotations

import numpy as np

from benchmark.inputs import level_scales

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
PHILOX_OPS_PER_VALUE = 28
REFRESH_CELLS = 2 ** 18


def bound_s(n_bytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least seconds a call that moves n_bytes and does ops can take."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def _sizes(p: dict):
    h = p["hash"]
    s = level_scales(h)
    D = h["dense_levels"]
    return h, D, [int(np.floor(s[l])) + 2 for l in range(h["num_levels"])]


def encoder_width(p: dict) -> int:
    h, D, _ = _sizes(p)
    if h["variant"] == "cp":
        return D * h["features_per_level"] + (h["num_levels"] - D) * h["cp_rank"]
    return h["num_levels"] * h["features_per_level"]


def sector_bytes(n: int, col0: int, cols: int, width: int) -> int:
    """Bytes of the 32-byte sectors that n rows of ``cols`` f32 columns
    from ``col0`` in an (n, width) f32 matrix cover."""
    if cols == width:
        return 4 * n * width
    first = (np.arange(n, dtype=np.int64) * width + col0) * 4
    last = first + cols * 4 - 1
    return int(((last // 32) - (first // 32) + 1).sum()) * 32


def table_bytes(p: dict) -> dict:
    """f32 bytes of each encoder's tables: {"dense", "cp" or "hash"}."""
    h, D, G = _sizes(p)
    F = h["features_per_level"]
    out = {"dense": 4 * sum(g ** 3 * F for g in G[:D])}
    if h["variant"] == "cp":
        out["cp"] = 4 * 3 * sum(G[D:]) * h["cp_rank"]
    else:
        out["hash"] = (4 * (h["num_levels"] - D)
                       * 2 ** h["log2_table_size"] * F)
    return out


def encoder_ops(p: dict, n: int, backward: bool, stochastic: bool) -> dict:
    """Scalar operations of each encoder kernel on n points."""
    h, D, _ = _sizes(p)
    F, L = h["features_per_level"], h["num_levels"] - D
    out = {}
    if D:
        out["dense"] = n * D * (28 + (18 if backward else 17) * F)
    if h["variant"] == "cp":
        out["cp"] = n * L * (h["cp_rank"] * (26 if backward else 11) + 3 * 6)
    else:
        fwd = n * L * (15 + (11 if stochastic else 8 * (10 + 2 * F)))
        out["hash"] = fwd + (n * L * F if backward else 0)
    return out


def encoder_bound_s(p: dict, n: int, backward: bool, stochastic: bool) -> float:
    """Least seconds of the encoder's kernels on n points: the forward
    (each level into its columns of the (n, width) feature matrix), or the
    backward (points, incoming gradient columns, tables read and their
    gradients written); a stochastic hash grid adds its Philox draw
    (forward) and its uniforms and corner bits."""
    h, D, _ = _sizes(p)
    F, L = h["features_per_level"], h["num_levels"] - D
    width = encoder_width(p)
    tables = table_bytes(p)
    ops = encoder_ops(p, n, backward, stochastic)
    pts = 12 * n
    total = 0.0
    if D:
        cols = D * F
        total += bound_s(
            pts + (4 * n * cols + 2 * tables["dense"] if backward
                   else tables["dense"] + sector_bytes(n, 0, cols, width)),
            ops["dense"])
    fine = width - D * F
    name = "cp" if h["variant"] == "cp" else "hash"
    if backward:
        extra = n * L if stochastic else 0
        rw = 2 * tables[name] if name == "cp" else tables[name]
        total += bound_s(pts + 4 * n * fine + rw + extra, ops[name])
    else:
        extra = (12 * L * n + n * L) if stochastic else 0
        total += bound_s(pts + tables[name] + extra
                         + sector_bytes(n, D * F, fine, width), ops[name])
        if stochastic and h["hw_rng"]:
            total += bound_s(4 + 12 * L * n, PHILOX_OPS_PER_VALUE * 3 * L * n,
                             INT32_OPS_PER_S)
    return total


def mlp_flops(p: dict, n: int, backward: bool, density_only: bool = False):
    """The MLP's GEMM FLOPs on n points: 2 d_in d_out a layer forward, and
    twice that again for the input and weight gradients."""
    m = p["mlp"]
    w = m["width"]
    d_view = p["dir_enc"]["d_model"] * p["dir_enc"]["num_freq"] * 2
    sig = [(encoder_width(p), w)] + [
        (w, 1 + m["geo_feat_dim"] if i == m["num_sig"] - 1 else w)
        for i in range(m["num_sig"])]
    col = [(m["geo_feat_dim"] + d_view, w)] + [
        (w, 3 if i == m["num_col"] - 1 else w) for i in range(m["num_col"])]
    layers = sig if density_only else sig + col
    fwd = 2 * n * sum(a * b for a, b in layers)
    return fwd * (3 if backward else 1)


def step_flops(p: dict, n: int, stochastic: bool) -> float:
    """Model FLOPs of one training step on n points: the MLP forward and
    backward and the encoder's operations both ways."""
    return (mlp_flops(p, n, True)
            + sum(encoder_ops(p, n, False, stochastic).values())
            + sum(encoder_ops(p, n, True, stochastic).values()))


def refresh_flops(p: dict) -> float:
    """Model FLOPs of one occupancy refresh: the density branch and the
    exact encode at REFRESH_CELLS points."""
    return (mlp_flops(p, REFRESH_CELLS, False, density_only=True)
            + sum(encoder_ops(p, REFRESH_CELLS, False, False).values()))


def frame_flops(p: dict, n: int) -> float:
    """Model FLOPs of a served frame's n points: MLP and exact encode."""
    return mlp_flops(p, n, False) + sum(encoder_ops(p, n, False, False).values())
