"""The numbers that decide ``correct``, each against its limit.

Training: per step, the loss's gap from the reference's relative to the
reference's; per leaf (a parameter tensor), the gap between the norms of
the program's and the reference's gradient, and of their changes over the
steps, relative to the reference's norm of that leaf or of the median
leaf, whichever is larger; the worst leaf counts.  Leaves whose reference
gradient is below a thousandth of the median leaf's (nought to rounding)
are left out of the change.  The refresh: the relative gap of the
refreshed densities at the cells it drew.  Serving: the widest gap, in
8-bit levels, between a served PNG's channel and 255 times the
reference's colour, and the share of channels whose level is not the one
the reference's colour gives.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

SMALL_GRAD = 1e-3


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(worst relative gap of the leaves' norms, its leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in ref]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def moving_leaves(ref_grad_norms: dict) -> set:
    med = float(np.median(list(ref_grad_norms.values())))
    return {k for k, v in ref_grad_norms.items() if v >= SMALL_GRAD * med}


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def relative_gap(got, want) -> float:
    """||got - want|| / ||want|| over the finite entries of ``want``
    (infinite where ``got`` is not finite there or the two disagree on
    which entries are infinite)."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return math.inf
    g, w = got[fin].double(), want[fin].double()
    return float(torch.linalg.vector_norm(g - w)
                 / max(float(torch.linalg.vector_norm(w)), 1e-30))


def decode_png(data: bytes) -> np.ndarray:
    """uint8 (H, W, C) of an 8-bit grey or RGB PNG, any row filter."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    if depth != 8 or ctype not in (0, 2):
        raise ValueError(f"PNG of depth {depth}, colour type {ctype}")
    c = 1 if ctype == 0 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        cur = np.zeros(w * c, np.int32)
        if f in (0, 2):                   # none, up: no left neighbour
            cur = (row + (prev if f == 2 else 0)) & 0xFF
        for x in range(w * c if f not in (0, 2) else 0):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            d = prev[x - c] if x >= c else 0
            if f == 1:
                p = a
            elif f == 3:
                p = (a + b) // 2
            else:
                pa, pb, pc = abs(b - d), abs(a - d), abs(a + b - 2 * d)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
            cur[x] = (row[x] + p) & 0xFF
        out[y], prev = cur, cur
    return out.reshape(h, w, c).astype(np.uint8)


def levels(img) -> np.ndarray:
    """The 8-bit levels the server writes for an f32 image: the colour
    clipped to [0, 1], times 255, truncated."""
    return (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def frame_gaps(png8: np.ndarray, ref) -> tuple:
    """(widest |served level - 255 * clip(reference colour)| over the
    frame's channels, share of channels whose level is not the
    reference's own level)."""
    r = np.clip(ref.detach().cpu().numpy().astype(np.float64), 0, 1) * 255
    got = png8.astype(np.float64)
    return (float(np.abs(got - r).max()),
            float(np.mean(png8 != levels(ref))))


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): each reading beside its limit; a reading that is
    missing, not finite or above its limit is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
