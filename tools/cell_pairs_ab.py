"""A/B of the cell forward and the pairs kernel on the card.

Cell forward (the ``cell`` mode: 16 levels, F 2, T 2^16, 64-byte rows, a
64 MB table) on ray-ordered points at the smoke's 1,024,000 (16000 rays x 64
samples, each ray's samples consecutive), on 1,024,000 random points and on
ray-ordered points at the protocol's 2,097,152 (16384 x 128).  Timed in
turns (a, b, ..., ..., b, a): the tree's kernel (``cell_encode_kernel``),
an earlier tree's (``--parent``, its ``hash.cu`` with ``levels.cuh``
beside it), and the tree's kernel built by ``tools/cell_pairs_ab.cu`` at
level groups 1, 2, 4, 8 and 16 (16: every level in one pass, as the
parent walks them), with its rows read by 2F cooperating lanes or a thread
a row, with and without its cache hints (rows L2 evict-last, streaming
stores), at groups 4 and 8; its anatomy at group 4 (the rows' loads
alone; all but the loads); and
``embedding_bag`` given the rows and weights.  Every variant is held to
``cell_encode_plain`` bit for bit first.  The record gives each case's HBM
bound (points, table and features once) and its L2 row figure: the bytes
of the rows whose cell differs from the previous point's at that level
(a repeat is an L1 hit at best), over the L2 read rate that ``ab_l2_read``
measures on a 24 MB buffer in the same call.

Pairs (``hash_pairs``) on the same 1,024,000 ray-ordered points, in the four
routings: ``pick`` alone (the bf16 1-of-2 mode ``packed_gsub``: L 16, F 2)
and ``pick`` null (every feature of every level, the same mode), ``lsel``
(``int8_dense_guided_lvl``'s hashed levels) and ``psel``
(``int8_dense_guided_k32_mass_lpair``'s): the tree's kernel against the
parent's and against the tree's with the other staging choice (pick and
pick null reading each drawn value from g, lsel and psel staging the block's
gradient rows; ``tools/cell_pairs_ab.cu``), each held to
``pairs_plain`` bit for bit (indices and values),
beside its bound (the points, the draws, the bits and the gradient rows that
the routing reads, and the pairs written, once each).

One JSON object goes to ``--out``.  Run on the card (about 2 minutes):

  mkdir -p local/parent && git archive <commit> \\
      human_body_reconstruction_tpu_torch/csrc | tar -x -C local/parent
  python tools/cell_pairs_ab.py \\
      --parent local/parent/human_body_reconstruction_tpu_torch/csrc/hash.cu \\
      --out results/cell_pairs_ab.json
"""

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hash_backward_ab import build, ptr, ray_points  # noqa: E402

VARIANT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "cell_pairs_ab.cu")
CELL_CASES = {"smoke_rays": (16000, 64), "random": (16000, 64),
              "protocol_rays": (16384, 128)}
GROUPS = (1, 2, 4, 8, 16)
PAIRS_MODES = {"pick": ("packed_gsub", "hash_encode_stochastic_packed"),
               "pick_null": ("packed_gsub", "hash_encode_stochastic_packed"),
               "lsel": ("int8_dense_guided_lvl", "hash_encode_stochastic_int8"),
               "psel": ("int8_dense_guided_k32_mass_lpair",
                        "hash_encode_stochastic_int8")}
L2_BUFFER_BYTES = 24 << 20


def bind(libs: dict):
    """argtypes of the entries this script calls."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    p, i, ll, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float)
    lv = ctypes.POINTER(cuda_lib.HbrLevels)
    for name, lib in libs.items():
        lib.hbr_hash_cell_forward.argtypes = [p, p, p, p, ll, i, i, lv, p, ll,
                                              p]
        lib.hbr_hash_pairs.argtypes = [p, p, p, p, p, p, p, p, ll, ll, i, i,
                                       f32, lv, p, p, p]
        if name == "tree":
            lib.ab_cell_forward.argtypes = [p, p, p, p, ll, i, lv, i, i, i, p,
                                            ll, p]
            lib.ab_l2_read.argtypes = [p, ll, i, p, p]
            lib.ab_cell_anatomy.argtypes = [p, p, p, p, ll, i, lv, i, i, p,
                                             ll, p]
            lib.ab_pairs_other.argtypes = [p, p, p, p, p, p, p, p, ll, ll, i,
                                            i, f32, lv, p, p, p]


def ok(code, what):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def changed_rows(x, mu, sigma, cfg) -> int:
    """(point, level)s whose cell row differs from the previous point's at
    that level (the first point's counted)."""
    from human_body_reconstruction_tpu_torch.ops import hash_variants as hv
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise

    total = 0
    for rows, _ in hv._cell_rows(normalise(x, mu, sigma), cfg):
        total += 1 + int((rows[1:] != rows[:-1]).sum())
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier tree's csrc/hash.cu (levels.cuh beside)")
    ap.add_argument("--out", default="results/cell_pairs_ab.json")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import chip_smoke as cs
    from human_body_reconstruction_tpu_torch.cli import card_line, quality_holdout
    from human_body_reconstruction_tpu_torch.ops import (
        cuda_lib, hash_encoding, hash_kernel, hash_variants as hv)

    device = torch.device("cuda")
    card = card_line(device)
    print(card, flush=True)
    libs = build({"parent": os.path.abspath(args.parent),
                  "tree": VARIANT_SRC})
    bind(libs)
    parent, tree = libs["parent"], libs["tree"]
    stream = cuda_lib.stream_handle(device)
    out = {"card": card, "cell_forward": {}, "pairs": {}}

    def timed(fns: dict) -> dict:
        """{name: [ms, ...]} of fns run in turns a, b, ..., ..., b, a."""
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cs.time_ms(fns[k], reps=args.reps))
        return ms

    # the L2's read rate: a 24 MB buffer read 20 times in one launch
    buf = torch.randn(L2_BUFFER_BYTES // 4, device=device)
    sink = torch.zeros(1, device=device)
    reads = 20
    l2_ms = cs.time_ms(lambda: ok(tree.ab_l2_read(
        buf.data_ptr(), buf.numel() // 4, reads, sink.data_ptr(), stream),
        "ab_l2_read"), reps=10)
    l2_rate = reads * L2_BUFFER_BYTES / (l2_ms * 1e-3)
    out["l2_read_bytes_per_s"] = l2_rate
    print(f"L2 reads: {l2_rate / 1e12:.3f} TB/s ({L2_BUFFER_BYTES} B x "
          f"{reads} in {l2_ms:.4f} ms) [{card}]", flush=True)
    del buf

    # ------------------------------------------------------- cell forward
    cfg = quality_holdout.make_modes()["cell"].hash
    L, F, T = cfg.num_hashed_levels, cfg.features_per_level, cfg.table_size
    gen = torch.Generator(device).manual_seed(3)
    table = torch.randn((L, T, 8 * F), generator=gen, device=device)
    for case, (rays, samples) in CELL_CASES.items():
        x, mu, sigma = ray_points(rays, samples, device, seed=4)
        if case == "random":
            x = torch.rand(x.shape, generator=gen, device=device) * 1.6 - 0.3
        n = x.shape[0]
        a = (table, x, mu, sigma, cfg)
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg)
        feats = torch.empty((n, L * F), device=device)
        pts = (xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
               table.data_ptr(), n, T)

        def parent_fn():
            ok(parent.hbr_hash_cell_forward(*pts, F, lv, feats.data_ptr(),
                                            L * F, stream), "parent forward")
            return feats

        def variant(group, coop, hints):
            def fn():
                ok(tree.ab_cell_forward(*pts, lv, group, coop, hints,
                                        feats.data_ptr(), L * F, stream),
                   f"ab_cell_forward {group} {coop} {hints}")
                return feats
            return fn

        fns = {"tree": lambda: hv.cell_encode_kernel(*a, out=feats),
               "parent": parent_fn}
        for group in GROUPS:
            fns[f"coop_hints_group_{group}"] = variant(group, 1, 1)
        for group in (4, 8):
            fns[f"thread_row_hints_group_{group}"] = variant(group, 0, 1)
            fns[f"coop_no_hints_group_{group}"] = variant(group, 1, 0)
            fns[f"thread_row_no_hints_group_{group}"] = variant(group, 0, 0)
        want = hv.cell_encode_plain(*a)
        for k, fn in fns.items():
            got = fn().clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"cell forward {case} {k}: not bit for bit")
        del want

        def anatomy(mode):
            def fn():
                ok(tree.ab_cell_anatomy(*pts, lv, 4, mode, feats.data_ptr(),
                                        L * F, stream), f"ab_cell_anatomy {mode}")
            return fn

        fns["loads_alone_group_4"] = anatomy(0)
        fns["all_but_loads_group_4"] = anatomy(1)
        crow, cw = cs.cell_rows_weights(x, mu, sigma, cfg)
        fns["embedding_bag"] = cs.embedding_bag_call(
            table.reshape(-1, F)[None], crow, cw)
        rec = {"points": n}
        rec.update(timed(fns))
        rec["bound_ms"], rec["bound_by"] = cs.bound(
            cs.nbytes(x, table, feats), n * L * (15 + 8 * (10 + 2 * F)))
        rec["rows_changed"] = changed_rows(x, mu, sigma, cfg)
        rec["row_bytes_changed"] = rec["rows_changed"] * 8 * F * 4
        rec["l2_row_bound_ms"] = 1e3 * rec["row_bytes_changed"] / l2_rate
        out["cell_forward"][case] = rec
        print(f"cell forward {case} ({n} points, {rec['rows_changed']} rows "
              f"changed, {rec['row_bytes_changed'] / 1e9:.3f} GB; bound "
              f"{rec['bound_ms']:.4f} ms, L2 row figure "
              f"{rec['l2_row_bound_ms']:.4f} ms) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)) + f" [{card}]", flush=True)
        del x, xc, feats, crow, cw, fns
        torch.cuda.empty_cache()
    del table

    # -------------------------------------------------------------- pairs
    x, mu, sigma = ray_points(16000, 64, device, seed=2)
    n = x.shape[0]
    for routing, (mode, route) in PAIRS_MODES.items():
        cfg = quality_holdout.make_modes()[mode].hash
        L, F, T = (cfg.num_hashed_levels, cfg.features_per_level,
                   cfg.table_size)
        gen = torch.Generator(device).manual_seed(1)
        table = torch.zeros((L, T, F), device=device)
        u = torch.rand((3, L, n), generator=gen, device=device)
        _, bits = hash_kernel.hash_encode_plain(table, x, mu, sigma, cfg, u)
        d = hash_encoding.draw_subsample(route, cfg, L, n, device, gen)
        g = torch.randn((n, L * F), generator=gen, device=device)
        sel = ((None, None, None) if routing == "pick_null" else
               (d["pick"], d.get("lsel"), d.get("psel")))
        a = (table, x, mu, sigma, cfg, g, bits, *sel)
        want_i, want_v = hv.pairs_plain(*a)
        m = want_i.numel()
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg)
        pidx = torch.empty(m, dtype=torch.int32, device=device)
        pval = torch.empty(m, device=device)

        def lib_pairs(lib, entry):
            def fn():
                ok(getattr(lib, entry)(
                    xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
                    ptr(bits), *[ptr(v) for v in sel], g.data_ptr(),
                    g.stride(0), n, T, F, float(F), lv, pidx.data_ptr(),
                    pval.data_ptr(), stream), entry)
                return pidx, pval
            return fn

        fns = {"tree": lambda: hv.pairs_kernel(*a),
               "parent": lib_pairs(parent, "hbr_hash_pairs"),
               "other_staging": lib_pairs(tree, "ab_pairs_other")}
        for k, fn in fns.items():
            gi, gv = fn()
            torch.cuda.synchronize()
            if not (torch.equal(gi.long(), want_i) and torch.equal(gv, want_v)):
                raise RuntimeError(f"pairs {routing} {k}: not bit for bit")
        # what the routing must read: the points, and the gradient rows, bits
        # and picks whole (pick, pick null) or each drawn term's value, pick
        # and bits (lsel, psel: 6 B a term) with the level draws; and the
        # pairs written
        if routing in ("pick", "pick_null"):
            read = cs.nbytes(x, g, bits, *[v for v in sel if v is not None])
        else:
            read = cs.nbytes(x, *[v for v in sel[1:] if v is not None]) + 6 * m
        rec = {"pairs": m, "levels": L, "features": F, "mode": mode}
        rec.update(timed(fns))
        rec["bound_ms"], rec["bound_by"] = cs.bound(read + m * 8, m * 14)
        out["pairs"][routing] = rec
        print(f"pairs {routing} ({mode}, {m} pairs; bound "
              f"{rec['bound_ms']:.4f} ms) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)) + f" [{card}]", flush=True)
        del table, u, bits, d, g, want_i, want_v, pidx, pval, fns
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
