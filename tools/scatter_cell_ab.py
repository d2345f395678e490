"""A/B of the sorted scatters and the cell backward on the card.

Scatter: the (index, value) pairs of the bf16 1-of-2 backward (``packed_gsub``:
16 levels, F 2, T 2^16) on 1,024,000 ray-ordered points (16000 rays x 64
samples, each ray's samples consecutive), sorted by index as the path sorts
them, and the same values with each level's terms on one index
(``one_cell``).  Timed in turns (a, b, ..., ..., b, a): the tree's segsum and
sorted (``add_sorted_kernel``), an earlier tree's (``--parent``, its
``hash.cu`` with ``levels.cuh`` beside it), segsum at 16 pairs a thread
(``tools/scatter_cell_ab.cu``), and ``index_add_`` on the same sorted pairs.
Each is held to ``scatter_plain`` within ``cuda_lib.sum_order_tolerance``
first, and the tree's segsum to itself bit for bit over two calls.

Cell backward (the ``cell`` mode: 16 levels, F 2, T 2^16, 64-byte rows) on
ray-ordered points at the smoke's 1,024,000 (16000 x 64) and the protocol's
2,097,152 (16384 x 128): the tree's kernel (``cell_encode_backward_kernel``:
one bulk reduction a row marked L2 evict-last, g read as streaming loads,
the levels a group at a time) and the parent's; the tree's kernel at level
groups 1, 2, 4, 8 and 16 (16: the parent's order, the level fastest); its
rows sent as four float4 reductions (the parent's way) at groups 4 and 16;
one warp a run of 32 points at one level, float4 or bulk; the bulk kernel
with neither cache hint, and with each alone; g transposed to level-major
first (the transpose timed apart) at groups 1 and 4; the anatomy: the kernel without its reductions (loads and sums only),
the rows it sends recorded and their reductions replayed alone (float4
against one bulk reduction a row) at groups 1, 4 and 16; ``index_add_``
given the rows and terms; the zeroing of the gradient table that every call
includes.  Every variant's gradient is held to ``cell_encode_plain_backward``
within the tolerance first.  The record also counts the rows sent a level.

One JSON object goes to ``--out``.  Run on the card (about 3 minutes):

  mkdir -p local/parent && git archive <commit> \\
      human_body_reconstruction_tpu_torch/csrc | tar -x -C local/parent
  python tools/scatter_cell_ab.py \\
      --parent local/parent/human_body_reconstruction_tpu_torch/csrc/hash.cu \\
      --out results/scatter_cell_ab.json
"""

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hash_backward_ab import build, ray_points  # noqa: E402

VARIANT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scatter_cell_ab.cu")
SCATTER_CASE = ("packed_gsub", 16000, 64)
CELL_CASES = {"smoke": (16000, 64), "protocol": (16384, 128)}
GROUPS = (1, 2, 4, 8, 16)


def bind(libs: dict):
    """argtypes of the entries this script calls."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lv = ctypes.POINTER(cuda_lib.HbrLevels)
    for name, lib in libs.items():
        lib.hbr_hash_cell_backward.argtypes = [p, p, p, p, ll, ll, i, i, lv,
                                               p, p]
        if name == "parent":
            lib.hbr_scatter_sorted.argtypes = [p, p, ll, i, p, p]
        else:
            lib.hbr_scatter_sorted.argtypes = [p, p, ll, i, p, p, p]
            lib.hbr_scatter_work_bytes.argtypes = [ll, i]
            lib.hbr_scatter_work_bytes.restype = ll
            lib.ab_cell_backward.argtypes = [p, p, p, p, ll, ll, i, lv, i, i,
                                             p, p, p]
            lib.ab_rows_red.argtypes = [p, ll, i, p, p]
            lib.ab_segsum_items16.argtypes = [p, p, ll, p, p, p]
            lib.ab_segsum_items16_work_bytes.argtypes = [ll]
            lib.ab_segsum_items16_work_bytes.restype = ll


def ok(code, what):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier tree's csrc/hash.cu (levels.cuh beside)")
    ap.add_argument("--out", default="results/scatter_cell_ab.json")
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
    out = {"card": card, "scatter": {}, "cell": {}}

    def timed(fns: dict) -> dict:
        """{name: [ms, ...]} of fns run in turns a, b, ..., ..., b, a."""
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cs.time_ms(fns[k], reps=args.reps))
        return ms

    def within(got, want, abs_sum, what):
        ratio = float(((got - want).abs() / cuda_lib.sum_order_tolerance(
            want, abs_sum, False)).max())
        print(f"{what}: worst |err| / tolerance {ratio:.3f}", flush=True)
        if not (ratio <= 1.0 and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"{what} disagrees with plain")
        return ratio

    # ------------------------------------------------------------ scatter
    mode, rays, samples = SCATTER_CASE
    cfg = quality_holdout.make_modes()[mode].hash
    gen = torch.Generator(device).manual_seed(1)
    x, mu, sigma = ray_points(rays, samples, device, seed=2)
    n, L, F, T = (x.shape[0], cfg.num_hashed_levels, cfg.features_per_level,
                  cfg.table_size)
    table = torch.zeros((L, T, F), device=device)
    u = torch.rand((3, L, n), generator=gen, device=device)
    _, bits = hash_kernel.hash_encode_plain(table, x, mu, sigma, cfg, u)
    d = hash_encoding.draw_subsample(hash_encoding.hash_route(cfg, True), cfg,
                                     L, n, device, gen)
    g = torch.randn((n, L * F), generator=gen, device=device)
    idx, val = hv.pairs_kernel(table, x, mu, sigma, cfg, g, bits, d["pick"])
    size = table.numel()
    one = (torch.arange(L, device=device, dtype=torch.int32)
           .repeat_interleave(n) * (T * F) + 7)
    for case, (ci, cv) in {"path": (idx, val), "one_cell": (one, val)}.items():
        si, sv = hv.sort_pairs(ci, cv)
        m = si.numel()
        work = torch.empty(tree.hbr_scatter_work_bytes(m, 1), dtype=torch.uint8,
                           device=device)

        def lib_scatter(lib, strategy):
            def fn():
                acc = torch.zeros(size, device=device)
                extra = ([work.data_ptr() if strategy == 1 else None]
                         if lib is tree else [])
                ok(lib.hbr_scatter_sorted(si.data_ptr(), sv.data_ptr(), m,
                                          strategy, acc.data_ptr(), *extra,
                                          stream), "hbr_scatter_sorted")
                return acc
            return fn

        work16 = torch.empty(tree.ab_segsum_items16_work_bytes(m),
                            dtype=torch.uint8, device=device)

        def segsum_items16():
            acc = torch.zeros(size, device=device)
            ok(tree.ab_segsum_items16(si.data_ptr(), sv.data_ptr(), m,
                                     acc.data_ptr(), work16.data_ptr(),
                                     stream), "ab_segsum_items16")
            return acc

        fns = {"tree_segsum": lambda: hv.add_sorted_kernel(size, si, sv,
                                                            "segsum"),
               "parent_segsum": lib_scatter(parent, 1),
               "tree_sorted": lambda: hv.add_sorted_kernel(size, si, sv,
                                                           "sorted"),
               "parent_sorted": lib_scatter(parent, 0),
               "segsum_items16": segsum_items16}
        want = hv.scatter_plain(size, si, sv, "segsum")
        abs_sum = hv.scatter_plain(size, si, sv.abs(), "sorted")
        rec = {"pairs": m, "runs": int(torch.unique_consecutive(si).numel())}
        for k, fn in fns.items():
            rec[f"{k}_err_ratio"] = within(fn(), want, abs_sum,
                                           f"scatter {case} {k}")
        a, b = fns["tree_segsum"](), fns["tree_segsum"]()
        rec["tree_segsum_same_bits"] = bool(torch.equal(a, b))
        if not rec["tree_segsum_same_bits"]:
            raise RuntimeError("segsum gave other bits on a second call")
        idx_long = si.long()
        acc = torch.zeros(size, device=device)
        fns["index_add_"] = lambda: acc.index_add_(0, idx_long, sv)
        fns["zeros"] = lambda: torch.zeros(size, device=device)
        rec.update(timed(fns))
        out["scatter"][case] = rec
        print(f"scatter {case} ({m} pairs, {rec['runs']} runs) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)) + f" [{card}]", flush=True)
        del work, work16, si, sv, want, abs_sum, idx_long, acc, fns
    del table, u, bits, d, g, idx, val, one
    torch.cuda.empty_cache()

    # ------------------------------------------------------ cell backward
    cfg = quality_holdout.make_modes()["cell"].hash
    for case, (rays, samples) in CELL_CASES.items():
        gen = torch.Generator(device).manual_seed(3)
        x, mu, sigma = ray_points(rays, samples, device, seed=4)
        n, L, F, T = (x.shape[0], cfg.num_hashed_levels,
                      cfg.features_per_level, cfg.table_size)
        table = torch.zeros((L, T, 8 * F), device=device)
        g = torch.randn((n, L * F), generator=gen, device=device)
        a = (table, x, mu, sigma, cfg)
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg)
        pts = (xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(), g.data_ptr(),
               g.stride(0), n)
        units = (n + 15) // 16 * L

        def parent_cell():
            dt = torch.zeros(table.shape, device=device)
            ok(parent.hbr_hash_cell_backward(*pts, T, F, lv, dt.data_ptr(),
                                             stream), "parent cell backward")
            return dt

        gt = g.reshape(n, L, F).permute(1, 0, 2).contiguous()  # level-major

        def variant(v, group, rows=None):
            at = pts if v != 10 else pts[:3] + (gt.data_ptr(),) + pts[4:]

            def fn():
                dt = torch.zeros(table.shape, device=device)
                ok(tree.ab_cell_backward(*at, T, lv, v, group, dt.data_ptr(),
                                         None if rows is None
                                         else rows.data_ptr(), stream),
                   f"ab_cell_backward {v} {group}")
                return dt
            return fn

        fns = {"tree": lambda: hv.cell_encode_backward_kernel(*a, g),
               "parent": parent_cell}
        for group in GROUPS:
            fns[f"group_{group}"] = variant(5, group)
        for group in (4, L):
            fns[f"float4_group_{group}"] = variant(0, group)
        fns["warp32_float4_group_4"] = variant(4, 4)
        fns["warp32_bulk_group_4"] = variant(6, 4)
        fns["bulk_no_hints_group_4"] = variant(7, 4)
        fns["streaming_g_only_group_4"] = variant(8, 4)
        fns["evict_last_rows_only_group_4"] = variant(9, 4)
        for group in (1, 4):
            fns[f"level_major_g_group_{group}"] = variant(10, group)
        want = hv.cell_encode_plain_backward(*a, g)
        abs_sum = hv.cell_encode_plain_backward(*a, g.abs())
        rec = {"points": n}
        for k, fn in fns.items():
            rec[f"{k}_err_ratio"] = within(fn(), want, abs_sum,
                                           f"cell {case} {k}")
        del want, abs_sum
        for group in (4, L):
            fns[f"no_reductions_group_{group}"] = variant(1, group)
        # the rows each order sends, then their reductions alone
        for group in (1, 4, L):
            rows = torch.empty((16 * units,), dtype=torch.int32, device=device)
            variant(3, group, rows)()
            sent = rows[rows >= 0]
            per_level = torch.bincount(sent // T, minlength=L).tolist()
            rec[f"rows_sent_group_{group}"] = int(sent.numel())
            rec[f"rows_sent_per_level_group_{group}"] = per_level
            for red, code in (("float4", 0), ("bulk", 2)):
                def replay(rows=rows, code=code):
                    dt = torch.zeros(table.shape, device=device)
                    ok(tree.ab_rows_red(rows.data_ptr(), units, code,
                                        dt.data_ptr(), stream), "ab_rows_red")
                    return dt
                fns[f"reductions_only_{red}_group_{group}"] = replay
            # each recorded row is sent once: the replay's sum of ones
            check = fns[f"reductions_only_float4_group_{group}"]()
            torch.cuda.synchronize()
            if float(check.double().sum()) != 16.0 * sent.numel():
                raise RuntimeError("the replay sent other rows")
        crow, cw = cs.cell_rows_weights(x, mu, sigma, cfg)
        fns["index_add_"] = cs.index_add_call(table.reshape(-1, F)[None], crow,
                                              cw, g)
        fns["zeros"] = lambda: torch.zeros(table.shape, device=device)
        fns["level_major_transpose_of_g"] = lambda: g.reshape(
            n, L, F).permute(1, 0, 2).contiguous()
        rec.update(timed(fns))
        rec["bound_ms"] = cs.bound(cs.nbytes(x, g, table),
                                   n * L * (15 + 8 * (10 + 2 * F)))[0]
        out["cell"][case] = rec
        print(f"cell {case} ({n} points) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)
                          and not k.startswith("rows_sent"))
              + f"; rows sent {rec[f'rows_sent_group_{L}']} [{card}]",
              flush=True)
        del table, g, gt, crow, cw, fns
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
