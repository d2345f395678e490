"""A/B of the packed-exact forward on the card.

Four shapes, each a packed table of random U(-1, 1) values packed by the
tree's ``pack_kernel``:

  int8_frame   the int8 frame's first pass: 16384 rays x 32 ray-ordered
               samples (524,288 points) through
               ``int8_dense_guided_k32_mass_lpair``'s words (6 hashed
               levels, F 4, T 2^16)
  bf16_train   ``train_hash --packed_exact``'s step: 16000 rays x 64
               samples (1,024,000 points) through ``packed_gsub``'s bf16
               words (L 16, F 2, T 2^16)
  int8_sweep   the middle chunk of a 256^3 mesh sweep (262,144 lattice
               points, ``mesh_export.sweep_points``, k fastest) of a cubic
               scene through the int8 words
  int8_random  524,288 uniform random points through the int8 words

On each it times, in turns (a, b, ..., ..., b, a): the tree's kernel
(``packed_encode_kernel``); an earlier tree's (``--parent``, its
``hash.cu`` with ``levels.cuh`` beside it); the tree's kernel built by
``tools/packed_exact_ab.cu`` with each corner pair's load 4, 8 or 16 bytes
wide, its words kept raw until the sum or unpacked as they are asked for,
G 1, 2 or 4 threads a point (every one at the parent's carveout, 38); the
tree's choice at carveouts 0 to 100; at level groups of 1 to 8 levels a
block, the group the grid's slowest index, at carveouts 0 and 38 (with 8-
byte pairs unpacked as they arrive, and for int8 with the bytes turned into
floats through the float's bits); one block a SM walking the levels in
lockstep (1 or 2 points a thread, a barrier after each level or not,
staging a sector's worth of levels or all of them); its anatomy (the loads
alone, all but the loads, and for int8 all but the loads with the bits
trick); and ``embedding_bag`` given the rows and weights on the unpacked
table.  Every variant is held to ``packed_encode_plain`` bit for bit first.
The record gives each shape's HBM bound (the points and the features once,
the words once), its sector count (the distinct 32-byte sectors the eight
corner words of each (point, level) span, summed), the loads the tree's
choice asks for (a chunk a corner pair, and the far words where x0's carry
leaves the chunk), and its L2 sector figure: the sectors' bytes over the L2
read rate that ``ab_l2_read`` measures on a 24 MB buffer in the same call
(``torch.sum`` over the same buffer beside it, the rate ``chip_smoke.py``
uses).  Before the shapes, the rate of scattered requests: 8 random 4- or
16-byte loads a thread in flight from buffers of 128 KB to 32 MB.

One JSON object goes to ``--out``.  Run on the card (about 2 minutes):

  mkdir -p local/parent && git archive <commit> \\
      human_body_reconstruction_tpu_torch/csrc | tar -x -C local/parent
  python tools/packed_exact_ab.py \\
      --parent local/parent/human_body_reconstruction_tpu_torch/csrc/hash.cu \\
      --out results/packed_exact_ab.json
"""

import argparse
import ctypes
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from cell_pairs_ab import L2_BUFFER_BYTES, ok  # noqa: E402
from hash_backward_ab import build, ray_points  # noqa: E402

VARIANT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "packed_exact_ab.cu")
INT8, BF16 = "int8_dense_guided_k32_mass_lpair", "packed_gsub"
CASES = {"int8_frame": (INT8, "int8"), "bf16_train": (BF16, "bf16"),
         "int8_sweep": (INT8, "int8"), "int8_random": (INT8, "int8")}
SWEEP_RES, SWEEP_CHUNK = 256, 262144
LOADS, GROUPS, CARVEOUTS = (4, 8, 16), (1, 2, 4), (0, 16, 25, 38, 50, 75, 100)
LEVEL_GROUPS = (1, 2, 3, 4, 8)           # levels a block, besides all of them
GATHER_BYTES = (128 << 10, 256 << 10, 1536 << 10, 4 << 20, 32 << 20)
PARENT_CARVEOUT = 38
SMEM_MAX = 232448                        # bytes of shared memory a block can use
# the tree's choice (csrc/hash.cu PX_GROUPS, PX_LOAD, raw words)
TREE = {"groups": 1, "load": 8, "raw": 1}


def bind(libs: dict):
    """argtypes of the entries this script calls."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lv = ctypes.POINTER(cuda_lib.HbrLevels)
    for name, lib in libs.items():
        lib.hbr_hash_packed_forward.argtypes = [p, p, p, p, p, p, ll, i, i, i,
                                                lv, p, ll, p, p]
        if name == "tree":
            lib.ab_packed_exact.argtypes = [p, p, p, p, p, ll, i, i, lv, i, i,
                                            i, i, i, p, ll, p]
            lib.ab_packed_exact_magic.argtypes = [p, p, p, p, p, ll, i, lv, i,
                                                  i, p, ll, p]
            lib.ab_gather.argtypes = [p, ll, i, i, p, p, p]
            lib.ab_lockstep.argtypes = [p, p, p, p, p, ll, i, i, lv, i, i, i,
                                        i, p, ll, p]
            lib.ab_packed_exact_anatomy.argtypes = [p, p, p, p, p, ll, i, i,
                                                    lv, i, p, ll, p]
            lib.ab_l2_read.argtypes = [p, ll, i, p, p]


def case_points(case: str, device):
    """(world points, mu, sigma) of a case."""
    if case == "bf16_train":
        return ray_points(16000, 64, device, seed=4)
    if case == "int8_frame":
        return ray_points(16384, 32, device, seed=5)
    if case == "int8_random":
        gen = torch.Generator(device).manual_seed(6)
        x = torch.rand((16384 * 32, 3), generator=gen, device=device) * 1.6 - 0.3
        return x, torch.zeros(3, device=device), torch.ones(3, device=device)
    from human_body_reconstruction_tpu_torch.pipeline import mesh_export

    # a cubic scene box [0, 1]^3: mu its corner, sigma its diagonal
    lo = torch.zeros(3, device=device)
    start = (SWEEP_RES ** 3 // SWEEP_CHUNK // 2) * SWEEP_CHUNK
    x = mesh_export.sweep_points(start, SWEEP_RES, SWEEP_CHUNK, lo,
                                 torch.ones(3, device=device))
    return x, lo, torch.full((3,), math.sqrt(3.0), device=device)


def far_loads(x, mu, sigma, cfg, load: int) -> int:
    """(point, level)s whose x0 carry leaves the `load`-byte chunk (dm >=
    load / 4): each asks for 4 far words besides its 4 chunks."""
    from human_body_reconstruction_tpu_torch.ops import hash_kernel
    from human_body_reconstruction_tpu_torch.ops.dense_grid import normalise

    xn, mask, total = normalise(x, mu, sigma), cfg.table_size - 1, 0
    for s in hash_kernel._scales(cfg):
        x0 = hash_kernel.level_coords(xn, float(s))[0][:, 0] & 0xFFFFFFFF
        total += int((((x0 ^ (x0 + 1)) & mask) >= load // 4).sum())
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier tree's csrc/hash.cu (levels.cuh beside)")
    ap.add_argument("--out", default="results/packed_exact_ab.json")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import chip_smoke as cs
    from human_body_reconstruction_tpu_torch.cli import card_line, quality_holdout
    from human_body_reconstruction_tpu_torch.ops import (
        cuda_lib, hash_kernel, hash_variants as hv)

    device = torch.device("cuda")
    card = card_line(device)
    print(card, flush=True)
    libs = build({"parent": os.path.abspath(args.parent),
                  "tree": VARIANT_SRC})
    bind(libs)
    parent, tree = libs["parent"], libs["tree"]
    stream = cuda_lib.stream_handle(device)
    out = {"card": card, "tree": TREE, "cases": {}}

    def timed(fns: dict) -> dict:
        """{name: [ms, ...]} of fns run in turns a, b, ..., ..., b, a."""
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cs.time_ms(fns[k], reps=args.reps))
        return ms

    # the L2's read rate: a 24 MB buffer read 20 times in one launch, and
    # torch.sum's (chip_smoke.py's figure) over the same buffer
    buf = torch.randn(L2_BUFFER_BYTES // 4, device=device)
    sink = torch.zeros(1, device=device)
    reads = 20
    l2_ms = cs.time_ms(lambda: ok(tree.ab_l2_read(
        buf.data_ptr(), buf.numel() // 4, reads, sink.data_ptr(), stream),
        "ab_l2_read"), reps=10)
    l2_rate = reads * L2_BUFFER_BYTES / (l2_ms * 1e-3)
    out["l2_read_bytes_per_s"] = l2_rate
    out["l2_read_bytes_per_s_torch_sum"] = cs.l2_read_rate(device)
    print(f"L2 reads: {l2_rate / 1e12:.3f} TB/s ({L2_BUFFER_BYTES} B x "
          f"{reads} in {l2_ms:.4f} ms); torch.sum "
          f"{out['l2_read_bytes_per_s_torch_sum'] / 1e12:.3f} TB/s [{card}]",
          flush=True)
    del buf

    # the rate of scattered requests: 8 random loads a thread in flight,
    # from buffers that fit the L1, the L2, or neither
    out["gather_requests_per_s"] = {}
    gthreads = ctypes.c_longlong(0)
    for size in GATHER_BYTES:
        gbuf = torch.randint(0, 2 ** 31, (size // 4,), dtype=torch.int32,
                             device=device)
        for load in (4, 16):
            greps = 64
            g_ms = cs.time_ms(lambda: ok(tree.ab_gather(
                gbuf.data_ptr(), gbuf.numel(), load, greps, sink.data_ptr(),
                ctypes.byref(gthreads), stream), "ab_gather"), reps=5)
            rate = gthreads.value * greps * 8 / (g_ms * 1e-3)
            out["gather_requests_per_s"][f"{size}_{load}"] = rate
            print(f"gather {load}-byte loads from {size} B: {rate / 1e9:.1f}G "
                  f"requests/s ({g_ms:.4f} ms) [{card}]", flush=True)
        del gbuf

    modes = quality_holdout.make_modes()
    for case, (mode, fmt) in CASES.items():
        cfg = modes[mode].hash
        L, F, T = cfg.num_hashed_levels, cfg.features_per_level, cfg.table_size
        gen = torch.Generator(device).manual_seed(7)
        table = torch.rand((L, T, F), generator=gen, device=device) * 2 - 1
        words, scale = hv.pack_kernel(table, fmt)
        x, mu, sigma = case_points(case, device)
        n = x.shape[0]
        a = (words, scale, x, mu, sigma, cfg)
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg)
        feats = torch.empty((n, L * F), device=device)
        head = (xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
                words.data_ptr(), None if scale is None else scale.data_ptr())
        code = hv.FORMATS[fmt]

        def parent_fn():
            ok(parent.hbr_hash_packed_forward(
                *head, None, n, T, F, code, lv, feats.data_ptr(), L * F, None,
                stream), "parent forward")
            return feats

        def variant(load, raw, groups, carveout, group=L):
            def fn():
                ok(tree.ab_packed_exact(*head, n, T, code, lv, load, raw,
                                        groups, group, carveout,
                                        feats.data_ptr(), L * F, stream),
                   f"ab_packed_exact {load} {raw} {groups} {group} {carveout}")
                return feats
            return fn

        def lockstep(per_thread, barrier, span, fmt_code):
            def fn():
                ok(tree.ab_lockstep(*head, n, T, fmt_code, lv, per_thread,
                                    barrier, span, 0, feats.data_ptr(), L * F,
                                    stream), f"ab_lockstep {per_thread} "
                   f"{barrier} {span} {fmt_code}")
                return feats
            return fn

        def magic(group, carveout=PARENT_CARVEOUT):
            def fn():
                ok(tree.ab_packed_exact_magic(*head, n, T, lv, group, carveout,
                                              feats.data_ptr(), L * F, stream),
                   f"ab_packed_exact_magic {group}")
                return feats
            return fn

        fns = {"tree": lambda: hv.packed_encode_kernel(*a, out=feats),
               "parent": parent_fn}
        for load in LOADS:
            for raw in (1, 0):
                for groups in GROUPS:
                    fns[f"load_{load}_{'raw' if raw else 'floats'}_g{groups}"] = (
                        variant(load, raw, groups, PARENT_CARVEOUT))
        for carveout in CARVEOUTS:
            fns[f"tree_carveout_{carveout}"] = variant(
                TREE["load"], TREE["raw"], TREE["groups"], carveout)
        for group in [g for g in LEVEL_GROUPS if g < L] + [L]:
            for carveout in (0, PARENT_CARVEOUT):
                fns[f"tree_group_{group}_carveout_{carveout}"] = variant(
                    TREE["load"], TREE["raw"], TREE["groups"], carveout, group)
                fns[f"load_8_floats_g1_group_{group}_carveout_{carveout}"] = (
                    variant(8, 0, 1, carveout, group))
                if fmt == "int8":
                    fns[f"magic_group_{group}_carveout_{carveout}"] = magic(
                        group, carveout)
        for per_thread in (1, 2):
            for barrier in (1, 0):
                for span in (32 // (4 * F), L):
                    if 1024 * per_thread * (span * F + 1) * 4 > SMEM_MAX:
                        continue          # past a block's shared memory
                    for fc in ((code, 2) if fmt == "int8" else (code,)):
                        fns[f"lockstep_{per_thread}pt_barrier{barrier}_span"
                            f"{span}" + ("_magic" if fc == 2 else "")] = (
                            lockstep(per_thread, barrier, span, fc))
        want = hv.packed_encode_plain(*a)
        for k, fn in fns.items():
            feats.fill_(float("nan"))
            got = fn().clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"packed-exact {case} {k}: not bit for bit")
        del want

        def anatomy(kind):
            def fn():
                ok(tree.ab_packed_exact_anatomy(*head, n, T, code, lv, kind,
                                                feats.data_ptr(), L * F,
                                                stream), f"anatomy {kind}")
            return fn

        fns["loads_alone"] = anatomy(0)
        fns["all_but_loads"] = anatomy(1)
        if fmt == "int8":
            fns["all_but_loads_magic"] = anatomy(2)
        rows, w = cs.hash_rows_weights(x, mu, sigma, cfg)
        unpacked = torch.cat([hv.unpack_plain(
            words.reshape(L, -1)[l], scale, fmt, F, l) for l in range(L)])
        fns["embedding_bag"] = cs.embedding_bag_call(unpacked, rows, w)
        rec = {"points": n, "levels": L, "features": F, "mode": mode}
        rec.update(timed(fns))
        rec["bound_ms"], rec["bound_by"] = cs.bound(
            cs.nbytes(x, words, feats) + (0 if scale is None else
                                          cs.nbytes(scale)),
            cs.forward_ops("hash_forward", table, cfg, n))
        rec["sectors"] = cs.corner_sectors(rows)
        rec["l2_sector_ms"] = 1e3 * 32 * rec["sectors"] / l2_rate
        rec["far_loads"] = {str(ld): far_loads(x, mu, sigma, cfg, ld)
                            for ld in LOADS}
        rec["tree_loads"] = (4 * n * L + 4 * int(
            rec["far_loads"][str(TREE["load"])]))
        out["cases"][case] = rec
        print(f"packed-exact {case} ({mode}, {n} points, {rec['sectors']} "
              f"sectors ({rec['sectors'] / (n * L):.3f} a (point, level)), "
              f"{rec['tree_loads']} loads; bound {rec['bound_ms']:.4f} ms, "
              f"L2 sector figure {rec['l2_sector_ms']:.4f} ms) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)) + f" [{card}]", flush=True)
        del x, xc, feats, rows, w, unpacked, fns, table, words, scale
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
