"""A/B of the subsampled hash backward and the table pack on the card.

On ray-ordered points at the shapes of the modes that run them (each ray's
samples consecutive, as the renderer flattens them; the modes' own level
scales and table widths):

  lpair  int8_dense_guided_k32_mass_lpair: 16384 rays x 32 samples, 6
         hashed levels, F 4, T 2^16, one level of each pair (psel)
  lvl    int8_dense_guided_lvl: 16384 x 48, one level a point (lsel)
  gsub   packed_gsub: 16000 x 64, 16 levels, F 2, every level (pick alone)

it times, each in turns (a, b, ..., ..., b, a): the tree's
``hbr_hash_backward`` given the draws (one thread a point and its drawn
terms); an earlier tree's (``--parent``, its ``hash.cu`` with
``levels.cuh`` beside it; at 8aaa93f, the run walk skipping the points
whose level was not drawn); the run walk (the unsubsampled stochastic
backward) given the routed gradient, whose undrawn terms are zero; the variants of ``tools/hash_backward_ab.cu`` (one thread a term,
with and without a warp's same-index terms summed first; the level-pair
terms merged over runs of 4 and 16 points; the point kernel without its
reductions, with streaming loads, with evict-last reductions, reading and
sending one term at a time); the
reductions alone given the pairs; ``index_add_`` given the pairs; and the
zeroing of the gradient table that every backward call includes.  Then the
packs of the parent and the tree (and the int8 one at 256 and 1024 threads
a block) on the lpair (int8) and gsub (bf16) tables, beside the bf16 cast.
Every variant's gradient is held to the plain version within
``cuda_lib.sum_order_tolerance`` and every pack to ``pack_plain`` bit for
bit before it is timed.  One JSON object goes to ``--out``.

Run on the card (about a minute of machine time):

  mkdir -p local/parent && git archive <commit> \
      human_body_reconstruction_tpu_torch/csrc | tar -x -C local/parent
  python tools/hash_backward_ab.py \
      --parent local/parent/human_body_reconstruction_tpu_torch/csrc/hash.cu \
      --out results/hash_backward_ab.json
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CASES = {"lpair": ("int8_dense_guided_k32_mass_lpair", 16384, 32),
         "lvl": ("int8_dense_guided_lvl", 16384, 48),
         "gsub": ("packed_gsub", 16000, 64)}
VARIANT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "hash_backward_ab.cu")


def build(sources: dict) -> dict:
    """{name: loaded library} of {name: .cu source}, each built by nvcc
    with the port's flags into the port's build directory, all at once."""
    from human_body_reconstruction_tpu_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {k: cuda_lib.BUILD_DIR / f"ab_{k}_{os.getpid()}.so" for k in sources}
    procs = {k: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(outs[k]),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, src in sources.items()}
    libs = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[k]}:\n{log}")
        libs[k] = ctypes.CDLL(str(outs[k]))
        outs[k].unlink()
    p, i, ll, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float)
    lv = ctypes.POINTER(cuda_lib.HbrLevels)
    for lib in libs.values():
        lib.hbr_hash_backward.argtypes = [p, p, p, p, p, p, p, p, ll, ll, i,
                                          i, i, f32, lv, p, p]
        lib.hbr_hash_pack.argtypes = [p, ll, ll, i, i, p, p, p]
        if hasattr(lib, "ab_hash_backward"):
            lib.ab_hash_backward.argtypes = [p, p, p, p, p, p, p, p, ll, ll,
                                             i, i, f32, i, i, lv, p, p]
            lib.ab_pairs_red.argtypes = [p, p, ll, p, p]
            lib.ab_pack_int8.argtypes = [p, ll, ll, i, i, p, p, p]
    return libs


def ray_points(rays: int, samples: int, device, seed: int):
    """World points of seeded rays through the box [0, 1]^3 of normalised
    coordinates (mu 0, sigma 1), each ray's samples consecutive."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 1.3, (rays, 1, 3))
    d = rng.uniform(0.3, 0.7, (rays, 1, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (np.linspace(0.0, 1.5, samples)[None, :, None]
         + rng.uniform(0.0, 1.5 / samples, (rays, samples, 1)))
    x = torch.tensor((o + d * t).reshape(-1, 3), dtype=torch.float32,
                     device=device)
    return (x, torch.zeros(3, device=device), torch.ones(3, device=device))


def ptr(t):
    return None if t is None else t.data_ptr()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier tree's csrc/hash.cu (levels.cuh beside)")
    ap.add_argument("--out", default="results/hash_backward_ab.json")
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
    stream = cuda_lib.stream_handle(device)
    out = {"card": card, "backward": {}, "pack": {}}

    def timed(fns: dict) -> dict:
        """{name: [ms, ...]} of fns run in turns a, b, ..., ..., b, a."""
        ms = {k: [] for k in fns}
        order = list(fns) + list(fns)[::-1]
        for k in order:
            ms[k].append(cs.time_ms(fns[k], reps=args.reps))
        return ms

    for case, (mode, rays, samples) in CASES.items():
        cfg = quality_holdout.make_modes()[mode].hash
        gen = torch.Generator(device).manual_seed(1)
        x, mu, sigma = ray_points(rays, samples, device, seed=2)
        n, L, F = x.shape[0], cfg.num_hashed_levels, cfg.features_per_level
        table = torch.zeros((L, cfg.table_size, F), device=device)
        u = torch.rand((3, L, n), generator=gen, device=device)
        _, bits = hash_kernel.hash_encode_plain(table, x, mu, sigma, cfg, u)
        route = hash_encoding.hash_route(cfg, True)
        d = hash_encoding.draw_subsample(route, cfg, L, n, device, gen)
        pick, lsel, psel = d["pick"], d.get("lsel"), d.get("psel")
        g = torch.randn((n, L * F), generator=gen, device=device)
        a = (table, x, mu, sigma, cfg)
        xc, muv, sigmav, lv = hash_kernel.launch_points(x, mu, sigma, cfg)

        def lib_backward(lib, variant=None, run=0):
            def fn():
                dt = torch.zeros(table.shape, device=device)
                common = [xc.data_ptr(), muv.data_ptr(), sigmav.data_ptr(),
                          bits.data_ptr(), pick.data_ptr(), ptr(lsel),
                          ptr(psel), g.data_ptr(), g.stride(0), n]
                if variant is None:
                    code = lib.hbr_hash_backward(
                        *common, 3, cfg.table_size, F, float(F), lv,
                        dt.data_ptr(), stream)
                else:
                    code = lib.ab_hash_backward(
                        *common, cfg.table_size, F, float(F), variant, run,
                        lv, dt.data_ptr(), stream)
                if code != 0:
                    raise RuntimeError(f"launch failed: CUDA error {code}")
                return dt
            return fn

        routed = hash_kernel.routed_grad(g, F, pick, lsel, psel)
        idx, val = hv.pairs_plain(*a, g, bits, pick, lsel, psel)
        acc = torch.zeros(table.numel(), device=device)

        def pairs_red():
            code = libs["tree"].ab_pairs_red(idx.data_ptr(), val.data_ptr(),
                                             idx.numel(), acc.data_ptr(),
                                             stream)
            if code != 0:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        fns = {"tree_point_terms": lambda: (
                   hash_kernel.hash_encode_backward_kernel(
                       *a, g, bits, pick=pick, lsel=lsel, psel=psel)),
               "parent": lib_backward(libs["parent"]),
               "walk_on_routed_grad": lambda: (
                   hash_kernel.hash_encode_backward_kernel(*a, routed, bits)),
               "one_thread_a_term": lib_backward(libs["tree"], 1),
               "warp_summed_terms": lib_backward(libs["tree"], 2),
               "point_terms_streaming_loads": lib_backward(libs["tree"], 4),
               "point_terms_evict_last": lib_backward(libs["tree"], 5),
               "point_terms_one_at_a_time": lib_backward(libs["tree"], 6)}
        if psel is not None:
            fns["psel_merge_run4"] = lib_backward(libs["tree"], 0, 4)
            fns["psel_merge_run16"] = lib_backward(libs["tree"], 0, 16)
        fns["pairs_red"] = pairs_red
        fns["index_add_pairs"] = lambda: acc.index_add_(0, idx, val)
        fns["zeros_of_the_table"] = lambda: torch.zeros(table.shape,
                                                        device=device)
        want = hash_kernel.hash_encode_plain_backward(
            *a, g, bits=bits, pick=pick, lsel=lsel, psel=psel)
        abs_sum = hash_kernel.hash_encode_plain_backward(
            *a, g.abs(), bits=bits, pick=pick, lsel=lsel, psel=psel)
        tol = cuda_lib.sum_order_tolerance(want, abs_sum, False)
        for k, fn in fns.items():
            if k in ("index_add_pairs", "pairs_red", "zeros_of_the_table"):
                continue
            got = fn()
            torch.cuda.synchronize()
            ratio = float(((got - want).abs() / tol).max())
            print(f"{case} {k}: worst |err| / tolerance {ratio:.3f}",
                  flush=True)
            if not ratio <= 1.0:
                raise RuntimeError(f"{case} {k} disagrees with plain")
        rec = timed(fns)
        rec["point_terms_no_reduction"] = timed(
            {"x": lib_backward(libs["tree"], 3)})["x"]
        rec["points"], rec["terms"] = n, int(val.numel())
        out["backward"][case] = rec
        print(f"{case} ({mode}, {n} points, {val.numel()} terms) ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()
                          if isinstance(v, list)) + f" [{card}]", flush=True)
        del table, u, bits, d, g, routed, idx, val, acc, want, abs_sum, tol

    for fmt, mode in (("int8", "int8_dense_guided_k32_mass_lpair"),
                      ("bf16", "packed_gsub")):
        cfg = quality_holdout.make_modes()[mode].hash
        table = torch.empty((cfg.num_hashed_levels, cfg.table_size,
                             cfg.features_per_level), device=device).uniform_(
            -1, 1, generator=torch.Generator(device).manual_seed(3))
        L, T, F = table.shape

        def lib_pack(lib, threads=None):
            def fn():
                w = torch.empty(L * T, dtype=torch.int32, device=device)
                s = torch.empty(L, device=device)
                if threads is None:
                    code = lib.hbr_hash_pack(table.data_ptr(), L, T, F,
                                             hv.FORMATS[fmt], w.data_ptr(),
                                             s.data_ptr(), stream)
                else:
                    code = lib.ab_pack_int8(table.data_ptr(), L, T, F,
                                            threads, w.data_ptr(),
                                            s.data_ptr(), stream)
                if code != 0:
                    raise RuntimeError(f"pack failed: CUDA error {code}")
                return w, s
            return fn

        fns = {"parent": lib_pack(libs["parent"]),
               "tree": lambda: hv.pack_kernel(table, fmt)}
        if fmt == "int8":
            for threads in (256, 1024):
                fns[f"tree_{threads}_threads"] = lib_pack(
                    libs["tree"], threads)
        want = hv.pack_plain(table, fmt)
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and (
                fmt == "bf16" or torch.equal(got[1], want[1]))
            if not same:
                raise RuntimeError(f"{fmt} pack {k} differs from pack_plain")
        if fmt == "bf16":
            fns["bf16_cast"] = lambda: table.to(torch.bfloat16).view(
                torch.int32)
        rec = timed(fns)
        out["pack"][fmt] = rec
        print(f"pack {fmt} {tuple(table.shape)} ms: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()) + f" [{card}]",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
