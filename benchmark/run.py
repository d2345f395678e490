"""Run one cell of the port's benchmark once and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits 2 and
prints no result.  With ``--trace 0`` the line's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (read from the
traced segment by ``metrics/<name>.py``).  Every run checks what the timed
path produced against the plain reference (``reference/``) and prints each
number compared beside its limit, last on standard error and last in the
line ("checks").  The process must not have loaded JAX or the JAX package
once the window has closed: if it has, the run exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches: fixed directories in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_ext")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "human_body_reconstruction_tpu")
THREADS = 1


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def line(cell, res: dict, trace: bool, device, correct_: bool,
         checks: dict) -> dict:
    """The result line: end-to-end metrics, or the listed per-layer ones."""
    import torch

    from benchmark import cells

    if trace:
        seg = res["segment"]
        if seg is None:
            raise RuntimeError("the window closed before the traced segment")
        wanted = cells.listed_metrics(cell.name)
        mods = cells.metric_modules()
        metrics = {}
        for name in wanted:
            v = mods[name].read(seg["run"], seg)
            if v is not None:
                metrics[name] = {"value": v, "unit": mods[name].UNIT}
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in res["metrics"].items()}
        metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct_, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res["segment"]["busy_s"]
        dev["window_s"] = res["segment"]["window_s"]
        out["breakdown"] = res["segment"]["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from benchmark import cells, correct

    # one process with one host compute thread: idle pool threads that
    # spin take cycles from the host's part of each step or frame
    torch.set_num_threads(THREADS)

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = cells.driver(cell).run(cell, args.seed, args.seconds,
                                 bool(args.trace), device)
    ok, checks = correct.judge(res["readings"], cell.limits)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    out = line(cell, res, bool(args.trace), device, ok, checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
