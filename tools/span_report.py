"""Where the program's spans put a benchmark cell's traced time.

Runs one traced run of a cell (``benchmark.run --trace 1``, which prints the
cell's line) and reads the program's spans from the same traced segment:
for each ``hbr.`` span, ``observability.span_summary``'s count, host
seconds, idle seconds and device seconds, and how much of the device's idle
time in the segment lies under some program span.  The benchmark's own
reduction of the segment is left as it is.

Run:  python3 tools/span_report.py --workload flagship.serve --seed 7 \\
          --seconds 30 --out results/spans.json
      (one CUDA card; the cell's set-up, window and check, about a minute)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run, trace  # noqa: E402
from human_body_reconstruction_tpu_torch.utils import (  # noqa: E402
    observability as obs)


def segment_report(events) -> dict:
    """The segment's length and idle seconds, the idle seconds under the
    union of the program's spans, and ``span_summary`` of them."""
    cpu = torch.autograd.DeviceType.CPU
    mark = next(e for e in events
                if e.name == trace.SEGMENT and e.device_type == cpu)
    lo, hi = mark.time_range.start, mark.time_range.end
    clock = obs.busy_clock(obs.device_busy(events, lo, hi))

    def idle(a, b):
        return (b - a - clock(b) + clock(a)) * 1e-6

    spans = obs.merged(
        (max(e.time_range.start, lo), min(e.time_range.end, hi))
        for e in events if e.device_type == cpu
        and e.name.startswith(obs.SPAN_PREFIX)
        and e.time_range.end > lo and e.time_range.start < hi)
    return {"window_s": (hi - lo) * 1e-6, "idle_s": idle(lo, hi),
            "idle_under_spans_s": sum(idle(a, b) for a, b in spans),
            "spans": obs.span_summary(events, lo, hi)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    reports, reduce = [], trace.reduce

    def reduce_and_report(seg):
        reports.append(segment_report(seg.prof.events()))
        return reduce(seg)

    trace.reduce = reduce_and_report
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "segments": reports}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
