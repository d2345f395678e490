"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, one run of the cell (a window of
``--seconds``) with the program's readings, the control's (the reference
computed in float8_e4m3fn where the configuration rounds to bfloat16, put
in the program's place) and the planted faults' (training: half of the
batch left out, the mean over the rest; serving: one pixel of a frame
altered).  The benchmark's own runs do not run it.

    python3 -m benchmark.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

One JSON line a seed: {"seed", "readings"}.  A state left unchanged reads
1 by the change's measure and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        res = cells.driver(cell).run(cell, seed, args.seconds, False, device,
                                     extra_readings=True)
        print(json.dumps({"seed": seed, "readings": res["readings"]}),
              flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
