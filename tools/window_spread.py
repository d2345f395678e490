"""How far runs of the same training window drift apart on the card.

The backward kernels add in float atomics, so two runs of the same steps
from the same state differ in their sums' last bits, and Adam turns a
near-zero gradient's sign into a step of the learning rate: runs branch
apart at random steps.  From one snapshot of the trained flagship (the
smoke's ``train``), this runs ``--runs`` eager windows and as many graphed
ones (``chip_smoke.window_check``'s runners: each graph captured by a first
window, reset to the snapshot and replayed) of ``--steps`` steps, for the
guided step, the unculled one and the data-parallel guided step (a world
of one on NCCL), and prints the distance between every two runs'
parameters and Adam moments after the window: eager against eager, graphed
against graphed, graphed against eager.

Run:  python tools/window_spread.py --runs 4 --steps 25
      (one CUDA card; about a minute of command time)
"""

from __future__ import annotations

import argparse
import copy
import itertools
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def spread(label, st0, gen, runner, runs: int, n: int) -> dict:
    """Pairwise distances of ``runs`` eager and ``runs`` graphed windows."""
    snap = cs.snapshot(st0, gen)
    vecs = []
    for kind in ("eager",) * runs + ("graph",) * runs:
        st, g = runner.state(snap)
        if kind == "eager":
            for _ in range(n):
                runner.step(st, g)
        else:
            run = runner.window(n)
            run(st, g)
            cs.restore_into(st, g, snap)
            run(st, g)
        torch.cuda.synchronize()
        vecs.append(cs.state_vector(st))
        del st
    E, G = range(runs), range(runs, 2 * runs)

    def d(i, j):
        return float((vecs[i] - vecs[j]).norm())

    out = {"eager_eager": sorted(d(i, j) for i, j in
                                 itertools.combinations(E, 2)),
           "graph_graph": sorted(d(i, j) for i, j in
                                 itertools.combinations(G, 2)),
           "graph_eager": sorted(d(i, j) for i in G for j in E),
           "norm": float(vecs[0].norm())}
    for k, v in out.items():
        print(f"{label} {k}: {v}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--steps", type=int, default=25)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_spread: needs a CUDA card")
    from human_body_reconstruction_tpu_torch.cli import card_line
    from human_body_reconstruction_tpu_torch.ops import cuda_lib
    from human_body_reconstruction_tpu_torch.parallel import data_parallel as dp

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.build()
    cuda_lib.library()
    device = torch.device("cuda")
    tag = f"[{card_line(device)}]"
    print(tag)
    work = tempfile.TemporaryDirectory()
    trainer, ds, _, _ = cs.train(f"{work.name}/flagship", device, tag)
    st, gen, n = trainer.state, trainer.generator, args.steps
    data = (ds["images"], ds["c2ws"], ds["K"])
    common = (st.field, trainer.scene, data, trainer.cfg, st.step + 10 * n)
    unculled = copy.copy(st)
    unculled.occ = None
    spread("guided", st, gen, cs.SingleRunner(*common), args.runs, n)
    spread("unculled", unculled, gen, cs.SingleRunner(*common), args.runs,
           n)
    with cs.nccl_world():
        spread("data-parallel guided", st, gen, cs.ParallelRunner(
            dp.make_dp_train_step, dp.make_mesh(), *common), args.runs, n)
    work.cleanup()


if __name__ == "__main__":
    main()
