"""Which quality-protocol modes the JAX CP Pallas forward runs per axis.

``ops/cp_pallas.py`` sizes the forward's scoped-VMEM stack (the three axes'
factor block, two W scratches of 256 points, the output block and the hat
temporaries) and, past 15.5 MB, runs ``_fwd_kernel_axis`` (one axis's
factor block resident at a time) instead of ``_fwd_kernel``.  This prints
that stack for every CP mode of ``scripts/quality_matrix.py`` that the port
runs, at the kernel's defaults (tight layout, double-buffered W, 256-point
forward tiles), and which kernel it takes.  A JAX-side reading for the CPU:

    JAX_PLATFORMS=cpu python tools/cp_axis_split.py
"""

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BM_F, N_W, LIMIT = 256, 2, 15.5e6     # cp_pallas.py:425, :231, :234


def main():
    from human_body_reconstruction_tpu.ops import cp_pallas, dense_grid, lowrank
    from human_body_reconstruction_tpu.utils import config as C

    spec = importlib.util.spec_from_file_location(
        "quality_matrix", os.path.join(REPO, "scripts", "quality_matrix.py"))
    qm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qm)
    for name, cfg in qm.make_modes(C, dense_grid).items():
        h = cfg.hash
        if h.variant != "cp":
            continue
        sizes = tuple(lowrank.cp_line_sizes(h))
        _, _, total = cp_pallas.get_layout(sizes, "tight")
        c_pad = -(-len(sizes) * h.cp_rank // 128) * 128
        stack = (3 * total * c_pad * 2 + N_W * BM_F * total * 2
                 + 3 * BM_F * c_pad * 4 + 2 * BM_F * 128 * 4)
        kernel = "_fwd_kernel_axis" if stack > LIMIT else "_fwd_kernel"
        print(f"{name}: CP levels {len(sizes)}, rank {h.cp_rank}, C "
              f"{len(sizes) * h.cp_rank} (pad {c_pad}), sum_G {sum(sizes)} "
              f"(tight {total}), stack {stack / 1e6:.2f} MB -> {kernel}")


if __name__ == "__main__":
    main()
