"""mfu.sdf.train: the neuralangelo step's two MLPs' FLOPs
(counts_sdf.mlp_flops of the program's per-step point counts) over the
traced segment's length and one card's f32 peak (67 TFLOP/s; the MLPs are
f32 GEMMs with TF32 off)."""

from benchmark import counts, counts_sdf

UNIT = "%"


def read(run, seg):
    if run.kind != "train_sdf" or not run.points or seg["window_s"] <= 0:
        return None
    flops = run.steps * counts_sdf.mlp_flops(run.p, run.points)
    return 100.0 * flops / (seg["window_s"] * counts.F32_OPS_PER_S)
