"""mfu.serve: the traced frames' model FLOPs (the MLP forward and the
exact encode of every sample of every ray) over the segment's length and
one card's f32 peak (67 TFLOP/s)."""

from benchmark import counts

UNIT = "%"


def read(run, seg):
    if run.kind != "serve" or seg["window_s"] <= 0:
        return None
    flops = run.frames * counts.frame_flops(run.p, run.rays * run.samples)
    return 100.0 * flops / (seg["window_s"] * counts.F32_OPS_PER_S)
