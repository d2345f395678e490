"""mfu.train: the traced training steps' model FLOPs (the MLP's GEMMs
forward and backward and the encoder's operations both ways, and each
occupancy refresh's density pass), counted from the configuration's shapes
and the points each step encodes, over the segment's length and one card's
f32 peak (67 TFLOP/s; the GEMMs are f32 with TF32 off)."""

from benchmark import counts

UNIT = "%"


def read(run, seg):
    if run.kind != "train" or seg["window_s"] <= 0:
        return None
    flops = (run.steps * counts.step_flops(run.p, run.points, run.stochastic)
             + run.refreshes * counts.refresh_flops(run.p))
    return 100.0 * flops / (seg["window_s"] * counts.F32_OPS_PER_S)
