"""gemm_ms.sdf.train: device milliseconds of the GEMM kernels (cuBLAS and
CUTLASS names) a neuralangelo training step, over the traced steps."""

from benchmark import trace

UNIT = "ms/step"


def read(run, seg):
    if run.kind != "train_sdf" or run.steps <= 0:
        return None
    s = trace.seconds_matching(seg["kernels"], trace.GEMM_KEYS)
    return 1e3 * s / run.steps if s > 0 else None
