"""adam_ms.sdf.train: device milliseconds of the optimizer's kernels a
neuralangelo training step, over the traced steps: the foreach kernels
(multi_tensor_apply) of the grouped Adam, which reads and writes the
537M-entry table's parameter, gradient and two moments (at least 15 GB a
step: 4.5 ms at 3.35 TB/s)."""

UNIT = "ms/step"
KEYS = ("multi_tensor_apply",)


def read(run, seg):
    if run.kind != "train_sdf" or run.steps <= 0:
        return None
    s = sum(sec for name, (_, sec) in seg["kernels"].items()
            if any(k in name for k in KEYS))
    return 1e3 * s / run.steps if s > 0 else None
