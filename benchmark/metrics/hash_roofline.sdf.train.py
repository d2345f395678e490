"""hash_roofline.sdf.train: the least time of the neuralangelo step's hash
forward and backward at F 8 in 2^22-entry tables (counts_sdf.hash_bound_s
of the per-step point counts: 32-byte sectors a corner row) over the
device time of the hash kernels (hash_forward_kernel,
hash_backward_kernel) in the traced steps."""

from benchmark import counts_sdf, trace

UNIT = "%"
KERNELS = ("hash_forward_kernel", "hash_backward_kernel")


def read(run, seg):
    if run.kind != "train_sdf" or not run.points or run.steps <= 0:
        return None
    s = trace.seconds_matching(seg["kernels"], KERNELS)
    if s <= 0:
        return None
    return 100.0 * run.steps * counts_sdf.hash_bound_s(run.p, run.points) / s
