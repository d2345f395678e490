"""encoder_roofline.train: the least time the traced steps' encoding could
take on the card (counts.encoder_bound_s of each step's points forward and
backward, and of each refresh's points forward) over the device time of the
encoder kernels (dense, CP, hash and Philox)."""

from benchmark import counts, trace

UNIT = "%"


def read(run, seg):
    if run.kind != "train":
        return None
    s = trace.seconds_matching(seg["kernels"], trace.ENCODER_KEYS)
    if s <= 0:
        return None
    b = (run.steps * (counts.encoder_bound_s(run.p, run.points, False,
                                             run.stochastic)
                      + counts.encoder_bound_s(run.p, run.points, True,
                                               run.stochastic))
         + run.refreshes * counts.encoder_bound_s(
             run.p, counts.REFRESH_CELLS, False, False))
    return 100.0 * b / s
