"""encoder_roofline.serve: the least time the traced frames' exact encode
could take on the card, launch by launch (the server's ray chunks times the
guided samples), over the device time of the encoder kernels."""

from benchmark import counts, trace

UNIT = "%"


def read(run, seg):
    if run.kind != "serve":
        return None
    s = trace.seconds_matching(seg["kernels"], trace.ENCODER_KEYS)
    if s <= 0:
        return None
    per_frame = sum(
        counts.encoder_bound_s(run.p, min(run.chunk, run.rays - a)
                               * run.samples, False, False)
        for a in range(0, run.rays, run.chunk))
    return 100.0 * run.frames * per_frame / s
