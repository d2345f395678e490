"""host_ms.serve: per frame, the viewer's wait less the server's own
render-and-copy time (its response's wall_s): the PNG encode, the base64
and the rest of the host's part, the mean over the window's frames."""

import math

UNIT = "ms/frame"


def read(run, seg):
    if run.kind != "serve":
        return None
    xs = [x for x in run.host_s if math.isfinite(x)]
    return 1e3 * sum(xs) / len(xs) if xs else None
