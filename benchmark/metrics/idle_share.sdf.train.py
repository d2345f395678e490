"""idle_share.sdf.train: the share of the traced neuralangelo training
segment in which no operation ran on the device (1 - union of device spans
/ its length), as ``idle_share.train`` reads the other training cells."""

UNIT = "%"


def read(run, seg):
    if run.kind != "train_sdf" or seg["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])
