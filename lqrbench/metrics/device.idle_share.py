"""The share of the traced window in which no operation ran on the
device: 1 - (union of device intervals / window), in percent."""


def read(run):
    s = run.summary
    if s is None or not s["window_us"]:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
