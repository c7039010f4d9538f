"""The least time the solve's work needs on the card, over the device's
busy ms per batched call, in percent. The least time is
``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)`` of the solver family's
stage counts (``stages/<family>.py``) at the cell's shapes."""


def least_s(stages, peaks) -> float:
    flops = sum(f for _, f, _ in stages)
    nbytes = sum(b for _, _, b in stages)
    return max(flops / peaks["float32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(run):
    s = run.summary
    if s is None or not s["busy_us"]:
        return None
    busy_s = 1e-6 * s["busy_us"] / s["calls"]
    return 100.0 * least_s(run.stages, run.peaks) / busy_s
