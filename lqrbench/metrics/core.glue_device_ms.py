"""Device ms per batched call of the operations that are not the port's
hand kernels (PyTorch's own kernels, copies and fills), from the
profiler."""


def read(run):
    if run.summary is None:
        return None
    return 1e-3 * run.summary["glue_us"] / run.summary["calls"]
