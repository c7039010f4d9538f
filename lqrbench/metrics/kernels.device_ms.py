"""Device ms per batched call of the port's hand kernels (names matched by
``kernels/*.txt``), from the profiler; nothing where none ran."""


def read(run):
    if run.summary is None or not run.summary["hand_us"]:
        return None
    return 1e-3 * run.summary["hand_us"] / run.summary["calls"]
