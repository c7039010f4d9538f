"""Device ms per traced call of the operations launched inside the
program's ``factor`` spans (each operation placed by its launch event's
time, ``args.correlation``), from the profiler (``stagetrace.py``)."""

from lqrbench import stagetrace


def read(run):
    return stagetrace.device_ms(run, "factor")
