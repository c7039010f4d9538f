"""Host ms per traced call inside the program's ``h2d`` spans: its copies
of host arrays to the card, each from pageable memory, so each waits for
the stream to drain first (0 where the solve copies none), from the
profiler (``stagetrace.py``)."""

from lqrbench import stagetrace


def read(run):
    return stagetrace.host_ms(run, "h2d")
