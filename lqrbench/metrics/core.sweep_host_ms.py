"""Host ms per traced call inside the program's ``sweep`` spans
(``rslqr_tpu_torch.sweep``: the tree's RHS sweep, or the scan's rollout
and outputs), from the profiler (``stagetrace.py``)."""

from lqrbench import stagetrace


def read(run):
    return stagetrace.host_ms(run, "sweep")
