"""Host ms per traced call inside the program's ``factor`` spans
(``rslqr_tpu_torch.factor``: the tree factorization, or the scan's value
pass and gains), from the profiler (``stagetrace.py``)."""

from lqrbench import stagetrace


def read(run):
    return stagetrace.host_ms(run, "factor")
