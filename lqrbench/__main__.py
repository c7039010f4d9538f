"""``python3 -m lqrbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see ``lqrbench/run.py``)."""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import sys  # noqa: E402

from lqrbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
