"""Small host-side integer utilities (counterpart of ``rslqr_tpu.utils``).

Horizon lengths and tree depths are plain Python ints: PyTorch runs
eagerly, so every index decision is made on the host before a launch.
"""

from __future__ import annotations


def is_power_of_two(x: int) -> bool:
    """True iff ``x`` is a positive power of two (ref: utils.c:7-9)."""
    return x > 0 and (x & (x - 1)) == 0


def power_of_two(exponent: int) -> int:
    """2**exponent via bit shift (ref: utils.c:11)."""
    return 1 << exponent


def log2_int(x: int) -> int:
    """Integer log2 of a power of two (ref: utils.c:13-15)."""
    if not is_power_of_two(x):
        raise ValueError(f"log2_int requires a power of two, got {x}")
    return x.bit_length() - 1
