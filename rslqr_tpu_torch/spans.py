"""Stage spans and host counters of the port, on the profiler's clock.

:func:`span` brackets one stage of a solve. With nothing listening it
returns the one shared :data:`OFF` (a ``contextlib.nullcontext()``) after
one check, and enters nothing. Two listeners:

* ``torch.profiler``: while it records (``torch.autograd._profiler_enabled``,
  a read of the profiler's own state: no synchronize, no launch), a stage
  enters ``torch.profiler.record_function("rslqr_tpu_torch." + name)``: a
  ``user_annotation`` range on the microsecond clock of the trace's
  kernels, copies and fills, so any profiled run over a caller's own
  solves puts each launch, and each gap between device operations, down
  to the stage the host was in;
* :func:`listening`: a callable ``clock(name)`` returning a context manager
  (``profile.py``'s ``_Clock``), called for every stage while its ``with``
  block runs.

Names (the profiler's label is ``rslqr_tpu_torch.<name>``): ``solve``, once
a call of a front door (``rslqr.solve``, ``rslqr.solve_kkt``,
``pscan.solve_pscan``, ``pscan.solve_pscan_kkt``: :func:`entry`), and its
children ``factor``, ``sweep`` and ``pack`` (the KKT vector); in rsLQR's
``factor`` ``leaves`` and per tree level ``L`` ``products.L<L>``,
``cholesky.L<L>``, ``cholsolve.L<L>``, ``shur.L<L>``, in its ``sweep``
``rhs.L<L>``; in the scan's ``factor`` ``leaf``, ``fold``, ``scan`` and
``down`` (chunked) or ``scan`` and ``gains`` (unchunked), in its ``sweep``
``prefix`` and ``outputs``; ``h2d`` around each host array copied to the
device (:func:`host_copy`).

Counters, in the style of the kernel wrappers' ``launch_counts()``:
``solves`` (front-door calls) and ``host_copies`` (host arrays copied to a
solve's device by :func:`host_copy`, counted on every device, so a CPU run
counts what a run on the card copies).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

PREFIX = "rslqr_tpu_torch."
OFF = contextlib.nullcontext()

_listener = None  # profile.py's clock while :func:`listening` runs
_counts = {"solves": 0, "host_copies": 0}


def span(name: str, level: Optional[int] = None):
    """The context manager of stage ``name`` (``<name>.L<level>`` with a
    tree ``level``): :data:`OFF` with nothing listening."""
    if _listener is None and not _profiler_enabled():
        return OFF
    return _on(name if level is None else f"{name}.L{level}")


@contextlib.contextmanager
def _on(name: str):
    rec = (torch.profiler.record_function(PREFIX + name)
           if _profiler_enabled() else OFF)
    with rec, (OFF if _listener is None else _listener(name)):
        yield


def entry():
    """The ``solve`` span of one front-door call, counted in ``solves``."""
    _counts["solves"] += 1
    return span("solve")


def host_copy(array, device) -> torch.Tensor:
    """``torch.as_tensor(array, device=device)`` in an ``h2d`` span, counted
    in ``host_copies``. From pageable memory, so on a CUDA device the host
    waits for the stream to drain before the copy: the span's host time is
    that wait. With nothing listening it costs the count and one check."""
    _counts["host_copies"] += 1
    if _listener is None and not _profiler_enabled():
        return torch.as_tensor(array, device=device)
    with _on("h2d"):
        return torch.as_tensor(array, device=device)


@contextlib.contextmanager
def listening(clock):
    """Call ``clock(name)`` for every stage while the block runs."""
    global _listener
    prev, _listener = _listener, clock
    try:
        yield clock
    finally:
        _listener = prev


def counters() -> dict:
    """``{"solves": ..., "host_copies": ...}`` since the last reset."""
    return dict(_counts)


def reset_counters() -> None:
    for k in _counts:
        _counts[k] = 0
