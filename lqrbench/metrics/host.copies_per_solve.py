"""Host arrays the program copies to the card per front-door call: its
``host_copies`` counter over its ``solves`` counter
(``<package>.spans.counters()``). Both count every call of the run, set-up
included; the copies of a call follow from its shapes alone."""

import importlib

from lqrbench import program


def read(run):
    try:
        spans = importlib.import_module(program.PACKAGE + ".spans")
    except ModuleNotFoundError:
        return None
    c = spans.counters()
    return c["host_copies"] / c["solves"] if c["solves"] else None
