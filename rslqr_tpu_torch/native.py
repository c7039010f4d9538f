"""Bridge to the native host runtime (the ``_rslqr_native`` C++ extension).

Counterpart of ``rslqr_tpu.native``. The host data path, parsing
reference-format problem JSON (src/json_utils.c with the vendored cJSON)
and building the tree tables (src/binary_tree.c), has a C++ fast path in
the repo's ``csrc/``, built with ``python setup.py build_ext --inplace``.
It is host code and touches no device. Where the extension is absent,
each entry point runs the pure-Python implementation
(:mod:`rslqr_tpu_torch.io`, :func:`rslqr_tpu_torch.tree.build_tree_tables`)
and returns the same structure, so the port works from a plain checkout.
"""

from __future__ import annotations

import json

import numpy as np

from .io import _problem_arrays, _soln
from .tree import build_tree_tables

try:
    import _rslqr_native as _native
except ImportError:  # the extension is not built
    _native = None


def have_native() -> bool:
    """Whether the C++ extension is loaded."""
    return _native is not None


def load_problem_native(path: str):
    """Parse a problem file into ``(fields, golden_soln_or_None)``: a dict
    of float64 numpy arrays under the :class:`LQRProblem` field names, and
    the file's ``soln`` vector."""
    if _native is None:
        with open(path) as fh:
            obj = json.load(fh)
        return _problem_arrays(obj, path), _soln(obj)
    raw = _native.load_problem(path)
    N, n, m = raw["nhorizon"], raw["nstates"], raw["ninputs"]

    def arr(key, shape):
        return np.frombuffer(raw[key], dtype=np.float64).reshape(shape)

    fields = {
        "A": arr("A", (N, n, n)),
        "B": arr("B", (N, n, m)),
        "f": arr("f", (N, n)),
        "Qdiag": arr("Qdiag", (N, n)),
        "Rdiag": arr("Rdiag", (N, m)),
        "q": arr("q", (N, n)),
        "r": arr("r", (N, m)),
        "c": arr("c", (N,)),
        "x0": arr("x0", (n,)),
    }
    soln = (
        np.frombuffer(raw["soln"], dtype=np.float64) if "soln" in raw else None
    )
    return fields, soln


def tree_tables_native(nhorizon: int):
    """The tree tables ``(depth, levels [N-1] int32, sep_index [N, depth]
    int32, calc_lambda [N, depth] bool)``; ``ValueError`` for a horizon
    that is not a power of two."""
    if _native is None:
        t = build_tree_tables(nhorizon)
        return t.depth, t.levels, t.sep_index, t.calc_lambda
    raw = _native.tree_tables(nhorizon)
    depth = raw["depth"]
    levels = np.frombuffer(raw["levels"], dtype=np.int32)
    sep = np.frombuffer(raw["sep_index"], dtype=np.int32).reshape(
        nhorizon, depth)
    calc = np.frombuffer(raw["calc_lambda"], dtype=np.uint8).reshape(
        nhorizon, depth
    ).astype(bool)
    return depth, levels, sep, calc
