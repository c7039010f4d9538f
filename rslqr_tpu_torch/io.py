"""JSON problem and golden-data loaders in the reference file formats.

Counterpart of ``rslqr_tpu.io`` (and of the reference's
``src/json_utils.{h,c}``). The formats (json_utils.h:24-66) come from a
Julia generator, so:

  * knot ``index`` fields are 1-based (json_utils.c:237 subtracts 1);
  * 2D arrays are stored column-major: the outer JSON list enumerates
    *columns* (json_utils.c:87-126).

Parsing is numpy host code; a problem becomes the port's
:class:`~rslqr_tpu_torch.problem.LQRProblem` on ``device`` (the card
unless the caller asks for the CPU, as the problem builders do).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .problem import LQRProblem, problem_from_arrays


def _read_matrix_colmajor(obj) -> np.ndarray:
    """Decode a reference-format 2D array: outer list = columns."""
    return np.asarray(obj, dtype=np.float64).T


def _decode_knot(obj) -> Dict[str, np.ndarray]:
    return {
        "nstates": int(obj["nstates"]),
        "ninputs": int(obj["ninputs"]),
        "Q": np.asarray(obj["Q"], dtype=np.float64),
        "R": np.asarray(obj["R"], dtype=np.float64),
        "q": np.asarray(obj["q"], dtype=np.float64),
        "r": np.asarray(obj["r"], dtype=np.float64),
        "c": float(obj["c"]),
        "A": _read_matrix_colmajor(obj["A"]),
        "B": _read_matrix_colmajor(obj["B"]),
        "d": np.asarray(obj["d"], dtype=np.float64),
    }


def read_lqr_data_json(path: str) -> Dict[str, np.ndarray]:
    """Load a single knot point file (format: json_utils.h:24-44): a dict
    with keys Q, R, q, r, c, A, B, d plus nstates/ninputs (numpy).
    Counterpart of ``ndlqr_ReadLQRDataJSONFile`` (json_utils.c:136-184)."""
    with open(path) as fh:
        return _decode_knot(json.load(fh))


def _problem_arrays(obj, path: str) -> Dict[str, np.ndarray]:
    """The nine float64 problem fields of a parsed problem file."""
    N = int(obj["nhorizon"])
    knots = [None] * N
    for entry in obj["lqrdata"]:
        knots[int(entry["index"]) - 1] = _decode_knot(entry)
    if any(kd is None for kd in knots):
        raise ValueError(f"{path}: missing knot points")
    n, m = knots[0]["nstates"], knots[0]["ninputs"]

    def stack(key, shape):
        return np.stack([kd[key].reshape(shape) for kd in knots])

    return dict(
        A=stack("A", (n, n)),
        B=stack("B", (n, m)),
        f=stack("d", (n,)),
        Qdiag=stack("Q", (n,)),
        Rdiag=stack("R", (m,)),
        q=stack("q", (n,)),
        r=stack("r", (m,)),
        c=np.array([kd["c"] for kd in knots]),
        x0=np.asarray(obj["x0"], dtype=np.float64),
    )


def _soln(obj) -> Optional[np.ndarray]:
    """The file's ``soln`` KKT vector (a 1-column matrix), if any."""
    if "soln" not in obj:
        return None
    return np.asarray(obj["soln"], dtype=np.float64).reshape(-1)


def read_lqr_problem_json(
    path: str, dtype=torch.float64, device="cuda"
) -> Tuple[LQRProblem, Optional[np.ndarray]]:
    """Load a full LQR problem file (format: json_utils.h:46-66) onto
    ``device`` in ``dtype``. Counterpart of ``ndlqr_ReadLQRProblemJSONFile``
    (json_utils.c:186-259). Returns ``(problem, golden_solution_or_None)``:
    the reference's problem files carry a ``soln`` KKT vector from the Julia
    generator (test/sample_problem_test.c:150-151), kept as numpy."""
    with open(path) as fh:
        obj = json.load(fh)
    arrays = _problem_arrays(obj, path)
    prob = problem_from_arrays(**arrays, dtype=dtype, device=device)
    return prob, _soln(obj)


def _decode_named(val) -> np.ndarray:
    arr = np.asarray(val, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr.T
        if 1 in arr.shape:  # column vectors flatten for convenience
            arr = arr.reshape(-1)
    return arr


def read_named_matrix(path: str, name: str) -> np.ndarray:
    """Load one named matrix from a golden-data file, column-major
    (``ReadMatrixJSONFile``, json_utils.c:311-348: the intermediate factor
    blocks ``F{knot}{level}{y|x|u}``, ``b``, ``soln``)."""
    with open(path) as fh:
        return _decode_named(json.load(fh)[name])


def read_all_named_matrices(path: str) -> Dict[str, np.ndarray]:
    """Load every named matrix in a golden-data file (column-major)."""
    with open(path) as fh:
        return {k: _decode_named(v) for k, v in json.load(fh).items()}


def _host(x) -> np.ndarray:
    """A tensor or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def write_lqr_problem_json(path: str, prob: LQRProblem, soln=None) -> None:
    """Serialize a single problem to the reference JSON format (the inverse
    of :func:`read_lqr_problem_json`; Python's JSON floats round-trip every
    float64 exactly)."""
    N, n, m = prob.nhorizon, prob.nstates, prob.ninputs
    P = {k: _host(getattr(prob, f)) for k, f in (
        ("A", "A"), ("B", "B"), ("f", "f"), ("Q", "Qdiag"), ("R", "Rdiag"),
        ("q", "q"), ("r", "r"), ("c", "c"), ("x0", "x0"))}
    lqrdata = [
        {
            "index": k + 1,
            "nstates": n,
            "ninputs": m,
            "Q": P["Q"][k].tolist(),
            "R": P["R"][k].tolist(),
            "q": P["q"][k].tolist(),
            "r": P["r"][k].tolist(),
            "c": float(P["c"][k]),
            "A": P["A"][k].T.tolist(),  # column-major on disk
            "B": P["B"][k].T.tolist(),
            "d": P["f"][k].tolist(),
        }
        for k in range(N)
    ]
    obj = {"nhorizon": N, "x0": P["x0"].tolist(), "lqrdata": lqrdata}
    if soln is not None:
        obj["soln"] = _host(soln).tolist()
    with open(path, "w") as fh:
        json.dump(obj, fh)
