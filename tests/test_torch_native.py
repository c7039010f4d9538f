"""Port tests: the native host-runtime bridge (``rslqr_tpu_torch.native``):
the C++ loader against the Python one, the tree tables against
``build_tree_tables``, and the pure-Python fallback taken where the
``_rslqr_native`` extension is absent. CPU; the problem file is written
into ``tmp_path``."""

import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import native

FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")


@pytest.fixture(scope="module")
def problem_file(tmp_path_factory):
    prob = pt.random_problem(torch.Generator().manual_seed(2), 16, 6, 3,
                             dtype=torch.float64, device="cpu")
    path = str(tmp_path_factory.mktemp("native") / "prob.json")
    soln = np.linspace(0.0, 1.0, prob.nvars)
    pt.write_lqr_problem_json(path, prob, soln)
    return path, prob, soln


def _needs_extension():
    if not native.have_native():
        pytest.skip("the _rslqr_native extension is not built (python "
                    "setup.py build_ext --inplace): only the fallback runs")


def test_native_loader_matches_python(problem_file):
    _needs_extension()
    path, prob, soln = problem_file
    fields, got_soln = native.load_problem_native(path)
    py, py_soln = pt.read_lqr_problem_json(path, device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(fields[k], to_numpy(getattr(py, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(fields[k], to_numpy(getattr(prob, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(got_soln, py_soln)
    np.testing.assert_array_equal(got_soln, soln)


@pytest.mark.parametrize("N", [8, 64, 256])
def test_tree_tables(N):
    d, lv, sep, calc = native.tree_tables_native(N)
    t = pt.build_tree_tables(N)
    assert d == t.depth
    np.testing.assert_array_equal(lv, t.levels)
    np.testing.assert_array_equal(sep, t.sep_index)
    np.testing.assert_array_equal(calc, t.calc_lambda)


def test_rejects_bad_horizon():
    with pytest.raises(ValueError):
        native.tree_tables_native(6)


def test_python_fallback(problem_file, monkeypatch):
    """Without the extension each entry point returns the same structure
    from the pure-Python implementation."""
    path, prob, soln = problem_file
    with_ext = (native.load_problem_native(path), native.tree_tables_native(8))
    monkeypatch.setattr(native, "_native", None)
    assert not native.have_native()
    fields, got_soln = native.load_problem_native(path)
    for k in FIELDS:
        np.testing.assert_array_equal(fields[k], to_numpy(getattr(prob, k)))
        np.testing.assert_array_equal(fields[k], with_ext[0][0][k])
    np.testing.assert_array_equal(got_soln, soln)
    for a, b in zip(native.tree_tables_native(8), with_ext[1]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.tree_tables_native(6)
