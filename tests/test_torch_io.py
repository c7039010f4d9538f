"""Port tests: JSON problem I/O (``rslqr_tpu_torch.io``) against
``rslqr_tpu.io``, CPU. Every file is written into ``tmp_path`` by the test
(the reference's golden files are not read): problems by both packages'
writers, a knot file and a named-matrix file by hand in the reference
format (json_utils.h:24-66: 1-based knot indices, column-major matrices).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

import rslqr_tpu as rt
from rslqr_tpu import io as jio

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import io as pio

FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")


@pytest.fixture(scope="module")
def jax_problem():
    return rt.random_problem(jax.random.PRNGKey(5), 8, 6, 3, jnp.float64)


def _assert_same(tp, jp):
    for k in FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(tp, k)),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def test_jax_writer_read_by_both(tmp_path, jax_problem):
    path = str(tmp_path / "prob.json")
    soln = np.arange(jax_problem.nvars, dtype=np.float64) / 7.0
    jio.write_lqr_problem_json(path, jax_problem, soln)
    jp, jsoln = jio.read_lqr_problem_json(path)
    tp, tsoln = pt.read_lqr_problem_json(path, device="cpu")
    assert tp.A.dtype == torch.float64 and tp.A.device.type == "cpu"
    _assert_same(tp, jp)
    _assert_same(tp, jax_problem)
    np.testing.assert_array_equal(tsoln, jsoln)
    np.testing.assert_array_equal(tsoln, soln)


def test_port_writer_read_by_jax(tmp_path, jax_problem):
    """The port's writer on a port problem (f64, and f32 read back in
    f32 bit for bit), read by JAX's reader."""
    tp = pt.problem_from_numpy(jax_problem, device="cpu")
    path = str(tmp_path / "port.json")
    pt.write_lqr_problem_json(path, tp)
    jp, jsoln = jio.read_lqr_problem_json(path)
    assert jsoln is None
    _assert_same(tp, jp)
    t32 = tp.to(dtype=torch.float32)
    pt.write_lqr_problem_json(path, t32)
    back, _ = pt.read_lqr_problem_json(path, dtype=torch.float32,
                                       device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(t32, k)), k


def test_named_matrices(tmp_path):
    """A golden-data file of named matrices, column-major (json_utils.c:
    311-348): a 6x6 block, a 1-column vector and a scalar list."""
    F = np.arange(36, dtype=np.float64).reshape(6, 6) / 10.0
    soln = np.linspace(-1.0, 1.0, 9)
    obj = {"F32y": F.T.tolist(), "soln": [soln.tolist()], "b": [1.5, 2.5]}
    path = str(tmp_path / "named.json")
    with open(path, "w") as fh:
        json.dump(obj, fh)
    np.testing.assert_array_equal(pt.read_named_matrix(path, "F32y"), F)
    np.testing.assert_array_equal(pt.read_named_matrix(path, "soln"), soln)
    got = pio.read_all_named_matrices(path)
    ref = jio.read_all_named_matrices(path)
    assert set(got) == set(ref) == set(obj)
    for k in obj:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jio.read_named_matrix(path, k))


def test_read_lqr_data(tmp_path):
    """One knot file (json_utils.h:24-44; lqrdata_test.c:15-39's
    double-integrator structure)."""
    dt = 0.1
    A = np.block([[np.eye(3), np.zeros((3, 3))], [dt * np.eye(3), np.eye(3)]])
    B = np.vstack([0.5 * dt * dt * np.eye(3), dt * np.eye(3)])
    obj = {"nstates": 6, "ninputs": 3, "Q": [1.0] * 6, "R": [0.01] * 3,
           "q": list(range(6)), "r": [0.5] * 3, "c": 2.0, "A": A.T.tolist(),
           "B": B.T.tolist(), "d": [1.5] * 6}
    path = str(tmp_path / "knot.json")
    with open(path, "w") as fh:
        json.dump(obj, fh)
    kd, jkd = pt.read_lqr_data_json(path), jio.read_lqr_data_json(path)
    assert (kd["nstates"], kd["ninputs"]) == (6, 3)
    np.testing.assert_array_equal(kd["A"], A)
    np.testing.assert_array_equal(kd["B"], B)
    assert set(kd) == set(jkd)
    for k in kd:
        np.testing.assert_array_equal(kd[k], jkd[k], err_msg=k)
