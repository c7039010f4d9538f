"""Port tests: failure detection and solution verification
(``rslqr_tpu_torch.diagnostics``), mirroring tests/test_diagnostics.py on
problems written into ``tmp_path`` (the reference's golden file is not
read), on both layouts (element-major and ``layout="grid"``), CPU; the
per-instance status is held against ``rslqr_tpu.diagnostics`` on the same
batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

import rslqr_tpu as rt
from rslqr_tpu import diagnostics as jdiag

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import diagnostics

LAYOUTS = ["auto", "grid"]


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    """The double integrator at N=8, through a problem file."""
    path = str(tmp_path_factory.mktemp("diag") / "prob.json")
    pt.write_lqr_problem_json(path, pt.double_integrator_problem(
        8, device="cpu"))
    return pt.read_lqr_problem_json(path, device="cpu")[0]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ok_solution(prob, layout):
    sol = pt.solve(prob, options=pt.SolveOptions(layout=layout))
    vec = sol.kkt_vector()
    rep = diagnostics.check_solution(prob, vec)
    assert int(rep.status) == diagnostics.SolveStatus.OK
    assert bool(rep.finite)
    assert bool(diagnostics.factorization_ok(sol.fact).all())
    diagnostics.assert_solution_ok(prob, vec)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_factorization_failure_detected(prob, layout):
    """A non-SPD problem (negative Q and R) is flagged, not silently
    wrong."""
    bad = dataclasses.replace(prob, Qdiag=-prob.Qdiag, Rdiag=-prob.Rdiag)
    sol = pt.solve(bad, options=pt.SolveOptions(layout=layout))
    assert not bool(diagnostics.factorization_ok(sol.fact).any())
    rep = diagnostics.check_solution(bad, sol.kkt_vector())
    assert int(rep.status) == diagnostics.SolveStatus.FACTORIZATION_FAILED
    with pytest.raises(RuntimeError):
        diagnostics.assert_solution_ok(bad, sol.kkt_vector())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_batched_mixed_status(prob, layout):
    """Instance 1 of 3 poisoned (``Qdiag`` negated): it alone is flagged,
    by the factorization check and by the residual status, as JAX's
    check_solution flags it."""
    batch = pt.batch_problems(prob, 3, torch.Generator().manual_seed(0))
    Q = batch.Qdiag.clone()
    Q[1] = -Q[1]
    batch = dataclasses.replace(batch, Qdiag=Q)
    sol = pt.solve(batch, options=pt.SolveOptions(layout=layout))
    ok = to_numpy(diagnostics.factorization_ok(sol.fact))
    np.testing.assert_array_equal(ok, [True, False, True])
    vec = sol.kkt_vector()
    status = to_numpy(diagnostics.check_solution(batch, vec).status)
    assert status[0] == diagnostics.SolveStatus.OK
    assert status[1] != diagnostics.SolveStatus.OK
    assert status[2] == diagnostics.SolveStatus.OK
    jbatch = rt.LQRProblem(**{k: jnp.asarray(to_numpy(getattr(batch, k)))
                              for k in ("A", "B", "f", "Qdiag", "Rdiag", "q",
                                        "r", "c", "x0")})
    jstatus = np.asarray(jdiag.check_solution(
        jbatch, jnp.asarray(to_numpy(vec))).status)
    np.testing.assert_array_equal(status, jstatus)


def test_factorization_ok_rejects_other_types():
    with pytest.raises(TypeError):
        diagnostics.factorization_ok(object())
