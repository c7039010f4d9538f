"""Port tests: the knot-major grid path (``SolveOptions(layout="grid")``)
and the multi-RHS front door against the JAX package on the same f64
inputs, CPU.

JAX runs with its default ``pallas`` option, so no Pallas kernel runs on
the CPU, with ``layout="grid"`` pinned on both sides. Bars: Y, X, U and
every ``RsLqrFactorization`` field within 1e-9 absolute (the bar of
tests/test_rslqr.py:201), the port's KKT residual below 1e-8, pscan and
refinement within 1e-9 relative (``max|a-b| / (1 + max|b|)``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err, to_numpy

import rslqr_tpu as rt
from rslqr_tpu import pscan as jpscan
from rslqr_tpu import refine as jrefine
from rslqr_tpu import rslqr as jrslqr
from rslqr_tpu import tree as jtree
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import rslqr as prslqr

BAR = 1e-9
JG = JaxOptions(layout="grid")
PG = pt.SolveOptions(layout="grid")
FIELDS = ("Flambda", "Fstate", "Finput", "chol")

# (N, n, m, batch): (6, 3) at N=8 and N=16, single and B=3; (12, 4) at
# N=16 single.
CASES = [(8, 6, 3, 0), (8, 6, 3, 3), (16, 6, 3, 0), (16, 6, 3, 3),
         (16, 12, 4, 0)]


def _problem(N, n, m, B):
    prob = rt.random_problem(jax.random.PRNGKey(N + n), N, n, m, jnp.float64)
    if B:
        prob = rt.batch_problems(
            prob, jax.random.split(jax.random.PRNGKey(7), B))
    return prob


def _perturbed(prob):
    return dataclasses.replace(prob, q=prob.q + 0.5, r=prob.r - 0.25,
                               x0=prob.x0 + 0.1)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "N{}_{}x{}_B{}".format(*c))
def case(request):
    """One case: the JAX problem, its grid solve, and the port's."""
    prob = _problem(*request.param)
    ref = jax.jit(lambda p: jrslqr.solve(p, options=JG))(prob)
    tp = pt.problem_from_numpy(prob, device="cpu")
    return prob, ref, tp, pt.solve(tp, options=PG)


def test_grid_solve_matches_jax(case):
    prob, ref, tp, got = case
    assert isinstance(got.fact, pt.RsLqrFactorization)
    assert got.fact.nbatch == prob.A.ndim - 3
    for k in ("Y", "X", "U"):
        a, b = to_numpy(getattr(got, k)), np.asarray(getattr(ref, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=BAR, err_msg=k)
    for k in FIELDS:
        a, b = to_numpy(getattr(got.fact, k)), np.asarray(getattr(ref.fact, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=BAR, err_msg=k)


def test_grid_kkt_residual(case):
    _, _, tp, got = case
    assert float(pt.kkt_residual(tp, got.kkt_vector()).max()) < 1e-8


@pytest.fixture(scope="module")
def batch8():
    return _problem(8, 6, 3, 3)


def test_multi_rhs_matches_jax_and_fresh_solve(batch8):
    """factorize once, re-solve a perturbed problem (x0 + 0.1, q + 0.5,
    r - 0.25: tests/test_rslqr.py:174-189) through solve_rhs /
    leaf_solve_rhs: against JAX's, and against a fresh grid solve."""
    prob2 = _perturbed(batch8)

    @jax.jit
    def jax_multi(p, p2):
        fact, rhs = jrslqr.factorize(p)
        rhs2 = jrslqr.leaf_solve_rhs(p2)
        return jrslqr.solve_rhs(p2, fact, rhs2), rhs, rhs2

    ref, ref_rhs, ref_rhs2 = jax_multi(batch8, prob2)
    tp = pt.problem_from_numpy(batch8, device="cpu")
    tp2 = pt.problem_from_numpy(prob2, device="cpu")
    fact, rhs = pt.factorize(tp)
    for a, b in zip(rhs + pt.leaf_solve_rhs(tp2), ref_rhs + ref_rhs2):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=0,
                                   atol=BAR)
    got = pt.solve_rhs(tp2, fact, pt.leaf_solve_rhs(tp2))
    assert got.fact is fact
    for k in ("Y", "X", "U"):
        np.testing.assert_allclose(to_numpy(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=BAR, err_msg=k)
    fresh = pt.solve_kkt(tp2, options=PG)
    assert rel_err(to_numpy(got.kkt_vector()), to_numpy(fresh)) < 1e-12
    assert float(pt.kkt_residual(tp2, got.kkt_vector()).max()) < 1e-8


def test_sweep_level_matches_jax_level_by_level():
    """The factor grids after each level of the sweep, N=8, one problem."""
    prob = _problem(8, 6, 3, 0)
    t = jtree.build_tree_tables(8)
    Fl, Fx, Fu, *_ = jrslqr._leaf_solve(prob, t.levels, t.depth)
    jfact = jrslqr.RsLqrFactorization(
        Flambda=Fl, Fstate=Fx, Finput=Fu,
        chol=jnp.zeros((7, 6, 6), jnp.float64), nbatch=0)
    tp = pt.problem_from_numpy(prob, device="cpu")
    tt = pt.build_tree_tables(8)
    pFl, pFx, pFu, *_ = prslqr._leaf_solve(tp, tt.levels, tt.depth)
    pfact = pt.RsLqrFactorization(
        Flambda=pFl, Fstate=pFx, Finput=pFu,
        chol=torch.zeros((7, 6, 6), dtype=torch.float64), nbatch=0)
    for level in range(t.depth):
        jfact = jrslqr._sweep_level(prob, t, level, jfact)
        before = pfact.Flambda.clone()
        pfact = prslqr._sweep_level(tp, tt, level, pfact)
        # The wrapper works on a copy: its input is left as it was.
        assert level == 0 or not torch.equal(before, pfact.Flambda)
        for k in FIELDS:
            np.testing.assert_allclose(
                to_numpy(getattr(pfact, k)), np.asarray(getattr(jfact, k)),
                rtol=0, atol=BAR, err_msg=f"level {level} {k}")


def test_pscan_and_refined_grid_match_jax(batch8):
    """solve_pscan (the batch-last scan) and solve_refined (its grid
    branch: one factorization, every re-solve through _solve_rhs_bl) under
    layout="grid"."""
    tp = pt.problem_from_numpy(batch8, device="cpu")
    ref_ps = jax.jit(lambda p: jpscan.solve_pscan(p, options=JG))(batch8)
    got_ps = pt.solve_pscan(tp, options=PG)
    for k in ("K", "d", "P", "p", "X", "U", "Y"):
        assert rel_err(to_numpy(getattr(got_ps, k)),
                       np.asarray(getattr(ref_ps, k))) < BAR, k
    ref_rf = jax.jit(lambda p: jrefine.solve_refined(
        p, iterations=2, options=JG).kkt_vector())(batch8)
    sol = pt.solve_refined(tp, iterations=2, options=PG)
    assert isinstance(sol.fact, pt.RsLqrFactorization)
    assert sol.fact.Flambda.dtype == torch.float32
    assert rel_err(to_numpy(sol.kkt_vector()), np.asarray(ref_rf)) < BAR
