"""Port tests: the mid-block slice (threshold < n <= 64, the quadruped
regime) of ``rslqr_tpu_torch.solve_kkt`` against ``rslqr_tpu.solve_kkt``
on its element-major path with the planes kernels in interpret mode
(``layout="em", pallas="interpret"``), on the same f64 problem: the
``mid_batch`` of tests/test_planes_ops.py (nx=12, nu=4, N=16, 128
perturbed instances). On CPU the port runs the plain versions of its four
plane kernels through the kernel path's structure.

Tolerance: ``1e-10 * (1 + max|ref|)``, as tests/test_torch_rslqr.py: the
two sides differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu import rslqr
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.ops import planes, schur

BAR = 1e-10


@pytest.fixture(scope="module")
def case():
    """(the port's problem batch, the JAX reference KKT vectors); the
    reference is compiled once per module."""
    prob = rt.random_problem(jax.random.PRNGKey(0), 16, 12, 4, jnp.float64)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(1),
                                                     128))
    ref = jax.jit(lambda p: rslqr.solve_kkt(
        p, options=JaxOptions(layout="em", pallas="interpret")))(batch)
    return pt.problem_from_numpy(batch, device="cpu"), np.asarray(ref)


def test_midblock_solve_kkt_matches_jax(case):
    tb, ref = case
    got = pt.solve_kkt(tb)
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert rel_err(got.numpy(), ref) < BAR


def test_midblock_kkt_residual(case):
    tb, _ = case
    got = pt.solve_kkt(tb)
    assert float(pt.kkt_residual(tb, got).max()) < 1e-9


def test_midblock_matches_riccati(case):
    """The port's own independent oracle (cross-solver bar 1e-6,
    tests/test_rslqr.py:143-148)."""
    tb, _ = case
    got = pt.solve_kkt(tb).numpy()
    ric = pt.solve_riccati(tb).kkt_vector().numpy()
    assert rel_err(got, ric) < 1e-6


def test_midblock_cached_factor_resolve(case):
    """The factorization re-solves a fresh leaf RHS to the same answer;
    its shape is the mid-block path's (single levels, one Cholesky factor
    per level)."""
    tb, ref = case
    sol = pt.solve(tb)
    fact = sol.fact
    assert len(fact.Fls) == 4 and len(fact.chols) == 4
    assert fact.Fls[0].shape == (12, 12, 16, 128)
    assert fact.Fus[0].shape == (4, 12, 16, 128)
    again = pt.solve_rhs_em(tb, fact, pt.leaf_rhs_em(tb))
    assert rel_err(again.kkt_vector().numpy(), ref) < BAR


def test_midblock_runs_no_small_block_kernel(case):
    """On CPU tensors no launch is counted, ``kernels="auto"`` is bitwise
    ``kernels="off"``, and the path never reaches the small-block Schur
    kernels' wrappers, whose CUDA kernels take only (n, m) = (6, 3)."""
    tb, _ = case
    calls = []
    wrapped = {}
    for name in ("schur_update_level_em", "schur_update_pair_em",
                 "leaf_schur_level0_em", "rhs_update_level_em"):
        wrapped[name] = getattr(schur, name)
        setattr(schur, name, lambda *a, _n=name, **k: calls.append(_n))
    try:
        planes.reset_launch_counts()
        a = pt.solve_kkt(tb)
        b = pt.solve_kkt(tb, options=pt.SolveOptions(kernels="off"))
    finally:
        for name, fn in wrapped.items():
            setattr(schur, name, fn)
    assert calls == []
    assert torch.equal(a, b)
    assert sum(planes.launch_counts().values()) == 0


def test_riccati_oracle_stays_symmetric_on_unstable_dynamics():
    """On the quadruped config's random dynamics (A = I + 0.1 randn,
    spectral radius ~1.6) the reference Riccati update leaves a rounding
    antisymmetric part in P that grows every step: at N=512 JAX's oracle
    returns NaN. The port keeps P symmetric, so its oracle agrees with the
    f64 tree solve there (ROADMAP C3); at N=16, where JAX's antisymmetric
    part is still ~1e-13, the two oracles agree at the reference's 1e-10."""
    for N, jax_ok in ((16, True), (512, False)):
        prob = rt.random_problem(jax.random.PRNGKey(1), N, 36, 12,
                                 jnp.float64)
        jric = rt.solve_riccati(prob)
        assert bool(jnp.isfinite(jric.P).all()) == jax_ok
        tp = pt.problem_from_numpy(prob, device="cpu")
        ric = pt.solve_riccati(tp).kkt_vector().numpy()
        if jax_ok:
            ref = np.asarray(rt.pack_solution(jric.Y, jric.X, jric.U))
            assert rel_err(ric, ref) < BAR
        else:
            tree = pt.solve_kkt(tp, options=pt.SolveOptions(kernels="off"))
            assert rel_err(ric, tree.numpy()) < 1e-6
