"""Port tests: the large-block route (a block dim above 64) of ``solve``,
``solve_pscan`` and ``solve_refined`` against the JAX package, f64, CPU.

Case: ``random_problem`` nx=68, nu=4, N=8, as a batch of two and as a
single problem (the batch's first instance). The JAX package solves a
batch of large blocks by vmapping its single-problem solve
(rslqr.py:571-580, pscan.py:1101-1109), which computes each instance as
the single solve does; its reference here is that single solve, run per
instance op by op (for these unrolled panel programs ``jax.jit`` compiles
several times longer than op-by-op dispatch takes). The port runs the
batch as one batched call (the grid path on the mat-last linalg route).
Bars: 1e-9 relative
(``max|a-b| / (1 + max|b|)``); the port's KKT residual below 1e-6
(tests/test_rslqr.py:205-211).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err, to_numpy

import rslqr_tpu as rt
from rslqr_tpu import pscan as jpscan
from rslqr_tpu import refine as jrefine

import rslqr_tpu_torch as pt

BAR = 1e-9
N, NX, NU, B = 8, 68, 4, 2


@pytest.fixture(scope="module")
def problems():
    """The JAX batch and its instances, and the port's batch and single."""
    prob = rt.random_problem(jax.random.PRNGKey(3), N, NX, NU, jnp.float64)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(1), B))
    singles = [jax.tree.map(lambda x, i=i: x[i], batch) for i in range(B)]
    tb = pt.problem_from_numpy(batch, device="cpu")
    return singles, tb, tb.map(lambda x: x[0])


SOLVERS = {
    "rslqr": (lambda p: rt.solve_kkt(p), pt.solve_kkt),
    "pscan": (lambda p: jpscan.solve_pscan_kkt(p), pt.solve_pscan_kkt),
    "refined": (
        lambda p: jrefine.solve_refined(p, iterations=2).kkt_vector(),
        lambda p: pt.solve_refined(p, iterations=2).kkt_vector(),
    ),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_large_block_matches_jax(problems, solver):
    singles, tb, t0 = problems
    jax_fn, port_fn = SOLVERS[solver]
    ref = np.stack([np.asarray(jax_fn(p)) for p in singles])
    got = to_numpy(port_fn(tb))
    assert got.shape == ref.shape
    assert rel_err(got, ref) < BAR
    one = to_numpy(port_fn(t0))
    assert one.shape == ref.shape[1:]
    assert rel_err(one, ref[0]) < BAR
    assert float(pt.kkt_residual(tb, port_fn(tb)).max()) < 1e-6


def test_large_block_solve_takes_the_grid_path(problems):
    """``"auto"`` sends blocks above 64 to the grid path, the whole batch
    in one factorization with one trailing batch axis."""
    _, tb, _ = problems
    sol = pt.solve(tb)
    assert isinstance(sol.fact, pt.RsLqrFactorization)
    assert sol.fact.nbatch == 1
    assert tuple(sol.fact.chol.shape) == (N - 1, NX, NX, B)
