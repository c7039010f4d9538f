"""Port tests: the whole batched slice, ``rslqr_tpu_torch.solve_kkt``,
against ``rslqr_tpu.solve_kkt`` with its XLA stages (``pallas="off"``), on
the same f64 problems (CPU: the port runs its plain kernel versions through
the kernel path's structure).

Tolerance: ``1e-10 * (1 + max|ref|)``, the bar at which JAX's interpret-mode
kernel path already matches its XLA stages (tests/test_pallas_ops.py:
202-233); the two sides differ in summation order only.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.ops import schur

BAR = 1e-10

# The JAX reference, its XLA stages, compiled as one program (op-by-op
# dispatch costs 3-4x more compile time on these shapes).
_jax_ref = jax.jit(lambda p: rt.solve_kkt(p, options=JaxOptions(pallas="off")))


@functools.lru_cache(maxsize=None)
def _case(N: int, B: int):
    """(JAX batch, JAX reference KKT vectors) for one shape; the reference
    does not depend on level pairing, so the two N=16 cases share it."""
    prob = rt.double_integrator_problem(N)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(N), B))
    ref = np.asarray(_jax_ref(batch))
    return batch, ref


@pytest.mark.parametrize(
    "N,B,pairing",
    [
        (16, 8, True),   # fused leaf, one pair (levels 1-2), single level 3
        (32, 8, True),   # depth 5: pair (1,2) then single level 3 (B1)
        (16, 8, False),  # every level single (B1 at levels 1 and 2)
    ],
)
def test_solve_kkt_matches_jax(N, B, pairing):
    batch, ref = _case(N, B)
    tb = pt.problem_from_numpy(batch, device="cpu")
    got = pt.solve_kkt(tb, options=pt.SolveOptions(level_pairing=pairing))
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert rel_err(got.numpy(), ref) < BAR
    # Optimality of every instance (the reference's residual bar).
    assert float(pt.kkt_residual(tb, got).max()) < 1e-9
    # The port's own independent oracle agrees (cross-solver bar 1e-6,
    # tests/test_rslqr.py:143-148; in practice ~1e-15 here).
    ric = pt.solve_riccati(tb).kkt_vector().numpy()
    assert rel_err(got.numpy(), ric) < 1e-6


def test_kernels_off_equals_auto_on_cpu():
    """On CPU tensors ``kernels="auto"`` runs the plain versions, so it is
    bitwise ``kernels="off"``, and no kernel launch is counted."""
    batch, _ = _case(16, 8)
    tb = pt.problem_from_numpy(batch, device="cpu")
    schur.reset_launch_counts()
    a = pt.solve_kkt(tb)
    b = pt.solve_kkt(tb, options=pt.SolveOptions(kernels="off"))
    assert torch.equal(a, b)
    assert sum(schur.launch_counts().values()) == 0


def test_solution_fields_and_factorization():
    """``solve`` returns batch-leading Y/X/U and the em factorization;
    the cached factorization re-solves the same RHS to the same answer."""
    batch, ref = _case(16, 8)
    tb = pt.problem_from_numpy(batch, device="cpu")
    sol = pt.solve(tb)
    assert sol.Y.shape == (8, 16, 6) and sol.U.shape == (8, 15, 3)
    fact = sol.fact
    assert len(fact.Fls) == 4 and len(fact.chols) == 4
    again = pt.solve_rhs_em(tb, fact, pt.leaf_rhs_em(tb))
    assert rel_err(again.kkt_vector().numpy(), ref) < BAR
    assert torch.equal(pt.solve_kkt_em(tb), sol.kkt_vector())


def test_options_validation():
    with pytest.raises(ValueError):
        pt.SolveOptions(kernels="on")
    with pytest.raises(ValueError):
        pt.SolveOptions(factor_dtype="float17")
    with pytest.raises(ValueError):
        pt.SolveOptions(layout="planes")
    # Mid blocks (n <= 64) run the planes path; larger blocks the grid
    # path (the large-block route) under "auto", and the element-major
    # path under layout="em" (the plain plane versions above 64).
    big = pt.double_integrator_problem(2, nstates=130, ninputs=65,
                                       device="cpu")
    sol = pt.solve(big)
    assert isinstance(sol.fact, pt.RsLqrFactorization)
    assert float(pt.kkt_residual(big, sol.kkt_vector())) < 1e-8
    em = pt.solve(big, options=pt.SolveOptions(layout="em"))
    assert isinstance(em.fact, pt.EmFactorization)
    assert float(pt.kkt_residual(big, em.kkt_vector())) < 1e-8
    assert rel_err(em.kkt_vector().numpy(), sol.kkt_vector().numpy()) < 1e-10

