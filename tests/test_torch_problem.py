"""Port tests: tree tables, problem helpers, small-block linalg and the
Riccati oracle of ``rslqr_tpu_torch`` against ``rslqr_tpu`` (CPU, f64).

The same numbers go to both packages: problems are built with
``rslqr_tpu.problem`` and carried over by ``problem_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err, to_numpy

import rslqr_tpu as rt
from rslqr_tpu import linalg as jla
from rslqr_tpu import tree as jtree

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import linalg as tla
from rslqr_tpu_torch import tree as ttree
from rslqr_tpu_torch.ops import schur
from rslqr_tpu_torch.rslqr import _lambda_mask


def _batch(N, B, seed=0):
    prob = rt.double_integrator_problem(N)
    return rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(seed), B))


@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 64])
def test_tree_tables_match_jax(N):
    """Integer tables: exact equality."""
    a, b = ttree.build_tree_tables(N), jtree.build_tree_tables(N)
    assert a.nhorizon == b.nhorizon and a.depth == b.depth
    np.testing.assert_array_equal(a.levels, b.levels)
    assert len(a.leaf_index) == len(b.leaf_index)
    for x, y in zip(a.leaf_index, b.leaf_index):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.sep_index, b.sep_index)
    np.testing.assert_array_equal(a.calc_lambda, b.calc_lambda)
    for i in range(N - 1):
        assert ttree.index_level(i) == jtree.index_level(i)
    for k in range(N):
        for L in range(a.depth):
            assert ttree.index_at_level(k, L, N) == jtree.index_at_level(
                k, L, N)


def test_tree_rejects_bad_horizons():
    for N in (0, 1, 3, 12):
        with pytest.raises(ValueError):
            ttree.build_tree_tables(N)


@pytest.mark.parametrize("N", [8, 32])
def test_kernel_masks_match_calc_lambda(N):
    """The kernels' per-knot lambda mask is the tree's calc_lambda column
    and rslqr._lambda_mask; the separator rows are knot % span == 2^L."""
    t = ttree.build_tree_tables(N)
    for L in range(t.depth):
        keep, sep = schur._masks(L, N, "cpu")
        span = 2 << L
        np.testing.assert_array_equal(keep[:, 0].numpy(), t.calc_lambda[:, L])
        np.testing.assert_array_equal(
            keep[:, 0].numpy(),
            _lambda_mask(N, span, span // 2).reshape(-1),
        )
        np.testing.assert_array_equal(
            np.nonzero(sep[:, 0].numpy())[0], np.arange(span // 2, N, span)
        )


def test_problem_from_numpy_round_trip():
    """Carrying a JAX problem over is exact, and back again."""
    batch = _batch(16, 4)
    tb = pt.problem_from_numpy(batch, device="cpu")
    for name in ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0"):
        src = np.asarray(getattr(batch, name))
        got = getattr(tb, name)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), src)
    again = pt.problem_from_numpy({k: getattr(tb, k).numpy() for k in (
        "A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")}, device="cpu")
    np.testing.assert_array_equal(again.A.numpy(), tb.A.numpy())
    assert tb.nvars == batch.nvars and tb.batch_shape == (4,)


def test_double_integrator_matches_jax():
    a = pt.double_integrator_problem(32, device="cpu")
    b = rt.double_integrator_problem(32)
    for name in ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0"):
        np.testing.assert_array_equal(
            getattr(a, name).numpy(), np.asarray(getattr(b, name))
        )
    f32 = pt.double_integrator_problem(8, dtype=torch.float32, device="cpu")
    assert f32.A.dtype == torch.float32


def test_batch_problems_from_generator():
    """Same seed, same batch; only x0, q, r are perturbed."""
    prob = pt.double_integrator_problem(8, device="cpu")
    b1 = pt.batch_problems(prob, 5, torch.Generator().manual_seed(7))
    b2 = pt.batch_problems(prob, 5, torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(b1.q.numpy(), b2.q.numpy())
    assert b1.A.shape == (5, 8, 6, 6) and b1.x0.shape == (5, 6)
    np.testing.assert_array_equal(b1.A[3].numpy(), prob.A.numpy())
    assert (b1.q[0] - prob.q).abs().max() > 0
    one = pt.perturb_problem(prob, torch.Generator().manual_seed(1))
    assert one.q.shape == prob.q.shape
    rnd = pt.random_problem(torch.Generator().manual_seed(2), 16, 6, 3,
                           device="cpu")
    rnd.validate()
    assert rnd.A.dtype == torch.float32


def test_builders_default_to_the_card():
    """Without ``device`` the builders put the problem on the card; where
    there is none they raise instead of falling back to the CPU."""
    arrays = {k: np.asarray(getattr(rt.double_integrator_problem(4), k))
              for k in ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")}
    builders = [
        lambda: pt.double_integrator_problem(4),
        lambda: pt.random_problem(torch.Generator().manual_seed(0), 4, 6, 3),
        lambda: pt.problem_from_numpy(arrays),
        lambda: pt.problem_from_arrays(*arrays.values()),
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert build().A.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    # batch_problems follows the problem it is given.
    prob = pt.double_integrator_problem(4, device="cpu")
    b = pt.batch_problems(prob, 2, torch.Generator().manual_seed(0))
    assert b.A.device.type == "cpu"


def test_pack_unpack_match_jax():
    """Pure data movement: exact."""
    rng = np.random.default_rng(0)
    prob = rt.double_integrator_problem(16)
    tp = pt.problem_from_numpy(prob, device="cpu")
    vec = rng.standard_normal((3, prob.nvars))
    Yj, Xj, Uj = rt.unpack_solution(prob, jnp.asarray(vec))
    Yt, Xt, Ut = pt.unpack_solution(tp, torch.as_tensor(vec))
    for a, b in ((Yt, Yj), (Xt, Xj), (Ut, Uj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        pt.pack_solution(Yt, Xt, Ut).numpy(), vec
    )


def test_kkt_residual_and_objective_match_jax():
    """Same formulas, f64: atol 1e-12 (summation order only)."""
    rng = np.random.default_rng(1)
    batch = _batch(16, 3)
    tb = pt.problem_from_numpy(batch, device="cpu")
    vec = rng.standard_normal((3, batch.nvars))
    got = pt.kkt_residual(tb, torch.as_tensor(vec)).numpy()
    ref = np.array([
        float(rt.kkt_residual(
            jax.tree.map(lambda x: x[i], batch), jnp.asarray(vec[i])
        ))
        for i in range(3)
    ])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    Y, X, U = pt.unpack_solution(tb, torch.as_tensor(vec))
    obj = pt.objective(tb, X, U).numpy()
    p0 = jax.tree.map(lambda x: x[0], batch)
    ref_obj = float(rt.objective(p0, jnp.asarray(X[0].numpy()),
                                 jnp.asarray(U[0].numpy())))
    np.testing.assert_allclose(obj[0], ref_obj, rtol=1e-12, atol=1e-12)


def test_small_block_linalg_matches_jax():
    """Unrolled Cholesky / substitutions / products on [n, n, G, B] blocks
    with two trailing batch axes (the em path's contract), f64: 1e-12."""
    rng = np.random.default_rng(2)
    n, G, B = 6, 4, 5
    M = rng.standard_normal((G, B, n, n))
    spd = np.moveaxis(M @ np.swapaxes(M, -1, -2) + n * np.eye(n), (0, 1),
                      (2, 3))
    rhs = rng.standard_normal((n, 9, G, B))
    L_t = tla.bcholesky(torch.as_tensor(spd), 2)
    L_j = jla.bcholesky(jnp.asarray(spd), 2)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), atol=1e-12)
    X_t = tla.bcho_solve(L_t, torch.as_tensor(rhs), 2)
    X_j = jla.bcho_solve(L_j, jnp.asarray(rhs), 2)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), atol=1e-12)
    v = rng.standard_normal((n, G, B))
    np.testing.assert_allclose(
        tla.bcho_solve_vec(L_t, torch.as_tensor(v), 2).numpy(),
        np.asarray(jla.bcho_solve_vec(L_j, jnp.asarray(v), 2)), atol=1e-12,
    )
    np.testing.assert_allclose(
        tla.bgemm(torch.as_tensor(spd), torch.as_tensor(rhs), 2).numpy(),
        np.asarray(jla.bgemm(jnp.asarray(spd), jnp.asarray(rhs), 2)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        tla.bgemv(torch.as_tensor(spd), torch.as_tensor(v), 2).numpy(),
        np.asarray(jla.bgemv(jnp.asarray(spd), jnp.asarray(v), 2)),
        atol=1e-12,
    )
    np.testing.assert_array_equal(
        tla.transpose_block(torch.as_tensor(rhs), 2).numpy(),
        np.asarray(jla.transpose_block(jnp.asarray(rhs), 2)),
    )


def test_riccati_matches_jax():
    """The port's Riccati oracle vs JAX's, f64: the reference's 1e-10 bar
    (test/riccati_solver_test.c:343)."""
    prob = rt.random_problem(jax.random.PRNGKey(4), 16, 6, 3, jnp.float64)
    ref = rt.solve_riccati(prob)
    got = pt.solve_riccati(pt.problem_from_numpy(prob, device="cpu"))
    for name in ("K", "d", "P", "p", "X", "U", "Y"):
        assert rel_err(to_numpy(getattr(got, name)),
                       np.asarray(getattr(ref, name))) < 1e-10, name
