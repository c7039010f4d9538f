"""Port tests: linalg's mat-last route (a block dim above 64, or a mid block
with leading grid dims) against ``rslqr_tpu.linalg``, f64, CPU.

Mirrors tests/test_linalg.py's cases at n=72 (above 64) and at n=36 with
leading grid dims (the knot-major grid path's operands), with and without
a trailing batch axis. The JAX package runs its blocked panel algorithms
there (linalg.py:797-1182); the port one ``torch.matmul`` /
``torch.linalg`` call on mat-last views. Bars: 1e-9 absolute against JAX
(entries O(1)-O(10)), 1e-8 for the round trips (test_linalg.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

from rslqr_tpu import linalg as jla

from rslqr_tpu_torch import linalg as la

BAR = 1e-9
SIZES = [36, 72]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _both(x):
    """The same numbers as a JAX array and a torch tensor."""
    return jnp.asarray(x), torch.as_tensor(x)


def _spd(seed, n, nbatch):
    """``[3, n, n, *b]`` SPD blocks ``M M' + n I``."""
    b = (4,) * nbatch
    M = _rand(seed, (3, n, n) + b)
    A = np.einsum("gij...,gkj...->gik...", M, M)
    return A + n * np.eye(n).reshape((1, n, n) + (1,) * nbatch)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nbatch", [0, 1])
def test_bgemm(n, nbatch):
    b = (5,) * nbatch
    A, B = _rand(n, (4, n, n) + b), _rand(n + 1, (4, n, n - 1) + b)
    out = to_numpy(la.bgemm(*(torch.as_tensor(x) for x in (A, B)), nbatch))
    ref = np.einsum("gij...,gjk...->gik...", A, B)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    jref = np.asarray(jla.bgemm(jnp.asarray(A), jnp.asarray(B), nbatch))
    np.testing.assert_allclose(out, jref, rtol=0, atol=BAR)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("a_lead,b_lead", [((1, 4), (2, 4)),
                                           ((4, 2), (4, 1))])
def test_bgemm_broadcast_leading(n, a_lead, b_lead):
    """Leading dims broadcast either way: A's size-1 dim expands; B's
    (the Schur updates' one multiplier per group) folds into A's rows."""
    A, B = _rand(n, a_lead + (n, n, 3)), _rand(n + 1, b_lead + (n, n, 3))
    out = to_numpy(la.bgemm(torch.as_tensor(A), torch.as_tensor(B), 1))
    lead = tuple(max(x, y) for x, y in zip(a_lead, b_lead))
    assert out.shape == lead + (n, n, 3)
    ref = np.einsum("ugijb,ugjkb->ugikb",
                    np.broadcast_to(A, lead + (n, n, 3)),
                    np.broadcast_to(B, lead + (n, n, 3)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    jref = np.asarray(jla.bgemm(jnp.asarray(A), jnp.asarray(B), 1))
    np.testing.assert_allclose(out, jref, rtol=0, atol=BAR)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nbatch", [0, 1])
def test_bcholesky_and_solve(n, nbatch):
    A = _spd(n + 100, n, nbatch)
    jA, tA = _both(A)
    L = la.bcholesky(tA, nbatch)
    np.testing.assert_allclose(to_numpy(L),
                               np.asarray(jla.bcholesky(jA, nbatch)),
                               rtol=0, atol=BAR)
    rec = la.bgemm(L, la.transpose_block(L, nbatch), nbatch)
    np.testing.assert_allclose(to_numpy(rec), A, rtol=0, atol=1e-8)
    X = _rand(n + 2, (3, n, 2) + (4,) * nbatch)
    Bm = np.einsum("gij...,gjk...->gik...", A, X)
    Xs = la.bcho_solve(L, torch.as_tensor(Bm), nbatch)
    np.testing.assert_allclose(to_numpy(Xs), X, rtol=0, atol=1e-8)
    jXs = jla.bcho_solve(jla.bcholesky(jA, nbatch), jnp.asarray(Bm), nbatch)
    np.testing.assert_allclose(to_numpy(Xs), np.asarray(jXs), rtol=0,
                               atol=BAR)


@pytest.mark.parametrize("n", SIZES)
def test_btrsm_lower_and_transposed(n):
    """The two substitutions of the blocked TRSM case
    (test_linalg.py:207-244) on batch-last blocks with a grid dim."""
    L = np.linalg.cholesky(np.moveaxis(_spd(n + 300, n, 1), -1, 1))
    L = np.moveaxis(L, 1, -1)  # [3, n, n, 4]
    Bm = _rand(n + 301, (3, n, 20, 4))
    (jL, tL), (jB, tB) = _both(L), _both(Bm)
    X = to_numpy(la.btrsm_lower(tL, tB, 1))
    np.testing.assert_allclose(np.einsum("gijb,gjwb->giwb", L, X), Bm,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(X, np.asarray(jla.btrsm_lower(jL, jB, 1)),
                               rtol=0, atol=BAR)
    Xt = to_numpy(la.btrsm_lower_t(tL, tB, 1))
    np.testing.assert_allclose(np.einsum("gjib,gjwb->giwb", L, Xt), Bm,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xt, np.asarray(jla.btrsm_lower_t(jL, jB, 1)),
                               rtol=0, atol=BAR)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nbatch", [0, 1])
def test_bsolve_general(n, nbatch):
    b = (4,) * nbatch
    A = _rand(n + 200, (3, n, n) + b) + 2 * n * np.eye(n).reshape(
        (1, n, n) + (1,) * nbatch)
    X = _rand(n + 201, (3, n, 2) + b)
    Bm = np.einsum("gij...,gjk...->gik...", A, X)
    (jA, tA), (jB, tB) = _both(A), _both(Bm)
    Xs = to_numpy(la.bsolve(tA, tB, nbatch))
    np.testing.assert_allclose(Xs, X, rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xs, np.asarray(jla.bsolve(jA, jB, nbatch)),
                               rtol=0, atol=BAR)


@pytest.mark.parametrize("n", [2] + SIZES)
def test_bsolve_needs_pivoting(n):
    """A zero at (0, 0) forces a row swap (test_linalg.py:75-81): a reversal
    permutation, with a grid dim. The small-block route pivots as JAX's
    does (n=2, held against it); the mat-last route is a pivoted LU solve
    (JAX's large route is an unpivoted blocked LU, which this block
    defeats, so n=36, 72 are held to the exact answer only)."""
    A = np.broadcast_to(np.eye(n)[::-1][None, :, :, None], (2, n, n, 1))
    X = _rand(n, (2, n, 1, 1))
    Bm = np.einsum("gijb,gjkb->gikb", A, X)
    Xs = to_numpy(la.bsolve(torch.as_tensor(A.copy()), torch.as_tensor(Bm),
                            1))
    np.testing.assert_allclose(Xs, X, rtol=0, atol=1e-12)
    if n == 2:
        jXs = jla.bsolve(jnp.asarray(A), jnp.asarray(Bm), 1)
        np.testing.assert_allclose(Xs, np.asarray(jXs), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 6])
@pytest.mark.parametrize("nbatch", [0, 1])
def test_blu_solve_t(n, nbatch):
    """``A' X = B`` from the unpivoted LU (test_linalg.py:97-124), with a
    grid dim."""
    b = (4,) * nbatch
    A = _rand(n + 300, (3, n, n) + b) + 2 * n * np.eye(n).reshape(
        (1, n, n) + (1,) * nbatch)
    X = _rand(n + 301, (3, n, 2) + b)
    Bt = np.einsum("gji...,gjk...->gik...", A, X)
    LU, dinv = la.blu_factor(torch.as_tensor(A), nbatch)
    Xs = to_numpy(la.blu_solve_t(LU, dinv, torch.as_tensor(Bt), nbatch))
    np.testing.assert_allclose(Xs, X, rtol=0, atol=1e-8)
    jLU, jdinv = jla.blu_factor(jnp.asarray(A), nbatch)
    jXs = jla.blu_solve_t(jLU, jdinv, jnp.asarray(Bt), nbatch)
    np.testing.assert_allclose(Xs, np.asarray(jXs), rtol=0, atol=BAR)


def test_normed_difference():
    A, B = _rand(0, (3, 72, 72, 2)), _rand(1, (3, 72, 72, 2))
    got = float(la.normed_difference(torch.as_tensor(A), torch.as_tensor(B)))
    ref = float(jla.normed_difference(jnp.asarray(A), jnp.asarray(B)))
    assert abs(got - ref) <= 1e-12 * ref
    assert abs(got - np.linalg.norm((A - B).ravel())) <= 1e-12 * ref


@pytest.mark.parametrize("n", SIZES)
def test_non_spd_block_gives_nan(n):
    """A block that is not SPD: its factor has NaN in both packages (the
    port's is NaN in every entry), the other blocks' factors agree."""
    A = _spd(n + 400, n, 1)
    A[1, :, :, 2] *= -1.0
    L = to_numpy(la.bcholesky(torch.as_tensor(A), 1))
    jL = np.asarray(jla.bcholesky(jnp.asarray(A), 1))
    assert np.isnan(L[1, :, :, 2]).all()
    assert np.isnan(jL[1, :, :, 2]).any()
    good = np.ones((3, 4), bool)
    good[1, 2] = False
    np.testing.assert_allclose(np.moveaxis(L, -1, 1)[good],
                               np.moveaxis(jL, -1, 1)[good], rtol=0,
                               atol=BAR)
