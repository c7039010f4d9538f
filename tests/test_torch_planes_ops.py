"""Port tests: the plain PyTorch versions of the four mid-block plane
kernels (``rslqr_tpu_torch/ops/planes.py``) against the JAX Pallas kernels
of ``rslqr_tpu/ops/planes_pallas.py`` run in interpret mode, on the same
random f64 inputs (interpret mode as tests/test_planes_ops.py runs it).

Tolerance: ``1e-10 * (1 + max|ref|)``. Both sides compute the same sums in
f64, in another order.

The JAX kernels take flattened ``(F//128, 128)`` planes; the port takes the
natural ``[., ., N, B]`` / ``[., ., G, B]`` planes. The same numbers go to
both: a plane of ``F = 1024`` elements is ``(8, 128)`` on the JAX side.
``schur3_update_planes`` gets the compact solved separators ``[n, q, G, B]``
in the port and their broadcast over each group's knots on the JAX side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

from rslqr_tpu.ops import planes_pallas as jp

from rslqr_tpu_torch import linalg as tla
from rslqr_tpu_torch.ops import planes

BAR = 1e-10
N, B = 16, 64           # slab planes: N knots x B batch columns = 1024
P1, P2 = 8, 128         # the same 1024 plane elements, JAX's tile shape


def _jflat(x: np.ndarray) -> jnp.ndarray:
    """``[p, q, *plane]`` with 1024 plane elements -> JAX's ``[p, q, 8,
    128]``."""
    return jnp.asarray(x.reshape(x.shape[0], x.shape[1], P1, P2))


def _spd(rng, n: int, plane) -> np.ndarray:
    """Random SPD blocks ``[n, n, *plane]``."""
    M = rng.standard_normal(plane + (n, n))
    S = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    return np.moveaxis(S, (-2, -1), (0, 1)).copy()


@pytest.mark.parametrize("p,K,q", [(12, 12, 12), (12, 4, 12), (36, 36, 36),
                                   (36, 12, 36)])
def test_pgemm_plain_matches_pallas(p, K, q):
    rng = np.random.default_rng(p + K)
    A = rng.standard_normal((p, K, N, B))
    Bm = rng.standard_normal((K, q, N, B))
    want = np.asarray(jp.pgemm(_jflat(A), _jflat(Bm), interpret=True))
    got = planes.pgemm(torch.as_tensor(A), torch.as_tensor(Bm))
    assert got.shape == (p, q, N, B)
    assert rel_err(got.numpy().reshape(want.shape), want) < BAR


def test_pchol_plain_matches_pallas():
    """The whole array, the zero upper triangle included."""
    n = 12
    A = _spd(np.random.default_rng(1), n, (N, B))
    want = np.asarray(jp.pchol(_jflat(A), interpret=True))
    got = planes.pchol(torch.as_tensor(A)).numpy().reshape(want.shape)
    assert rel_err(got, want) < BAR
    iu = np.triu_indices(n, 1)
    assert not got[iu].any() and not want[iu].any()


@pytest.mark.parametrize("w", [12, 1])
def test_pcho_solve_plain_matches_pallas(w):
    """w = n (the factor sweep's separator solves) and w = 1 (the RHS
    sweep's)."""
    n = 12
    rng = np.random.default_rng(2 + w)
    L = np.asarray(jp.pchol(_jflat(_spd(rng, n, (N, B))), interpret=True))
    L = L.reshape(n, n, N, B).copy()
    Bm = rng.standard_normal((n, w, N, B))
    want = np.asarray(jp.pcho_solve(_jflat(L), _jflat(Bm), interpret=True))
    Bt = torch.as_tensor(Bm.copy())
    got = planes.pcho_solve(torch.as_tensor(L), Bt)
    assert got is Bt  # solved in place
    assert rel_err(got.numpy().reshape(want.shape), want) < BAR


@pytest.mark.parametrize("q", [12, 1])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_schur3_update_planes_plain_matches_pallas(level, q):
    """Levels 0-2 (dense and sparse lambda masks, separator overwrite) for
    the factor sweep (q = n) and the RHS sweep (q = 1)."""
    n, m = 12, 4
    G = N >> (level + 1)
    span = N // G
    rng = np.random.default_rng(10 * level + q)
    FLl = rng.standard_normal((n, n, N, B))
    FLx = rng.standard_normal((n, n, N, B))
    FLu = rng.standard_normal((m, n, N, B))
    fsol = rng.standard_normal((n, q, G, B))
    Cl = rng.standard_normal((n, q, N, B))
    Cx = rng.standard_normal((n, q, N, B))
    Cu = rng.standard_normal((m, q, N, B))
    fs_full = np.broadcast_to(
        fsol[:, :, :, None], (n, q, G, span, B)
    ).reshape(n, q, N, B)
    want = jp.schur3_update_planes(
        _jflat(FLl), _jflat(FLx), _jflat(FLu), _jflat(fs_full),
        _jflat(Cl), _jflat(Cx), _jflat(Cu),
        level=level, logb=B.bit_length() - 1, interpret=True,
    )
    t = lambda x: torch.as_tensor(x.copy())
    Cs = (t(Cl), t(Cx), t(Cu))
    got = planes.schur3_update_planes(
        t(FLl), t(FLx), t(FLu), t(fsol), *Cs, level=level
    )
    for g, c, w in zip(got, Cs, want):
        assert g is c  # updated in place
        w = np.asarray(w)
        assert rel_err(g.numpy().reshape(w.shape), w) < BAR


def test_linalg_mid_block_dispatch():
    """``linalg`` sends contractions / factors above the threshold to the
    planes wrappers and keeps small contractions on the broadcast route;
    blocks above 64 take the mat-last route (``torch.linalg``)."""
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((12, 12, 4, 8)))
    Bs = torch.as_tensor(rng.standard_normal((12, 4, 4, 8)))
    Bsmall = torch.as_tensor(rng.standard_normal((4, 12, 4, 8)))
    Asmall = torch.as_tensor(rng.standard_normal((12, 4, 4, 8)))
    ref = lambda a, b: torch.einsum("ikgb,kjgb->ijgb", a, b)
    assert torch.allclose(tla.bgemm(A, Bs, 2), ref(A, Bs), atol=1e-12)
    assert torch.allclose(tla.bgemm(Asmall, Bsmall, 2), ref(Asmall, Bsmall),
                          atol=1e-12)
    S = torch.as_tensor(_spd(rng, 12, (4, 8)))
    L = tla.bcholesky(S, 2)
    assert torch.allclose(ref(L, L.transpose(0, 1)), S, atol=1e-10)
    x = torch.as_tensor(rng.standard_normal((12, 4, 8)))
    x0 = x.clone()
    y = tla.bcho_solve_vec(L, x, 2)
    assert torch.equal(x, x0)  # the right-hand side is left as it is
    assert torch.allclose(tla.bgemv(S, y, 2), x, atol=1e-10)
    big = torch.as_tensor(_spd(rng, 65, (2, 2)))
    Lbig = tla.bcholesky(big, 2)
    ref_big = torch.linalg.cholesky(big.permute(2, 3, 0, 1))
    assert torch.allclose(Lbig.permute(2, 3, 0, 1), ref_big, atol=1e-12)


@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("transposed", [False, True])
def test_linalg_bcho_solve_leaves_rhs(n, transposed):
    """``linalg.bcho_solve`` returns a new tensor and leaves its right-hand
    side as it is on the small- and the mid-block route, contiguous or
    not; only ``planes.pcho_solve`` solves in place."""
    rng = np.random.default_rng(6 + n)
    S = torch.as_tensor(_spd(rng, n, (4, 8)))
    L = tla.bcholesky(S, 2)
    Bm = torch.as_tensor(rng.standard_normal((n, n, 4, 8)))
    if transposed:
        Bm = Bm.transpose(0, 1)
    B0 = Bm.clone()
    X = tla.bcho_solve(L, Bm, 2)
    assert torch.equal(Bm, B0)
    assert X.data_ptr() != Bm.data_ptr()
    prod = torch.einsum("ikgb,kjgb->ijgb", S, X)
    assert torch.allclose(prod, B0, atol=1e-10)


def test_wrappers_dispatch_by_device():
    """CPU tensors run the plain versions (no launch counted); a device
    with no kernel raises instead of falling back."""
    planes.reset_launch_counts()
    A = torch.ones((3, 3, 2, 2), dtype=torch.float64)
    planes.pgemm(A, A)
    planes.pgemm(A, A, kernels="off")
    assert planes.launch_counts() == {
        "pgemm": 0, "pchol": 0, "pcho_solve": 0, "schur3_update_planes": 0,
        "schur_update_planes": 0, "plu_solve_multi": 0, "pgemm_flagged": 0,
    }
    meta = torch.empty(A.shape, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        planes.pgemm(meta, meta)
    with pytest.raises(ValueError, match="kernel mode"):
        planes.pchol(A, kernels="on")
