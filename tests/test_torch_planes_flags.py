"""Port tests: the plain PyTorch versions of the parallel scan's plane
kernels (``rslqr_tpu_torch/ops/planes.py``: ``pgemm`` with B5's flags,
``schur_update_planes``, ``plu_solve_multi``) against the JAX Pallas
kernels of ``rslqr_tpu/ops/planes_pallas.py`` (``_pgemm_call``,
``schur_update_planes``, ``plu_solve_multi``) run in interpret mode, on the
same random f64 inputs; and the pin that the scan's combines overwrite
none of their operands.

Tolerance: ``1e-10 * (1 + max|ref|)`` (the same sums in f64, in another
order). The JAX kernels take ``(8, 128)`` planes, the port the natural
``[N, B] = [16, 64]`` planes of the same 1024 elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

from rslqr_tpu.ops import planes_pallas as jp

from rslqr_tpu_torch import linalg as tla
from rslqr_tpu_torch import pscan as tps
from rslqr_tpu_torch.config import SolveOptions
from rslqr_tpu_torch.ops import planes

BAR = 1e-10
N, B = 16, 64           # port planes: N knots x B batch columns = 1024
P1, P2 = 8, 128         # the same 1024 plane elements, JAX's tile shape


def _j(x: np.ndarray) -> jnp.ndarray:
    """``[d0(, d1), *plane]`` with 1024 plane elements -> JAX's ``[d0(, d1),
    8, 128]``."""
    lead = x.shape[:-2]
    return jnp.asarray(x.reshape(lead + (P1, P2)))


def _t(x):
    return None if x is None else torch.as_tensor(x.copy())


# (p, K, q, flags): each flag alone, then the pscan call sites' combinations
# (pscan.py: Sm, IC, Vt, C, J of the leaf and generic combines, Quu). The
# block dims are small and unequal (5 x 3 . 3 x 5 and the like), which
# catches a swapped index as well as n=36 would and keeps the interpret-mode
# compiles short; the CUDA tests run the same flags at the path's dims.
FLAG_CASES = [
    (5, 3, 4, dict(ta=True)),
    (5, 3, 4, dict(tbt=True)),
    (5, 3, 4, dict(cin=True)),
    (5, 3, 4, dict(cin=True, sub=False)),
    (5, 3, 5, dict(diag=True)),
    (5, 3, 5, dict(dconst=1.0)),
    (5, 3, 5, dict(sym=True)),
    (5, 3, 4, dict(ks=True)),
    (3, 5, 3, dict(dconst=1.0)),
    (3, 5, 5, dict(tbt=True)),
    (5, 3, 5, dict(cin=True, sub=False, sym=True)),
    (5, 5, 5, dict(ta=True, diag=True, sym=True)),
    (5, 5, 5, dict(ta=True, ks=True, diag=True, sym=True)),
    (5, 5, 5, dict(tbt=True, cin=True, sub=False, sym=True)),
    (3, 5, 3, dict(diag=True, sym=True)),
]


@pytest.mark.parametrize("p,K,q,flags", FLAG_CASES)
def test_pgemm_flags_plain_matches_pallas(p, K, q, flags):
    rng = np.random.default_rng(p + 3 * K + 7 * len(flags))
    A = rng.standard_normal(((K, p) if flags.get("ta") else (p, K)) + (N, B))
    Bm = rng.standard_normal(((q, K) if flags.get("tbt") else (K, q)) + (N, B))
    Cin = rng.standard_normal((p, q, N, B)) if flags.get("cin") else None
    diag = rng.standard_normal((p, N, B)) if flags.get("diag") else None
    ks = rng.standard_normal((K, N, B)) if flags.get("ks") else None
    kw = dict(ta=flags.get("ta", False), tbt=flags.get("tbt", False),
              sub=flags.get("sub", True), dconst=flags.get("dconst", 0.0),
              sym=flags.get("sym", False))
    want = np.asarray(jp._pgemm_call(
        _j(A), _j(Bm), None if Cin is None else _j(Cin),
        None if diag is None else _j(diag), None if ks is None else _j(ks),
        interpret=True, **kw,
    ))
    got = planes.pgemm(_t(A), _t(Bm), _t(Cin), _t(diag), _t(ks), **kw)
    assert got.shape == (p, q, N, B)
    assert rel_err(got.numpy().reshape(want.shape), want) < BAR
    if Cin is not None and not (diag is not None or ks is not None
                                or kw["dconst"] or kw["sym"]):
        acc = planes.pgemm_acc(_t(A), _t(Bm), _t(Cin), sub=kw["sub"],
                               ta=kw["ta"], tbt=kw["tbt"])
        assert torch.equal(acc, got)


def test_pgemm_flags_validation():
    """``diag``/``dconst``/``sym`` need a square output, as in JAX."""
    A = torch.zeros((3, 2, 4, 4), dtype=torch.float64)
    Bm = torch.zeros((2, 5, 4, 4), dtype=torch.float64)
    for kw in (dict(sym=True), dict(dconst=1.0)):
        with pytest.raises(ValueError, match="square"):
            planes.pgemm(A, Bm, **kw)


@pytest.mark.parametrize("q", [12, 1])
@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("lam", [True, False])
def test_schur_update_planes_plain_matches_pallas(level, lam, q):
    """The lambda slab's masked update with the separator write-back
    (``lam``) and the plain subtract, at two levels; the port takes the
    compact separators, JAX their broadcast over each group's knots."""
    n = 12
    G = N >> (level + 1)
    rng = np.random.default_rng(20 + level + q + lam)
    FL = rng.standard_normal((n, n, N, B))
    fsol = rng.standard_normal((n, q, G, B))
    Fin = rng.standard_normal((n, q, N, B))
    fs_full = np.broadcast_to(
        fsol[:, :, :, None], (n, q, G, N // G, B)
    ).reshape(n, q, N, B)
    want = np.asarray(jp.schur_update_planes(
        _j(FL), _j(fs_full), _j(Fin), level=level, lam=lam,
        logb=B.bit_length() - 1, interpret=True,
    ))
    C = _t(Fin)
    got = planes.schur_update_planes(_t(FL), _t(fsol), C, level=level,
                                     lam=lam)
    assert got is C  # updated in place, as B9
    assert rel_err(got.numpy().reshape(want.shape), want) < BAR


def _lu_case(rng, n: int, ws):
    """``I + C J`` blocks (C, J PSD: eigenvalues >= 1, as the scan's) and
    right-hand sides of widths ``ws``."""
    M = rng.standard_normal((N, B, n, n))
    P = rng.standard_normal((N, B, n, n))
    IC = np.eye(n) + (M @ np.swapaxes(M, -1, -2)) @ (P @ np.swapaxes(P, -1, -2)) / n**2
    A = np.moveaxis(IC, (-2, -1), (0, 1)).copy()
    return A, [rng.standard_normal((n, w, N, B)) for w in ws]


@pytest.mark.parametrize("n,ws", [(5, (5, 1)), (12, (12, 1, 12, 1)),
                                  (36, (1,))])
def test_plu_solve_multi_plain_matches_pallas(n, ws):
    """4 right-hand sides at n=12 (the Woodbury solve's m), one at n=36
    (the generic combine's I + C J), 2 at n=5. The interpret-mode compile
    grows with n^2 per right-hand side: ~30 s for one at n=36, ~14 s for
    four at n=12."""
    A, Bs = _lu_case(np.random.default_rng(30 + n + len(ws)), n, ws)
    want = jp.plu_solve_multi(_j(A), *(_j(b) for b in Bs), interpret=True)
    tBs = [_t(b) for b in Bs]
    got = planes.plu_solve_multi(_t(A), *tBs)
    assert len(got) == len(ws)
    for g, w, b, tb in zip(got, want, Bs, tBs):
        w = np.asarray(w)
        assert rel_err(g.numpy().reshape(w.shape), w) < BAR
        assert np.array_equal(tb.numpy(), b)  # the right-hand side is kept
    one = planes.plu_solve(_t(A), _t(Bs[0]))
    assert torch.equal(one, got[0])


def _elem(rng, n: int, L: int):
    """A full element ``(F, c, C, eta, J)`` on ``[.., 2L, 8]`` slabs with C,
    J PSD, returned as its even positions: strided views, as the scan's
    ``_even_odd`` hands them to the combines."""
    Bw = 8
    M = rng.standard_normal((2 * L, Bw, n, n))
    sym = lambda X: np.moveaxis(X @ np.swapaxes(X, -1, -2) / n, (-2, -1),
                                (0, 1))
    full = (
        rng.standard_normal((n, n, 2 * L, Bw)),
        rng.standard_normal((n, 2 * L, Bw)),
        sym(M),
        rng.standard_normal((n, 2 * L, Bw)),
        sym(rng.standard_normal((2 * L, Bw, n, n))),
    )
    return tuple(torch.as_tensor(np.ascontiguousarray(x))[..., 0::2, :]
                 for x in full)


def _leaf(rng, n: int, m: int, L: int):
    Bw = 8
    U = rng.standard_normal((n, m, L, Bw))
    return (
        torch.as_tensor(rng.standard_normal((n, n, L, Bw))),
        torch.as_tensor(U),
        torch.as_tensor(np.swapaxes(U, 0, 1).copy()),
        torch.as_tensor(rng.standard_normal((n, L, Bw))),
        torch.as_tensor(rng.standard_normal((n, L, Bw))),
        torch.as_tensor(0.5 + rng.random((n, L, Bw))),
    )


@pytest.mark.parametrize("n,m", [(12, 4), (12, 12)])
def test_combines_leave_operands_unchanged(n, m):
    """Every combine of the scan, and the linalg calls whose JAX versions
    donate an operand (``bgemm_tt``'s ``cin``, ``bsolve_multi``'s
    right-hand sides), leaves every input element as it was: the port's
    kernels write new tensors (the scan passes strided views and reads
    ``e_odd``'s ``C`` again after combining it)."""
    rng = np.random.default_rng(40 + m)
    opts = SolveOptions()
    L = 3
    e1, e2 = _elem(rng, n, L), _elem(rng, n, L)
    l1 = _leaf(rng, n, m, L)
    inputs = e1 + e2 + l1
    before = [x.clone() for x in inputs]
    tps._combine(e1, e2, 2, opts)
    tps._combine_reduced(e1, (e2[3], e2[4]), 2, opts)
    tps._combine_leaf_full(l1, e2, 2, opts)
    tps._combine_reduced_leaf(l1, (e2[3], e2[4]), 2, opts,
                              gains=(l1[5][:m], l1[3][:m]))
    tla.bgemm_tt(e1[2], e2[4], 2, cin=e2[2], sub=False, sym=True)
    tla.bsolve_multi(e1[2] + 2 * torch.eye(n, dtype=torch.float64)[
        :, :, None, None], (e1[0], e2[1].unsqueeze(1)), 2)
    for x, x0 in zip(inputs, before):
        assert torch.equal(x, x0)


@pytest.mark.parametrize("fn", ["bgemm_tt", "bsolve_multi"])
def test_linalg_kernel_route_dims(fn):
    """The JAX dispatch dims: ``bgemm_tt`` takes the plane kernel when
    ``max(A.shape[0], A.shape[1])`` is above the threshold, ``bsolve_multi``
    when ``n`` is; at n=12, m=4 ``G_I @ TA1`` (4x4 . 4x12) takes the
    fallback and ``U1 @ G_I`` (12x4 . 4x4) the kernel route."""
    calls = []
    name = "pgemm" if fn == "bgemm_tt" else "plu_solve_multi"
    orig = getattr(planes, name)
    setattr(planes, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    try:
        rng = np.random.default_rng(50)
        T = lambda *s: torch.as_tensor(rng.standard_normal(s))
        if fn == "bgemm_tt":
            tla.bgemm_tt(T(4, 4, 3, 8), T(4, 12, 3, 8), 2)  # G_I @ TA1
            assert calls == []
            tla.bgemm_tt(T(12, 4, 3, 8), T(4, 4, 3, 8), 2)  # U1 @ G_I
            assert calls == [1]
            tla.bgemm_tt(T(4, 4, 3, 8), T(4, 12, 3, 8), 2, ta=True)
            assert calls == [1]
        else:
            eye = lambda k: torch.eye(k, dtype=torch.float64)[:, :, None,
                                                               None]
            tla.bsolve_multi(eye(4) + 0.1 * T(4, 4, 3, 8), (T(4, 4, 3, 8),),
                             2)
            assert calls == []
            tla.bsolve_multi(eye(12) + 0.1 * T(12, 12, 3, 8),
                             (T(12, 12, 3, 8), T(12, 1, 3, 8)), 2)
            assert calls == [1]
    finally:
        setattr(planes, name, orig)
