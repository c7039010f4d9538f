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

import functools

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


@functools.cache
def _pallas_solve(n: int, w: int):
    """``L``, ``B`` and the JAX kernel's solve of ``(L L') X = B``. At n =
    12 ``L`` is the JAX kernel's Cholesky; past it numpy's, since each
    interpret-mode compile of the unrolled kernels at n = 70 takes minutes
    (so one solve of n columns serves every w there: the columns are
    independent)."""
    rng = np.random.default_rng(2 + w)
    if n == 12:
        L = np.asarray(jp.pchol(_jflat(_spd(rng, n, (N, B))), interpret=True))
        L = L.reshape(n, n, N, B).copy()
    else:
        S = np.moveaxis(_spd(rng, n, (N, B)), (0, 1), (-2, -1))
        L = np.moveaxis(np.linalg.cholesky(S), (-2, -1), (0, 1)).copy()
    Bm = rng.standard_normal((n, w, N, B))
    want = np.asarray(jp.pcho_solve(_jflat(L), _jflat(Bm), interpret=True))
    return L, Bm, want.reshape(Bm.shape)


@pytest.mark.parametrize("n,w", [(12, 12), (12, 1), (70, 70), (70, 1)],
                         ids=["12", "1", "70-70", "70-1"])
def test_pcho_solve_plain_matches_pallas(n, w):
    """w = n (the factor sweep's separator solves) and w = 1 (the RHS
    sweep's), at n = 12 and at the Unitree G1's n = 70, whose several
    columns the card runs in ``wide::pcho_solve_kernel`` (the CUDA tests
    hold that kernel to this plain version)."""
    L, Bm, want = _pallas_solve(n, w if n == 12 else n)
    Bt = torch.as_tensor(Bm[:, :w].copy())  # the cached B stays as it is
    got = planes.pcho_solve(torch.as_tensor(L), Bt)
    assert got is Bt  # solved in place
    assert rel_err(got.numpy(), want[:, :w]) < BAR


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


# schur3_update_levels: N knots x B batch columns = 256 plane elements,
# JAX's (2, 128) tile; every level that has an upper level.
LEVEL_CASES = [(n_, lv) for n_ in (16, 32)
               for lv in range(n_.bit_length() - 2)]


@pytest.mark.parametrize("Nk,level", LEVEL_CASES)
@pytest.mark.parametrize("n,m", [(36, 12), (9, 3), (64, 64), (13, 40)])
def test_schur3_update_levels_plain_matches_pallas(n, m, Nk, level):
    """The fused update of every upper level of ``level`` (its plain
    version: the plain B9 of each upper level in turn) against the JAX
    kernel applied per upper level, lambda masks and the separator
    write-back included, at N = 16 and 32 (B = 16 and 8)."""
    Bb = 256 // Nk
    depth = Nk.bit_length() - 1
    U = depth - 1 - level
    G = Nk >> (level + 1)
    rng = np.random.default_rng(1000 * n + 10 * Nk + level)
    R = lambda *s: rng.standard_normal(s)
    FLl, FLx, FLu = R(n, n, Nk, Bb), R(n, n, Nk, Bb), R(m, n, Nk, Bb)
    fsols = [R(n, n, G, Bb) for _ in range(U)]
    Cs = [(R(n, n, Nk, Bb), R(n, n, Nk, Bb), R(m, n, Nk, Bb))
          for _ in range(U)]
    jf = lambda x: jnp.asarray(x.reshape(x.shape[0], x.shape[1], 2, 128))
    t = lambda x: torch.as_tensor(x.copy())
    tC = [tuple(t(c) for c in trio) for trio in Cs]
    got = planes.schur3_update_levels(
        t(FLl), t(FLx), t(FLu), [t(f) for f in fsols],
        [c[0] for c in tC], [c[1] for c in tC], [c[2] for c in tC],
        level=level)
    assert [list(g) for g in got] == [[c[i] for c in tC] for i in range(3)]
    for fs, trio, mine in zip(fsols, Cs, tC):
        fs_full = np.repeat(fs, Nk // G, axis=2)  # each group's knots
        want = jp.schur3_update_planes(
            jf(FLl), jf(FLx), jf(FLu), jf(fs_full), *(jf(c) for c in trio),
            level=level, logb=Bb.bit_length() - 1, interpret=True, t1=2)
        for g, w in zip(mine, want):
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
        "schur3_update_levels": 0, "schur_update_planes": 0,
        "plu_solve_multi": 0, "pgemm_flagged": 0,
        "schur3_update_levels_pairs": 0,
    }
    meta = torch.empty(A.shape, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        planes.pgemm(meta, meta)
    with pytest.raises(ValueError, match="kernel mode"):
        planes.pchol(A, kernels="on")


def _spy(monkeypatch, name, calls):
    """Record each call of ``planes.<name>`` (its level, its number of
    upper levels and its columns q), then run it."""
    fn = getattr(planes, name)

    def spied(FLl, FLx, FLu, fs, *rest, level, **kw):
        fss = fs if isinstance(fs, (list, tuple)) else [fs]
        calls.append((level, len(fss), fss[0].shape[1]))
        return fn(FLl, FLx, FLu, fs, *rest, level=level, **kw)

    monkeypatch.setattr(planes, name, spied)


def test_midblock_factor_takes_fused_update(monkeypatch):
    """A mid-block solve (nx=12, nu=4, N=16, f32 on the CPU): the factor
    sweep calls ``schur3_update_levels`` once per level that has an upper
    level, with all of them (3, 2, 1 at depth 4); ``schur3_update_planes``
    runs only in the RHS sweep, once per level, with one column."""
    import rslqr_tpu_torch as pt

    fused, per_u = [], []
    _spy(monkeypatch, "schur3_update_levels", fused)
    _spy(monkeypatch, "schur3_update_planes", per_u)
    prob = pt.random_problem(torch.Generator().manual_seed(3), 16, 12, 4,
                             device="cpu")
    got = pt.solve_kkt(prob)
    assert bool(torch.isfinite(got).all())
    assert fused == [(0, 3, 12), (1, 2, 12), (2, 1, 12)]
    assert sorted(per_u) == [(lv, 1, 1) for lv in range(4)]


def test_schur3_update_levels_groups(monkeypatch):
    """The kernel route's launch plan (``_launch`` recorded, no card): one
    launch per ``UPPER_GROUP`` upper levels, each naming its own slabs, and
    the counters."""
    launched = []
    monkeypatch.setattr(planes, "kernel_applies", lambda k, *a, **kw: True)
    monkeypatch.setattr(planes, "_launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(planes, "UPPER_GROUP", 2)
    planes.reset_launch_counts()
    n, m, Nk, Bb, U = 9, 3, 32, 2, 5
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)
    fs = [f32(n, n, Nk // 2, Bb) for _ in range(U)]
    Cl, Cx, Cu = ([f32(r, n, Nk, Bb) for _ in range(U)] for r in (n, n, m))
    planes.schur3_update_levels(f32(n, n, Nk, Bb), f32(n, n, Nk, Bb),
                                f32(m, n, Nk, Bb), fs, Cl, Cx, Cu, level=0)
    assert [a[7] for a in launched] == [2, 2, 1]
    assert [p for a in launched for p in a[4]] == [c.data_ptr() for c in Cl]
    assert [p for a in launched for p in a[3]] == [f.data_ptr() for f in fs]
    counts = planes.launch_counts()
    assert counts["schur3_update_levels"] == 3
    assert counts["schur3_update_levels_pairs"] == U
    with pytest.raises(ValueError, match="fsols"):
        planes.schur3_update_levels(f32(n, n, Nk, Bb), f32(n, n, Nk, Bb),
                                    f32(m, n, Nk, Bb), fs, Cl[:-1], Cx, Cu,
                                    level=0)
    planes.reset_launch_counts()


def test_quadruped_depth_launch_counts(monkeypatch):
    """The closed form of ``launch_counts()`` for one mid-block solve at
    N = 512 (depth 9), the quadruped's horizon, on the kernel route with
    the launches recorded and not run (f32 CPU tensors, nx=9, nu=1, B=1;
    the values are not looked at): 8 fused launches covering the 36 (level,
    upper level) pairs, and 9 per-level B9 launches, all in the RHS sweep;
    B6 once a level, B7 for every upper level and once a level in the RHS
    sweep."""
    import rslqr_tpu_torch as pt

    monkeypatch.setattr(planes, "kernel_applies",
                        lambda k, *a, **kw: k == "auto")
    monkeypatch.setattr(planes, "_launch", lambda *a: None)
    prob = pt.random_problem(torch.Generator().manual_seed(4), 512, 9, 1,
                             device="cpu")
    planes.reset_launch_counts()
    pt.solve_kkt(prob)
    counts = planes.launch_counts()
    planes.reset_launch_counts()
    assert counts["schur3_update_levels"] == 8
    assert counts["schur3_update_levels_pairs"] == 36
    assert counts["schur3_update_planes"] == 9
    assert counts["pchol"] == 9
    assert counts["pcho_solve"] == 36 + 9
