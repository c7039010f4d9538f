"""Port tests: the plain versions of the three flat-plane sweep kernels
(``rslqr_tpu_torch/ops/flat.py``) against the JAX Pallas kernels
(``rslqr_tpu/ops/schur_planes.py``) run in interpret mode, on the same
random f32 inputs; and the flat path's dispatch against JAX's.

Shapes: N=16, B=1024 (the smallest batch the flat layout takes), n=3, m=2:
B10 at levels 0 and 1 (emitting, with the fold) and 2 (not), B11 at depth
4, B12 at levels 0 and 2. Tolerance: ``1e-5 * max|ref|`` (f32; the two
sides sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

from rslqr_tpu.config import SolveOptions as JaxOptions
from rslqr_tpu.ops import schur_planes as jk
from rslqr_tpu.rslqr_em import _flat_path_ok as jax_flat_path_ok
from rslqr_tpu.rslqr_em import _pallas_schur_mode

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.ops import flat
from rslqr_tpu_torch.rslqr_em import _flat_path_ok

N, B, n, m = 16, 1024, 3, 2
nn, mn = n * n, m * n
R = N * B // 128
DEPTH = 4
TOL = 1e-5


def _rows(G: int) -> int:
    """Rows of 128 of a compact [e, G, B] array in flat planes."""
    return G * B // 128


def _pair(rng, *shape, positive=False):
    """One random f32 array, as (jax array, torch tensor) with equal data."""
    x = (rng.uniform(0.5, 2.0, shape) if positive
         else rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _pairs(rng, count, *shape):
    ps = [_pair(rng, *shape) for _ in range(count)]
    return [p[0] for p in ps], [p[1] for p in ps]


def _assert_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            to_numpy(g), w, rtol=0, atol=TOL * np.abs(w).max(),
            err_msg=f"{what}[{i}]",
        )


@pytest.mark.parametrize("level,emits", [(0, True), (1, True), (2, False)])
def test_schur_update_level_flat_plain_matches_pallas(level, emits):
    """B10: every upper slab of a depth-4 tree at one level, with the
    next-level separator dynamics given (emitted only at levels 0-1)."""
    U = DEPTH - level - 1
    G, G2 = N >> (level + 1), N >> (level + 2)
    rng = np.random.default_rng(level)
    FLl, FLl_t = _pair(rng, nn, R, 128)
    FLx, FLx_t = _pair(rng, nn, R, 128)
    FLu, FLu_t = _pair(rng, mn, R, 128)
    Fls, Fls_t = _pairs(rng, U, nn, R, 128)
    Fxs, Fxs_t = _pairs(rng, U, nn, R, 128)
    Fus, Fus_t = _pairs(rng, U, mn, R, 128)
    fs, fs_t = _pairs(rng, U, nn, _rows(G), 128)
    As, As_t = _pair(rng, nn, _rows(G2), 128)
    Bs, Bs_t = _pair(rng, n * m, _rows(G2), 128)
    ol, ox, ou, S = jk.schur_update_level_flat(
        FLl, FLx, FLu, Fls, Fxs, Fus, fs, As, Bs, level=level, n=n, m=m,
        N=N, interpret=True,
    )
    gl, gx, gu, gS = flat.schur_update_level_flat(
        FLl_t, FLx_t, FLu_t, Fls_t, Fxs_t, Fus_t, fs_t, As_t, Bs_t,
        level=level, n=n, m=m, N=N,
    )
    assert (S is not None) == (gS is not None) == emits
    assert flat._flat_emits(level, N) == emits
    assert gl[0] is Fls_t[0]  # updated in place
    _assert_close(gl, ol, "Fl")
    _assert_close(gx, ox, "Fx")
    _assert_close(gu, ou, "Fu")
    if emits:
        _assert_close(gS, S, "S_next")


def test_leaf_schur_level0_flat_plain_matches_pallas():
    """B11 at depth 4: leaf synthesis, level 0 of every slab and the
    level-1 products with their fold."""
    rng = np.random.default_rng(20)
    A, A_t = _pair(rng, nn, R, 128)
    Bm, Bm_t = _pair(rng, n * m, R, 128)
    q, q_t = _pair(rng, n, R, 128, positive=True)
    r, r_t = _pair(rng, m, R, 128, positive=True)
    S0, S0_t = _pair(rng, nn, _rows(N // 2), 128)
    fs, fs_t = _pairs(rng, DEPTH - 1, nn, _rows(N // 2), 128)
    As, As_t = _pair(rng, nn, _rows(N // 4), 128)
    Bs, Bs_t = _pair(rng, n * m, _rows(N // 4), 128)
    ol, ox, ou, S = jk.leaf_schur_level0_flat(
        A, Bm, q, r, S0, fs, As, Bs, depth=DEPTH, n=n, m=m, N=N,
        interpret=True,
    )
    gl, gx, gu, gS = flat.leaf_schur_level0_flat(
        A_t, Bm_t, q_t, r_t, S0_t, fs_t, As_t, Bs_t, depth=DEPTH, n=n, m=m,
        N=N,
    )
    assert len(gl) == DEPTH and len(gS) == len(S) == DEPTH - 1
    assert all(tuple(x.shape) == (nn, R, 128) for x in gl)
    _assert_close(gl, ol, "Fl")
    _assert_close(gx, ox, "Fx")
    _assert_close(gu, ou, "Fu")
    _assert_close(gS, S, "S_next")


@pytest.mark.parametrize("level", [0, 2])
def test_rhs_update_level_flat_plain_matches_pallas(level):
    """B12: level 0 (dense masks) and level 2 (groups wider than a tile)."""
    G = N >> (level + 1)
    rng = np.random.default_rng(30 + level)
    Fl, Fl_t = _pair(rng, nn, R, 128)
    Fx, Fx_t = _pair(rng, nn, R, 128)
    Fu, Fu_t = _pair(rng, mn, R, 128)
    zy, zy_t = _pair(rng, n, R, 128)
    zx, zx_t = _pair(rng, n, R, 128)
    zu, zu_t = _pair(rng, m, R, 128)
    zb, zb_t = _pair(rng, n, _rows(G), 128)
    want = jk.rhs_update_level_flat(
        Fl, Fx, Fu, zy, zx, zu, zb, level=level, n=n, m=m, N=N,
        interpret=True,
    )
    got = flat.rhs_update_level_flat(
        Fl_t, Fx_t, Fu_t, zy_t, zx_t, zu_t, zb_t, level=level, n=n, m=m, N=N
    )
    assert got[0] is zy_t  # updated in place
    _assert_close(got, want, "z")


@pytest.mark.parametrize("N_,level", [(4, 0), (4, 1), (8, 1), (16, 2),
                                      (256, 0), (256, 1), (256, 2)])
def test_flat_geometry_matches_jax(N_, level):
    """Knots per tile, tile geometry and the emission choice are JAX's."""
    assert flat._kpt_for(level, N_) == jk._kpt_for(level, N_)
    assert flat._flat_geometry(level, N_, 1024) == jk._flat_geometry(
        level, N_, 1024)
    assert flat._flat_emits(level, N_) == (
        jk._flat_geometry(level, N_, 1024)[5] > 0)


FLAT = pt.SolveOptions(flat_planes=True)
JAX_KERNELS = JaxOptions(layout="em", pallas="interpret", flat_planes=True)


@pytest.mark.parametrize(
    "tdt,jdt,nb,N_,bshape",
    [
        (torch.float32, jnp.float32, 1, 16, (1024,)),
        (torch.float32, jnp.float32, 1, 16, (512,)),    # sub-tile knots
        (torch.float64, jnp.float64, 1, 16, (1024,)),   # f32 only
        (torch.float32, jnp.float32, 2, 16, (8, 128)),  # one batch axis
        (torch.float32, jnp.float32, 1, 4, (1024,)),    # no kernel path
        (torch.float32, jnp.float32, 1, 256, (2048,)),
    ],
)
def test_flat_path_ok_matches_jax(tdt, jdt, nb, N_, bshape):
    """The port's dispatch is JAX's: its ``_flat_path_ok`` (the cases of
    tests/test_schur_flat.py:50-54) where its Pallas Schur kernels run at
    all (``_pallas_schur_mode``: N >= 8)."""
    want = bool(jax_flat_path_ok(jdt, nb, N_, bshape, JAX_KERNELS)) and (
        _pallas_schur_mode(jdt, nb, N_, bshape, n, JAX_KERNELS) is not None)
    assert _flat_path_ok(tdt, nb, N_, bshape, n, FLAT) == want
    assert flat.flat_ok(N_, bshape[0], tdt) == jk.flat_ok(N_, bshape[0], jdt)
    # Off by default, and never for mid-size blocks.
    assert not _flat_path_ok(tdt, nb, N_, bshape, n, pt.SolveOptions())
    assert not _flat_path_ok(tdt, nb, N_, bshape, 12, FLAT)


def test_flat_wrappers_dispatch_by_device():
    """CPU tensors run the plain version (no launch counted); a device with
    no kernel raises instead of falling back."""
    flat.reset_launch_counts()
    t = lambda *s: torch.zeros(s)
    args = (t(nn, R, 128), t(nn, R, 128), t(mn, R, 128), t(n, R, 128),
            t(n, R, 128), t(m, R, 128), t(n, _rows(N // 2), 128))
    flat.rhs_update_level_flat(*args, level=0, n=n, m=m, N=N)
    flat.rhs_update_level_flat(*args, level=0, n=n, m=m, N=N, kernels="off")
    assert flat.launch_counts() == {
        "schur_update_level_flat": 0, "leaf_schur_level0_flat": 0,
        "rhs_update_level_flat": 0,
    }
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        flat.rhs_update_level_flat(*meta, level=0, n=n, m=m, N=N)
    with pytest.raises(ValueError, match="kernel mode"):
        flat.rhs_update_level_flat(*args, level=0, n=n, m=m, N=N,
                                   kernels="on")
