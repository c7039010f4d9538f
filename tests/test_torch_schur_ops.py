"""Port tests: the plain PyTorch versions of the four sweep kernels
(``rslqr_tpu_torch/ops/schur.py``) against the JAX Pallas kernels run in
interpret mode, on the same random f64 inputs.

Tolerance: atol 1e-10. Both sides compute the same sums in f64, in another
order; that is the bar at which JAX's own interpret-mode kernels match its
XLA stages (tests/test_pallas_ops.py:202-233).

Shapes are the cheapest that reach each kernel's branches (interpret mode
costs seconds per call): emission of the next-level products and the fold
are exercised for B1 and B3 (B4: tests/test_torch_schur_pair.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import to_numpy

from rslqr_tpu.ops import schur_pallas as jk

from rslqr_tpu_torch.ops import schur

ATOL = 1e-10
n, m = 6, 3
nn, mn = n * n, m * n


def _pair(rng, *shape):
    """One random f64 array, as (jax array, torch tensor) with equal data."""
    x = rng.standard_normal(shape)
    return jnp.asarray(x), torch.as_tensor(x.copy())


def _pairs(rng, count, *shape):
    ps = [_pair(rng, *shape) for _ in range(count)]
    return [p[0] for p in ps], [p[1] for p in ps]


def _assert_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            to_numpy(g), np.asarray(w), rtol=0, atol=ATOL,
            err_msg=f"{what}[{i}]",
        )


@pytest.mark.parametrize("level", [0, 5])
def test_rhs_update_plain_matches_pallas(level):
    """B2 at N=64, B=8: level 0 (dense masks) and level 5 (one group)."""
    N, B = 64, 8
    G = N >> (level + 1)
    rng = np.random.default_rng(level)
    Fl, Fl_t = _pair(rng, nn, N, B)
    Fx, Fx_t = _pair(rng, nn, N, B)
    Fu, Fu_t = _pair(rng, mn, N, B)
    zy, zy_t = _pair(rng, n, N, B)
    zx, zx_t = _pair(rng, n, N, B)
    zu, zu_t = _pair(rng, m, N, B)
    zb, zb_t = _pair(rng, G, n, B)
    want = jk.rhs_update_level_em(
        Fl, Fx, Fu, zy, zx, zu, zb, level=level, n=n, m=m, interpret=True
    )
    got = schur.rhs_update_level_em(
        Fl_t, Fx_t, Fu_t, zy_t, zx_t, zu_t, zb_t, level=level, n=n, m=m
    )
    assert got[0] is zy_t  # updated in place
    _assert_close(got, want, "z")


def test_schur_update_level_plain_matches_pallas():
    """B1 at N=16, level 2: the last level that emits next-level products
    (with the fold into the next level's own slab)."""
    N, B, level = 16, 8, 2
    U, G, G2 = 1, N >> 3, N >> 4
    rng = np.random.default_rng(10)
    FLl, FLl_t = _pair(rng, nn, N, B)
    FLx, FLx_t = _pair(rng, nn, N, B)
    FLu, FLu_t = _pair(rng, mn, N, B)
    Fls, Fls_t = _pairs(rng, U, nn, N, B)
    Fxs, Fxs_t = _pairs(rng, U, nn, N, B)
    Fus, Fus_t = _pairs(rng, U, mn, N, B)
    fs, fs_t = _pairs(rng, U, G, nn, B)
    As, As_t = _pair(rng, G2, nn, B)
    Bs, Bs_t = _pair(rng, G2, n * m, B)
    ol, ox, ou, S = jk.schur_update_level_em(
        FLl, FLx, FLu, Fls, Fxs, Fus, fs, As, Bs, level=level, n=n, m=m,
        interpret=True,
    )
    gl, gx, gu, gS = schur.schur_update_level_em(
        FLl_t, FLx_t, FLu_t, Fls_t, Fxs_t, Fus_t, fs_t, As_t, Bs_t,
        level=level, n=n, m=m,
    )
    assert S is not None and gS is not None and len(gS) == len(S)
    assert gl[0] is Fls_t[0]
    _assert_close(gl, ol, "Fl")
    _assert_close(gx, ox, "Fx")
    _assert_close(gu, ou, "Fu")
    _assert_close(gS, S, "S_next")


def test_leaf_schur_level0_plain_matches_pallas():
    """B3 at N=4 (depth 2, one upper slab): leaf synthesis, level 0 and the
    level-1 product emission with its fold."""
    N, B, depth = 4, 8, 2
    rng = np.random.default_rng(20)
    A, A_t = _pair(rng, nn, N, B)
    Bm, Bm_t = _pair(rng, n * m, N, B)
    q = rng.uniform(0.5, 2.0, (n, N, B))
    r = rng.uniform(0.5, 2.0, (m, N, B))
    S0, S0_t = _pair(rng, N // 2, nn, B)
    fs, fs_t = _pairs(rng, depth - 1, N // 2, nn, B)
    As, As_t = _pair(rng, N // 4, nn, B)
    Bs, Bs_t = _pair(rng, N // 4, n * m, B)
    ol, ox, ou, S = jk.leaf_schur_level0_em(
        A, Bm, jnp.asarray(q), jnp.asarray(r), S0, fs, As, Bs, depth=depth,
        n=n, m=m, interpret=True,
    )
    gl, gx, gu, gS = schur.leaf_schur_level0_em(
        A_t, Bm_t, torch.as_tensor(q), torch.as_tensor(r), S0_t, fs_t, As_t,
        Bs_t, depth=depth, n=n, m=m,
    )
    assert len(gl) == depth and len(gS) == len(S) == depth - 1
    _assert_close(gl, ol, "Fl")
    _assert_close(gx, ox, "Fx")
    _assert_close(gu, ou, "Fu")
    _assert_close(gS, S, "S_next")


@pytest.mark.parametrize(
    "level,N,B,expect",
    [(0, 16, 8, True), (2, 16, 8, True), (3, 32, 8, False)],
)
def test_level_emission_policy_matches_jax_tiles(level, N, B, expect):
    """S_next is returned exactly when the JAX kernel's tiling emits."""
    _, _, _, gd2, _ = jk._tiles(level, N, B, jnp.float32, 128)
    assert schur._level_emits(level, N) == (gd2 > 0) == expect


@pytest.mark.parametrize(
    "level,N,B,U", [(1, 256, 1024, 6), (3, 256, 1024, 4), (5, 256, 1024, 2),
                    (5, 256, 8, 2), (1, 16, 8, 2), (1, 16, 8, 1)],
)
def test_pair_emission_policy_matches_jax_tiles(level, N, B, U):
    *_, gd3, _ = jk._tiles_pair(level, N, B, jnp.float32, 128, 2 * nn + mn, U)
    assert schur._pair_emits(level, N, B, U, n, m) == (gd3 > 0 and U >= 2)


def test_wrappers_dispatch_by_device():
    """CPU tensors run the plain version (no launch counted); a device with
    no kernel raises instead of falling back."""
    schur.reset_launch_counts()
    N, B = 8, 3
    t = lambda *s: torch.zeros(s, dtype=torch.float64)
    args = (t(nn, N, B), t(nn, N, B), t(mn, N, B), t(n, N, B), t(n, N, B),
            t(m, N, B), t(N // 2, n, B))
    schur.rhs_update_level_em(*args, level=0, n=n, m=m)
    schur.rhs_update_level_em(*args, level=0, n=n, m=m, kernels="off")
    assert schur.launch_counts() == {
        "schur_update_level_em": 0, "rhs_update_level_em": 0,
        "leaf_schur_level0_em": 0, "schur_update_pair_em": 0,
    }
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        schur.rhs_update_level_em(*meta, level=0, n=n, m=m)
    with pytest.raises(ValueError, match="kernel mode"):
        schur.rhs_update_level_em(*args, level=0, n=n, m=m, kernels="on")
