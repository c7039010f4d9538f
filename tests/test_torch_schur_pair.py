"""Port test: the plain PyTorch version of the paired sweep kernel
(``schur_update_pair_em``) against the JAX Pallas kernel in interpret mode,
on the same random f64 inputs (a file of its own: the interpret-mode call
takes ~20-30 s).

Tolerance: atol 1e-10, as in tests/test_torch_schur_ops.py.
"""

import numpy as np

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from test_torch_schur_ops import _assert_close, _pair, _pairs, m, mn, n, nn

from rslqr_tpu.ops import schur_pallas as jk

from rslqr_tpu_torch.ops import schur


def test_schur_update_pair_plain_matches_pallas():
    """B4 at N=16, level 1: both updates, the Sbar2 fold, and the
    level-3 product emission with its fold."""
    N, B, level = 16, 8, 1
    U = 2
    G1, G2, G3 = N >> 2, N >> 3, N >> 4
    rng = np.random.default_rng(30)
    FLl, FLl_t = _pair(rng, nn, N, B)
    FLx, FLx_t = _pair(rng, nn, N, B)
    FLu, FLu_t = _pair(rng, mn, N, B)
    Fls, Fls_t = _pairs(rng, U, nn, N, B)
    Fxs, Fxs_t = _pairs(rng, U, nn, N, B)
    Fus, Fus_t = _pairs(rng, U, mn, N, B)
    f1, f1_t = _pairs(rng, U, G1, nn, B)
    sb, sb_t = _pair(rng, G2, nn, B)
    f2, f2_t = _pairs(rng, U - 1, G2, nn, B)
    As, As_t = _pair(rng, G3, nn, B)
    Bs, Bs_t = _pair(rng, G3, n * m, B)
    ol, ox, ou, S = jk.schur_update_pair_em(
        FLl, FLx, FLu, Fls, Fxs, Fus, f1, sb, f2, As, Bs, level=level, n=n,
        m=m, interpret=True,
    )
    gl, gx, gu, gS = schur.schur_update_pair_em(
        FLl_t, FLx_t, FLu_t, Fls_t, Fxs_t, Fus_t, f1_t, sb_t, f2_t, As_t,
        Bs_t, level=level, n=n, m=m,
    )
    assert S is not None and gS is not None and len(gS) == len(S) == U - 1
    _assert_close(gl, ol, "Fl")
    _assert_close(gx, ox, "Fx")
    _assert_close(gu, ou, "Fu")
    _assert_close(gS, S, "S_next")
