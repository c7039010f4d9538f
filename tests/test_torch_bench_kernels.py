"""Port tests: ``rslqr_tpu_torch.bench_kernels`` on the CPU.

* Each section's chained program runs at a tiny size (N=16, B=8; planes
  N=16, B=8, nx=12) with the plain versions, and its K-chain equals K
  sequential calls: the in-place chains (update, rhs, planes) against the
  wrapper called K times on a copy of the same inputs; the chains that feed
  ``s * 1e-38`` back (leaf, sep, prod; too small to move an f32 input) sum K
  times the value of one iteration, computed here independently.
* Each byte model equals the JAX script's inline formula, written out here
  from ``bench_kernels.py`` at two shapes.
* ``chain_diff`` raises without a CUDA device; ``linalg.beye`` matches
  ``rslqr_tpu.linalg.beye``.
"""

import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

from rslqr_tpu import linalg as jla

from rslqr_tpu_torch import bench_kernels as bk
from rslqr_tpu_torch import linalg as la
from rslqr_tpu_torch.ops import planes, schur

N, B, K = 16, 8, 3
n, m = 6, 3
nn, mn, nm = n * n, m * n, n * m


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return [_copy(v) for v in x]
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


def _close(a, b, rel=1e-5):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(
        b, dtype=torch.float64)
    assert float((a - b).abs().max()) <= rel * (1.0 + float(b.abs().max()))


@pytest.mark.parametrize("N_,level", [(16, 0), (32, 3)])
def test_update_chain_is_sequential_calls(N_, level):
    """Emitting at level 0, not at level 3."""
    inp = bk.update_inputs(N_, B, level, "cpu")
    seq, start = _copy(inp), _copy(inp)
    out = bk.update_chain(inp)(K)()
    assert out is inp["Fls"]
    for _ in range(K):
        schur.schur_update_level_em(
            *seq["FL"], seq["Fls"], seq["Fxs"], seq["Fus"], seq["fsol"],
            *seq["sep"], level=level, n=n, m=m)
    assert (inp["sep"][0] is not None) == (level <= 2)
    for key in ("Fls", "Fxs", "Fus"):
        for a, b, s in zip(inp[key], seq[key], start[key]):
            assert torch.equal(a, b)
            assert not torch.equal(a, s)


def test_leaf_chain_sums_k_calls():
    inp = bk.leaf_inputs(N, B, "cpu")
    depth = (N - 1).bit_length()
    Fls, *_ = schur.leaf_schur_level0_em(
        inp["A"], inp["B"], inp["qinv"], inp["rinv"], inp["S0"], inp["fsol"],
        inp["Asep"], inp["Bsep"], depth=depth, n=n, m=m)
    _close(bk.leaf_chain(inp)(K)(), K * Fls[0][0].sum())


@pytest.mark.parametrize("level", [0, 3])
def test_rhs_chain_is_sequential_calls(level):
    inp = bk.rhs_inputs(N, B, level, "cpu")
    seq = _copy(inp)
    bk.rhs_chain(inp)(K)()
    for _ in range(K):
        schur.rhs_update_level_em(*seq["F"], *seq["z"], seq["zb"],
                                  level=level, n=n, m=m)
    for a, b in zip(inp["z"], seq["z"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", [0, 1])
def test_sep_chain_sums_k_calls(level):
    """One iteration is ``sum((S S' + 10 I) \\ S) * U + sum(L)`` over the
    level's G groups: torch.linalg on mat-last blocks here."""
    U = (N - 1).bit_length() - level - 1
    base = bk.sep_inputs(N, B, level, "cpu")
    G = base.shape[0]
    S = base.reshape(G, n, n, B).permute(0, 3, 1, 2).double()  # [G, B, n, n]
    L = torch.linalg.cholesky(S @ S.transpose(-1, -2) + 10.0 * torch.eye(n))
    X = torch.cholesky_solve(S, L)
    one = U * X.sum() + L.sum()
    _close(bk.sep_chain(base, U)(K)(), K * one, 1e-4)


@pytest.mark.parametrize("level", [0, 2])
def test_prod_chain_sums_k_calls(level):
    """One iteration is U times the sum over groups of ``A_sep Fx[sep] +
    B_sep Fu[sep] - Fx[sep+1] - Fl[sep+1]`` at knots ``g*span + 2^L - 1``:
    numpy here."""
    U = (N - 1).bit_length() - level
    inp = bk.prod_inputs(N, B, level, "cpu")
    a = {k: v.double().numpy() for k, v in inp.items() if k != "level"}
    span = 1 << (level + 1)
    sep = np.arange(N // span) * span + (1 << level) - 1
    at = lambda x, r: np.moveaxis(x[:, :, r], (0, 1), (-2, -1))  # [G, B, ., .]
    S = (at(a["A"], sep) @ at(a["Fx"], sep) + at(a["B"], sep) @ at(a["Fu"], sep)
         - at(a["Fx"], sep + 1) - at(a["Fl"], sep + 1))
    _close(bk.prod_chain(inp, U)(K)(), K * U * S.sum(), 1e-4)


def test_planes_chains_are_sequential_calls():
    inp = bk.planes_inputs(N, B, 12, "cpu")
    seq = _copy(inp)
    c = seq["B"]
    for _ in range(K):
        c = planes.pgemm(seq["A"], c) * 1e-2
    assert torch.equal(bk.planes_gemm_chain(inp)(K)(), c)
    bk.planes_update_chain(inp)(K)()
    for _ in range(K):
        planes.schur_update_planes(seq["A"], seq["fsol"], seq["C"],
                                   level=bk.PLANES_LEVEL, lam=True)
    assert torch.equal(inp["C"], seq["C"])
    assert inp["fsol"].shape == (12, 12, N >> (bk.PLANES_LEVEL + 1), B)


@pytest.mark.parametrize("N_,B_,level", [(256, 1024, 0), (128, 512, 3)])
def test_traffic_models_match_jax_formulas(N_, B_, level):
    depth = (N_ - 1).bit_length()
    span = 1 << (level + 1)
    G = N_ // span
    U = depth - level - 1
    # bench_kernels.py:86-87, 113-115 (update).
    span2 = 2 * span
    emit_cfg = span2 <= min(max(span, 8) * 2, 16, N_) and N_ >= span2
    slab = (2 * nn + mn) * N_ * B_ * 4
    ex_bytes = nn * (N_ // span2) * B_ * 4 if emit_cfg else 0
    update = slab + U * (2 * slab + ex_bytes) + U * (G * nn * B_ * 4)
    assert bk.update_emits(N_, level) == emit_cfg == (level <= 2)
    assert bk.update_traffic(N_, B_, level, U, emit_cfg) == update
    # :160-163 (leaf).
    Ul = depth - 1
    reads = (nn + nm + n + m) * N_ * B_ * 4 + (Ul + 1) * (N_ // 2) * nn * B_ * 4
    reads += (N_ // 4) * (nn + nm) * B_ * 4 + Ul * (N_ // 4) * nn * B_ * 4
    writes = depth * (2 * nn + nm) * N_ * B_ * 4
    assert bk.leaf_traffic(N_, B_) == reads + writes
    # :204-208 (rhs).
    rhs = ((2 * nn + mn) * N_ * B_ * 4 + 2 * (2 * n + m) * N_ * B_ * 4
           + G * n * B_ * 4)
    assert bk.rhs_traffic(N_, B_, level) == rhs
    # :267-269 (sep).
    compact = G * nn * B_ * 4
    assert bk.sep_traffic(N_, B_, level, U) == (U + 1) * compact * 4 \
        + U * compact * 2
    # :334 (prod, model_full_GB).
    U0 = depth - level
    assert bk.prod_traffic(N_, B_, level, U0) == U0 * (2 * nn + mn) * N_ * B_ * 4
    # :369-370 and :392 (planes), at nx=36 and 12 over the N*B plane.
    for nx in (36, 12):
        F = N_ * B_
        assert bk.planes_flops(nx, F) == 2 * nx * nx * nx * F
        assert bk.planes_gemm_traffic(nx, F) == 3 * nx * nx * F * 4
        assert bk.planes_update_traffic(nx, F) == 4 * nx * nx * F * 4


def test_chain_diff_needs_cuda():
    make_run = lambda Kc: (lambda: None)
    devices = ["cpu"] + ([] if torch.cuda.is_available() else ["cuda"])
    for dev in devices:
        with pytest.raises(RuntimeError, match="CUDA device"):
            bk.chain_diff(make_run, 2, 1, dev)


def test_chain_ms_and_launch_ms_need_cuda():
    """The single-call and chained clocks of chip_smoke.py and
    tools/time_solve.py raise without a card, as chain_diff does."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        bk.chain_ms(lambda: None, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            bk.launch_ms(lambda: None, tuple)


def test_run_rejects_unknown_sections():
    with pytest.raises(ValueError, match="unknown sections"):
        bk.run(["update", "bogus"], "cpu")


@pytest.mark.parametrize("nn_,nbatch", [(6, 1), (6, 2), (36, 2)])
def test_beye_matches_jax(nn_, nbatch):
    like = torch.zeros((nn_, nn_) + (3,) * nbatch, dtype=torch.float64)
    got = la.beye(nn_, like, nbatch)
    want = np.asarray(jla.beye(nn_, like.numpy(), nbatch))
    assert got.shape == want.shape and got.dtype == like.dtype
    assert np.array_equal(got.numpy(), want)
    assert (like + got).shape == like.shape
