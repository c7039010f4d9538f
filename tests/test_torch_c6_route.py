"""Port tests: state dims above the small-block kernels' limit under a raised
``mxu_block_threshold`` (ROADMAP C6).

The rule (``rslqr_em._mid_block``): a state dim n takes the mid-block planes
route when ``n > min(mxu_block_threshold, ops.schur.MAX_STATE)``. So under
``SolveOptions(mxu_block_threshold=16)`` a state dim of 9..16 runs the plain
leaf, the B7 separator solves (``planes.pcho_solve``) and the B9 Schur
updates (``planes.schur3_update_planes``), and no small-block sweep kernel
(B1-B4, B10-B12), whose kernels take n <= 8. The reference runs its
small-block Schur kernels there; both give the same KKT solution.

* The rule's decisions at n = 8, 9, 12, 16 and thresholds 8 and 16; the
  default options send every block where they did before.
* The route on the CPU: the solve calls the plane wrappers and no
  small-block wrapper (the card's structure; on the card they launch,
  tests/test_torch_cuda_kernels.py).
* An f64 solve at nx=12, nu=4, N=16 against ``rslqr_tpu.solve_kkt`` with
  the same options, within ``1e-8 (1 + max|ref|)`` (JAX's stage is XLA on
  the CPU: the threshold keeps its Pallas kernels off; f64, since in f32
  the two packages differ by ~7e-7 from rounding alone).
* nx=9 and nx=16 at the same threshold against the port's own f64 Riccati
  oracle, within ``1e-6 (1 + max|ref|)`` (the cross-solver bar of
  tests/test_rslqr.py:143-148), which keeps the JAX compiles to one.
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import rslqr_em
from rslqr_tpu_torch.ops import flat, planes, schur

RAISED = 16


@pytest.mark.parametrize("threshold", [8, RAISED])
@pytest.mark.parametrize("n", [8, 9, 12, 16])
def test_mid_block_rule(n, threshold):
    """Mid block exactly when n passes the threshold or the small-block
    kernels' limit of 8."""
    opts = pt.SolveOptions(mxu_block_threshold=threshold)
    assert rslqr_em._mid_block(n, opts) is (n > 8)
    assert schur.MAX_STATE == 8


@pytest.mark.parametrize("n", [1, 6, 8, 9, 36, 64])
def test_default_threshold_routes_as_before(n):
    """The default threshold (8) keeps the old rule ``n > threshold``; a
    lower threshold still sends every n above it to the planes."""
    assert rslqr_em._mid_block(n, pt.SolveOptions()) is (n > 8)
    assert rslqr_em._mid_block(n, pt.SolveOptions(
        mxu_block_threshold=4)) is (n > 4)


def _counting(monkeypatch, mod, names):
    """Wrap ``mod``'s wrappers ``names`` to count their calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_raised_threshold_takes_plane_route(monkeypatch):
    """nx=12 under threshold 16 (N=16, f32 on the CPU): the solve calls B7
    and B9 and no small-block or flat sweep wrapper, also with
    ``flat_planes`` asked for (the flat schedule is a small-block one)."""
    plane_calls = _counting(monkeypatch, planes,
                            ("pcho_solve", "schur3_update_planes"))
    small = tuple(w.__name__ for w in schur.KERNEL_WRAPPERS)
    small_calls = _counting(monkeypatch, schur, small)
    flat_calls = _counting(monkeypatch, flat,
                           tuple(w.__name__ for w in flat.KERNEL_WRAPPERS))
    prob = pt.random_problem(torch.Generator().manual_seed(12), 16, 12, 4,
                             device="cpu")
    for fp in (False, True):
        got = pt.solve_kkt(prob, options=pt.SolveOptions(
            mxu_block_threshold=RAISED, flat_planes=fp))
        assert bool(torch.isfinite(got).all())
    assert all(c > 0 for c in plane_calls.values()), plane_calls
    assert not any(small_calls.values()), small_calls
    assert not any(flat_calls.values()), flat_calls


def test_raised_threshold_f64_matches_jax():
    """nx=12, nu=4, N=16 in f64 under threshold 16: the port's planes route
    against the reference's small-block route, the same KKT solution."""
    prob = rt.random_problem(jax.random.PRNGKey(12), 16, 12, 4,
                             dtype=jax.numpy.float64)
    ref = np.asarray(rt.solve_kkt(prob, options=JaxOptions(
        mxu_block_threshold=RAISED)))
    tp = pt.problem_from_numpy(prob, device="cpu")
    got = pt.solve_kkt(tp, options=pt.SolveOptions(
        mxu_block_threshold=RAISED))
    assert got.dtype == torch.float64
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-8 * (
        1.0 + float(np.abs(ref).max()))


@pytest.mark.parametrize("nx", [9, 16])
def test_raised_threshold_f64_matches_riccati(nx):
    """nx=9 and 16 (nu=4, N=16, a batch of 3) in f64 under threshold 16,
    against the port's f64 Riccati oracle."""
    prob = pt.random_problem(torch.Generator().manual_seed(nx), 16, nx, 4,
                             dtype=torch.float64, device="cpu")
    batch = pt.batch_problems(prob, 3, torch.Generator().manual_seed(1))
    got = pt.solve_kkt(batch, options=pt.SolveOptions(
        mxu_block_threshold=RAISED))
    ric = pt.solve_riccati(batch).kkt_vector()
    assert rel_err(got.numpy(), ric.numpy()) <= 1e-6
