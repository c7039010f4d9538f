"""Port tests: the blocks that time B7 (``pcho_solve``) chained keep X normal.

A chained timing of B7 (``bench_kernels.chain_ms``, used by ``chip_smoke.py``
phase 2b and ``tools/time_solve.py``) solves ``(L L') X = X`` in place and
carries X through every call of the timing. Its SPD blocks come from
``bench_kernels.chain_spd`` (eigenvalues in about [1, 1.16]); the plain
twin runs that chain here, in f32 at n=12 on a few planes, for at least
every call of one timing and no fewer than 500, and X must stay finite and
free of subnormals. The blocks ``M M' + d I`` that the timing used before
shrink X d-fold a call and turn it subnormal within the same count, which
is the fault the helper guards against.
"""

import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

from rslqr_tpu_torch.bench_kernels import chain_spd
from rslqr_tpu_torch.ops import planes

D, W, PLANE = 12, 12, (3, 8)
# Calls of the solve in one chain_diff timing at K=10, 3 reps (chip_smoke.py's
# CHAIN_K and CHAIN_REPS, and chain_ms's defaults, which tools/time_solve.py
# uses): eager warm-ups of the 1- and K-chains, one replay of each after
# capture, then 3 replays of each.
TIMING_CALLS = (2 + 3) * (1 + 10)
CALLS = max(500, TIMING_CALLS)
TINY = torch.finfo(torch.float32).tiny


def _inputs(seed):
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.standard_normal(PLANE + (D, D)),
                        dtype=torch.float32)
    X = torch.as_tensor(rng.standard_normal((D, W) + PLANE),
                        dtype=torch.float32)
    return M, X


def _old_spd(M):
    """The blocks the chained timings used before: ``M M' + d I``."""
    S = M @ M.transpose(-1, -2) + D * torch.eye(D)
    return S.movedim((-2, -1), (0, 1)).contiguous()


def _first_subnormal(Lc, X, calls):
    """The call after which X first holds a subnormal entry (None if it
    never does), running the plain twin in place; asserts X stays finite."""
    for call in range(1, calls + 1):
        X = planes.pcho_solve_plain(Lc, X)
        assert bool(torch.isfinite(X).all()), f"X not finite after {call}"
        if bool(((X != 0) & (X.abs() < TINY)).any()):
            return call
    return None


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_spd_keeps_x_normal(seed):
    M, X = _inputs(seed)
    S = chain_spd(M)
    assert S.shape == (D, D) + PLANE and S.dtype == torch.float32
    ev = torch.linalg.eigvalsh(S.movedim((0, 1), (-2, -1)).double())
    assert float(ev.min()) >= 1.0 - 1e-6 and float(ev.max()) <= 1.3
    Lc = planes.pchol_plain(S)
    assert _first_subnormal(Lc, X.clone(), CALLS) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_old_blocks_turn_x_subnormal(seed):
    M, X = _inputs(seed)
    Lc = planes.pchol_plain(_old_spd(M))
    call = _first_subnormal(Lc, X.clone(), CALLS)
    assert call is not None and call <= TIMING_CALLS
