"""Port tests: small state, wide input (n <= 8 < m <= 64).

The reference gates its small-block Schur kernels on the state dim alone
(``rslqr_tpu/rslqr_em.py:_pallas_schur_mode``), so a default-option solve
with nx <= 8 and a wider input runs them; the port's small-block kernels
take every 1 <= m <= 64 (``csrc/small_blocks.cuh``'s wide tag). Here, on
the CPU (the plain stages):

* default-option f64 and f32 ``solve_kkt`` at (n, m) = (6, 12), (3, 17) and
  (8, 64), N=8, B=8, against ``rslqr_tpu.solve_kkt(pallas="off")``: f64 at
  ``1e-10 * (1 + max|ref|)`` (the bar of tests/test_torch_rslqr.py), f32 at
  ``1e-5`` relative (two f32 solvers summing in another order);
* (6, 12), N=16, B=128, against the reference's own Pallas kernels at
  m > 8 (``layout="em", pallas="interpret"``, f32 at 1e-5; its JAX compile
  alone takes ~100 s on one core), and the flat schedule against the
  port's element-major one (f32, 1e-6: the flat plain stages run the em
  plain stages on views);
* the row-group launch plan of B1 and B10 (``ops/schur.py:_level_plan``),
  walked as ``csrc/row_groups.cuh`` walks it, covering every slab row and
  every knot once at every n <= 8 and m in {1, 3, 8, 9, 33, 64}, in at most
  16 slots (1,024 threads a block);
* the wrappers' block check raising past n = 8 and past m = 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.ops import schur

WIDE = [(6, 12), (3, 17), (8, 64)]


@functools.lru_cache(maxsize=None)
def _case(N, nx, nu, B, f32):
    """(JAX batch, port batch on the CPU) of a perturbed
    ``random_problem`` with ``nx`` states and ``nu`` inputs."""
    dtype = jnp.float32 if f32 else jnp.float64
    prob = rt.random_problem(jax.random.PRNGKey(nx + nu), N, nx, nu, dtype)
    batch = rt.batch_problems(prob,
                              jax.random.split(jax.random.PRNGKey(N + nu), B))
    return batch, pt.problem_from_numpy(batch, device="cpu")


def _jax_solve(batch, **opts):
    return np.asarray(jax.jit(lambda p: rt.solve_kkt(
        p, options=JaxOptions(**opts)))(batch))


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("nx,nu", WIDE)
def test_default_solve_matches_jax(nx, nu, f32):
    batch, tb = _case(8, nx, nu, 8, f32)
    ref = _jax_solve(batch, pallas="off")
    got = pt.solve_kkt(tb)
    assert got.dtype == (torch.float32 if f32 else torch.float64)
    assert rel_err(got.numpy(), ref) < (1e-5 if f32 else 1e-10)


def test_default_solve_matches_jax_pallas_interpret():
    """(6, 12), N=16, B=128 in f32: the yardstick is the reference's own
    small-block Pallas kernels at m = 12, in interpret mode."""
    batch, tb = _case(16, 6, 12, 128, True)
    ref = _jax_solve(batch, layout="em", pallas="interpret")
    assert rel_err(pt.solve_kkt(tb).numpy(), ref) < 1e-5


def test_flat_schedule_matches_em():
    """The flat-plane schedule (f32, B % 1024 == 0) at (6, 12) against the
    port's element-major result on the same batch."""
    prob = pt.random_problem(torch.Generator().manual_seed(6), 16, 6, 12,
                             dtype=torch.float32, device="cpu")
    tb = pt.batch_problems(prob, 1024, torch.Generator().manual_seed(12))
    em = pt.solve_kkt(tb)
    fl = pt.solve_kkt(tb, options=pt.SolveOptions(flat_planes=True))
    assert rel_err(fl.numpy(), em.numpy()) < 1e-6


def _walk(plan, N, B, n, m):
    """Walk the plan as ``row_level_kernel`` does: block (x, y), thread
    (slot, z) takes knot ``y * LEVEL_KB - shift + z`` and row groups
    ``slot, slot + slots, ...``. Returns the store count of every (slab
    row, knot) pair, the block of every knot and the batch columns'
    counts."""
    kb, rpt = schur.LEVEL_KB, schur.LEVEL_RPT
    nl, nx, nu = plan.groups
    rows = (n, n, m)
    count = [np.zeros((r, N), dtype=int) for r in rows]
    block = np.full(N, -1)
    gx, gy = plan.grid
    for y in range(gy):
        for z in range(kb):
            k = y * kb - plan.shift + z
            if not 0 <= k < N:
                continue
            block[k] = y
            for slot in range(plan.slots):
                for rg in range(slot, nl + nx + nu, plan.slots):
                    slab = 0 if rg < nl else (1 if rg < nl + nx else 2)
                    i0 = (rg - slab * nl) * rpt
                    live = [i for i in range(i0, i0 + rpt) if i < rows[slab]]
                    assert live, f"row group {rg} takes no row"
                    count[slab][live, k] += 1
    cols = np.zeros(gx * schur.LEVEL_TB, dtype=int)
    for x in range(gx):
        cols[x * schur.LEVEL_TB:(x + 1) * schur.LEVEL_TB] += 1
    return count, block, cols


@pytest.mark.parametrize("m", [1, 3, 8, 9, 33, 64])
@pytest.mark.parametrize("n", range(1, 9))
def test_level_plan_covers_every_row_and_knot_once(n, m):
    N, B = 64, 40
    for level, emit in ((0, True), (1, True), (2, False), (4, False)):
        plan = schur._level_plan(N, B, emit, n, m)
        assert plan.groups == (-(-n // 3), -(-n // 3), -(-m // 3))
        assert plan.slots == min(sum(plan.groups), schur.LEVEL_SLOTS)
        threads = schur.LEVEL_TB * plan.slots * schur.LEVEL_KB
        assert threads <= 1024
        count, block, cols = _walk(plan, N, B, n, m)
        assert all((c == 1).all() for c in count)
        assert (cols[:B] == 1).all() and len(cols) - B < schur.LEVEL_TB
        # The C launcher's own check of the plan (row_plan_ok).
        assert plan.grid[1] * schur.LEVEL_KB - plan.shift >= N
        if emit:  # each emitting group's rows r and r + 1 share a block
            span = 2 << level
            for g2 in range(N // (2 * span)):
                r = g2 * 2 * span + span - 1
                assert block[r] == block[r + 1]


@pytest.mark.parametrize("nm", [(9, 3), (6, 65), (0, 3), (6, 0)])
def test_check_raises_past_the_block_limits(nm):
    with pytest.raises(ValueError, match=r"state dims n in 1\.\.8 and input "
                                         r"dims m in 1\.\.64"):
        schur._check("t", [], [], *nm, torch.device("cuda"))


@pytest.mark.parametrize("nm", [(1, 1), (8, 8), (6, 12), (1, 64), (8, 64)])
def test_check_takes_every_small_state_block(nm):
    schur._check("t", [], [], *nm, torch.device("cuda"))
