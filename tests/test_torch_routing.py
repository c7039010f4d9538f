"""Port tests: the kernel router and the launch plans of the redesigned
kernels.

* The router (``ops.schur.kernel_applies``, the one rule of every kernel
  wrapper, B1-B12 and the probes): a CUDA kernel runs for float32 on a
  CUDA device under ``kernels="auto"``, whatever the block size (a wrapper
  whose kernels do not take a block size raises: its ``_check``);
  everything else runs the plain stages, as the reference sends non-f32
  data to XLA. The rule is a function of the device type, so its CUDA
  decisions are checked here on ``torch.device("cuda")`` without a card.
* Default-option solves on the CPU (the plain stages) at block sizes
  other than (6, 3), against ``rslqr_tpu`` on the same problems: f64 at
  ``1e-10 * (1 + max|ref|)`` (the bar of tests/test_torch_rslqr.py and
  tests/test_torch_pscan.py); f32 against JAX's f32 solve at ``1e-5``
  relative (two f32 solvers summing in another order).
* The launch plans computed in Python (``planes._flagged_plan`` for
  ``flagged_kernel``, ``schur._level_plan`` for ``flat_level_kernel``),
  walked the way the CUDA kernels walk them: every output entry (the lower
  triangle under ``sym``, mirrored once) and every plane element is covered
  exactly once; every knot and batch column once, each emitting group's
  separator row and the row after it in one block, and every slab row of
  every block size 1 <= n, m <= 8 by one thread (the wide inputs, m > 8:
  tests/test_torch_wide_input.py).
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
from rslqr_tpu import pscan as jps
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import linalg
from rslqr_tpu_torch.ops import flat, planes, schur

CPU, CUDA, META = (torch.device(d) for d in ("cpu", "cuda", "meta"))
DTYPES = (torch.float32, torch.float64, torch.bfloat16)

# ---------------------------------------------------------------------------
# The router.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("device", [CPU, CUDA])
@pytest.mark.parametrize("nm", [(6, 3), (4, 2), (8, 8), (6, 2), (3, 6)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_schur_router(dtype, nm, device, kernels):
    """The rule does not look at the block size: every small block has a
    kernel (``csrc/small_blocks.cuh``), and past a state dim of 8 the
    wrapper raises (past an input dim of 64: tests/test_torch_wide_input.py)."""
    want = (kernels == "auto" and device.type == "cuda"
            and dtype == torch.float32)
    assert schur.kernel_applies(kernels, device, dtype) is want
    assert 1 <= min(nm) and max(nm) <= schur.MAX_STATE <= schur.MAX_INPUT
    schur._check("t", [], [], *nm, device)  # the kernels take the block
    with pytest.raises(ValueError, match=r"state dims n in 1\.\.8"):
        schur._check("t", [], [], nm[0] + schur.MAX_STATE, nm[1], device)


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("device", [CPU, CUDA])
@pytest.mark.parametrize("dims", [(36,), (36, 12, 36), (1, 64), (12, 65),
                                  (0, 12)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_planes_router(dtype, dims, device, kernels):
    """The plane wrappers take the same rule; block dims outside 1..64
    raise in their ``_check`` instead of running plain on the card."""
    want = (kernels == "auto" and device.type == "cuda"
            and dtype == torch.float32)
    assert planes.kernel_applies(kernels, device, dtype) is want
    if not all(1 <= d <= planes.MAX_BLOCK for d in dims):
        with pytest.raises(ValueError, match="block dims 1..64"):
            planes._check("t", [torch.zeros(1)], [(1,)], dims)


def test_router_raises_on_unknown_mode_or_device():
    """An unknown mode raises everywhere; a device with no kernels raises
    under ``"auto"`` and takes the plain version under ``"off"``."""
    for rule in (schur.kernel_applies, planes.kernel_applies):
        with pytest.raises(ValueError, match="kernel mode"):
            rule("on", CPU, torch.float32)
        with pytest.raises(RuntimeError, match="no kernel"):
            rule("auto", META, torch.float32)
        assert rule("off", META, torch.float32) is False


def test_mid_route_mode():
    """``linalg._mid``: small dims stay on the small-block route; mid dims
    take the plane route with the options' mode, which the plane wrappers
    route by the rule (so the decision lives in one place)."""
    A = torch.zeros(36, 36, 4, dtype=torch.float64)
    assert linalg._mid(6, A, 1, None) is None
    assert linalg._mid(36, A, 1, None) == "auto"
    assert linalg._mid(36, A.float(), 1, pt.SolveOptions(kernels="off")) \
        == "off"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrappers_take_plain_route_where_no_kernel_applies(dtype):
    """A wrapper whose kernel does not apply returns its plain version's
    result and counts no launch (here: CPU tensors, at (4, 2))."""
    g = torch.Generator().manual_seed(0)
    R = lambda *s: torch.randn(s, generator=g, dtype=dtype)
    n4, m2, N, B, level = 4, 2, 16, 8, 1
    G = N >> (level + 1)
    args = [R(n4 * n4, N, B), R(n4 * n4, N, B), R(m2 * n4, N, B), R(n4, N, B),
            R(n4, N, B), R(m2, N, B), R(G, n4, B)]
    ref = schur.rhs_update_level_em_plain(
        *[a.clone() for a in args], level=level, n=n4, m=m2)
    schur.reset_launch_counts()
    got = schur.rhs_update_level_em(*[a.clone() for a in args], level=level,
                                    n=n4, m=m2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert sum(schur.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# Default-option solves on the plain stages, against rslqr_tpu.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _di_case(N, nx, nu, B, f32):
    """(JAX batch, port batch on the CPU, JAX reference KKT vectors) of a
    perturbed problem with ``nx`` states and ``nu`` inputs: the double
    integrator where it exists (``nx = 2 nu``), else ``random_problem``."""
    dtype = jnp.float32 if f32 else jnp.float64
    prob = (rt.double_integrator_problem(N, nstates=nx, ninputs=nu,
                                         dtype=dtype) if nx == 2 * nu else
            rt.random_problem(jax.random.PRNGKey(nx), N, nx, nu, dtype))
    batch = rt.batch_problems(prob,
                              jax.random.split(jax.random.PRNGKey(N + nx), B))
    ref = jax.jit(lambda p: rt.solve_kkt(p, options=JaxOptions(
        pallas="off")))(batch)
    return batch, pt.problem_from_numpy(batch, device="cpu"), np.asarray(ref)


@pytest.mark.parametrize("nx,nu", [(4, 2), (8, 8), (6, 3)])
def test_f64_solve_default_options_matches_jax(nx, nu):
    _, tb, ref = _di_case(16, nx, nu, 8, False)
    got = pt.solve_kkt(tb)
    assert got.dtype == torch.float64
    assert rel_err(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("nx,nu", [(4, 2), (8, 8)])
def test_f32_solve_default_options_matches_jax(nx, nu):
    """f32 at block sizes other than (6, 3), on the CPU: the plain stages,
    the same sums as JAX's f32 XLA stages in another order (on the card
    the generic instantiations run, tests/test_torch_cuda_kernels.py)."""
    _, tb, ref = _di_case(16, nx, nu, 8, True)
    got = pt.solve_kkt(tb)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < 1e-5


def test_f64_pscan_default_options_matches_jax():
    """The batch-last pscan at (4, 2) in f64, default options."""
    batch, tb, _ = _di_case(16, 4, 2, 8, False)
    ref = jax.jit(lambda p: jps.solve_pscan(p, options=JaxOptions(
        layout="em", pallas="off")))(batch)
    got = pt.solve_pscan_kkt(tb)
    assert rel_err(got.numpy(), np.asarray(ref.kkt_vector())) < 1e-10


# ---------------------------------------------------------------------------
# Launch plans.
# ---------------------------------------------------------------------------


def _flagged_cover(p, q, F, sym):
    """Walk ``flagged_kernel``'s plan as the kernel does: per tile, warp
    ``w`` takes rows ``r0 + FLAG_IB*w ..`` (stopping where they all lie
    above the diagonal under ``sym``), lane ``l`` of grid column ``x``
    plane element ``32x + l``. Returns the store count of each output entry
    and of each plane element."""
    plan = planes._flagged_plan(p, q, F, sym)
    tc, ib = planes.FLAG_TC, planes.FLAG_IB
    count = np.zeros((p, q), dtype=int)
    for r0, c0 in plan.tiles:
        assert 0 <= r0 < p and 0 <= c0 < q
        stored = 0
        for w in range(plan.warps):
            i0 = r0 + w * ib
            if i0 >= p or (sym and i0 + ib - 1 < c0):
                continue
            for i in range(i0, i0 + ib):
                for c in range(c0, c0 + tc):
                    if i < p and c < q and (not sym or c <= i):
                        count[i, c] += 1
                        stored += 1
                        if sym and c != i:
                            count[c, i] += 1
        assert stored, f"tile {(r0, c0)} stores nothing"
    gx, gy = plan.grid
    assert gy == len(plan.tiles) <= 128 and plan.warps in (3, 6)
    lanes = np.zeros(gx * 32, dtype=int)
    for x in range(gx):
        lanes[x * 32:(x + 1) * 32] += 1
    return count, lanes[:F], lanes[F:], plan


@pytest.mark.parametrize("F", [1, 33, 2049, 4096, 130816])
@pytest.mark.parametrize(
    "p,q,sym",
    [(d, d, sym) for d in (1, 5, 12, 36, 40, 64) for sym in (False, True)]
    + [(12, 36, False), (36, 12, False), (5, 64, False), (64, 1, False)])
def test_flagged_plan_covers_once(p, q, sym, F):
    count, live, dead, plan = _flagged_cover(p, q, F, sym)
    assert (count == 1).all()
    assert (live == 1).all() and len(dead) < 32
    assert list(plan.c_tiles) == [v for t in plan.tiles for v in t]


def test_flagged_plan_fills_the_card_at_the_scans_planes():
    """The scan's 36x36 products at F = 8*256 launch 18 tiles (12 under
    sym) per 32 plane elements, where the one-block-per-32 design launched
    64 blocks."""
    assert planes._flagged_plan(36, 36, 2048, False).grid == (64, 18)
    assert planes._flagged_plan(36, 36, 2048, True).grid == (64, 12)
    assert planes._flagged_plan(12, 12, 4096, True).grid == (128, 2)
    # The batched interior's Quu (F = 511*256): two 12x6 tiles, the wide
    # plane's chunks filling the card on their own.
    wide = planes._flagged_plan(12, 12, 511 * 256, True)
    assert wide.grid == (4088, 2)


def _level_cover(N, B, level, emit):
    plan = schur._level_plan(N, B, emit, 6, 3)
    gx, gy = plan.grid
    kb, tb = schur.LEVEL_KB, schur.LEVEL_TB
    knots = np.zeros(N, dtype=int)
    block = np.full(N, -1)
    for y in range(gy):
        for z in range(kb):
            k = y * kb - plan.shift + z
            if 0 <= k < N:
                knots[k] += 1
                block[k] = y
    cols = np.zeros(gx * tb, dtype=int)
    for x in range(gx):
        cols[x * tb:(x + 1) * tb] += 1
    return knots, block, cols, plan


@pytest.mark.parametrize("B", [1024, 33])
@pytest.mark.parametrize("N,level", [(8, 0), (8, 1), (8, 2), (16, 1),
                                     (256, 0), (256, 1), (256, 2), (256, 4),
                                     (256, 6)])
def test_level_plan_covers_once(N, level, B):
    emits = flat._flat_emits(level, N)
    for emit in sorted({False, emits}):
        knots, block, cols, plan = _level_cover(N, B, level, emit)
        assert (knots == 1).all() and (cols[:B] == 1).all()
        assert len(cols) - B < schur.LEVEL_TB
        # The C launcher's own check of the plan.
        assert plan.grid[1] * schur.LEVEL_KB - plan.shift >= N
        if emit:
            span = 2 << level
            for g2 in range(N // (2 * span)):
                r = g2 * 2 * span + span - 1
                assert block[r] == block[r + 1]


@pytest.mark.parametrize("nm", [(n, m) for n in range(1, 9)
                                for m in range(1, 9)])
def test_level_plan_row_groups_cover_once(nm):
    """``flat_level_kernel``'s row groups at every small block: the lambda
    and x slabs' n rows and the u slab's m rows are each taken by one
    thread (groups of LEVEL_RPT, the last one masked past the slab), and no
    group is empty; (6, 3) keeps its 2 + 2 + 1 whole groups."""
    n, m = nm
    plan = schur._level_plan(256, 1024, False, n, m)
    rpt = schur.LEVEL_RPT
    assert plan.groups == (-(-n // rpt), -(-n // rpt), -(-m // rpt))
    if nm == (6, 3):
        assert plan.groups == (2, 2, 1)
    firsts = (0, plan.groups[0], plan.groups[0] + plan.groups[1])
    for slab, rows in enumerate((n, n, m)):
        taken = np.zeros(rows, dtype=int)
        for z in range(firsts[slab], firsts[slab] + plan.groups[slab]):
            i0 = (z - firsts[slab]) * rpt
            live = [i for i in range(i0, i0 + rpt) if i < rows]
            assert live, f"group {z} takes no row"
            taken[live] += 1
        assert (taken == 1).all()
