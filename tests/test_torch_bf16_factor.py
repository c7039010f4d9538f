"""Port tests: bf16 factor-slab storage (``SolveOptions(factor_dtype=
"bfloat16")``) against ``rslqr_tpu`` on the CPU.

1. The plain versions of B1-B4 with bf16 slabs against the JAX Pallas
   kernels run in interpret mode on the same bf16 slabs (f32 math, one
   rounding at each store, products from the unrounded values): slabs
   equal except for 1-ulp rounding flips in at most 0.1% of the elements
   (the two sides sum in other orders), f32 outputs within 1e-6 relative.
   The block is (n, m) = (2, 1) at N=16: interpret mode compiles the
   kernels' unrolled bodies, ~35 s for one (6, 3) call, ~2.5 s at (2, 1);
   the rounding points do not depend on the block size.
2. The port's bf16 solve on the double integrator (N=16, 4 instances,
   f32) against JAX's (``pallas="off"``): both against the f64 solution,
   the port within 2x of JAX's error (the two round at other points: the
   port runs the kernel path's schedule, JAX on the CPU its XLA stages).
3. The accuracy contract (tests/test_rslqr_em.py:82-132, whose golden
   files are absent): the raw bf16 residual within 2x of JAX's, and
   refinement (f32 factorization on bf16 slabs, f64 residuals) to 1e-6 at
   N=16 and 1e-8 at N=256 with 8 iterations.
4. The routes: ``flat_planes`` with bf16 slabs runs the em schedule; mid
   blocks (nx=12, nu=4) against JAX's bf16 solve; the grid path and the
   parallel scan ignore the option.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu import rslqr_em as jem
from rslqr_tpu.config import SolveOptions as JaxOptions
from rslqr_tpu.ops import schur_pallas as jk

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import rslqr_em
from rslqr_tpu_torch.ops import schur

BF = pt.SolveOptions(factor_dtype="bfloat16")
N, B = 16, 8
n, m = 2, 1
nn, mn = n * n, m * n


# -- 1. the kernels' plain versions --------------------------------------


def _f32(rng, *shape):
    """One random f32 array as (jax array, torch tensor), equal data."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x.copy())


def _bf16(rng, *shape):
    """One random bf16 slab as (jax array, torch tensor), equal bits."""
    t = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _many(make, rng, count, *shape):
    ps = [make(rng, *shape) for _ in range(count)]
    return [p[0] for p in ps], [p[1] for p in ps]


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two bf16 tensors in units in the last place."""
    def key(x):
        v = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(v >= 0, v, -(v + 32768))
    return (key(a) - key(b)).abs()


def _as_torch(x) -> torch.Tensor:
    """A JAX array (bf16 or f32) as a torch tensor, bits kept."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_outputs(got, want):
    """bf16 slabs: equal but for rare 1-ulp flips; f32 outputs within
    1e-6 of their largest value."""
    flips = total = 0
    for g, w in zip(got, want):
        w = _as_torch(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.bfloat16:
            d = _ulps(g, w)
            assert int(d.max()) <= 1
            flips += int((d > 0).sum())
            total += d.numel()
        else:
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert flips <= 1e-3 * total, (flips, total)


def _flat(outs):
    res = []
    for o in outs:
        res.extend(o if isinstance(o, (list, tuple)) else [o])
    return res


def test_rhs_update_bf16_matches_pallas():
    """B2, level 0: bf16 slabs in, f32 z vectors updated."""
    rng = np.random.default_rng(40)
    Fl, Fl_t = _bf16(rng, nn, N, B)
    Fx, Fx_t = _bf16(rng, nn, N, B)
    Fu, Fu_t = _bf16(rng, mn, N, B)
    zs = [_f32(rng, k, N, B) for k in (n, n, m)]
    zb, zb_t = _f32(rng, N // 2, n, B)
    want = jk.rhs_update_level_em(Fl, Fx, Fu, *(z[0] for z in zs), zb,
                                  level=0, n=n, m=m, interpret=True)
    got = schur.rhs_update_level_em(Fl_t, Fx_t, Fu_t, *(z[1] for z in zs),
                                    zb_t, level=0, n=n, m=m)
    _assert_outputs(got, want)


def test_schur_update_level_bf16_matches_pallas():
    """B1, level 1 of depth 4: two upper slabs, the level-2 products
    emitted and folded (bf16 emits at levels 0-3)."""
    level, U = 1, 2
    rng = np.random.default_rng(41)
    FL = [_bf16(rng, k, N, B) for k in (nn, nn, mn)]
    Fls, Fls_t = _many(_bf16, rng, U, nn, N, B)
    Fxs, Fxs_t = _many(_bf16, rng, U, nn, N, B)
    Fus, Fus_t = _many(_bf16, rng, U, mn, N, B)
    fs, fs_t = _many(_f32, rng, U, N >> 2, nn, B)
    As, As_t = _f32(rng, N >> 3, nn, B)
    Bs, Bs_t = _f32(rng, N >> 3, n * m, B)
    assert schur._level_emits(level, N, torch.bfloat16)
    want = jk.schur_update_level_em(*(f[0] for f in FL), Fls, Fxs, Fus, fs,
                                    As, Bs, level=level, n=n, m=m,
                                    interpret=True)
    got = schur.schur_update_level_em(*(f[1] for f in FL), Fls_t, Fxs_t,
                                      Fus_t, fs_t, As_t, Bs_t, level=level,
                                      n=n, m=m)
    assert want[3] is not None and got[3] is not None
    _assert_outputs(_flat(got), _flat(want))


def test_leaf_schur_level0_bf16_matches_pallas():
    """B3 at depth 4: bf16 slabs written from f32 problem data, the
    level-1 products from the unrounded values."""
    depth = 4
    rng = np.random.default_rng(42)
    A, A_t = _f32(rng, nn, N, B)
    Bm, Bm_t = _f32(rng, n * m, N, B)
    q = (0.5 + rng.random((n, N, B))).astype(np.float32)
    r = (0.5 + rng.random((m, N, B))).astype(np.float32)
    S0, S0_t = _f32(rng, N // 2, nn, B)
    fs, fs_t = _many(_f32, rng, depth - 1, N // 2, nn, B)
    As, As_t = _f32(rng, N // 4, nn, B)
    Bs, Bs_t = _f32(rng, N // 4, n * m, B)
    want = jk.leaf_schur_level0_em(
        A, Bm, jnp.asarray(q), jnp.asarray(r), S0, fs, As, Bs, depth=depth,
        n=n, m=m, interpret=True, factor_dtype="bfloat16")
    got = schur.leaf_schur_level0_em(
        A_t, Bm_t, torch.as_tensor(q), torch.as_tensor(r), S0_t, fs_t, As_t,
        Bs_t, depth=depth, n=n, m=m, factor_dtype="bfloat16")
    assert all(x.dtype == torch.bfloat16 for x in got[0] + got[1] + got[2])
    _assert_outputs(_flat(got), _flat(want))


def test_schur_update_pair_bf16_matches_pallas():
    """B4, levels 0 and 1 of depth 4: slab 1 rounded once and read back as
    the level-1 multiplier (as the JAX kernel reads its output block),
    the upper slabs rounded once for both levels, the level-2 products
    emitted."""
    level, U = 0, 3
    rng = np.random.default_rng(43)
    FL = [_bf16(rng, k, N, B) for k in (nn, nn, mn)]
    Fls, Fls_t = _many(_bf16, rng, U, nn, N, B)
    Fxs, Fxs_t = _many(_bf16, rng, U, nn, N, B)
    Fus, Fus_t = _many(_bf16, rng, U, mn, N, B)
    f1, f1_t = _many(_f32, rng, U, N >> 1, nn, B)
    sb, sb_t = _f32(rng, N >> 2, nn, B)
    f2, f2_t = _many(_f32, rng, U - 1, N >> 2, nn, B)
    As, As_t = _f32(rng, N >> 3, nn, B)
    Bs, Bs_t = _f32(rng, N >> 3, n * m, B)
    assert schur._pair_emits(level, N, B, U, n, m, torch.bfloat16)
    want = jk.schur_update_pair_em(*(f[0] for f in FL), Fls, Fxs, Fus, f1,
                                   sb, f2, As, Bs, level=level, n=n, m=m,
                                   interpret=True)
    got = schur.schur_update_pair_em(*(f[1] for f in FL), Fls_t, Fxs_t,
                                     Fus_t, f1_t, sb_t, f2_t, As_t, Bs_t,
                                     level=level, n=n, m=m)
    assert want[3] is not None and got[3] is not None
    _assert_outputs(_flat(got), _flat(want))


@pytest.mark.parametrize("level,NN,expect",
                         [(2, 32, True), (3, 32, True), (3, 64, True),
                          (4, 64, False)])
def test_level_emission_policy_bf16_matches_jax_tiles(level, NN, expect):
    """bf16 slabs emit at levels 0-3 (a knot tile of 16-32), f32 at 0-2."""
    *_, gd2, _ = jk._tiles(level, NN, 128, jnp.bfloat16, 128)
    assert schur._level_emits(level, NN, torch.bfloat16) == (gd2 > 0) \
        == expect


@pytest.mark.parametrize("level,NN,BB,U", [(1, 256, 1024, 6),
                                          (5, 256, 1024, 2), (0, 16, 8, 3)])
def test_pair_emission_policy_bf16_matches_jax_tiles(level, NN, BB, U):
    *_, gd3, _ = jk._tiles_pair(level, NN, BB, jnp.bfloat16, 128,
                                2 * 36 + 18, U)
    assert schur._pair_emits(level, NN, BB, U, 6, 3, torch.bfloat16) == (
        gd3 > 0 and U >= 2)


# -- 2, 3. solves ---------------------------------------------------------


def _jax_bf16(batch):
    """JAX's bf16-slab solve of an f64 batch taken at f32 (XLA stages, one
    jitted program), as f64 numpy."""
    b32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), batch)
    solve = jax.jit(lambda p: jem.solve_kkt_em(p, options=JaxOptions(
        factor_dtype="bfloat16", pallas="off")))
    return np.asarray(solve(b32), dtype=np.float64)


def _di_ref():
    """The double integrator at N=16, 4 seeded instances."""
    prob = rt.double_integrator_problem(16)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(0),
                                                     4))
    return batch, _jax_bf16(batch)


def _mid_ref():
    """A mid-block problem (nx=12, nu=4, N=16), 2 seeded instances."""
    prob = rt.random_problem(jax.random.PRNGKey(3), 16, 12, 4)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(1),
                                                     2))
    return batch, _jax_bf16(batch)


@functools.lru_cache(maxsize=None)
def _refs():
    """The two JAX solves, compiled in threads beside the file's first
    tests (each is one jitted program that takes 10-30 s to compile)."""
    pool = ThreadPoolExecutor(2)
    return pool.submit(_di_ref), pool.submit(_mid_ref)


@pytest.fixture(scope="module", autouse=True)
def _start_refs():
    _refs()


def _di_case():
    """The double-integrator batch, JAX's bf16 solution and its largest
    KKT residual."""
    batch, ref = _refs()[0].result()
    t64 = pt.problem_from_numpy(batch, device="cpu")
    res = float(pt.kkt_residual(t64, torch.as_tensor(ref)).max())
    return batch, ref, res


def test_bf16_solve_matches_jax():
    batch, ref, _ = _di_case()
    t64 = pt.problem_from_numpy(batch, device="cpu")
    t32 = t64.to(dtype=torch.float32)
    sol = pt.solve(t32, options=BF)
    got = sol.kkt_vector().double()
    assert {x.dtype for F in (sol.fact.Fls, sol.fact.Fxs, sol.fact.Fus)
            for x in F} == {torch.bfloat16}
    truth = pt.solve_riccati(t64).kkt_vector()
    e_port, e_jax = rel_err(got, truth), rel_err(ref, truth)
    # The bf16 scale: far above f32's error, and both packages on it.
    e_f32 = rel_err(pt.solve_kkt(t32).double(), truth)
    assert 100 * e_f32 < e_jax
    assert e_port <= 2.0 * e_jax


def test_bf16_raw_residual_is_bounded():
    batch, _, res_jax = _di_case()
    t64 = pt.problem_from_numpy(batch, device="cpu")
    got = pt.solve_kkt(t64.to(dtype=torch.float32), options=BF).double()
    res = float(pt.kkt_residual(t64, got).max())
    assert np.isfinite(res) and res <= 2.0 * res_jax


def test_bf16_refined_n16():
    batch, _, _ = _di_case()
    t64 = pt.problem_from_numpy(batch, device="cpu")
    sol = pt.solve_refined(t64, iterations=8, options=BF)
    assert float(pt.kkt_residual(t64, sol.kkt_vector()).max()) < 1e-6
    assert {x.dtype for x in sol.fact.Fxs} == {torch.bfloat16}


def test_bf16_refined_contract_n256():
    """The contract at production depth (tests/test_rslqr_em.py:113-132):
    8 refinement steps on the bf16 factorization reach 1e-8, here on a
    seeded random problem (nx=6, nu=3). On the double integrator both
    packages contract more slowly at N=256 (ROADMAP C9)."""
    prob = pt.random_problem(torch.Generator().manual_seed(0), 256, 6, 3,
                             dtype=torch.float64, device="cpu")
    b = pt.batch_problems(prob, 2, torch.Generator().manual_seed(1))
    sol = pt.solve_refined(b, iterations=8, options=BF)
    assert float(pt.kkt_residual(b, sol.kkt_vector()).max()) < 1e-8


# -- 4. routes -------------------------------------------------------------


def test_flat_planes_bf16_takes_the_em_schedule():
    """``flat_ok`` takes f32 slabs only (JAX schur_planes.py:316-323, asked
    with the storage dtype): bf16 with ``flat_planes`` is the em solve."""
    opts = pt.SolveOptions(factor_dtype="bfloat16", flat_planes=True)
    assert rslqr_em._flat_path_ok(torch.float32, 1, 16, (1024,), 6, opts)
    assert not rslqr_em._flat_path_ok(torch.bfloat16, 1, 16, (1024,), 6,
                                      opts)
    prob = pt.double_integrator_problem(16, dtype=torch.float32,
                                        device="cpu")
    b = pt.batch_problems(prob, 1024, torch.Generator().manual_seed(2))
    assert torch.equal(pt.solve_kkt(b, options=opts),
                       pt.solve_kkt(b, options=BF))


def test_bf16_schedule_needs_knots_in_sixteens(monkeypatch):
    """The kernel path's schedule for bf16 slabs needs N % 16 == 0 and
    N >= 16 (JAX rslqr_em.py:440-446); at N=8 the plain leaf and single
    levels without emission, every level's slabs rounded once."""
    assert rslqr_em._kernel_schedule(torch.bfloat16, 16, 6, BF)
    assert not rslqr_em._kernel_schedule(torch.bfloat16, 8, 6, BF)
    assert rslqr_em._kernel_schedule(torch.float32, 8, 6, BF)
    calls = []
    level = schur.schur_update_level_em
    monkeypatch.setattr(schur, "leaf_schur_level0_em",
                        lambda *a, **k: calls.append("leaf"))
    monkeypatch.setattr(schur, "schur_update_pair_em",
                        lambda *a, **k: calls.append("pair"))

    def spy(*a, **k):
        calls.append(("level", a[7] is None))
        return level(*a, **k)

    monkeypatch.setattr(schur, "schur_update_level_em", spy)
    prob = pt.double_integrator_problem(8, dtype=torch.float32, device="cpu")
    b = pt.batch_problems(prob, 2, torch.Generator().manual_seed(3))
    sol = pt.solve(b, options=BF)
    assert calls == [("level", True)] * 2  # levels 0 and 1, no emission
    assert {x.dtype for x in sol.fact.Fls} == {torch.bfloat16}
    assert bool(torch.isfinite(sol.kkt_vector()).all())


def test_bf16_mid_block_matches_jax():
    """nx=12, nu=4 (mid blocks): the plain leaf cast to bf16, products on
    upcast slab rows, the plain Schur update rounded once a level (no
    plane kernel takes a bf16 slab: JAX rslqr_em.py:383, linalg.py:128)."""
    jb, ref = _refs()[1].result()
    t64 = pt.problem_from_numpy(jb, device="cpu")
    sol = pt.solve(t64.to(dtype=torch.float32), options=BF)
    assert {x.dtype for x in sol.fact.Fls} == {torch.bfloat16}
    truth = pt.solve_riccati(t64).kkt_vector()
    e_jax = rel_err(ref, truth)
    assert rel_err(sol.kkt_vector().double(), truth) <= 2.0 * e_jax
    assert e_jax > 10 * rel_err(pt.solve_kkt(t64.to(dtype=torch.float32))
                                .double(), truth)


def test_grid_and_pscan_ignore_factor_dtype():
    prob = pt.double_integrator_problem(16, dtype=torch.float32,
                                        device="cpu")
    b = pt.batch_problems(prob, 4, torch.Generator().manual_seed(4))
    grid = pt.SolveOptions(layout="grid")
    assert torch.equal(
        pt.solve_kkt(b, options=pt.SolveOptions(layout="grid",
                                                factor_dtype="bfloat16")),
        pt.solve_kkt(b, options=grid))
    assert torch.equal(pt.solve_pscan_kkt(b, options=BF),
                       pt.solve_pscan_kkt(b))


def test_bf16_option_flows_through_the_entry_points():
    """Gradients (the same autograd Function, reusing the bf16
    factorization: finite, error reported on the card, not barred),
    diagnostics, the per-phase profile and the host/device refinements all
    take the bf16 slabs."""
    import dataclasses

    from rslqr_tpu_torch import diagnostics, profile

    prob = pt.double_integrator_problem(16, dtype=torch.float32,
                                        device="cpu")
    b = pt.batch_problems(prob, 2, torch.Generator().manual_seed(5))
    A = b.A.clone().requires_grad_(True)
    sol = pt.solve(dataclasses.replace(b, A=A), options=BF)
    assert {x.dtype for x in sol.fact.Fus} == {torch.bfloat16}
    (sol.U ** 2).sum().backward()
    assert bool(torch.isfinite(A.grad).all())
    assert bool(diagnostics.factorization_ok(sol.fact).all())
    assert profile.profile_solve(b, options=BF).t_total_ms >= 0
    b64 = b.to(dtype=torch.float64)
    for solve in (pt.solve_refined_host, pt.solve_refined_device):
        _, res = solve(b64, iterations=8, options=BF)
        assert res < 1e-6
