"""Port tests: ``SolveOptions.factor_dtype`` takes the floating dtype
names ``"float16"``, ``"bfloat16"``, ``"float32"`` and ``"float64"``, which
``rslqr_tpu`` stores its slabs in (``jnp.dtype(...)``,
rslqr_tpu/rslqr_em.py:162-168, 875), on the CPU. (``jnp.dtype`` also takes
numpy's aliases, such as ``"half"``; the port takes these four names and
``""`` alone.)

1. ``"float32"`` on an f32 problem (and ``"float64"`` on an f64 one) is the
   default solve, bit for bit.
2. ``"float16"`` slabs, and ``"float64"`` slabs on an f32 problem, against
   ``rslqr_tpu.solve_kkt_em(..., pallas="off")`` with the same option on
   the same seeded random problem (N=16, nx=6, nu=3, 4 instances, f32).
   Bar: 2^-14 relative (``max|a-b| / (1+max|b|)``), an eighth of f16's unit
   roundoff 2^-11. The f16 slabs move the answer ~6.7e-4 from the f32
   solve, so the bar tells a solve that rounds where JAX's XLA stages round
   (the plain leaf, each level's slabs once) from one that does not; the
   two sum in other orders, which costs ~1e-6. JAX promotes f64 slabs on an
   f32 problem to f64 math; the port keeps the problem dtype, ~1e-6 apart.
   ``"float32"`` slabs on an f64 problem keep the kernel schedule (as JAX's
   kernel path takes f32 slabs), whose products come from the unrounded
   values, while JAX's XLA stages under ``pallas="off"`` form them from the
   stored ones: bar 2^-22 relative, four f32 unit roundoffs (2^-24); the
   two lie ~7.8e-8 apart, and the f32 storage moves the answer ~4e-8 from
   the f64 solve, where f64 slabs move it by no more than ~1e-15.
3. The schedule rule (``rslqr_em._kernel_schedule``) sends such storage to
   the plain leaf and single levels without emission, as JAX's
   ``_pallas_schur_mode`` sends it to its XLA stages, and the routing rule
   (``ops/schur.py:kernel_applies``) keeps it off the kernels on a CUDA
   device; a name that is no floating dtype raises.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import problem_arrays, rel_err

import rslqr_tpu as rt
from rslqr_tpu import rslqr_em as jem
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import rslqr_em
from rslqr_tpu_torch.config import storage_dtype
from rslqr_tpu_torch.ops import schur

BAR = 2.0 ** -14
BAR32 = 2.0 ** -22  # f32 slabs on an f64 problem
OTHER = ("float16", "float64")  # storages the kernels do not take


@functools.lru_cache(maxsize=None)
def _t32():
    """The seeded random problem (N=16, nx=6, nu=3), 4 instances, f32."""
    prob = pt.random_problem(torch.Generator().manual_seed(3), 16, 6, 3,
                             dtype=torch.float64, device="cpu")
    return pt.batch_problems(prob, 4, torch.Generator().manual_seed(1)).to(
        dtype=torch.float32)


def _jax_solve(factor_dtype, dtype=torch.float32):
    """JAX's solve of the same batch (in ``dtype``) with ``factor_dtype``
    slabs (XLA stages, one jitted program of ~3 s), as f64 numpy."""
    b32 = rt.LQRProblem(**{k: jnp.asarray(v) for k, v in problem_arrays(
        _t32().to(dtype=dtype)).items()})
    solve = jax.jit(lambda p: jem.solve_kkt_em(p, options=JaxOptions(
        factor_dtype=factor_dtype, pallas="off")))
    return np.asarray(solve(b32), dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _refs():
    """JAX's three solves, compiled in threads beside the file's first
    tests."""
    pool = ThreadPoolExecutor(len(OTHER) + 1)
    refs = {fd: pool.submit(_jax_solve, fd) for fd in OTHER}
    refs["float32", torch.float64] = pool.submit(_jax_solve, "float32",
                                                  torch.float64)
    return refs


@pytest.fixture(scope="module", autouse=True)
def _start_refs():
    _refs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_own_dtype_name_is_the_default_solve(dtype):
    b = _t32().to(dtype=dtype)
    name = str(dtype).split(".")[1]
    sol = pt.solve(b, options=pt.SolveOptions(factor_dtype=name))
    assert {x.dtype for x in sol.fact.Fxs} == {dtype}
    assert torch.equal(sol.kkt_vector(), pt.solve_kkt(b))


@pytest.mark.parametrize("factor_dtype", OTHER)
def test_slabs_match_jax(factor_dtype):
    t32 = _t32()
    sol = pt.solve(t32, options=pt.SolveOptions(factor_dtype=factor_dtype))
    got = sol.kkt_vector()
    assert got.dtype == torch.float32
    assert {x.dtype for F in (sol.fact.Fls, sol.fact.Fxs, sol.fact.Fus)
            for x in F} == {getattr(torch, factor_dtype)}
    ref = _refs()[factor_dtype].result()
    assert rel_err(got.double(), ref) <= BAR
    if factor_dtype == "float16":  # the storage took effect
        assert rel_err(got, pt.solve_kkt(t32)) > 4 * BAR


def test_f32_slabs_on_f64_problem_match_jax():
    b = _t32().to(dtype=torch.float64)
    sol = pt.solve(b, options=pt.SolveOptions(factor_dtype="float32"))
    got = sol.kkt_vector()
    assert got.dtype == torch.float64
    assert {x.dtype for F in (sol.fact.Fls, sol.fact.Fxs, sol.fact.Fus)
            for x in F} == {torch.float32}
    ref = _refs()["float32", torch.float64].result()
    assert rel_err(got, ref) <= BAR32
    assert rel_err(got, pt.solve_kkt(b)) > 2.0 ** -30  # the storage took effect


def test_schedule_sends_other_storage_to_single_levels(monkeypatch):
    opts = pt.SolveOptions()
    f16, f32, f64 = torch.float16, torch.float32, torch.float64
    sched = lambda fdt, dtype: rslqr_em._kernel_schedule(fdt, 16, 6, opts,
                                                         dtype)
    assert sched(f32, f32) and sched(f32, f64) and sched(f64, f64)
    assert not sched(f16, f32) and not sched(f64, f32)
    assert sched(torch.bfloat16, f32)  # N % 16 == 0
    assert not rslqr_em._flat_path_ok(
        f64, 1, 16, (1024,), 6, pt.SolveOptions(flat_planes=True), f32)
    # The routes: no fused leaf and no pair; single levels, none emitting.
    calls = []
    monkeypatch.setattr(schur, "leaf_schur_level0_em",
                        lambda *a, **k: calls.append("leaf"))
    monkeypatch.setattr(schur, "schur_update_pair_em",
                        lambda *a, **k: calls.append("pair"))
    level = schur.schur_update_level_em

    def spy(*a, **k):
        calls.append(("level", k["level"], a[0].dtype, a[7] is None))
        return level(*a, **k)

    monkeypatch.setattr(schur, "schur_update_level_em", spy)
    t32 = _t32()
    pt.solve(t32, options=pt.SolveOptions(factor_dtype="float16"))
    assert calls == [("level", L, f16, True) for L in range(3)]


def test_routing_keeps_other_storage_off_the_kernels():
    cuda = torch.device("cuda")
    for slabs, want in ((None, True), (torch.float32, True),
                        (torch.bfloat16, True), (torch.float16, False),
                        (torch.float64, False)):
        assert schur.kernel_applies("auto", cuda, torch.float32,
                                    slabs) is want
    assert not schur.kernel_applies("auto", cuda, torch.float64,
                                    torch.float64)
    assert storage_dtype("float16", torch.float32) == torch.float16
    assert storage_dtype("", torch.float64) == torch.float64


@pytest.mark.parametrize("name", ["int32", "planes", "uint8", "float17"])
def test_non_floating_name_raises(name):
    with pytest.raises(ValueError):
        pt.SolveOptions(factor_dtype=name)
