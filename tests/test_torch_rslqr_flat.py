"""Port tests: the flat-plane rsLQR path, ``rslqr_tpu_torch.rslqr_em``
under ``SolveOptions(flat_planes=True)``, against
``rslqr_tpu.rslqr_em.solve_em`` with its flat Pallas kernels in interpret
mode, on the same f32 problems (B=1024, the smallest batch the flat layout
takes; CPU: the port runs the plain versions through the flat schedule).

Tolerance: ``atol 5e-6 * max|ref|``, the bar at which JAX holds its flat
path to its XLA stages (tests/test_schur_flat.py:68).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions
from rslqr_tpu.ops import schur_planes as jk
from rslqr_tpu.rslqr_em import solve_em as jax_solve_em

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import rslqr_em
from rslqr_tpu_torch.ops import flat, schur

B = 1024
FLAT = pt.SolveOptions(flat_planes=True)
JAX_FLAT = JaxOptions(layout="em", pallas="interpret", flat_planes=True)
JAX_REF = JaxOptions(layout="em", pallas="off")
FLAT_KERNELS = ("leaf_schur_level0_flat", "schur_update_level_flat",
                "rhs_update_level_flat")
EM_KERNELS = ("leaf_schur_level0_em", "schur_update_level_em",
              "schur_update_pair_em", "rhs_update_level_em")


def _wide_problem(N, n, m, seed):
    """The f32 problem of tests/test_schur_flat.py's ``_wide_problem``
    (numpy-seeded; x0 perturbed across the batch), as numpy arrays with a
    leading batch axis of B."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    one = dict(
        A=f32(np.eye(n) + 0.1 * rng.standard_normal((N, n, n))),
        B=f32(0.1 * rng.standard_normal((N, n, m))),
        f=f32(0.01 * rng.standard_normal((N, n))),
        Qdiag=f32(1.0 + rng.random((N, n))),
        Rdiag=f32(1.0 + rng.random((N, m))),
        q=f32(rng.standard_normal((N, n))),
        r=f32(rng.standard_normal((N, m))),
        c=np.zeros((N,), np.float32),
        x0=f32(rng.standard_normal((n,))),
    )
    dx = f32(0.01 * rng.standard_normal((B, n)))
    out = {k: np.broadcast_to(v, (B,) + v.shape).copy()
           for k, v in one.items()}
    out["x0"] = out["x0"] + dx
    return out


def _jax_problem(arrs):
    return rt.problem_from_arrays(*(arrs[k] for k in (
        "A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")))


def _count_calls(monkeypatch, module, names):
    """Count the calls of ``module``'s functions ``names`` (on the CPU every
    call is a plain version; on the card each would be one launch)."""
    calls = collections.Counter()
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture(scope="module", params=[(16, 3, 2), (8, 4, 1)],
                ids=["N16_n3m2", "N8_n4m1"])
def case(request):
    """(N, problem arrays, JAX flat-kernel solution, JAX kernel calls)."""
    N, n, m = request.param
    arrs = _wide_problem(N, n, m, seed=N)
    mp = pytest.MonkeyPatch()
    calls = _count_calls(mp, jk, FLAT_KERNELS)
    try:
        sol = jax_solve_em(_jax_problem(arrs), options=JAX_FLAT)
        want = {k: np.asarray(getattr(sol, k)) for k in ("Y", "X", "U")}
    finally:
        mp.undo()
    return N, arrs, want, dict(calls)


def test_flat_solve_matches_jax_flat_kernels(case, monkeypatch):
    """The port's flat schedule against JAX's flat kernels: every field,
    and the same kernel calls on both sides (none of B1-B4 in the port)."""
    N, arrs, want, jax_calls = case
    depth = N.bit_length() - 1
    expect = {"leaf_schur_level0_flat": 1,
              "schur_update_level_flat": depth - 2,
              "rhs_update_level_flat": depth}
    assert jax_calls == expect
    calls = _count_calls(monkeypatch, flat, FLAT_KERNELS)
    em_calls = _count_calls(monkeypatch, schur, EM_KERNELS)
    prob = pt.problem_from_numpy(arrs, device="cpu")
    sol = rslqr_em.solve_em(prob, options=FLAT)
    assert dict(calls) == expect and sum(em_calls.values()) == 0
    for name in ("Y", "X", "U"):
        got = getattr(sol, name).numpy()
        ref = want[name]
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=5e-6 * np.abs(ref).max(), err_msg=name)


def test_flat_factorization_resolve():
    """The cached factorization through the flat RHS kernel, as
    tests/test_schur_flat.py:71-90: the same RHS again, then a fresh one
    (perturbed cost vectors), each against JAX's XLA stages."""
    arrs = _wide_problem(16, 3, 2, seed=7)
    prob = pt.problem_from_numpy(arrs, device="cpu")
    fact, rhs = rslqr_em.factorize_em(prob, options=FLAT)
    assert all(S.shape == (3, 3, 16 >> (L + 1), B)
               for L, S in enumerate(fact.chols))
    sol = rslqr_em.solve_rhs_em(prob, fact, rhs, options=FLAT)
    prob2 = dataclasses.replace(prob, q=prob.q + 0.01)
    sol2 = rslqr_em.solve_rhs_em(prob2, fact, rslqr_em.leaf_rhs_em(prob2),
                                 options=FLAT)

    jprob = _jax_problem(arrs)
    jprob2 = dataclasses.replace(jprob, q=jprob.q + 0.01)
    for got, jp in ((sol, jprob), (sol2, jprob2)):
        ref = np.asarray(jax_solve_em(jp, options=JAX_REF).X)
        np.testing.assert_allclose(got.X.numpy(), ref, rtol=0,
                                   atol=5e-6 * np.abs(ref).max())
    assert not np.allclose(sol2.X.numpy(), sol.X.numpy())


def test_flat_front_door_and_kernels_off():
    """``solve_kkt`` takes the flat path through the front door; on CPU
    tensors ``kernels="auto"`` is bitwise ``kernels="off"``; off the flat
    path's conditions (B=512) the em schedule runs instead."""
    arrs = _wide_problem(16, 3, 2, seed=3)
    prob = pt.problem_from_numpy(arrs, device="cpu")
    a = pt.solve_kkt(prob, options=FLAT)
    b = pt.solve_kkt(prob, options=pt.SolveOptions(flat_planes=True,
                                                   kernels="off"))
    assert torch.equal(a, b)
    ref = pt.solve_kkt(prob)  # the em schedule, same problem
    assert float((a - ref).abs().max()) <= 5e-6 * float(ref.abs().max())
    half = prob.map(lambda x: x[:512])
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_calls(mp, flat, FLAT_KERNELS)
        pt.solve_kkt(half, options=FLAT)
    assert sum(calls.values()) == 0
