"""Port tests: gradients through the solvers (``rslqr_tpu_torch.autodiff``)
against ``jax.grad`` of the JAX package's solvers, on the same f64 inputs,
CPU.

The loss touches every output: ``L = Σ U² + <wX, X> + <wY, Y>`` with fixed
seeded weights. Every field's gradient (``c`` and the unused last knot
included, both zero) is held to ``max|Δ| / (1 + max|ref|) <= 1e-8``. The
routes: the element-major path on one problem and on a batch of 4, the
grid path, a mid block (nx=12, nu=4, N=8: the plane route), the parallel
scan and the Riccati oracle (plain autograd). The JAX side runs one
jitted single-problem ``jax.grad`` per instance, rsLQR and pscan on JAX's
grid layout (the same functions as its other routes, the quickest to
compile) and the mid block through JAX's Riccati oracle (its mid-block
rsLQR gradient compiles for ~30 s on the CPU; the gradient is the same).
The f32 gradients (refined backward) within 1e-6 of the f64 ones, on
every route but Riccati. Then
tests/test_rslqr.py:241-259 on a ``random_problem`` (its ``prob8`` needs
an absent golden file): the
gradient of ``Σ U²`` w.r.t. ``q`` against a central difference at
``q[2, 1]``, bar ``1e-4 · max(1, |fd|)``; the caller's fields are left as
they were; and no graph is built when no field requires grad.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err, to_numpy

import rslqr_tpu as rt
from rslqr_tpu import pscan as jpscan
from rslqr_tpu import riccati as jriccati
from rslqr_tpu import rslqr as jrslqr
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import autodiff

BAR = 1e-8
FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")
PG = pt.SolveOptions(layout="grid")
JG = JaxOptions(layout="grid")

# name: (N, n, m, batch, port solver, JAX solver)
ROUTES = {
    "em": (16, 4, 2, 0, pt.solve, "rslqr"),
    "em_batch": (16, 4, 2, 4, pt.solve, "rslqr"),
    "grid": (16, 4, 2, 0, lambda p: pt.solve(p, options=PG), "rslqr"),
    "mid_block": (8, 12, 4, 0, pt.solve, "riccati"),
    "pscan": (16, 4, 2, 4, pt.solve_pscan, "pscan"),
    "riccati": (16, 4, 2, 0, pt.solve_riccati, "riccati"),
}
JAX_SOLVERS = {
    "rslqr": lambda p: jrslqr.solve(p, options=JG),
    "pscan": lambda p: jpscan.solve_pscan(p, options=JG),
    "riccati": jriccati.solve_riccati,
}


def _problem(N, n, m, B, seed=3):
    prob = rt.random_problem(jax.random.PRNGKey(seed + n), N, n, m,
                             jnp.float64)
    if B:
        prob = rt.batch_problems(
            prob, jax.random.split(jax.random.PRNGKey(11), B))
    return prob


def _weights(prob):
    rng = np.random.default_rng(5)
    shape = np.asarray(prob.q).shape
    return rng.standard_normal(shape), rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(kind):
    solver = JAX_SOLVERS[kind]

    def loss(fields, wX, wY):
        sol = solver(rt.LQRProblem(**fields))
        return (jnp.sum(sol.U ** 2) + jnp.sum(wX * sol.X)
                + jnp.sum(wY * sol.Y))

    return jax.jit(jax.grad(loss))


def _jax_grads(prob, kind, wX, wY):
    """``jax.grad`` of the loss, one instance at a time."""
    fn = _jax_grad_fn(kind)
    fields = {k: getattr(prob, k) for k in FIELDS}
    if wX.ndim == 2:
        return {k: np.asarray(v) for k, v in fn(fields, wX, wY).items()}
    per = [fn({k: v[i] for k, v in fields.items()}, wX[i], wY[i])
           for i in range(wX.shape[0])]
    return {k: np.stack([np.asarray(g[k]) for g in per]) for k in FIELDS}


def _port_grads(prob, solver, wX, wY):
    p = pt.problem_from_numpy(prob, device="cpu")
    leaves = {k: getattr(p, k).clone().requires_grad_(True) for k in FIELDS}
    sol = solver(dataclasses.replace(p, **leaves))
    loss = ((sol.U ** 2).sum() + (torch.as_tensor(wX) * sol.X).sum()
            + (torch.as_tensor(wY) * sol.Y).sum())
    grads = torch.autograd.grad(loss, [leaves[k] for k in FIELDS],
                                allow_unused=True)  # Riccati: c unused
    return {k: np.zeros(leaves[k].shape) if g is None else to_numpy(g)
            for k, g in zip(FIELDS, grads)}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    N, n, m, B, psolve, jsolve = ROUTES[request.param]
    prob = _problem(N, n, m, B)
    wX, wY = _weights(prob)
    return (request.param, _port_grads(prob, psolve, wX, wY),
            _jax_grads(prob, jsolve, wX, wY))


@pytest.mark.parametrize("field", FIELDS)
def test_gradient_matches_jax(route, field):
    name, got, ref = route
    assert got[field].shape == ref[field].shape
    assert np.isfinite(got[field]).all()
    err = rel_err(got[field], ref[field])
    assert err <= BAR, f"{name} d/d{field}: rel err {err:.3e}"


@pytest.mark.parametrize("name", ["em", "pscan"])
def test_unused_entries_get_zero(name):
    """``c``, the unused last knot of A, B, f, Rdiag, r: exact zeros."""
    N, n, m, B, psolve, _ = ROUTES[name]
    prob = _problem(N, n, m, B)
    got = _port_grads(prob, psolve, *_weights(prob))
    assert not got["c"].any()
    for k in ("A", "B", "f", "Rdiag", "r"):
        knot = got[k].ndim - (3 if k in ("A", "B") else 2)
        assert not np.take(got[k], -1, axis=knot).any(), k


def test_gradient_central_difference():
    """tests/test_rslqr.py:241-259 on a random_problem: d(Σ U²)/dq at
    q[2, 1] against a central difference of the port's f64 solve."""
    prob = pt.problem_from_numpy(_problem(16, 4, 2, 0, seed=8), device="cpu")

    def loss(q):
        return (pt.solve(dataclasses.replace(prob, q=q)).U ** 2).sum()

    q = prob.q.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(q), [q])
    assert g.shape == prob.q.shape and bool(torch.isfinite(g).all())
    eps = 1e-6
    e = torch.zeros_like(prob.q)
    e[2, 1] = eps
    with torch.no_grad():
        fd = float((loss(prob.q + e) - loss(prob.q - e)) / (2 * eps))
    assert abs(float(g[2, 1]) - fd) < 1e-4 * max(1.0, abs(fd))


@pytest.mark.parametrize("name", ["em_batch", "grid", "mid_block", "pscan"])
def test_fields_unchanged(name):
    """Forward and backward leave the caller's fields as they were."""
    N, n, m, B, psolve, _ = ROUTES[name]
    prob = pt.problem_from_numpy(_problem(N, n, m, B), device="cpu")
    leaves = {k: getattr(prob, k).clone().requires_grad_(True)
              for k in FIELDS}
    before = {k: v.detach().clone() for k, v in leaves.items()}
    sol = psolve(dataclasses.replace(prob, **leaves))
    (sol.U.sum() + sol.X.sum() + sol.Y.sum()).backward()
    for k in FIELDS:
        assert torch.equal(leaves[k].detach(), before[k]), k


def test_no_graph_without_grad(monkeypatch):
    """No field requires grad, or grad is off: the solvers never enter the
    autograd Functions and return tensors without a graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("autograd Function entered")

    monkeypatch.setattr(autodiff._RsLqrSolve, "apply", refuse)
    monkeypatch.setattr(autodiff._PscanSolve, "apply", refuse)
    prob = pt.problem_from_numpy(_problem(16, 4, 2, 2), device="cpu")
    for solve in (pt.solve_kkt, pt.solve_pscan_kkt):
        out = solve(prob)
        assert out.grad_fn is None and not out.requires_grad
    leafy = dataclasses.replace(prob, q=prob.q.clone().requires_grad_(True))
    with torch.no_grad():
        for solve in (pt.solve_kkt, pt.solve_pscan_kkt):
            out = solve(leafy)
            assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("name", ["em", "em_batch", "grid", "mid_block",
                                  "pscan"])
def test_f32_gradient_is_refined(name):
    """Below f64 the backward refines ``w`` and ``z`` once (f64 residuals,
    corrections through the f32 factorization, or by f32 scans): the f32
    gradient of every field lies within 1e-6 relative of the f64 one
    (unrefined, the mid block's dA lies 1.7e-6 away)."""
    N, n, m, B, psolve, kind = ROUTES[name]
    prob = _problem(N, n, m, B)
    wX, wY = _weights(prob)
    ref = _jax_grads(prob, kind, wX, wY)
    p32 = jax.tree.map(lambda x: np.asarray(x, np.float32), prob)
    got = _port_grads(p32, psolve, wX, wY)
    for k in FIELDS:
        assert got[k].dtype == np.float32
        assert rel_err(got[k], ref[k]) <= 1e-6, k


def test_refined_solves_build_no_graph():
    """The refined solves loop on the host and have no gradient path: they
    run under no_grad, so a field that requires grad gets no graph."""
    prob = pt.problem_from_numpy(_problem(16, 4, 2, 2), device="cpu")
    leafy = dataclasses.replace(prob, q=prob.q.clone().requires_grad_(True))
    sol = pt.solve_refined(leafy, iterations=1)
    assert sol.Y.grad_fn is None and not sol.Y.requires_grad
    kkt, _ = pt.solve_refined_device(leafy, iterations=1)
    assert np.isfinite(kkt).all()
