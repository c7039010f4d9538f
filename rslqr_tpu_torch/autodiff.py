"""Gradients through the solvers: the adjoint of the KKT solve.

Counterpart of ``jax.grad`` through the JAX package's ``rslqr.solve`` and
``pscan.solve_pscan`` (tests/test_rslqr.py:241-259). The JAX
solvers are plain XLA, so autodiff traces them. The port's solvers are
not: the element-major sweeps update their slabs in place and the hand
kernels are ctypes calls that autograd cannot see. So the solves run as
``torch.autograd.Function`` s whose backward is one more solve.

The solve computes ``z = K(θ)^-1 b(θ)`` (``b``: :func:`refine.kkt_rhs`,
``K z``: :func:`refine.kkt_apply`). With the loss's gradient ``g = (gY,
gX, gU)`` at ``z``, and ``K`` symmetric, one solve ``K w = g`` gives every
parameter's gradient at once:

    dL/dθ = ∂/∂θ [ wᵀ (b(θ) - K(θ) z) ],   w and z held fixed,

one ``torch.autograd.grad`` of that plain residual. It covers ``A``,
``B``, ``f``, ``Qdiag``, ``Rdiag``, ``q``, ``r`` and ``x0``; ``c`` (not in
the KKT system), the unused last knot of ``A``, ``B``, ``f``, ``Rdiag``
and ``r`` (problem.py:35-36) and the terminal scratch row of ``U`` get an
exact zero.

``w`` solves the *shadow* problem: the same ``A``, ``B``, ``Qdiag`` and
``Rdiag`` with ``x0 = -gY[0]``, ``f[:-1] = -gY[1:]``, ``q = -gX`` and
``r = -gU``, whose KKT right-hand side is ``g``. rsLQR re-solves it through
the factorization that its forward cached (the RHS sweep, as refinement
re-solves: ``rhs_sweep_em`` on the element-major path, ``_solve_rhs_bl``
on the grid path; on the card the sweep's kernels run again). pscan caches
no factorization, so its adjoint is a second scan, of the shadow problem.
Below float64, ``w`` and ``z`` then take one step of refinement each
(:func:`refine._refine_steps`: the residual in float64, the correction by
the same solve), which triples the backward's solves. On a badly scaled
batch that is most of the gradient's accuracy: on the double integrator
at N=256 (max|x| ~2e4) the f32 gradient of ``A`` went from 1.2e-3 to
3.3e-5 of the f64 one, and on the quadruped config's scan from 1.0e-5 to
2.5e-6 (H100, ``chip_smoke.py`` phase 3g). It does not close the gap
between the kernel path and the plain path of rsLQR on the quadruped
config: its f32 solve, and so its gradient, lies ~2x further from f64.

:func:`rslqr_tpu_torch.solve` (and ``solve_kkt``) and
:func:`rslqr_tpu_torch.solve_pscan` (and ``solve_pscan_kkt``) route here
only when grad is enabled and a field requires grad; otherwise they build
no graph and hold nothing for a backward. pscan's gains ``K``, ``d``,
``P`` and ``p`` come back detached: gradients flow through ``Y``, ``X``
and ``U``. ``solve_riccati`` needs no Function: it is plain differentiable
torch ops. ``solve_refined*`` have no gradient path (they loop on the
host), as JAX's cannot be differentiated either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import rslqr
from .config import SolveOptions, resolve_options
from .problem import _FIELDS, LQRProblem
from .pscan import _solve_pscan_impl
from .refine import _refine_resolve, _refine_steps, kkt_apply, kkt_rhs
from .riccati import RiccatiSolution
from .rslqr import RsLqrSolution, _no_tf32, _one_batch_axis, _to_batch_last
from .tree import TreeTables


def wants_grad(prob: LQRProblem) -> bool:
    """Grad is enabled and some field of ``prob`` requires grad."""
    return torch.is_grad_enabled() and any(
        getattr(prob, k).requires_grad for k in _FIELDS)


def _pad_u(U: torch.Tensor) -> torch.Tensor:
    """``[B, N-1, m]`` -> ``[B, N, m]`` with a zero terminal scratch row."""
    return torch.cat([U, U.new_zeros(U.shape[:-2] + (1, U.shape[-1]))], -2)


def _bl(x: torch.Tensor) -> torch.Tensor:
    """One leading batch axis to the back."""
    return x.movedim(0, -1)


def shadow_problem(prob: LQRProblem, gY, gX, gU) -> LQRProblem:
    """The problem whose KKT right-hand side is ``g = (gY, gX, gU)``: the
    same ``A``, ``B``, ``Qdiag``, ``Rdiag``; ``x0 = -gY[0]``, ``f[:-1] =
    -gY[1:]``, ``q = -gX``, ``r[:-1] = -gU`` (one leading batch axis; the
    unused last knot of ``f`` and ``r`` and ``c`` are zero)."""
    zero = lambda x: x.new_zeros(x.shape[:1] + (1,) + x.shape[2:])
    return dataclasses.replace(
        prob,
        x0=-gY[:, 0],
        f=torch.cat([-gY[:, 1:], zero(gY)], 1),
        q=-gX,
        r=torch.cat([-gU, zero(gU)], 1),
        c=torch.zeros_like(prob.c),
    )


def _vjp(fields, needs, z, w):
    """``∂/∂θ [wᵀ (b(θ) - K(θ) z)]`` for the fields in ``needs``, with
    ``z`` and ``w`` batch-last ``(Y, X, U)`` (``U`` with the scratch row)
    held fixed; ``None`` for a field that needs no gradient."""
    with torch.enable_grad():
        th = [f.detach().requires_grad_(need)
              for f, need in zip(fields, needs)]
        pbl = _to_batch_last(LQRProblem(*th), 1)
        s = sum((wi * (bi - ki)).sum() for wi, bi, ki in
                zip(w, kkt_rhs(pbl), kkt_apply(pbl, *z)))
        wrt = [t for t in th if t.requires_grad]
        grads = iter(torch.autograd.grad(s, wrt, allow_unused=True))
    out = []
    for t in th:
        g = next(grads) if t.requires_grad else None
        out.append(torch.zeros_like(t) if t.requires_grad and g is None
                   else g)
    return out


def _no_scratch(w):
    """Zero the terminal scratch row of ``w``'s u block."""
    wy, wx, wu = w
    return wy, wx, torch.cat([wu[:-1], torch.zeros_like(wu[-1:])])


def _z(Y, X, U):
    """Leading-batch ``(Y, X, U [B, N-1, m])`` as batch-last ``(zy, zx,
    zu)`` with the zero scratch row."""
    return _bl(Y), _bl(X), _bl(_pad_u(U))


def _adjoint(prob: LQRProblem, shadow: LQRProblem, z, resolve):
    """``w = K^-1 g`` (``g``: ``shadow``'s KKT right-hand side) by
    ``resolve``, a solve with ``prob``'s KKT matrix of a batch-last RHS in
    the solve dtype; below float64, ``z`` and ``w`` then take one
    refinement step each (f64 residuals, corrections by ``resolve``).
    Returns batch-last ``(z, w)``."""
    w = resolve(kkt_rhs(_to_batch_last(shadow, 1)))
    lo = z[0].dtype
    if lo != torch.float64:
        step = lambda p, s: _refine_steps(
            p.to(dtype=torch.float64), s, 1,
            lambda r: resolve(tuple(v.to(lo) for v in r)))
        z, w = step(prob, z), step(shadow, w)
    return z, _no_scratch(w)


class _RsLqrSolve(torch.autograd.Function):
    """rsLQR solve of a problem with ONE leading batch axis on the route
    :func:`rslqr_tpu_torch.solve` picks; the backward re-solves through the
    cached factorization."""

    @staticmethod
    def forward(ctx, opts: SolveOptions, tables, box: list, *fields):
        # Grad is off here, so this is the plain solve on its own route,
        # inside the front door's ``solve`` span.
        sol = rslqr._solve(LQRProblem(*fields), tables, opts)
        box.append(sol.fact)
        ctx.fact, ctx.opts = sol.fact, opts
        ctx.save_for_backward(*fields, sol.Y, sol.X, sol.U)
        return sol.Y, sol.X, sol.U

    @staticmethod
    @once_differentiable
    def backward(ctx, gY, gX, gU):
        _no_tf32()
        *fields, Y, X, U = ctx.saved_tensors
        prob = LQRProblem(*fields)
        # The shadow problem's RHS is leaf-solved and swept through the
        # forward's factorization.
        z, w = _adjoint(prob, shadow_problem(prob, gY, gX, gU), _z(Y, X, U),
                        lambda r: _refine_resolve(prob, ctx.fact, r,
                                                  ctx.opts))
        ctx.fact = None
        return (None, None, None,
                *_vjp(fields, ctx.needs_input_grad[3:], z, w))


class _PscanSolve(torch.autograd.Function):
    """Parallel-scan solve of a problem with ONE leading batch axis; the
    backward scans the shadow problem. Outputs ``(K, d, P, p, X, U, Y)``;
    the gains come back detached."""

    @staticmethod
    def forward(ctx, opts: SolveOptions, *fields):
        sol = _solve_pscan_impl(LQRProblem(*fields), opts)
        ctx.opts = opts
        ctx.save_for_backward(*fields, sol.Y, sol.X, sol.U)
        ctx.mark_non_differentiable(sol.K, sol.d, sol.P, sol.p)
        return sol.K, sol.d, sol.P, sol.p, sol.X, sol.U, sol.Y

    @staticmethod
    @once_differentiable
    def backward(ctx, gK, gd, gP, gp, gX, gU, gY):
        _no_tf32()
        *fields, Y, X, U = ctx.saved_tensors
        prob = LQRProblem(*fields)

        def scan(r):  # K s = r: the scan of the problem whose RHS is r
            ry, rx, ru = (v.movedim(-1, 0) for v in r)
            s = _solve_pscan_impl(
                shadow_problem(prob, ry, rx, ru[:, :-1]), ctx.opts)
            return _z(s.Y, s.X, s.U)

        z, w = _adjoint(prob, shadow_problem(prob, gY, gX, gU), _z(Y, X, U),
                        scan)
        return (None, *_vjp(fields, ctx.needs_input_grad[1:], z, w))


def _flat_fields(prob: LQRProblem):
    flat, bshape = _one_batch_axis(prob)
    return [getattr(flat, k) for k in _FIELDS], bshape


def solve(prob: LQRProblem, tables: Optional[TreeTables] = None,
          options: Optional[SolveOptions] = None):
    """Differentiable :func:`rslqr_tpu_torch.solve` (which calls it when a
    field requires grad): an :class:`RsLqrSolution` whose ``Y``, ``X``,
    ``U`` carry the adjoint backward."""
    fields, bshape = _flat_fields(prob)
    box: list = []
    Y, X, U = _RsLqrSolve.apply(resolve_options(options), tables, box,
                                *fields)
    unflat = lambda x: x.reshape(bshape + x.shape[1:])
    return RsLqrSolution(Y=unflat(Y), X=unflat(X), U=unflat(U), fact=box[0])


def solve_pscan(prob: LQRProblem, options: Optional[SolveOptions] = None):
    """Differentiable :func:`rslqr_tpu_torch.solve_pscan` (which calls it
    when a field requires grad): a ``RiccatiSolution`` whose ``Y``, ``X``,
    ``U`` carry the adjoint backward; ``K``, ``d``, ``P``, ``p`` detached."""
    fields, bshape = _flat_fields(prob)
    out = _PscanSolve.apply(resolve_options(options), *fields)
    names = ("K", "d", "P", "p", "X", "U", "Y")
    return RiccatiSolution(**{
        k: v.reshape(bshape + v.shape[1:]) for k, v in zip(names, out)})
