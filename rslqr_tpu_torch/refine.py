"""Mixed-precision iterative refinement: f32 factorization, f64 accuracy.

Counterpart of ``rslqr_tpu.refine``. Factor and solve in float32 (the heavy block work, on the kernel path), then iterate

    r = b - K s            (the KKT residual, in float64)
    delta = K_f32^{-1} r   (a re-solve through the cached f32
                            factorization: the RHS sweep only)
    s <- s + delta

Each iteration multiplies the error by O(kappa * eps_f32), so 2-3
iterations reach f64-limited accuracy on well-conditioned problems.

The card has native float64, so the device-side residual is plain f64
arithmetic; the double-float ``(hi, lo)`` residual of the JAX package
(refine.py:297-440), which exists because the TPU has none, is not ported.

Every entry point takes a problem with any number of leading batch axes and
flattens them to one, and factors on the layout :func:`rslqr_tpu_torch.solve`
would take: the element-major path (its kernels), or the knot-major grid
path (``layout="grid"``, blocks above 64), where every re-solve is one
:func:`rslqr_tpu_torch.rslqr._solve_rhs_bl` sweep over the one
factorization (JAX refine.py:124-130, 195-196, 228). Everything runs on the
problem's device, eagerly; the only host round trips are those of
:func:`solve_refined_host`, by design.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import rslqr_em
from .config import SolveOptions, resolve_options
from .problem import LQRProblem, pack_solution
from .rslqr import (
    RsLqrFactorization,
    RsLqrSolution,
    _bf,
    _factorize_bl,
    _leaf_rhs_transform,
    _one_batch_axis,
    _solve_rhs_bl,
    _to_batch_last,
    _use_em_layout,
)
from .tree import TreeTables, build_tree_tables

# The problem fields the host residual reads.
_HOST_FIELDS = ("A", "B", "f", "q", "r", "Qdiag", "Rdiag", "x0")


def kkt_apply(prob: LQRProblem, Y, X, U):
    """Apply the KKT matrix to ``(Y [N,n,*b], X, U [N,m,*b])``, batch-last
    (``prob`` batch-last too; ``U`` carries the terminal scratch row).

    Block rows (variable ordering solve.h:50-53; matrix structure
    solver.c:122-190):

      y-row k=0:   -x_0
      y-row k>=1:  A_{k-1} x_{k-1} + B_{k-1} u_{k-1} - x_k
      x-row k<N-1: -y_k + Q_k x_k + A_k' y_{k+1}
      x-row N-1:   -y_{N-1} + Q_{N-1} x_{N-1}
      u-row k<N-1: R_k u_k + B_k' y_{k+1}
    """
    nb = prob.A.dim() - 3
    A, B = prob.A[:-1], prob.B[:-1]

    def mv(M, v):  # [K,p,q,*b] @ [K,q,*b]
        return (M * v.unsqueeze(-(nb + 2))).sum(-(nb + 1))

    def mtv(M, v):  # M' @ v
        return (M * v.unsqueeze(-(nb + 1))).sum(-(nb + 2))

    My = torch.cat([-X[:1], mv(A, X[:-1]) + mv(B, U[:-1]) - X[1:]])
    Mx = -Y + prob.Qdiag * X
    Mx = torch.cat([Mx[:-1] + mtv(A, Y[1:]), Mx[-1:]])
    Mu = prob.Rdiag * U
    Mu = torch.cat([Mu[:-1] + mtv(B, Y[1:]), Mu[-1:]])
    return My, Mx, Mu


def kkt_rhs(prob: LQRProblem):
    """The packed KKT right-hand side ``-[x0; q0; r0; f0; q1; ...]``
    (ref solver.c:138-190), in (y, x, u) block form, batch-last."""
    by = torch.cat([-prob.x0[None], -prob.f[:-1]])
    return by, -prob.q, -prob.r


def _residual(pbl: LQRProblem, Y, X, U):
    """``b - K s`` in (ry, rx, ru) block form (batch-last, the scratch u row
    zeroed) and its max norm, a device scalar."""
    by, bx, bu = kkt_rhs(pbl)
    My, Mx, Mu = kkt_apply(pbl, Y, X, U)
    ry, rx, ru = by - My, bx - Mx, bu - Mu
    ru[-1] = 0.0
    res = torch.stack([ry.abs().max(), rx.abs().max(), ru.abs().max()]).max()
    return (ry, rx, ru), res


def _sweep(pbl: LQRProblem, fact, rhs_em, opts):
    """The RHS sweep of an element-major leaf-solved RHS over ``fact``;
    returns batch-last ``(zy, zx, zu)``."""
    zs = rslqr_em.rhs_sweep_em(
        rslqr_em._em(pbl.A), rslqr_em._em(pbl.B), fact, rhs_em, opts
    )
    return tuple(rslqr_em._emv_bl(z) for z in zs)


def _refine_factor_init(prob: LQRProblem, opts: SolveOptions,
                        tables: Optional[TreeTables] = None):
    """Device half: factorization and initial solve of ``prob`` (one
    leading batch axis, in the solve dtype) on the layout ``solve`` would
    take. Returns ``(fact, (zy, zx, zu))`` batch-last, ``zu`` with the
    terminal scratch row."""
    pbl = _to_batch_last(prob, 1)
    if not _use_em_layout(prob, opts):
        t = tables or build_tree_tables(prob.nhorizon)
        fact, rhs = _factorize_bl(pbl, t, 1, opts)
        return fact, _solve_rhs_bl(pbl, fact, rhs, t, opts)
    fact, rhs = rslqr_em.factorize_em(prob, tables, options=opts)
    return fact, _sweep(pbl, fact, rhs, opts)


def _refine_resolve(prob: LQRProblem, fact, r_bl, opts: SolveOptions):
    """Device half of one refinement step: leaf-transform the batch-last
    residual (in the solve dtype) and solve it with the cached
    factorization."""
    pbl = _to_batch_last(prob, 1)
    r_lo = _leaf_rhs_transform(pbl, r_bl)
    if isinstance(fact, RsLqrFactorization):
        t = build_tree_tables(prob.nhorizon)
        return _solve_rhs_bl(pbl, fact, r_lo, t, opts)
    return _sweep(pbl, fact, rslqr_em.em_rhs_from_bl(r_lo), opts)


def _refine(prob: LQRProblem, iterations: int, solve_dtype,
            opts: SolveOptions, tables: Optional[TreeTables] = None):
    """The refinement loop on ``prob``'s device (one leading batch axis):
    factor and solve in ``solve_dtype``, residuals in ``prob``'s dtype.
    Returns batch-last ``(Y, X, U)`` in ``prob``'s dtype (``U`` with the
    scratch row) and the factorization."""
    lo = prob.to(dtype=solve_dtype)
    fact, zs = _refine_factor_init(lo, opts, tables)
    resolve = lambda r: _refine_resolve(
        lo, fact, tuple(v.to(solve_dtype) for v in r), opts)
    return _refine_steps(prob, zs, iterations, resolve), fact


def _refine_steps(prob: LQRProblem, zs, iterations: int, resolve):
    """``iterations`` refinement steps of the batch-last solution ``zs``
    of ``prob`` (one leading batch axis): the residual in ``prob``'s dtype,
    the correction ``resolve(residual)`` (a solve with the same KKT
    matrix). Returns batch-last ``(Y, X, U)`` in ``prob``'s dtype."""
    hi = prob.A.dtype
    pbl = _to_batch_last(prob, 1)
    Y, X, U = (z.to(hi) for z in zs)
    for _ in range(iterations):
        r, _ = _residual(pbl, Y, X, U)
        dy, dx, du = resolve(r)
        Y = Y + dy.to(hi)
        X = X + dx.to(hi)
        U = U + du.to(hi)
    return Y, X, U


@torch.no_grad()
def solve_refined(
    prob: LQRProblem,
    iterations: int = 2,
    solve_dtype=torch.float32,
    tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """rsLQR solve with a ``solve_dtype`` factorization refined to the
    precision of ``prob``'s dtype (pass a float64 problem for full
    accuracy). ``options`` pins the kernel dispatch (for example
    ``flat_planes``) of the factorization and of every re-solve.

    Not differentiable, nor are the other refined entry points: they run
    under ``torch.no_grad()`` and return tensors without a graph, as the
    JAX package's refinement cannot be differentiated either; differentiate
    :func:`rslqr_tpu_torch.solve` instead."""
    one, bshape = _one_batch_axis(prob)
    (Y, X, U), fact = _refine(one, iterations, solve_dtype,
                              resolve_options(options), tables)
    lead = lambda x: _bf(x, 1).reshape(bshape + x.shape[:-1])
    return RsLqrSolution(Y=lead(Y), X=lead(X), U=lead(U[:-1]), fact=fact)


@torch.no_grad()
def _refined_kkt(prob64: LQRProblem, iterations: int, opts: SolveOptions):
    """f32 factorization, f64 residuals on the device: the packed f64 KKT
    vectors ``[*b, nvars]`` and the final max-norm residual (device
    tensors)."""
    one, bshape = _one_batch_axis(prob64)
    (Y, X, U), _ = _refine(one, iterations, torch.float32, opts)
    _, res = _residual(_to_batch_last(one, 1), Y, X, U)
    kkt = pack_solution(_bf(Y, 1), _bf(X, 1), _bf(U[:-1], 1))
    return kkt.reshape(bshape + kkt.shape[-1:]), res


def refined_kkt_device(prob: LQRProblem, iterations: int = 3, options=None):
    """The device entry for f64-accurate batched solves: the problem is
    taken at float32 (its stored precision on the card) and the refinement
    drives the residual of THAT problem to f64 level, with no host round
    trip. Returns ``(kkt_hi, kkt_lo, residual)``: ``kkt_hi`` ``[*b, nvars]``
    is the float32 of the f64 result, ``kkt_lo`` the float32 of the
    remainder (the f64 solution is ``hi + lo``), ``residual`` a device
    scalar.

    ``options`` is ignored: the solve runs with the default options, as the
    JAX package's ``refined_kkt_device`` (refine.py:467) runs with
    ``options=None`` whatever it is given.
    """
    del options
    p64 = prob.to(dtype=torch.float32).to(dtype=torch.float64)
    kkt, res = _refined_kkt(p64, iterations, resolve_options(None))
    hi = kkt.to(torch.float32)
    lo = (kkt - hi.to(torch.float64)).to(torch.float32)
    return hi, lo, res


def solve_refined_device(
    prob: LQRProblem, iterations: int = 3,
    options: Optional[SolveOptions] = None,
):
    """f64-accurate rsLQR solve with the residuals evaluated on the device
    in float64: no per-iteration host round trip.

    Same contract as :func:`solve_refined_host` (pass a float64 problem):
    returns ``(kkt_f64, residual)``, the packed KKT solution as a numpy
    float64 array ``[*b, nvars]`` and the final max-norm KKT residual.
    """
    kkt, res = _refined_kkt(prob.to(dtype=torch.float64), iterations,
                            resolve_options(options))
    return kkt.cpu().numpy(), float(res)


def _np_kkt_residual_rhs(p, Y, X, U):
    """numpy float64 KKT residual ``b - K s`` in (ry, rx, ru) block form.

    Leading-batch arrays ``[*b, N, n|m]``; ``U`` carries the terminal
    scratch row (zeroed in the output). Block rows per :func:`kkt_apply`."""
    A, B = p["A"][..., :-1, :, :], p["B"][..., :-1, :, :]
    mv = lambda M, v: np.einsum("...kij,...kj->...ki", M, v)
    mtv = lambda M, v: np.einsum("...kji,...kj->...ki", M, v)
    My = np.concatenate(
        [-X[..., :1, :],
         mv(A, X[..., :-1, :]) + mv(B, U[..., :-1, :]) - X[..., 1:, :]],
        axis=-2,
    )
    Mx = -Y + p["Qdiag"] * X
    Mx[..., :-1, :] += mtv(A, Y[..., 1:, :])
    Mu = p["Rdiag"] * U
    Mu[..., :-1, :] += mtv(B, Y[..., 1:, :])
    by = np.concatenate(
        [-p["x0"][..., None, :], -p["f"][..., :-1, :]], axis=-2
    )
    ry = by - My
    rx = -p["q"] - Mx
    ru = -p["r"] - Mu
    ru[..., -1, :] = 0.0
    res = max(
        np.max(np.abs(ry)), np.max(np.abs(rx)),
        np.max(np.abs(ru[..., :-1, :])),
    )
    return (ry, rx, ru), float(res)


def _np_pack_solution(Y, X, U):
    """numpy twin of :func:`rslqr_tpu_torch.pack_solution` (leading
    batch)."""
    N = X.shape[-2]
    batch = X.shape[:-2]
    body = np.concatenate(
        [Y[..., : N - 1, :], X[..., : N - 1, :], U], axis=-1
    ).reshape(batch + (-1,))
    tail = np.concatenate([Y[..., N - 1, :], X[..., N - 1, :]], axis=-1)
    return np.concatenate([body, tail], axis=-1)


@torch.no_grad()
def solve_refined_host(
    prob: LQRProblem, iterations: int = 3,
    options: Optional[SolveOptions] = None,
):
    """f64-accurate rsLQR solve with the residuals evaluated in numpy
    float64 on the host.

    ``prob`` is ideally a float64 problem: its full-precision data drives
    the host residuals, while the device half (the factorization and every
    correction solve, on ``prob``'s device) sees a float32 cast. Per
    iteration that costs two trajectory-sized transfers. Returns
    ``(kkt_f64, residual)``: the packed KKT solution as a numpy float64
    array ``[*b, nvars]`` and the final host-evaluated max-norm KKT
    residual.
    """
    opts = resolve_options(options)
    one, bshape = _one_batch_axis(prob)
    prob32 = one.to(dtype=torch.float32)
    dev = prob32.A.device
    fact, zs = _refine_factor_init(prob32, opts)

    def to_np(x):  # batch-last device tensor -> leading-batch numpy f64
        return np.moveaxis(x.to(torch.float64).cpu().numpy(), -1, 0)

    def to_dev(a):  # leading-batch numpy -> batch-last f32 device tensor
        return torch.as_tensor(np.moveaxis(a, 0, -1), dtype=torch.float32,
                               device=dev)

    Y, X, U = (to_np(z) for z in zs)
    p64 = {k: getattr(one, k).to(torch.float64).cpu().numpy()
           for k in _HOST_FIELDS}
    for _ in range(iterations):
        r, _ = _np_kkt_residual_rhs(p64, Y, X, U)
        dy, dx, du = _refine_resolve(
            prob32, fact, tuple(to_dev(v) for v in r), opts
        )
        Y += to_np(dy)
        X += to_np(dx)
        U += to_np(du)
    _, res = _np_kkt_residual_rhs(p64, Y, X, U)
    kkt = _np_pack_solution(Y, X, U[..., :-1, :])
    return kkt.reshape(tuple(bshape) + kkt.shape[-1:]), res
