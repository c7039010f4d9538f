"""Horizon (sequence) sharding: knot points distributed over a mesh axis.

Counterpart of the JAX package's ``parallel/seq.py``. Each rank owns a
contiguous, power-of-two chunk of ``C = N/D`` knot points. Tree levels
with group span ``2^(L+1) <= C`` are rank-local (the reference's
per-level parallelism, solve.c:68-134, maps onto chunks that never
talk); only the top
``log2(D)`` levels exchange data, and only boundary blocks: each level's
separators sit at chunk boundaries, so all_gathers of first/last-knot
factor blocks feed a separator solve that every rank repeats, and every
Schur update stays local. Per solve that is two dynamics gathers, then per
top level four factor-block gathers in the sweep and four vector gathers
in the RHS pass: ``O(D log D n^2 b)`` bytes, independent of ``N``.

JAX's ``lax.axis_index`` is the rank in the sp group here, a Python int,
so its traced one-hot writes (seq.py:15-18) become static writes that
each rank makes or skips. The stages are the grid path's
(:mod:`rslqr_tpu_torch.rslqr`: ``_group``, ``_stage_*``,
``_rhs_level_core``) on batch-last ``[C, ., ., b]`` chunks, so mid blocks
take :mod:`linalg`'s mat-last route and small blocks its unrolled ops: no
hand kernel runs, as JAX's seq reaches no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import linalg as la
from ..config import SolveOptions, resolve_options
from ..problem import LQRProblem
from ..rslqr import (
    _one_batch_axis,
    _rhs_level_core,
    _stage_cholesky,
    _stage_cholsolve,
    _stage_products,
    _stage_schur,
    _to_batch_last,
)
from ..utils import log2_int
from . import comm
from .mesh import gather_solution, horizon_shard, local_chunk


def _tz(x: int) -> int:
    """Trailing zeros of a positive integer."""
    x = int(x)
    return (x & -x).bit_length() - 1


def _toplevel_hits(dd: int, D: int, local_depth: int, topl: int) -> bool:
    """Does the chunk-last knot of rank ``dd`` sit at global tree level
    ``topl``? Its level is ``local_depth + tz(dd + 1)``."""
    t = topl - local_depth
    return (dd + 1) % (1 << (t + 1)) == (1 << t)


def _top_lambda_mask(d: int, C: int, E: int, device) -> torch.Tensor:
    """Lambda-update mask ``[C, 1, 1, 1]`` of a top level: local knot 0 of
    a rank with ``d % E == 0`` starts a range (masked), except global knot
    0."""
    keep = torch.ones((C, 1, 1, 1), dtype=torch.bool, device=device)
    if d % E == 0 and d != 0:
        keep[0] = False
    return keep


def _local_leaf_solve(p: LQRProblem, d: int, C: int, D: int, depth: int,
                      nb: int = 1):
    """The leaf solves (ref nested_dissection.c:10-105) of rank ``d``'s
    chunk ``p`` (batch-last, ``f`` shifted by one knot: ``f[j] = f[dC + j
    - 1]``, ``x0`` first on rank 0). Returns the per-level factor lists
    (views of stacked ``[depth, C, ., n, *b]`` grids) and the leaf-solved
    RHS ``(zy, zx, zu)``."""
    A, Bm = p.A, p.B
    n, m = A.shape[1], Bm.shape[2]
    dev = A.device
    first, is_last = d == 0, d == D - 1
    local_depth = log2_int(C)
    qinv, rinv = 1.0 / p.Qdiag, 1.0 / p.Rdiag
    qcol = qinv.unsqueeze(-(nb + 1))
    rcol = rinv.unsqueeze(-(nb + 1))
    At, Bt = la.transpose_block(A, nb), la.transpose_block(Bm, nb)
    QiAt, RiBt = At * qcol, Bt * rcol
    Fl = A.new_zeros((depth, C, n, n) + A.shape[3:])
    Fx = torch.zeros_like(Fl)
    Fu = A.new_zeros((depth, C, m, n) + A.shape[3:])
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=dev)

    # RHS (ref solver.c:138-190, negated); global knot 0 keeps its own form.
    zy, zx, zu = -p.f, -p.q, -p.r
    k1 = 1 if first else 0  # the first local knot with global k >= 1
    zx[k1:] *= qinv[k1:]
    ku = C - 1 if is_last else C  # global N-1 has no input
    zu[k1:ku] *= rinv[k1:ku]

    # Own dynamics F[level(k), k] = {Q^-1 A', R^-1 B'} for 1 <= k < N-1:
    # local knots j < C-1 at level tz(j+1); the chunk-last knot at level
    # local_depth + tz(d+1), except on the last rank (global knot N-1).
    js = np.arange(k1, C - 1)
    lv = idx([_tz(j + 1) for j in js])
    Fx[lv, idx(js)] = QiAt[k1:C - 1]
    Fu[lv, idx(js)] = RiBt[k1:C - 1]
    for topl in range(local_depth, depth):
        if _toplevel_hits(d, D, local_depth, topl) and not is_last:
            Fx[topl, C - 1] = QiAt[C - 1]
            Fu[topl, C - 1] = RiBt[C - 1]

    # Previous-step blocks F[level(k-1), k] = -Q_k^-1 for k >= 1 (ref
    # nested_dissection.c:92-102); local knot 0's previous knot is the
    # previous chunk's last, at level local_depth + tz(d).
    eye = torch.eye(n, dtype=A.dtype, device=dev).reshape(
        (1, n, n) + (1,) * nb)
    negQi = -eye * qcol
    js = np.arange(1, C)
    Fx[idx([_tz(j) for j in js]), idx(js)] = negQi[1:]
    for topl in range(local_depth, depth):
        if _toplevel_hits(d - 1, D, local_depth, topl) and not first:
            Fx[topl, 0] = negQi[0]

    # Global knot 0 (rank 0 only, ref nested_dissection.c:24-58).
    if first:
        Fl[0, 0] = -At[0]
        Fu[0, 0] = RiBt[0]
        zy0 = zy[0].clone()
        zy[0] = -p.Qdiag[0] * zy0 - zx[0]
        zx[0] = -zy0
        zu[0] = zu[0] * rinv[0]
    return (list(Fl.unbind(0)), list(Fx.unbind(0)), list(Fu.unbind(0)),
            zy, zx, zu)


def _sweep_core_sharded_local(p, level, depth, Fls, Fxs, Fus, chols, nb, d,
                              opts):
    """One rank-local level of the sweep (``rslqr._sweep_level_core``) with
    the knot-0 lambda exemption on rank 0 only."""
    Ss = _stage_products(p, level, depth, Fls, Fxs, Fus, nb, opts)
    Lc = _stage_cholesky(Ss, nb, opts)
    chols.append(Lc)
    fsols = _stage_cholsolve(Lc, Ss, nb, opts)
    _stage_schur(level, depth, Fls, Fxs, Fus, Ss, fsols, nb, opts,
                 knot0=d == 0)


def _top_devices(level: int, C: int, D: int):
    """``(E, span_dev, a_dev, b_dev)`` of a top level: each separator's
    left knot is the last of rank ``a_dev``, its right knot the first of
    ``b_dev``."""
    E = (1 << level) // C
    span_dev = 2 * E
    a_dev = (2 * np.arange(D // span_dev) + 1) * E - 1
    return E, span_dev, list(a_dev), list(a_dev + 1)


def solve_seq_sharded(
    prob: LQRProblem,
    mesh,
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    options: Optional[SolveOptions] = None,
) -> torch.Tensor:
    """Horizon-sharded rsLQR solve over ``mesh[sp_axis]`` ranks.

    Every rank passes the same global ``prob`` (leading batch axes
    optional; the batch is sharded over ``dp_axis`` when given) and gets
    back the full KKT vector(s) ``[*batch, nvars]``, the values of
    :func:`rslqr_tpu_torch.solve_kkt`. ``options`` pins the linalg
    dispatch (threshold, kernel mode) as in the single-device solve.
    """
    opts = resolve_options(options)
    flat, bshape = _one_batch_axis(prob)
    hs = horizon_shard(flat, mesh, sp_axis, dp_axis)
    N, D, d, C, group = hs.N, hs.D, hs.d, hs.C, hs.group
    depth, local_depth = log2_int(N), log2_int(C)
    nb = 1

    # The RHS needs f shifted by one knot with x0 in front (zy[k] =
    # -f[k-1], zy[0] = -x0; ref solver.c:138-176), taken globally.
    pbl = _to_batch_last(flat, 1)
    pbl = dataclasses.replace(pbl, f=torch.cat([pbl.x0[None], pbl.f[:-1]]))
    p = local_chunk(pbl, hs)

    Fls, Fxs, Fus, zy, zx, zu = _local_leaf_solve(p, d, C, D, depth, nb)
    chols: list = []
    for level in range(local_depth):  # communication-free
        _sweep_core_sharded_local(p, level, depth, Fls, Fxs, Fus, chols, nb,
                                  d, opts)

    # Top levels: boundary-block all_gathers, the separator solve on every
    # rank, local Schur updates.
    A_last = comm.all_gather(p.A[C - 1], group)  # [D, n, n, b]
    B_last = comm.all_gather(p.B[C - 1], group)
    top_chols = []
    for level in range(local_depth, depth):
        E, span_dev, a_dev, b_dev = _top_devices(level, C, D)
        ups = range(level, depth)
        gather = lambda F, j: comm.all_gather(
            torch.stack([F[u][j] for u in ups]), group)  # [D, U, ., n, b]
        lasts_x, lasts_u = gather(Fxs, C - 1), gather(Fus, C - 1)
        firsts_x, firsts_l = gather(Fxs, 0), gather(Fls, 0)
        # Inner products of every separator of this level, all upper fact
        # levels (ref nested_dissection.c:114-134): S [U, G_top, n, n, b].
        S = (la.bgemm(A_last[a_dev][None], lasts_x[a_dev].movedim(0, 1), nb,
                      opts)
             + la.bgemm(B_last[a_dev][None], lasts_u[a_dev].movedim(0, 1),
                        nb, opts)
             - firsts_x[b_dev].movedim(0, 1) - firsts_l[b_dev].movedim(0, 1))
        Lc = la.bcholesky(S[0], nb, opts)  # [G_top, n, n, b], on every rank
        top_chols.append(Lc)
        if level + 1 < depth:
            f_my = la.bcho_solve(Lc[None], S[1:], nb, opts)[:, d // span_dev]
            if d % span_dev == E:  # owner of the separator's right knot
                for ui, u in enumerate(range(level + 1, depth)):
                    Fls[u][0] = f_my[ui]
            # Local Schur updates (ref solve.c:119-131).
            keep = _top_lambda_mask(d, C, E, zy.device)
            for ui, u in enumerate(range(level + 1, depth)):
                fu = f_my[ui][None]
                Fls[u].sub_(torch.where(keep, la.bgemm(Fls[level], fu, nb,
                                                       opts), 0.0))
                Fxs[u].sub_(la.bgemm(Fxs[level], fu, nb, opts))
                Fus[u].sub_(la.bgemm(Fus[level], fu, nb, opts))

    # RHS sweep (ref solve.c:137-182).
    for level in range(local_depth):
        zy, zx, zu = _rhs_level_core(
            p, level, Fls[level], Fxs[level], Fus[level], chols[level], zy,
            zx, zu, nb, opts, knot0=d == 0)
    for li, level in enumerate(range(local_depth, depth)):
        E, span_dev, a_dev, b_dev = _top_devices(level, C, D)
        last_zx = comm.all_gather(zx[C - 1], group)  # [D, n, b]
        last_zu = comm.all_gather(zu[C - 1], group)
        first_zx = comm.all_gather(zx[0], group)
        first_zy = comm.all_gather(zy[0], group)
        znew = (la.bgemv(A_last[a_dev], last_zx[a_dev], nb)
                + la.bgemv(B_last[a_dev], last_zu[a_dev], nb)
                - first_zx[b_dev] - first_zy[b_dev])
        zb_my = la.bcho_solve_vec(top_chols[li], znew, nb,
                                  opts)[d // span_dev]  # [n, b]
        if d % span_dev == E:
            zy = zy.clone()
            zy[0] = zb_my
        keep = _top_lambda_mask(d, C, E, zy.device)[:, :, 0]  # [C, 1, 1]
        fv = zb_my[None]
        zy = zy - torch.where(keep, la.bgemv(Fls[level], fv, nb), 0.0)
        zx = zx - la.bgemv(Fxs[level], fv, nb)
        zu = zu - la.bgemv(Fus[level], fv, nb)

    kkt = gather_solution(hs, zy, zx, zu)
    return kkt.reshape(bshape + kkt.shape[-1:])
