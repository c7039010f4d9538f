"""rsLQR front door: recursive Schur-complement (nested dissection) solve.

Counterpart of ``rslqr_tpu.rslqr``. :func:`solve` routes by
``SolveOptions.layout`` (see :mod:`rslqr_tpu_torch.config`):

* the element-major path of :mod:`rslqr_tpu_torch.rslqr_em` for blocks up
  to 64 (``"auto"``, ``"em"``): leading batch axes are flattened to one (a
  single problem runs as a batch of one), so on CUDA the kernel path is the
  only path;
* the knot-major grid path of this module (``"grid"``, and ``"auto"`` above
  64: the large-block route) on factor grids ``[depth, N, {n,n,m}, n, *b]``
  with the batch axes trailing (JAX rslqr.py:70-495). Its stages call
  :mod:`rslqr_tpu_torch.linalg` on operands with a leading group axis, so
  mid and large blocks take linalg's mat-last route (``torch.matmul`` and
  ``torch.linalg``) and small blocks its unrolled ops: no hand kernel runs
  here, as no Pallas kernel runs on the JAX grid path. A batch runs as one
  batched call per stage, never a loop over instances.

The grid path updates its per-level factor lists in place where the JAX
module uses ``.at[].set``: each list entry is a view of the stacked grid,
so the grids need no final stack. :func:`factorize` / :func:`solve_rhs` /
:func:`leaf_solve_rhs` are the multi-RHS front door (factor once, re-solve
for a new ``x0``, ``q``, ``r`` or ``f``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import linalg as la
from .config import SolveOptions, resolve_options
from .problem import LQRProblem, pack_solution
from .ops.planes import MAX_BLOCK
from .ops.schur import _masks
from .spans import entry, host_copy, span
from .tree import TreeTables, build_tree_tables


@dataclasses.dataclass(frozen=True)
class RsLqrFactorization:
    """The factorization state of the knot-major level sweep.

    Attributes:
      Flambda/Fstate/Finput: ``[depth, N, {n,n,m}, n, *b]`` factor grids
        (the reference's ``fact`` NdData, nddata.h:83-93).
      chol: ``[N-1, n, n, *b]`` lower Cholesky factors of every separator
        Sbar in node order (NdLqrCholeskyFactors, cholesky_factors.h:30-35),
        reused to solve fresh right-hand sides.
      nbatch: number of trailing batch axes.
    """

    Flambda: torch.Tensor
    Fstate: torch.Tensor
    Finput: torch.Tensor
    chol: torch.Tensor
    nbatch: int = 0


@dataclasses.dataclass(frozen=True)
class RsLqrSolution:
    """Solution of one (possibly batched) rsLQR solve: ``Y``/``X`` are
    ``[*batch, N, n]``, ``U`` is ``[*batch, N-1, m]``; ``fact`` is the
    factorization: an :class:`RsLqrFactorization` on the grid path, an
    ``EmFactorization`` (batch flattened to one trailing axis) on the
    element-major one."""

    Y: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    fact: object

    def kkt_vector(self) -> torch.Tensor:
        return pack_solution(self.Y, self.X, self.U)


def _bl(x: torch.Tensor, nlead: int) -> torch.Tensor:
    """Move ``nlead`` leading batch axes to the back (batch-last layout)."""
    if nlead == 0:
        return x
    return x.permute(tuple(range(nlead, x.dim())) + tuple(range(nlead)))


def _bf(x: torch.Tensor, nbatch: int) -> torch.Tensor:
    """Move ``nbatch`` trailing batch axes to the front."""
    if nbatch == 0:
        return x
    nd = x.dim()
    return x.permute(tuple(range(nd - nbatch, nd)) + tuple(range(nd - nbatch)))


def _to_batch_last(prob: LQRProblem, nlead: int) -> LQRProblem:
    return prob.map(lambda x: _bl(x, nlead))


def _num_batch_axes(prob: LQRProblem) -> int:
    return prob.A.dim() - 3


def _no_tf32() -> None:
    """Every front door sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: the plain stages lower to
    batched matmuls, and TF32 would cut them to ~3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _leaf_rhs_transform(prob: LQRProblem, rhs):
    """Leaf-solve an arbitrary RHS given in batch-last ``(zy, zx, zu)``
    block form (``[N, n|m, *b]``) against batch-last ``prob``.

    The z-vector half of ndlqr_SolveLeaf (nested_dissection.c:42-58,
    79-90), a linear map independent of the factors, so it also serves
    fresh right-hand sides (multi-RHS mode, iterative refinement):

      k = 0:   zy' = -Q0 zy - zx;  zx' = -zy;  zu' = R0^{-1} zu
      k >= 1:  zx' = Qk^{-1} zx;   zu' = Rk^{-1} zu (k < N-1);  zy' = zy
    """
    zy, zx, zu = rhs
    zy0 = zy[0]
    zy = torch.cat([(-prob.Qdiag[0] * zy0 - zx[0])[None], zy[1:]])
    zx = torch.cat([-zy0[None], zx[1:] * (1.0 / prob.Qdiag[1:])])
    zu = torch.cat([zu[:-1] * (1.0 / prob.Rdiag[:-1]), zu[-1:]])
    return zy, zx, zu


def _leaf_solve(prob: LQRProblem, levels: np.ndarray, depth: int,
                nb: int = 0):
    """Phase 1: the per-knot leaf solves (ref nested_dissection.c:10-105;
    JAX rslqr.py:127-180) on batch-last ``prob`` with ``nb`` trailing batch
    axes. Q and R are diagonal, so every leaf "Cholesky solve" is a scale
    by 1/diag. Returns the initialized factor grids and the leaf-solved
    RHS."""
    A, Bm = prob.A, prob.B
    N, n, m = A.shape[0], A.shape[1], Bm.shape[2]
    b_shape = A.shape[3:]
    dev = A.device
    qcol = (1.0 / prob.Qdiag).unsqueeze(-(nb + 1))  # [N, n, 1, *b]
    rcol = (1.0 / prob.Rdiag).unsqueeze(-(nb + 1))  # [N, m, 1, *b]

    Flambda = A.new_zeros((depth, N, n, n) + b_shape)
    Fstate = A.new_zeros((depth, N, n, n) + b_shape)
    Finput = A.new_zeros((depth, N, m, n) + b_shape)
    At = la.transpose_block(A, nb)  # [N, n, n, *b]
    Bt = la.transpose_block(Bm, nb)  # [N, m, n, *b]

    # Negated RHS (ref solver.c:187-190): z = -[x0; q0; r0; d0; q1; ...].
    zy = torch.cat([-prob.x0[None], -prob.f[:-1]])
    zy, zx, zu = _leaf_rhs_transform(prob, (zy, -prob.q, -prob.r))

    idx = lambda a: host_copy(a, dev)
    # F[level(k), k] <- {Q_k^{-1} A_k', R_k^{-1} B_k'} for 1 <= k < N-1
    # (ref nested_dissection.c:81-86).
    ks = np.arange(1, N - 1)
    lvl, ks_t = idx(levels[ks]), idx(ks)
    Fstate[lvl, ks_t] = At[1:-1] * qcol[1:-1]
    Finput[lvl, ks_t] = Bt[1:-1] * rcol[1:-1]
    # F[level(k-1), k] <- {Q_k^{-1} (-I), 0} for k >= 1
    # (ref nested_dissection.c:92-102).
    ks_all = np.arange(1, N)
    eye = torch.eye(n, dtype=A.dtype, device=dev).reshape(
        (1, n, n) + (1,) * nb)
    Fstate[idx(levels[ks_all - 1]), idx(ks_all)] = -eye * qcol[1:]
    # Knot 0's blocks (ref nested_dissection.c:24-58).
    Flambda[0, 0] = -At[0]
    Finput[0, 0] = Bt[0] * rcol[0]
    return Flambda, Fstate, Finput, zy, zx, zu


def _group(x: torch.Tensor, span: int) -> torch.Tensor:
    """The knot axis ``[N, ...] -> [N/span, span, ...]`` (a view): the
    level-L separator of group ``g`` is knot ``g*2^(L+1) + 2^L - 1``
    (binary_tree.c:65-69), so every index pattern of the sweep is a fixed
    column of this grouping."""
    return x.view((x.shape[0] // span, span) + x.shape[1:])


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _lambda_mask(N: int, span: int, mid: int) -> np.ndarray:
    """calc_lambda (nested_dissection.c:173-177) as a static ``[G, span]``
    pattern: the left-range start (position 0) and right-range start
    (position mid) of each group skip the lambda update, except knot 0."""
    mask = np.ones((N // span, span), dtype=bool)
    mask[:, 0] = False
    mask[:, mid] = False
    mask[0, 0] = True
    return mask


def _keep(level: int, N: int, trail: int, device,
          knot0: bool = True) -> torch.Tensor:
    """:func:`_lambda_mask` at ``span = 2^(level+1)``, ``mid = 2^level``,
    made on the device (no host copy), broadcastable against grouped
    ``[G, span, ...]`` arrays with ``trail`` dims after the span.
    ``knot0``: the first knot is global knot 0 (its lambda update is
    kept); False on a horizon chunk that starts past knot 0."""
    keep = _masks(level, N, device)[0]  # [N, 1]
    if not knot0:
        keep[0] = False
    span = 2 << level
    return keep.view((N // span, span) + (1,) * trail)


def _stage_products(prob, level: int, depth: int, Fls, Fxs, Fus, nb: int,
                    opts: Optional[SolveOptions] = None):
    """Inner products ``S[u]`` for every fact level ``u >= level``
    (ref solve.c:71-83, ndlqr_FactorInnerProduct nested_dissection.c:114-
    134): the list of ``[G, n, n, *b]`` separator blocks."""
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    A_g = _group(prob.A, span)[:, mid]  # [G, n, n, *b]
    B_g = _group(prob.B, span)[:, mid]
    Ss = []
    for u in range(level, depth):
        gl, gx, gu = (_group(F[u], span) for F in (Fls, Fxs, Fus))
        Ss.append(
            la.bgemm(A_g, gx[:, mid], nb, opts)
            + la.bgemm(B_g, gu[:, mid], nb, opts)
            - gx[:, mid + 1]
            - gl[:, mid + 1]
        )
    return Ss


def _stage_cholesky(Ss, nb: int, opts: Optional[SolveOptions] = None):
    """Batched Cholesky of this level's separator blocks (solve.c:87-98)."""
    return la.bcholesky(Ss[0], nb, opts)


def _stage_cholsolve(Lc, Ss, nb: int, opts: Optional[SolveOptions] = None):
    """Sbar backslash the upper-level separator blocks (solve.c:103-116,
    ndlqr_SolveCholeskyFactor nested_dissection.c:136-152)."""
    return [la.bcho_solve(Lc, S, nb, opts) for S in Ss[1:]]


def _stage_schur(level: int, depth: int, Fls, Fxs, Fus, Ss, fsols, nb: int,
                 opts: Optional[SolveOptions] = None, knot0: bool = True):
    """Write the separator blocks back into the factor slabs and apply the
    Schur-complement updates to every knot (solve.c:119-131,
    ndlqr_UpdateShurFactor nested_dissection.c:154-171), in place:
    ``F*[u] -= F*[level] @ f_u`` with ``f_u`` broadcast over each group and
    the lambda row masked by calc_lambda (``knot0`` as in :func:`_keep`)."""
    N = Fls[0].shape[0]
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    for ui, u in enumerate(range(level, depth)):
        _group(Fls[u], span)[:, mid + 1] = (Ss[0] if u == level
                                            else fsols[ui - 1])
    if level + 1 >= depth:
        return
    keep = _keep(level, N, nb + 2, Fls[0].device, knot0)
    FL_l, FL_x, FL_u = (_group(F[level], span) for F in (Fls, Fxs, Fus))
    for ui, u in enumerate(range(level + 1, depth)):
        f_u = fsols[ui][:, None]  # [G, 1, n, n, *b]: broadcast over span
        upd_l = la.bgemm(FL_l, f_u, nb, opts).masked_fill_(~keep, 0.0)
        _group(Fls[u], span).sub_(upd_l)
        _group(Fxs[u], span).sub_(la.bgemm(FL_x, f_u, nb, opts))
        _group(Fus[u], span).sub_(la.bgemm(FL_u, f_u, nb, opts))


def _sweep_level_core(prob, level: int, depth: int, Fls, Fxs, Fus, chols,
                      nb: int, opts: Optional[SolveOptions] = None):
    """One level of the factorization sweep (body of the loop in
    solve.c:68-134) on per-level factor lists ``F*s[u]`` of shape
    ``[N, r, n, *b]``, updated in place, composed of the four reference
    phases, each in its span (:mod:`rslqr_tpu_torch.spans`). Appends this
    level's separator Cholesky factors ``[G, n, n, *b]`` to ``chols``."""
    with span("products", level):
        Ss = _stage_products(prob, level, depth, Fls, Fxs, Fus, nb, opts)
    with span("cholesky", level):
        Lc = _stage_cholesky(Ss, nb, opts)
    chols.append(Lc)
    with span("cholsolve", level):
        fsols = _stage_cholsolve(Lc, Ss, nb, opts)
    with span("shur", level):
        _stage_schur(level, depth, Fls, Fxs, Fus, Ss, fsols, nb, opts)


def _chol_cache_set(chol: torch.Tensor, level: int, vals: torch.Tensor):
    """Write level-``level`` Sbar Cholesky factors into the cache, in
    place: level-L nodes sit at indices ``(2j+1) 2^L - 1``, a strided
    slice."""
    chol[(1 << level) - 1::2 << level] = vals
    return chol


def _chol_cache_get(chol: torch.Tensor, level: int) -> torch.Tensor:
    """Read level-``level`` factors from the cache (a strided view)."""
    return chol[(1 << level) - 1::2 << level]


def _sweep_level(prob: LQRProblem, t: TreeTables, level: int,
                 fact: RsLqrFactorization,
                 options: Optional[SolveOptions] = None
                 ) -> RsLqrFactorization:
    """Stacked-grid wrapper of :func:`_sweep_level_core`: one level on a
    copy of ``fact``, for tests that compare per-level state."""
    nb = fact.nbatch
    Fl, Fx, Fu, chol = (x.clone() for x in (
        fact.Flambda, fact.Fstate, fact.Finput, fact.chol))
    chols: list = []
    _sweep_level_core(prob, level, t.depth, list(Fl.unbind(0)),
                      list(Fx.unbind(0)), list(Fu.unbind(0)), chols, nb,
                      options)
    return RsLqrFactorization(Flambda=Fl, Fstate=Fx, Finput=Fu,
                              chol=_chol_cache_set(chol, level, chols[0]),
                              nbatch=nb)


def _factorize_bl(
    prob: LQRProblem, t: TreeTables, nb: int,
    opts: Optional[SolveOptions] = None,
) -> Tuple[RsLqrFactorization, Tuple[torch.Tensor, ...]]:
    """Phases 1-2 on batch-last problem arrays (ref solve.c:50-134), in the
    ``factor`` span."""
    with span("factor"):
        with span("leaves"):
            Flambda, Fstate, Finput, zy, zx, zu = _leaf_solve(
                prob, t.levels, t.depth, nb)
        Fls, Fxs, Fus = (list(F.unbind(0))
                         for F in (Flambda, Fstate, Finput))
        chols: list = []
        for level in range(t.depth):
            _sweep_level_core(prob, level, t.depth, Fls, Fxs, Fus, chols,
                              nb, opts)
        chol = Flambda.new_zeros((Flambda.shape[1] - 1,)
                                 + Flambda.shape[2:])
        for level in range(t.depth):
            _chol_cache_set(chol, level, chols[level])
    fact = RsLqrFactorization(Flambda=Flambda, Fstate=Fstate, Finput=Finput,
                              chol=chol, nbatch=nb)
    return fact, (zy, zx, zu)


def _rhs_level_core(prob, level: int, Fl, Fx, Fu, Lc, zy, zx, zu, nb: int,
                    opts: Optional[SolveOptions] = None, knot0: bool = True):
    """One level of the RHS sweep (ref solve.c:137-182) with this level's
    stacked separator Cholesky ``Lc [G, n, n, *b]``; returns new ``(zy,
    zx, zu)``. ``knot0``: the first knot is global knot 0, which keeps its
    lambda update (JAX rslqr.py:385-417): True on one device, and under
    horizon sharding on the first chunk only."""
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    A_g = _group(prob.A, span)[:, mid]
    B_g = _group(prob.B, span)[:, mid]
    gy, gx, gu = _group(zy, span), _group(zx, span), _group(zu, span)
    # Inner product against the RHS (ref solve.c:147) and separator solve
    # with the cached Cholesky (ref solve.c:153-170).
    znew = (
        la.bgemv(A_g, gx[:, mid], nb)
        + la.bgemv(B_g, gu[:, mid], nb)
        - gx[:, mid + 1]
        - gy[:, mid + 1]
    )
    zbar = la.bcho_solve_vec(Lc, znew, nb, opts)
    zy = zy.clone()
    _group(zy, span)[:, mid + 1] = zbar
    # Propagate into the solution (ref solve.c:176-180):
    # g_k -= F[level, k] @ zbar[group(k)]   (lambda row masked).
    fvec = zbar[:, None]  # [G, 1, n, *b]: broadcast over the group span
    keep = _keep(level, zy.shape[0], nb + 1, zy.device, knot0)
    zy = zy - _ungroup(torch.where(
        keep, la.bgemv(_group(Fl, span), fvec, nb), 0.0))
    zx = zx - _ungroup(la.bgemv(_group(Fx, span), fvec, nb))
    zu = zu - _ungroup(la.bgemv(_group(Fu, span), fvec, nb))
    return zy, zx, zu


def _solve_rhs_bl(prob: LQRProblem, fact: RsLqrFactorization, rhs,
                  t: TreeTables, opts: Optional[SolveOptions] = None):
    """Phase 3 on batch-last arrays (ref solve.c:137-182), in the ``sweep``
    span."""
    zy, zx, zu = rhs
    with span("sweep"):
        for level in range(t.depth):
            with span("rhs", level):
                zy, zx, zu = _rhs_level_core(
                    prob, level, fact.Flambda[level], fact.Fstate[level],
                    fact.Finput[level], _chol_cache_get(fact.chol, level),
                    zy, zx, zu, fact.nbatch, opts,
                )
    return zy, zx, zu


def factorize(
    prob: LQRProblem, tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> Tuple[RsLqrFactorization, Tuple[torch.Tensor, ...]]:
    """Leaf solves + level sweep on the grid path (ref solve.c:50-134), of
    a single problem or a batch (leading batch axes on every field).
    Returns the factorization and the leaf-solved RHS, both batch-LAST
    (feed them to :func:`solve_rhs`)."""
    _no_tf32()
    nb = _num_batch_axes(prob)
    pbl = _to_batch_last(prob, nb)
    t = tables or build_tree_tables(pbl.A.shape[0])
    return _factorize_bl(pbl, t, nb, resolve_options(options))


def solve_rhs(
    prob: LQRProblem, fact: RsLqrFactorization, rhs,
    tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """Solve a leaf-solved, batch-last RHS with a cached factorization
    (ref solve.c:137-182): the multi-RHS mode the reference only hints at
    (nddata.h:72-75), re-solving after a change of ``q``/``r``/``x0``/``f``
    without re-factorizing."""
    _no_tf32()
    nb = fact.nbatch
    pbl = _to_batch_last(prob, _num_batch_axes(prob))
    t = tables or build_tree_tables(pbl.A.shape[0])
    zy, zx, zu = _solve_rhs_bl(pbl, fact, rhs, t, resolve_options(options))
    return RsLqrSolution(Y=_bf(zy, nb), X=_bf(zx, nb), U=_bf(zu[:-1], nb),
                         fact=fact)


def leaf_solve_rhs(prob: LQRProblem, tables: Optional[TreeTables] = None):
    """Leaf-solve just the RHS of ``prob`` (batch-last), for multi-RHS
    reuse. ``tables`` is taken for the JAX signature."""
    pbl = _to_batch_last(prob, _num_batch_axes(prob))
    zy = torch.cat([-pbl.x0[None], -pbl.f[:-1]])
    return _leaf_rhs_transform(pbl, (zy, -pbl.q, -pbl.r))


def _use_em_layout(prob: LQRProblem, opts: SolveOptions) -> bool:
    """Layout dispatch (JAX ``_use_em_layout``, rslqr.py:498-533, with the
    port's rule, see :mod:`rslqr_tpu_torch.config`): element-major for
    blocks up to ``MAX_BLOCK`` unless ``layout="grid"``, the grid path
    above it; ``layout="em"`` takes the element-major path at every block
    size, as in the JAX package (rslqr.py:508-509): blocks above
    ``MAX_BLOCK`` run its mid-block route through the plain versions of
    the plane kernels (``rslqr_em._plane_options``)."""
    if opts.layout != "auto":
        return opts.layout == "em"
    return max(prob.nstates, prob.ninputs) <= MAX_BLOCK


def _one_batch_axis(prob: LQRProblem):
    """The front door's preparation for the element-major path: TF32 off,
    leading batch axes flattened to one. Returns the flattened problem and
    the batch shape."""
    _no_tf32()
    bshape = prob.batch_shape
    return prob.map(lambda x: x.reshape((-1,) + x.shape[len(bshape):])), bshape


def solve(
    prob: LQRProblem,
    tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """Full rsLQR solve (ref ndlqr_Solve, solve.c:38-190) of a single
    problem or a batch (leading batch axes on every field), on the device
    of the problem's tensors.

    Blocks up to 64 run the element-major path (small blocks through the
    Schur sweep kernels, mid blocks through the element-plane kernels);
    ``layout="grid"`` and, under ``layout="auto"``, blocks above 64 run the
    knot-major grid path, the whole batch in one batched call per stage
    (JAX vmaps single solves there, rslqr.py:571-580). ``layout="em"``
    runs the element-major path at every block size (above 64 the plain
    versions of the plane kernels). Sets TF32 off (:func:`_no_tf32`).

    Differentiable: when grad is enabled and a field requires grad, the
    solve runs as :mod:`rslqr_tpu_torch.autodiff`'s Function (the same
    route; its backward re-solves through the cached factorization).
    Otherwise no graph is built.
    """
    with entry():
        return _solve(prob, tables, options)


def _solve(prob: LQRProblem, tables: Optional[TreeTables] = None,
           options: Optional[SolveOptions] = None) -> RsLqrSolution:
    """:func:`solve` inside its ``solve`` span: the route."""
    opts = resolve_options(options)
    from . import autodiff

    if autodiff.wants_grad(prob):
        return autodiff.solve(prob, tables, opts)
    if _use_em_layout(prob, opts):
        from . import rslqr_em

        flat, bshape = _one_batch_axis(prob)
        sol = rslqr_em.solve_em(flat, tables, options=opts)
        unflat = lambda x: x.reshape(bshape + x.shape[1:])
        return RsLqrSolution(
            Y=unflat(sol.Y), X=unflat(sol.X), U=unflat(sol.U), fact=sol.fact
        )
    fact, rhs = factorize(prob, tables, opts)
    return solve_rhs(prob, fact, rhs, tables, opts)


def solve_kkt(
    prob: LQRProblem, options: Optional[SolveOptions] = None
) -> torch.Tensor:
    """Solve and return the flat KKT vector(s) ``[*b, nvars]``."""
    with entry():
        sol = _solve(prob, options=options)
        with span("pack"):
            return sol.kkt_vector()
