"""Batched block linear algebra in batch-last layout.

Counterpart of ``rslqr_tpu.linalg``. Block arrays have shape
``[..., p, q, *b]``: leading grid dims ``...`` and ``nbatch`` trailing batch
axes. The element-major solve treats the knot axis as one more batch axis
(``nbatch + 1``). Each function routes on one block dim, the same dim as its
JAX counterpart (``bgemm`` the contraction dim, ``bgemm_tt`` ``max`` of A's
two block dims, the solves ``n``):

* Small blocks (at most ``SolveOptions.mxu_block_threshold``, 8 by
  default): the tiny block dims (n=6, m=3) unroll into elementwise ops over
  ``[..., *b]``, exactly as the JAX lane kernels do.
* Mid blocks (above the threshold, at most 64) of ``[p, q, *b]`` arrays
  with no leading grid dims and at least one batch axis: the element-plane
  kernels of :mod:`rslqr_tpu_torch.ops.planes` (JAX: ``_planes_*_maybe``,
  linalg.py:169-243, 391-413, 542-557, 321-349, 655-675). Strided operands
  are made contiguous first (one compact copy each).
* Everything else above the threshold, i.e. blocks above 64, operands with
  leading grid dims (the knot-major grid path's ``[G, n, n, *b]``) or no
  batch axis: the mat-last route (JAX ``_bgemm_mxu``, ``_to_mat_last``,
  linalg.py:255-390): the block dims are moved last (a permuted copy of
  each operand) and one natively batched ``torch.matmul``,
  ``torch.linalg.cholesky_ex``, ``torch.linalg.solve_triangular`` or
  ``torch.linalg.solve`` runs over every block at once.

The JAX package's blocked panel algorithms (``cholesky_ml``, ``lu_ml``,
``solve_ml``, ``_*_bl_blocked``, ``PANEL``; linalg.py:797-1182) are not
ported: they exist because XLA's batched Cholesky and LU run column-serial
on the TPU (linalg.py:402-407, 584-588). The ``torch.linalg`` calls take
their place. The large ``bsolve`` is a pivoted LU solve on every device,
where JAX's is an unpivoted blocked LU; both solve the well-conditioned
``I + C J`` of the scan combines to rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .config import SolveOptions, resolve_options
from .ops import planes


# The route of a block dim above the threshold that the plane kernels do
# not take (see the module docstring).
MAT_LAST = "mat_last"


def _mid(d: int, A: torch.Tensor, nbatch: int,
         options: Optional[SolveOptions]) -> Optional[str]:
    """The route of a block dim ``d``: ``None`` for the small-block one,
    :data:`MAT_LAST` for the mat-last one, else the kernel mode of the
    plane kernels."""
    opts = resolve_options(options)
    if d <= opts.mxu_block_threshold:
        return None
    if d > planes.MAX_BLOCK or nbatch == 0 or A.dim() != nbatch + 2:
        return MAT_LAST
    return opts.kernels


def _to_mat_last(A: torch.Tensor, nbatch: int) -> torch.Tensor:
    """``[..., p, q, *b] -> [..., *b, p, q]`` (a view)."""
    nd = A.dim()
    lead = tuple(range(nd - nbatch - 2))
    return A.permute(lead + tuple(range(nd - nbatch, nd))
                     + (nd - nbatch - 2, nd - nbatch - 1))


def _from_mat_last(A: torch.Tensor, nbatch: int) -> torch.Tensor:
    """Inverse of :func:`_to_mat_last` (a view)."""
    nd = A.dim()
    lead = tuple(range(nd - nbatch - 2))
    return A.permute(lead + (nd - 2, nd - 1)
                     + tuple(range(nd - nbatch - 2, nd - 2)))


def _bcast_mat_last(L: torch.Tensor, B: torch.Tensor, nbatch: int):
    """Broadcast the leading grid dims of two block arrays against each
    other (JAX ``_bcast_mat_last``, linalg.py:532-539), both mat-last."""
    lead = torch.broadcast_shapes(L.shape[:L.dim() - 2 - nbatch],
                                  B.shape[:B.dim() - 2 - nbatch])
    L = L.expand(lead + L.shape[L.dim() - 2 - nbatch:])
    B = B.expand(lead + B.shape[B.dim() - 2 - nbatch:])
    return _to_mat_last(L, nbatch), _to_mat_last(B, nbatch)


def _bgemm_mxu(A: torch.Tensor, B: torch.Tensor, nbatch: int):
    """The mat-last product (JAX linalg.py:255-282): leading grid dims
    broadcast, batch axes as batch dims of one ``torch.matmul``. A leading
    dim of size 1 in ``B`` only (the Schur updates' one multiplier per
    group) folds into A's rows instead, so ``B`` is never expanded and each
    product is one taller matrix."""
    nl = max(A.dim(), B.dim()) - 2 - nbatch
    A = A.reshape((1,) * (nl + 2 + nbatch - A.dim()) + A.shape)
    B = B.reshape((1,) * (nl + 2 + nbatch - B.dim()) + B.shape)
    fold = [i for i in range(nl) if B.shape[i] == 1 < A.shape[i]]
    if not fold:
        Am, Bm = _bcast_mat_last(A, B, nbatch)
        return _from_mat_last(torch.matmul(Am, Bm), nbatch)
    rest = [i for i in range(nl) if i not in fold]
    bat = list(range(nl + 2, nl + 2 + nbatch))
    p, q, r = A.shape[nl], A.shape[nl + 1], B.shape[nl + 1]
    k = len(rest) + nbatch
    Am = A.permute(rest + bat + fold + [nl, nl + 1])
    Am = Am.reshape(Am.shape[:k] + (-1, q))  # [*rest, *b, F*p, q]
    Bm = B.permute(rest + bat + [nl, nl + 1] + fold)
    Bm = Bm.reshape(Bm.shape[:k + 2])  # [*rest, *b, q, r]
    out = torch.matmul(Am, Bm)
    out = out.reshape(out.shape[:k] + tuple(A.shape[i] for i in fold)
                      + (p, r))  # [*rest, *b, *fold, p, r]
    src = {i: j for j, i in enumerate(rest)}
    src.update({i: k + j for j, i in enumerate(fold)})
    f = k + len(fold)
    return out.permute([src[i] for i in range(nl)] + [f, f + 1]
                       + list(range(len(rest), k)))


def _cholesky_ml(Am: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of mat-last blocks; a block that is not SPD
    gets NaN in every entry (as JAX's factorization leaves NaN, which
    :func:`rslqr_tpu_torch.diagnostics.factorization_ok` reads), with no
    host sync."""
    L, info = torch.linalg.cholesky_ex(Am)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _at(M: torch.Tensor, i: int, j: int, nbatch: int) -> torch.Tensor:
    """Block element ``M[..., i, j, *b]``."""
    return M[(Ellipsis, i, j) + (slice(None),) * nbatch]


def _row(M: torch.Tensor, i: int, nbatch: int) -> torch.Tensor:
    """Block row ``M[..., i, :, *b]``."""
    return M[(Ellipsis, i, slice(None)) + (slice(None),) * nbatch]


def bgemm(A: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
          options: Optional[SolveOptions] = None) -> torch.Tensor:
    """``[..., p, q, *b] @ [..., q, r, *b] -> [..., p, r, *b]``.

    Dispatches on the contraction dim ``q``, as the JAX package does
    (linalg.py:231-232): mid-size contractions run ``planes.pgemm``, the
    mat-last route one ``torch.matmul``; small ones a broadcast
    multiply-reduce over the tiny contraction axis (leading dims broadcast
    on every route)."""
    mode = _mid(A.shape[-(nbatch + 1)], A, nbatch, options)
    if mode == MAT_LAST:
        return _bgemm_mxu(A, B, nbatch)
    if mode is not None:
        return planes.pgemm(A.contiguous(), B.contiguous(), kernels=mode)
    Ae = A.unsqueeze(-(nbatch + 1))  # [..., p, q, 1, *b]
    Be = B.unsqueeze(-(nbatch + 3))  # [..., 1, q, r, *b]
    return (Ae * Be).sum(-(nbatch + 2))


def bgemv(A: torch.Tensor, x: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """``[..., p, q, *b] @ [..., q, *b] -> [..., p, *b]``."""
    return (A * x.unsqueeze(-(nbatch + 2))).sum(-(nbatch + 1))


def bcholesky(A: torch.Tensor, nbatch: int = 1,
              options: Optional[SolveOptions] = None) -> torch.Tensor:
    """Cholesky of SPD blocks ``[..., n, n, *b]`` -> lower ``L``. Small
    blocks: unrolled Cholesky-Banachiewicz, every step an elementwise op on
    ``[..., *b]`` (the reference's unblocked factorization,
    linalg_custom.c:88-111); mid blocks: ``planes.pchol``; the mat-last
    route: ``torch.linalg.cholesky_ex``, NaN where a block is not SPD."""
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
    if mode == MAT_LAST:
        return _from_mat_last(_cholesky_ml(_to_mat_last(A, nbatch)), nbatch)
    if mode is not None:
        return planes.pchol(A.contiguous(), kernels=mode)
    cols = [[None] * n for _ in range(n)]
    for j in range(n):
        s = _at(A, j, j, nbatch)
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        ljj = torch.sqrt(s)
        inv = 1.0 / ljj
        cols[j][j] = ljj
        for i in range(j + 1, n):
            s = _at(A, i, j, nbatch)
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv
    zero = torch.zeros_like(_at(A, 0, 0, nbatch))
    rows = [
        torch.stack(
            [cols[i][j] if j <= i else zero for j in range(n)],
            dim=-(nbatch + 1),
        )
        for i in range(n)
    ]
    return torch.stack(rows, dim=-(nbatch + 2))


def btrsm_lower(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
                options: Optional[SolveOptions] = None):
    """Solve ``L X = B`` by unrolled forward substitution
    (clap_LowerTriBackSub, linalg_custom.c:113-132). ``L``:
    ``[..., n, n, *b]``; ``B``: ``[..., n, r, *b]``. Above the threshold
    (there is no plane kernel for it): ``torch.linalg.solve_triangular``
    on mat-last views, as JAX's large branch (linalg.py:446-463)."""
    n = L.shape[-(nbatch + 2)]
    if n > resolve_options(options).mxu_block_threshold:
        return _trsm_ml(L, B, nbatch, transpose=False)
    xs = []
    for i in range(n):
        s = _row(B, i, nbatch)
        for k in range(i):
            s = s - _at(L, i, k, nbatch).unsqueeze(-(nbatch + 1)) * xs[k]
        xs.append(s / _at(L, i, i, nbatch).unsqueeze(-(nbatch + 1)))
    return torch.stack(xs, dim=-(nbatch + 2))


def btrsm_lower_t(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
                  options: Optional[SolveOptions] = None):
    """Solve ``L' X = B`` by unrolled back substitution; above the
    threshold as :func:`btrsm_lower` (JAX linalg.py:486-498)."""
    n = L.shape[-(nbatch + 2)]
    if n > resolve_options(options).mxu_block_threshold:
        return _trsm_ml(L, B, nbatch, transpose=True)
    xs = [None] * n
    for i in reversed(range(n)):
        s = _row(B, i, nbatch)
        for k in range(i + 1, n):
            s = s - _at(L, k, i, nbatch).unsqueeze(-(nbatch + 1)) * xs[k]
        xs[i] = s / _at(L, i, i, nbatch).unsqueeze(-(nbatch + 1))
    return torch.stack(xs, dim=-(nbatch + 2))


def _trsm_ml(L: torch.Tensor, B: torch.Tensor, nbatch: int,
             transpose: bool) -> torch.Tensor:
    """``L X = B`` (or ``L' X = B``) on mat-last views, leading grid dims
    broadcast."""
    Lm, Bm = _bcast_mat_last(L, B, nbatch)
    if transpose:
        X = torch.linalg.solve_triangular(Lm.mT, Bm, upper=True)
    else:
        X = torch.linalg.solve_triangular(Lm, Bm, upper=False)
    return _from_mat_last(X, nbatch)


def bcho_solve(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
               options: Optional[SolveOptions] = None):
    """Solve ``(L L') X = B`` given the Cholesky factor: two substitutions
    (clap_CholeskySolve, linalg_custom.c:134-138). Mid blocks run
    ``planes.pcho_solve`` on a copy of ``B``; the mat-last route two
    ``torch.linalg.solve_triangular`` calls on one pair of mat-last copies.
    On every route ``B`` is left as it is and ``X`` is a new tensor."""
    mode = _mid(L.shape[-(nbatch + 2)], L, nbatch, options)
    if mode == MAT_LAST:
        Lm, Bm = _bcast_mat_last(L, B, nbatch)
        Y = torch.linalg.solve_triangular(Lm, Bm, upper=False)
        X = torch.linalg.solve_triangular(Lm.mT, Y, upper=True)
        return _from_mat_last(X, nbatch)
    if mode is not None:
        X = B.clone(memory_format=torch.contiguous_format)
        return planes.pcho_solve(L.contiguous(), X, kernels=mode)
    return btrsm_lower_t(L, btrsm_lower(L, B, nbatch, options), nbatch,
                         options)


def bcho_solve_vec(L: torch.Tensor, b: torch.Tensor, nbatch: int = 1,
                   options: Optional[SolveOptions] = None):
    """Vector right-hand side: ``[..., n, n, *b] \\ [..., n, *b]``."""
    return bcho_solve(
        L, b.unsqueeze(-(nbatch + 1)), nbatch, options
    ).squeeze(-(nbatch + 1))


def transpose_block(A: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """Transpose the block dims of ``[..., p, q, *b]``."""
    return A.transpose(-(nbatch + 2), -(nbatch + 1))


def beye(n: int, like: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """Identity block broadcastable against ``[..., n, n, *b]`` arrays."""
    return torch.eye(n, dtype=like.dtype, device=like.device).reshape(
        (n, n) + (1,) * nbatch)


def bgemm_tt(
    A: torch.Tensor,
    B: torch.Tensor,
    nbatch: int = 1,
    *,
    ta: bool = False,
    tbt: bool = False,
    cin: Optional[torch.Tensor] = None,
    sub: bool = True,
    diag: Optional[torch.Tensor] = None,
    dconst: float = 0.0,
    sym: bool = False,
    kscale: Optional[torch.Tensor] = None,
    options: Optional[SolveOptions] = None,
) -> torch.Tensor:
    """``op(A) @ op(B)``, or ``cin -/+ op(A) @ op(B)``, plus ``diag`` /
    ``dconst`` on the output diagonal; ``ta``: A stored transposed
    (``[.., K, p, *b]``), ``tbt``: B stored transposed (``[.., q, K, *b]``),
    ``kscale``: ``op(A) diag(kscale) op(B)``, ``sym``: the output (and
    ``cin``) is symmetric.

    JAX linalg.py:291-366. Where ``max(A.shape[0], A.shape[1])`` is above
    the threshold (and A has no leading grid dims) one ``planes.pgemm``
    with its flags computes it all; its output is a new tensor, so ``cin``
    is never overwritten (JAX donates it). Else explicit block transposes,
    :func:`bgemm` (whichever route it takes) and the epilogues as separate
    ops."""
    if A.dim() == nbatch + 2:
        mode = _mid(max(A.shape[0], A.shape[1]), A, nbatch, options)
        if mode not in (None, MAT_LAST):
            c = lambda t: None if t is None else t.contiguous()
            return planes.pgemm(
                c(A), c(B), c(cin), c(diag), c(kscale), ta=ta, tbt=tbt,
                sub=sub, dconst=dconst, sym=sym, kernels=mode,
            )
    At = transpose_block(A, nbatch) if ta else A
    Bt = transpose_block(B, nbatch) if tbt else B
    if kscale is not None:
        Bt = Bt * kscale.unsqueeze(-(nbatch + 1))
    out = bgemm(At, Bt, nbatch, options)
    if cin is not None:
        out = cin - out if sub else cin + out
    if diag is not None or dconst:
        p = out.shape[-(nbatch + 2)]
        ar = torch.arange(p, device=out.device)
        idx = (Ellipsis, ar, ar) + (slice(None),) * nbatch
        dg = out[idx]
        if diag is not None:
            dg = dg + diag
        if dconst:
            dg = dg + dconst
        out[idx] = dg  # out is a new tensor (bgemm's, or cin -/+ it)
    return out


def bsolve(A: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
           options: Optional[SolveOptions] = None) -> torch.Tensor:
    """Solve general square block systems ``A X = B`` (``A [..., n, n,
    *b]``, ``B [..., n, r, *b]``). Small blocks: unrolled Gauss-Jordan
    elimination with partial pivoting, the pivot search as ``where`` chains
    over the batch lanes (JAX linalg.py:572-647). Mid blocks:
    ``planes.plu_solve`` (unpivoted, for the well-conditioned ``I + C J``
    of the scan combines), a new tensor; the mat-last route: one pivoted
    ``torch.linalg.solve``."""
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
    if mode == MAT_LAST:
        Am, Bm = _bcast_mat_last(A, B, nbatch)
        return _from_mat_last(torch.linalg.solve(Am, Bm), nbatch)
    if mode is not None:
        return planes.plu_solve(A.contiguous(), B.contiguous(), kernels=mode)

    def row(M, i):  # [..., cols, *b]
        return M[(Ellipsis, i, slice(None)) + (slice(None),) * nbatch]

    def elem(r, j):  # [..., *b]
        return r[(Ellipsis, j) + (slice(None),) * nbatch]

    ax = -(nbatch + 1)
    arows = [row(A, i) for i in range(n)]
    brows = [row(B, i) for i in range(n)]
    for col in range(n):
        # Partial pivot: the largest |A[i, col]| among rows col..n-1.
        best_a, best_b = arows[col], brows[col]
        best_mag = elem(best_a, col).abs()
        for i in range(col + 1, n):
            mag = elem(arows[i], col).abs()
            take = (mag > best_mag).unsqueeze(ax)
            best_a = torch.where(take, arows[i], best_a)
            best_b = torch.where(take, brows[i], best_b)
            best_mag = torch.maximum(best_mag, mag)
        # Swap: the first candidate row whose magnitude equals the winner's
        # takes the old row at ``col``.
        swapped = torch.zeros(best_mag.shape, dtype=torch.bool,
                              device=A.device)
        old_a, old_b = arows[col], brows[col]
        for i in range(col, n):
            is_best = (elem(arows[i], col).abs() == best_mag) & ~swapped
            swapped = swapped | is_best
            is_best_r = is_best.unsqueeze(ax)
            arows[i] = torch.where(is_best_r, old_a, arows[i])
            brows[i] = torch.where(is_best_r, old_b, brows[i])
        arows[col], brows[col] = best_a, best_b

        inv = (1.0 / elem(arows[col], col)).unsqueeze(ax)
        arows[col] = arows[col] * inv
        brows[col] = brows[col] * inv
        for i in range(n):
            if i != col:
                factor = elem(arows[i], col).unsqueeze(ax)
                arows[i] = arows[i] - factor * arows[col]
                brows[i] = brows[i] - factor * brows[col]
    return torch.stack(brows, dim=-(nbatch + 2))


def bsolve_vec(A: torch.Tensor, b: torch.Tensor, nbatch: int = 1,
               options: Optional[SolveOptions] = None) -> torch.Tensor:
    """Vector right-hand side: ``[..., n, n, *b] \\ [..., n, *b]``."""
    return bsolve(
        A, b.unsqueeze(-(nbatch + 1)), nbatch, options
    ).squeeze(-(nbatch + 1))


def bsolve_multi(A: torch.Tensor, Bs: Sequence[torch.Tensor],
                 nbatch: int = 1, options: Optional[SolveOptions] = None):
    """Solve ``A X_i = B_i`` for several right-hand sides with one
    factorization (JAX linalg.py:655-684). Mid blocks (``n`` above the
    threshold, no leading grid dims): one ``planes.plu_solve_multi``, the
    ``B_i`` passed separately and left as they are (JAX donates them); else
    one :func:`bsolve` of the stacked right-hand sides, split after."""
    Bs = tuple(Bs)
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
    if mode not in (None, MAT_LAST):
        return planes.plu_solve_multi(
            A.contiguous(), *(b.contiguous() for b in Bs), kernels=mode
        )
    w_axis = -(nbatch + 1)
    X = bsolve(A, torch.cat(Bs, dim=w_axis), nbatch, options)
    return tuple(torch.split(X, [b.shape[w_axis] for b in Bs], dim=w_axis))


def blu_factor(A: torch.Tensor,
               nbatch: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted Doolittle LU of ``[..., n, n, *b]`` blocks, unrolled (JAX
    linalg.py:687-723). Returns the packed factorization (unit-diagonal L
    below, U on and above the diagonal) and U's diagonal reciprocals
    ``[..., n, *b]``. For well-conditioned blocks such as the scan
    combine's ``I + C J``."""
    n = A.shape[-(nbatch + 2)]
    lu = [[None] * n for _ in range(n)]
    dinv = [None] * n
    for k in range(n):
        for j in range(k, n):
            s = _at(A, k, j, nbatch)
            for t in range(k):
                s = s - lu[k][t] * lu[t][j]
            lu[k][j] = s
        dinv[k] = 1.0 / lu[k][k]
        for i in range(k + 1, n):
            s = _at(A, i, k, nbatch)
            for t in range(k):
                s = s - lu[i][t] * lu[t][k]
            lu[i][k] = s * dinv[k]
    rows = [torch.stack(lu[i], dim=-(nbatch + 1)) for i in range(n)]
    return (torch.stack(rows, dim=-(nbatch + 2)),
            torch.stack(dinv, dim=-(nbatch + 1)))


def blu_solve(LU: torch.Tensor, dinv: torch.Tensor, B: torch.Tensor,
              nbatch: int = 1) -> torch.Tensor:
    """Solve ``A X = B`` from :func:`blu_factor`'s output; ``B [..., n, r,
    *b]`` (JAX linalg.py:726-756)."""
    n = LU.shape[-(nbatch + 2)]
    ax = -(nbatch + 1)
    ys = []
    for i in range(n):  # unit-lower forward substitution
        s = _row(B, i, nbatch)
        for k in range(i):
            s = s - _at(LU, i, k, nbatch).unsqueeze(ax) * ys[k]
        ys.append(s)
    xs = [None] * n
    for i in reversed(range(n)):  # U back substitution
        s = ys[i]
        for k in range(i + 1, n):
            s = s - _at(LU, i, k, nbatch).unsqueeze(ax) * xs[k]
        xs[i] = s * dinv[(Ellipsis, i) + (slice(None),) * nbatch].unsqueeze(ax)
    return torch.stack(xs, dim=-(nbatch + 2))


def blu_solve_t(LU: torch.Tensor, dinv: torch.Tensor, B: torch.Tensor,
                nbatch: int = 1) -> torch.Tensor:
    """Solve ``A' X = B`` from :func:`blu_factor`'s output (``A' = U'
    L'``; JAX linalg.py:759-789)."""
    n = LU.shape[-(nbatch + 2)]
    ax = -(nbatch + 1)
    zs = []
    for i in range(n):  # U' z = B: lower, U's diagonal; (U')[i, k] = U[k, i]
        s = _row(B, i, nbatch)
        for k in range(i):
            s = s - _at(LU, k, i, nbatch).unsqueeze(ax) * zs[k]
        zs.append(s * dinv[(Ellipsis, i) + (slice(None),) * nbatch].unsqueeze(ax))
    xs = [None] * n
    for i in reversed(range(n)):  # L' x = z: unit upper; (L')[i, k] = L[k, i]
        s = zs[i]
        for k in range(i + 1, n):
            s = s - _at(LU, k, i, nbatch).unsqueeze(ax) * xs[k]
        xs[i] = s
    return torch.stack(xs, dim=-(nbatch + 2))


def normed_difference(A, B) -> torch.Tensor:
    """Frobenius norm of ``A - B`` (ref MatrixNormedDifference,
    matrix.c:109-123; JAX linalg.py:565-569)."""
    d = torch.as_tensor(A) - torch.as_tensor(B)
    return torch.sqrt((d * d).sum())
