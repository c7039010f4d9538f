"""Batched block linear algebra in batch-last layout.

Counterpart of ``rslqr_tpu.linalg`` for small and mid-size blocks. Block
arrays have shape ``[..., p, q, *b]`` with ``nbatch`` trailing batch axes.
The element-major solve treats the knot axis as one more batch axis
(``nbatch + 1``).

* Small blocks (at most ``SolveOptions.mxu_block_threshold``, 8 by
  default): the tiny block dims (n=6, m=3) unroll into elementwise ops over
  ``[..., *b]``, exactly as the JAX lane kernels do.
* Mid blocks (above the threshold, at most 64): the element-plane kernels
  of :mod:`rslqr_tpu_torch.ops.planes` (JAX: ``_planes_*_maybe``,
  linalg.py:169-243, 391-413, 542-557, 321-349, 655-675), on ``[p, q, *b]``
  arrays with no leading grid dims. Strided operands are made contiguous
  first (one compact copy each). Each function takes the kernel route on
  the same dim as its JAX counterpart: ``bgemm`` on the contraction dim,
  ``bgemm_tt`` on ``max`` of A's two block dims, the solves on ``n``.
* Larger blocks (the JAX package's blocked panel and MXU routes) are not
  ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .config import SolveOptions, resolve_options
from .ops import planes


def _mid(d: int, A: torch.Tensor, nbatch: int,
         options: Optional[SolveOptions]) -> Optional[str]:
    """The kernel mode when a block dim ``d`` takes the mid-block route,
    ``None`` when it stays on the small-block one."""
    opts = resolve_options(options)
    if d <= opts.mxu_block_threshold:
        return None
    if d > planes.MAX_BLOCK:
        raise NotImplementedError(
            f"block dim {d} above {planes.MAX_BLOCK}: the large-block route "
            "is not ported yet"
        )
    if A.dim() != nbatch + 2:
        raise NotImplementedError(
            "the mid-block route takes [p, q, *b] blocks without leading "
            f"grid dims, got shape {tuple(A.shape)} with nbatch={nbatch}"
        )
    return opts.kernels


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
    (linalg.py:231-232): mid-size contractions run ``planes.pgemm``; small
    ones a broadcast multiply-reduce over the tiny contraction axis (leading
    dims broadcast)."""
    mode = _mid(A.shape[-(nbatch + 1)], A, nbatch, options)
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
    linalg_custom.c:88-111); mid blocks: ``planes.pchol``."""
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
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


def btrsm_lower(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1):
    """Solve ``L X = B`` by unrolled forward substitution
    (clap_LowerTriBackSub, linalg_custom.c:113-132). ``L``:
    ``[..., n, n, *b]``; ``B``: ``[..., n, r, *b]``."""
    n = L.shape[-(nbatch + 2)]
    xs = []
    for i in range(n):
        s = _row(B, i, nbatch)
        for k in range(i):
            s = s - _at(L, i, k, nbatch).unsqueeze(-(nbatch + 1)) * xs[k]
        xs.append(s / _at(L, i, i, nbatch).unsqueeze(-(nbatch + 1)))
    return torch.stack(xs, dim=-(nbatch + 2))


def btrsm_lower_t(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1):
    """Solve ``L' X = B`` by unrolled back substitution."""
    n = L.shape[-(nbatch + 2)]
    xs = [None] * n
    for i in reversed(range(n)):
        s = _row(B, i, nbatch)
        for k in range(i + 1, n):
            s = s - _at(L, k, i, nbatch).unsqueeze(-(nbatch + 1)) * xs[k]
        xs[i] = s / _at(L, i, i, nbatch).unsqueeze(-(nbatch + 1))
    return torch.stack(xs, dim=-(nbatch + 2))


def bcho_solve(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1,
               options: Optional[SolveOptions] = None):
    """Solve ``(L L') X = B`` given the Cholesky factor: two substitutions
    (clap_CholeskySolve, linalg_custom.c:134-138). Mid blocks run
    ``planes.pcho_solve`` on a copy of ``B``: on every route ``B`` is left
    as it is and ``X`` is a new tensor."""
    mode = _mid(L.shape[-(nbatch + 2)], L, nbatch, options)
    if mode is not None:
        X = B.clone(memory_format=torch.contiguous_format)
        return planes.pcho_solve(L.contiguous(), X, kernels=mode)
    return btrsm_lower_t(L, btrsm_lower(L, B, nbatch), nbatch)


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
    :func:`bgemm` and the epilogues as separate ops."""
    if A.dim() == nbatch + 2:
        mode = _mid(max(A.shape[0], A.shape[1]), A, nbatch, options)
        if mode is not None:
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
    of the scan combines), a new tensor."""
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
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
    threshold): one ``planes.plu_solve_multi``, the ``B_i`` passed
    separately and left as they are (JAX donates them); else one
    :func:`bsolve` of the stacked right-hand sides, split after."""
    Bs = tuple(Bs)
    n = A.shape[-(nbatch + 2)]
    mode = _mid(n, A, nbatch, options)
    if mode is not None:
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
