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
  linalg.py:169-243, 391-413, 542-557), on ``[p, q, *b]`` arrays with no
  leading grid dims. Strided operands are made contiguous first (one compact
  copy each).
* Larger blocks (the JAX package's blocked panel and MXU routes) are not
  ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

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
