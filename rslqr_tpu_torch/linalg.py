"""Batched small-block linear algebra in batch-last layout.

Counterpart of the small-block part of ``rslqr_tpu.linalg``. Block arrays
have shape ``[..., p, q, *b]`` with ``nbatch`` trailing batch axes; the
tiny block dims (n=6, m=3) unroll into elementwise ops over ``[..., *b]``,
exactly as the JAX lane kernels do. The element-major solve treats the knot
axis as one more batch axis (``nbatch + 1``).

The mid/large-block dispatch of the JAX module (element-plane kernels,
blocked panel factorizations, MXU lowerings) is not ported yet.
"""

from __future__ import annotations

import torch


def _at(M: torch.Tensor, i: int, j: int, nbatch: int) -> torch.Tensor:
    """Block element ``M[..., i, j, *b]``."""
    return M[(Ellipsis, i, j) + (slice(None),) * nbatch]


def _row(M: torch.Tensor, i: int, nbatch: int) -> torch.Tensor:
    """Block row ``M[..., i, :, *b]``."""
    return M[(Ellipsis, i, slice(None)) + (slice(None),) * nbatch]


def bgemm(A: torch.Tensor, B: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """``[..., p, q, *b] @ [..., q, r, *b] -> [..., p, r, *b]`` as a
    broadcast multiply-reduce over the tiny contraction axis (leading dims
    broadcast)."""
    Ae = A.unsqueeze(-(nbatch + 1))  # [..., p, q, 1, *b]
    Be = B.unsqueeze(-(nbatch + 3))  # [..., 1, q, r, *b]
    return (Ae * Be).sum(-(nbatch + 2))


def bgemv(A: torch.Tensor, x: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """``[..., p, q, *b] @ [..., q, *b] -> [..., p, *b]``."""
    return (A * x.unsqueeze(-(nbatch + 2))).sum(-(nbatch + 1))


def bcholesky(A: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """Cholesky of SPD blocks ``[..., n, n, *b]`` -> lower ``L``: unrolled
    Cholesky-Banachiewicz, every step an elementwise op on ``[..., *b]``
    (the reference's unblocked factorization, linalg_custom.c:88-111)."""
    n = A.shape[-(nbatch + 2)]
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


def bcho_solve(L: torch.Tensor, B: torch.Tensor, nbatch: int = 1):
    """Solve ``(L L') X = B`` given the Cholesky factor: two substitutions
    (clap_CholeskySolve, linalg_custom.c:134-138)."""
    return btrsm_lower_t(L, btrsm_lower(L, B, nbatch), nbatch)


def bcho_solve_vec(L: torch.Tensor, b: torch.Tensor, nbatch: int = 1):
    """Vector right-hand side: ``[..., n, n, *b] \\ [..., n, *b]``."""
    return bcho_solve(L, b.unsqueeze(-(nbatch + 1)), nbatch).squeeze(
        -(nbatch + 1)
    )


def transpose_block(A: torch.Tensor, nbatch: int = 1) -> torch.Tensor:
    """Transpose the block dims of ``[..., p, q, *b]``."""
    return A.transpose(-(nbatch + 2), -(nbatch + 1))
