"""rsLQR front door: recursive Schur-complement (nested dissection) solve.

Counterpart of the entry points of ``rslqr_tpu.rslqr`` (rslqr.py:90-124,
218-227, 444-449, 536-592). Every solve runs the element-major path of
:mod:`rslqr_tpu_torch.rslqr_em`, for small and mid-size blocks (n, m <= 64):
any number of leading batch axes is flattened to one (a single problem runs
as a batch of one), so on CUDA the kernel path is the only path. The
knot-major grid path and the large-block route of the JAX package are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import SolveOptions, resolve_options
from .problem import LQRProblem, pack_solution
from .ops.planes import MAX_BLOCK
from .tree import TreeTables


@dataclasses.dataclass(frozen=True)
class RsLqrSolution:
    """Solution of one (possibly batched) rsLQR solve: ``Y``/``X`` are
    ``[*batch, N, n]``, ``U`` is ``[*batch, N-1, m]``; ``fact`` is the
    factorization (batch flattened to one trailing axis)."""

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


def _leaf_rhs_transform(prob: LQRProblem, rhs):
    """Leaf-solve an arbitrary RHS given in batch-last ``(zy, zx, zu)``
    block form (``[N, n|m, *b]``) against batch-last ``prob``.

    The z-vector half of ndlqr_SolveLeaf (nested_dissection.c:42-58,
    79-90), a linear map independent of the factors, so it also serves
    fresh right-hand sides (iterative refinement):

      k = 0:   zy' = -Q0 zy - zx;  zx' = -zy;  zu' = R0^{-1} zu
      k >= 1:  zx' = Qk^{-1} zx;   zu' = Rk^{-1} zu (k < N-1);  zy' = zy
    """
    zy, zx, zu = rhs
    zy0 = zy[0]
    zy = torch.cat([(-prob.Qdiag[0] * zy0 - zx[0])[None], zy[1:]])
    zx = torch.cat([-zy0[None], zx[1:] * (1.0 / prob.Qdiag[1:])])
    zu = torch.cat([zu[:-1] * (1.0 / prob.Rdiag[:-1]), zu[-1:]])
    return zy, zx, zu


def _lambda_mask(N: int, span: int, mid: int) -> np.ndarray:
    """calc_lambda (nested_dissection.c:173-177) as a static ``[G, span]``
    pattern: the left-range start (position 0) and right-range start
    (position mid) of each group skip the lambda update, except knot 0."""
    mask = np.ones((N // span, span), dtype=bool)
    mask[:, 0] = False
    mask[:, mid] = False
    mask[0, 0] = True
    return mask


def solve(
    prob: LQRProblem,
    tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """Full rsLQR solve (ref ndlqr_Solve, solve.c:38-190) of a single
    problem or a batch (leading batch axes on every field), on the device
    of the problem's tensors.

    Blocks up to 64 run the element-major path (JAX ``_use_em_layout``,
    rslqr.py:498-533): small blocks through the Schur sweep kernels, mid
    blocks (above ``mxu_block_threshold``) through the element-plane
    kernels. Larger blocks raise ``NotImplementedError``.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: the plain stages may
    lower to batched matmuls, and TF32 would cut them to ~3 digits.
    """
    from . import rslqr_em

    flat, bshape = _one_batch_axis(prob)
    sol = rslqr_em.solve_em(flat, tables, options=resolve_options(options))
    unflat = lambda x: x.reshape(bshape + x.shape[1:])
    return RsLqrSolution(
        Y=unflat(sol.Y), X=unflat(sol.X), U=unflat(sol.U), fact=sol.fact
    )


def _one_batch_axis(prob: LQRProblem):
    """The front door's preparation for the element-major path: TF32 off,
    blocks up to ``MAX_BLOCK`` (larger ones raise ``NotImplementedError``),
    leading batch axes flattened to one. Returns the flattened problem and
    the batch shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, m = prob.nstates, prob.ninputs
    if max(n, m) > MAX_BLOCK:
        raise NotImplementedError(
            f"blocks n={n}, m={m} above {MAX_BLOCK}: the large-block "
            "route is not ported yet"
        )
    bshape = prob.batch_shape
    return prob.map(lambda x: x.reshape((-1,) + x.shape[len(bshape):])), bshape


def solve_kkt(
    prob: LQRProblem, options: Optional[SolveOptions] = None
) -> torch.Tensor:
    """Solve and return the flat KKT vector(s) ``[*b, nvars]``."""
    return solve(prob, options=options).kkt_vector()
