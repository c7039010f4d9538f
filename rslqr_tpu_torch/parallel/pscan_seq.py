"""Horizon-sharded parallel-scan solve (multi-rank pscan).

Counterpart of the JAX package's ``parallel/pscan_seq.py``: the ``N``
knot points split into contiguous chunks of ``C = N/D`` per rank, and the
suffix scan over value elements decomposes as any associative scan does:

1. local up-sweep: each rank reduces its chunk to ONE full element
   (``pscan._reduce_full``);
2. segment exchange: one all_gather of the ``D`` segment elements; each
   rank computes the reduced suffix chain to its right and takes its seed
   ``r_{d+1}`` (none on the last rank);
3. seeded local scan: the ordinary odd-even suffix scan on the chunk with
   the seed appended (``pscan._suffix_pj(seed=...)``).

The rollout is the mirrored prefix scan over affine maps: local
composition, one all_gather of the ``D`` chunk maps, the serial
chunk-start recursion, then the local ``_prefix_action``. The gains need
one ppermute of the next chunk's first cost-to-go. Communication per
solve: 2 all_gathers and 1 ppermute pair of ``O(n^2 D)`` blocks,
independent of ``N``. On batch-last ``[C, ., ., b]`` chunks, so no hand
kernel runs (mid blocks take :mod:`linalg`'s mat-last route).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import linalg as la
from .. import pscan as ps
from ..config import SolveOptions, resolve_options
from ..problem import LQRProblem
from ..rslqr import _one_batch_axis, _to_batch_last
from . import comm
from .mesh import gather_solution, horizon_shard, local_chunk


def _local_elements(p: LQRProblem, d: int, D: int, nb: int,
                    opts: SolveOptions):
    """Leaf elements ``(F, c, C, eta, J)`` of a local chunk (the leaf
    algebra of ``pscan._value_scan``), with the global terminal element
    (pure cost, no propagation) on the last rank's last knot."""
    B = p.B
    rinv = 1.0 / p.Rdiag
    Brinv = B * rinv.unsqueeze(-(nb + 2))
    F = p.A
    c = p.f - la.bgemv(Brinv, p.r, nb)
    Cm = la.bgemm(Brinv, la.transpose_block(B, nb), nb, opts)
    eta = -p.q
    J = ps._diag_blocks(p.Qdiag.movedim(0, 1)).movedim(2, 0)
    if d == D - 1:  # terminal knot: F = c = C = 0
        term = lambda x: torch.cat([x[:-1], torch.zeros_like(x[-1:])])
        F, c, Cm = term(F), term(c), term(Cm)
    return (F, c, Cm, eta, J)


def solve_pscan_sharded(
    prob: LQRProblem,
    mesh,
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    options: Optional[SolveOptions] = None,
) -> torch.Tensor:
    """Horizon-sharded parallel-scan LQR solve over ``mesh[sp_axis]``.

    Every rank passes the same global ``prob`` (leading batch axes
    optional; sharded over ``dp_axis`` when given) and gets back the full
    KKT vector(s) ``[*batch, nvars]``, the values of
    :func:`rslqr_tpu_torch.solve_pscan_kkt`. The per-rank chunk ``N/D``
    must be a power of two.
    """
    opts = resolve_options(options)
    flat, bshape = _one_batch_axis(prob)
    hs = horizon_shard(flat, mesh, sp_axis, dp_axis)
    D, d, C, group = hs.D, hs.d, hs.C, hs.group
    if C & (C - 1):
        # The chunk-composition fold below halves the chunk each step.
        raise ValueError(f"per-device chunk N/D = {hs.N}/{D} = {C} must be "
                         "a power of two")
    nb = 1
    p = local_chunk(_to_batch_last(flat, 1), hs)

    # Backward: the seeded suffix scan of value elements.
    elems = _local_elements(p, d, D, nb, opts)
    seed = None
    if D > 1:
        T = ps._reduce_full(elems, nb, opts)  # [1, ...] chunk element
        Tg = tuple(comm.all_gather(t[0], group) for t in T)  # [D, ...]
        if d < D - 1:
            # Reduced suffix chain over the segments right of this one.
            seed = (Tg[3][D - 1:], Tg[4][D - 1:])
            for dd in range(D - 2, d, -1):
                seed = ps._combine_reduced(
                    tuple(t[dd:dd + 1] for t in Tg), seed, nb, opts)
    eta_all, J_all = ps._suffix_pj(elems, nb, opts, seed=seed)
    Pk, pk = J_all, -eta_all

    # Gains from the next knot's cost-to-go; the chunk's last knot reads
    # the next chunk's first (the last rank gets zeros: its terminal gain
    # is scratch).
    perm = [(dd, dd - 1) for dd in range(1, D)]
    Pn = torch.cat([Pk[1:], comm.ppermute(Pk[0], group, perm)[None]])
    pn = torch.cat([pk[1:], comm.ppermute(pk[0], group, perm)[None]])
    K, dgain = ps._gains_from(p.A, p.B, p.Rdiag, p.r, p.f, Pn, pn, nb, opts)

    # Forward: the seeded prefix scan of the closed-loop affine maps.
    Phi = p.A + la.bgemm(p.B, K, nb, opts)
    tv = la.bgemv(p.B, dgain, nb) + p.f
    Mc, tc = Phi, tv  # chunk composition, earlier map first
    while Mc.shape[0] > 1:
        Me, Mo = ps._even_odd(Mc)
        te, to = ps._even_odd(tc)
        Mc, tc = la.bgemm(Mo, Me, nb, opts), la.bgemv(Mo, te, nb) + to
    Mg = comm.all_gather(Mc[0], group)  # [D, n, n, b]
    tg = comm.all_gather(tc[0], group)
    x_start = p.x0  # the serial chunk-start recursion up to this chunk
    for dd in range(d):
        x_start = la.bgemv(Mg[dd], x_start, nb) + tg[dd]
    a = ps._prefix_action(Phi, tv, x_start, nb, opts)  # [C, n, b]
    X = torch.cat([x_start[None], a[:-1]])
    U = la.bgemv(K, X, nb) + dgain  # the terminal entry is scratch
    Y = la.bgemv(Pk, X, nb) + pk
    kkt = gather_solution(hs, Y, X, U)
    return kkt.reshape(bshape + kkt.shape[-1:])
