"""Parallel-scan LQR solver: the Riccati recursion as associative scans.

Counterpart of ``rslqr_tpu.pscan``, the third solver family (after the
rsLQR tree solve and the serial Riccati oracle): the backward recursion is
an associative suffix scan over conditional value-function elements
``(F, c, C, eta, J)``, the rollout a prefix scan over affine maps
(Särkkä & García-Fernández, IEEE TAC 2021; the combine's algebra is in
``rslqr_tpu/pscan.py:14-38``). Same algorithm, element algebra and scan
structure as the JAX module, function for function; each ``lax.scan``
becomes a Python loop over contiguous ``[s, ...]`` slices.

:func:`solve_pscan` routes by block size and ``layout`` (leading batch
axes flattened to one; JAX pscan.py:1078-1130):

* small blocks (n, m at most ``mxu_block_threshold``), ``layout="grid"``,
  and blocks above 64 (the large-block route): the batch-last path
  (elements ``[L, n, n, B]``). The tiny block dims unroll in :mod:`linalg`;
  mid and large blocks, whose operands carry the leading scan axis, take
  its mat-last route (``torch.matmul``, ``torch.linalg``), one batched call
  for the whole batch where JAX vmaps single solves (pscan.py:1101-1109).
  No hand kernel runs on this path;
* mid blocks (above the threshold, at most 64; the quadruped config) under
  ``"auto"`` or ``"em"``: the element-major path on ``[p, q, L, B]`` slabs
  with the chunked hybrid scan. Its products run ``planes.pgemm`` (B5, with
  its flags) through ``linalg.bgemm``/``bgemm_tt``; its ``I + C J`` and
  Woodbury ``I + V J U`` solves run ``planes.plu_solve_multi`` (B8) through
  ``linalg.bsolve_multi``; with ``pscan_chunk=1`` or
  ``pscan_batched_interior`` the gains pass adds ``pchol`` and
  ``pcho_solve`` (B6, B7).

Every linalg call gets the solve's options (kernel mode, threshold). No
operand is updated in place: the kernels of this path write new tensors,
since the scan hands them strided views (``_even_odd``) and operands it reads
again. Not ported yet: the JAX module's ``_reduce_full`` and ``seed`` (used
only by its horizon-sharded solver).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import linalg as la
from .config import SolveOptions, resolve_options
from .ops.planes import MAX_BLOCK
from .problem import LQRProblem, pack_solution
from .riccati import RiccatiSolution
from .rslqr import _bf, _one_batch_axis, _to_batch_last
from .spans import entry, span


def _eye_like(S: torch.Tensor, nb: int) -> torch.Tensor:
    """Identity blocks broadcast to ``S``'s shape ``[m, m, *b]``."""
    m = S.shape[0]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    return eye.reshape((m, m) + (1,) * nb).expand(S.shape)


def _diag_blocks(d: torch.Tensor) -> torch.Tensor:
    """``[n, *b]`` -> diagonal blocks ``[n, n, *b]``."""
    n = d.shape[0]
    out = d.new_zeros((n,) + d.shape)
    ar = torch.arange(n, device=d.device)
    out[ar, ar] = d
    return out


def _combine(e1, e2, nb: int, opts: SolveOptions):
    """Associative combine of conditional-value-function elements ``e =
    (F, c, C, eta, J)`` (``[..., n, n, *b]`` / ``[..., n, *b]``), with one
    factorization of ``I + C1 J2``: the Woodbury-style identities route
    every ``M2 = (I + J2 C1)^-1`` application through ``M1 = (I + C1
    J2)^-1`` (JAX pscan.py:58-112). Small blocks: unrolled LU and one
    stacked solve; mid blocks: one multi-RHS LU kernel."""
    F1, c1, C1, eta1, J1 = e1
    F2, c2, C2, eta2, J2 = e2
    n = F1.shape[-(nb + 2)]
    ax = -(nb + 1)

    IC = la.bgemm_tt(C1, J2, nb, dconst=1.0, options=opts)
    w = eta2 - la.bgemv(J2, c1, nb)
    b_c = (c1 + la.bgemv(C1, eta2, nb)).unsqueeze(ax)
    b_w = la.bgemv(C1, w, nb).unsqueeze(ax)
    F1t = la.transpose_block(F1, nb)
    if n <= opts.mxu_block_threshold:
        rhs = torch.cat([F1, b_c, C1, b_w], dim=ax)
        LU, dinv = la.blu_factor(IC, nb)
        sol = la.blu_solve(LU, dinv, rhs, nb)
        MF1, Mcm, MC1, MCwm = torch.split(sol, [n, 1, n, 1], dim=ax)
    else:
        MF1, Mcm, MC1, MCwm = la.bsolve_multi(IC, (F1, b_c, C1, b_w), nb,
                                              opts)
    Mc, MCw = Mcm.squeeze(ax), MCwm.squeeze(ax)

    F = la.bgemm(F2, MF1, nb, opts)
    c = la.bgemv(F2, Mc, nb) + c2
    # C and J are symmetric: sym computes the lower triangle only, tbt reads
    # F2 transposed, cin adds C2 / J1 in the same pass.
    C = la.bgemm_tt(la.bgemm(F2, MC1, nb, opts), F2, nb, tbt=True, cin=C2,
                    sub=False, sym=True, options=opts)
    J = la.bgemm_tt(F1t, la.bgemm(J2, MF1, nb, opts), nb, cin=J1, sub=False,
                    sym=True, options=opts)
    eta = la.bgemv(F1t, w - la.bgemv(J2, MCw, nb), nb) + eta1
    return (F, c, C, eta, J)


def _combine_reduced(e1, pj2, nb: int, opts: SolveOptions):
    """Reduced combine: a full left element and the right segment's
    ``(eta2, J2)`` -> ``(eta, J)`` of the combination only (every down-sweep
    result is consumed as a cost-to-go; JAX pscan.py:115-148)."""
    F1, c1, C1, eta1, J1 = e1
    eta2, J2 = pj2
    n = F1.shape[-(nb + 2)]
    ax = -(nb + 1)

    IC = la.bgemm_tt(C1, J2, nb, dconst=1.0, options=opts)
    w = eta2 - la.bgemv(J2, c1, nb)
    b_w = la.bgemv(C1, w, nb).unsqueeze(ax)
    F1t = la.transpose_block(F1, nb)
    if n <= opts.mxu_block_threshold:
        rhs = torch.cat([F1, b_w], dim=ax)
        LU, dinv = la.blu_factor(IC, nb)
        sol = la.blu_solve(LU, dinv, rhs, nb)
        MF1, MCwm = torch.split(sol, [n, 1], dim=ax)
    else:
        MF1, MCwm = la.bsolve_multi(IC, (F1, b_w), nb, opts)
    MCw = MCwm.squeeze(ax)

    J = la.bgemm_tt(F1t, la.bgemm(J2, MF1, nb, opts), nb, cin=J1, sub=False,
                    sym=True, options=opts)
    eta = la.bgemv(F1t, w - la.bgemv(J2, MCw, nb), nb) + eta1
    return eta, J


# Scan-axis helpers: the leading axis, or -2 in element-major mode (arrays
# ``[p(, q), L, B]`` with the scan second-minor).


def _sc(x: torch.Tensor, sl, em: bool = False) -> torch.Tensor:
    return x[(Ellipsis, sl, slice(None))] if em else x[sl]


def _cat(xs, em: bool = False) -> torch.Tensor:
    return torch.cat(xs, dim=-2 if em else 0)


def _slen(x: torch.Tensor, em: bool = False) -> int:
    return x.shape[-2] if em else x.shape[0]


def _tree_slice(elems, sl, em: bool = False):
    return tuple(_sc(x, sl, em) for x in elems)


def _even_odd(x: torch.Tensor, em: bool = False):
    """Even and odd positions of an even-length scan axis (strided views;
    the JAX module's reshape variant for large blocks is a TPU layout
    choice)."""
    return _sc(x, slice(0, None, 2), em), _sc(x, slice(1, None, 2), em)


def _tree_even_odd(elems, em: bool = False):
    pairs = [_even_odd(x, em) for x in elems]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def _interleave(a: torch.Tensor, b: torch.Tensor, em: bool = False):
    """``[L, ...]``, ``[L, ...]`` -> ``[2L, ...]`` as a0 b0 a1 b1 ... on the
    scan axis."""
    if em:
        L = a.shape[-2]
        out = a.new_empty(a.shape[:-2] + (2 * L, a.shape[-1]))
        out[..., 0::2, :] = a
        out[..., 1::2, :] = b
        return out
    return torch.stack([a, b], dim=1).reshape((-1,) + a.shape[1:])


def _suffix_pj(elems, nb: int, opts: SolveOptions, em: bool = False,
               seed=None):
    """All-suffix reductions of value elements, returning only ``(eta,
    J)``: an odd-even (Brent-Kung) suffix scan whose up-sweep combines full
    pairs and whose down-sweep uses :func:`_combine_reduced` (JAX
    pscan.py:209-260).

    ``seed``: an optional cost-to-go pair ``(eta [1, n, *b], J [1, n, n,
    *b])`` appended after the last element, ``S_k = reduce(e_k .. e_{L-1},
    seed)``: the horizon-sharded scan (:mod:`rslqr_tpu_torch.parallel.
    pscan_seq`) seeds each chunk with the combined suffix of the chunks to
    its right. Without it the scan is unchanged."""
    L = _slen(elems[0], em)
    if L == 1:
        if seed is None:
            return elems[3], elems[4]
        return _combine_reduced(elems, seed, nb, opts)
    if L % 2 == 1:
        # Peel the first element: S_0 = combine(e_0, S_1).
        eta_r, J_r = _suffix_pj(_tree_slice(elems, slice(1, None), em), nb,
                                opts, em, seed)
        e0 = _tree_slice(elems, slice(0, 1), em)
        eta0, J0 = _combine_reduced(
            e0, (_sc(eta_r, slice(0, 1), em), _sc(J_r, slice(0, 1), em)), nb,
            opts,
        )
        return _cat([eta0, eta_r], em), _cat([J0, J_r], em)
    e_even, e_odd = _tree_even_odd(elems, em)
    c = _combine(e_even, e_odd, nb, opts)  # segment [2i, 2i+1]
    eta_p, J_p = _suffix_pj(c, nb, opts, em, seed)  # S_{2i}
    # S_{2i+1} = combine(e_{2i+1}, S_{2i+2}) for i < L/2-1; S_{L-1} = e_{L-1}
    # (combined with the seed, if any).
    e_last = _tree_slice(e_odd, slice(-1, None), em)
    if seed is None:
        eta_last, J_last = e_last[3], e_last[4]
    else:
        eta_last, J_last = _combine_reduced(e_last, seed, nb, opts)
    if L > 2:
        eta_o, J_o = _combine_reduced(
            _tree_slice(e_odd, slice(0, -1), em),
            (_sc(eta_p, slice(1, None), em), _sc(J_p, slice(1, None), em)),
            nb, opts,
        )
        eta_odd = _cat([eta_o, eta_last], em)
        J_odd = _cat([J_o, J_last], em)
    else:
        eta_odd, J_odd = eta_last, J_last
    return _interleave(eta_p, eta_odd, em), _interleave(J_p, J_odd, em)


def _reduce_full(elems, nb: int, opts: SolveOptions, em: bool = False):
    """Reduce a whole element sequence to ONE full element ``[1, ...]`` by
    a pairwise tree, the same pair combines as the up-sweep of
    :func:`_suffix_pj` (JAX pscan.py:263-285)."""
    L = _slen(elems[0], em)
    while L > 1:
        if L % 2 == 1:
            head = _tree_slice(elems, slice(0, 1), em)
            rest = _tree_slice(elems, slice(1, None), em)
            rest_even, rest_odd = _tree_even_odd(rest, em)
            c = _combine(rest_even, rest_odd, nb, opts)
            e0c = _combine(head, _tree_slice(c, slice(0, 1), em), nb, opts)
            elems = tuple(_cat([a, _sc(b, slice(1, None), em)], em)
                          for a, b in zip(e0c, c))
        else:
            e_even, e_odd = _tree_even_odd(elems, em)
            elems = _combine(e_even, e_odd, nb, opts)
        L = _slen(elems[0], em)
    return elems


# ---------------------------------------------------------------------------
# Small blocks: the batch-last path (``[N, n, n, B]``, nb = 1).
# ---------------------------------------------------------------------------


def _value_scan(prob_bl: LQRProblem, nb: int, opts: SolveOptions):
    """Suffix-scan all cost-to-go pairs ``(P [N, n, n, *b], p [N, n, *b])``
    (JAX pscan.py:286-322)."""
    A, B = prob_bl.A, prob_bl.B
    N, n = A.shape[0], A.shape[1]
    rinv = 1.0 / prob_bl.Rdiag
    Brinv = B * rinv.unsqueeze(-(nb + 2))  # B R^-1: scale B's columns
    Bt = la.transpose_block(B, nb)

    # Leaf elements of steps 0..N-2, then the terminal pure-cost element.
    F = A[:-1]
    c = prob_bl.f[:-1] - la.bgemv(Brinv[:-1], prob_bl.r[:-1], nb)
    C = la.bgemm(Brinv[:-1], Bt[:-1], nb, opts)
    eta = -prob_bl.q[:-1]
    Jq = _diag_blocks(prob_bl.Qdiag.movedim(0, 1)).movedim(2, 0)
    zF = torch.zeros_like(A[:1])
    elems = (
        torch.cat([F, zF], dim=0),
        torch.cat([c, torch.zeros_like(c[:1])], dim=0),
        torch.cat([C, zF], dim=0),
        torch.cat([eta, -prob_bl.q[-1:]], dim=0),
        Jq,
    )
    eta_all, J_all = _suffix_pj(elems, nb, opts)
    return J_all, -eta_all


def _gains(prob_bl: LQRProblem, P, p, nb: int, opts: SolveOptions):
    """Gains of every step from the next step's cost-to-go (JAX
    pscan.py:325-334)."""
    return _gains_from(
        prob_bl.A[:-1], prob_bl.B[:-1], prob_bl.Rdiag[:-1], prob_bl.r[:-1],
        prob_bl.f[:-1], P[1:], p[1:], nb, opts,
    )


def _gains_from(A, B, Rd, r, f, Pn, pn, nb: int, opts: SolveOptions):
    """The serial backward step's gain algebra (riccati_solve.c:50-93) on
    explicit per-knot arrays, all knots at once (JAX pscan.py:337-352)."""
    Bt = la.transpose_block(B, nb)
    BtP = la.bgemm(Bt, Pn, nb, opts)
    Quu = la.bgemm_tt(BtP, B, nb, diag=Rd, sym=True, options=opts)
    Qux = la.bgemm(BtP, A, nb, opts)
    Qu = r + la.bgemv(Bt, la.bgemv(Pn, f, nb) + pn, nb)
    Lc = la.bcholesky(Quu, nb, opts)
    K = -la.bcho_solve(Lc, Qux, nb, opts)
    d = -la.bcho_solve_vec(Lc, Qu, nb, opts)
    return K, d


def _prefix_action(Phi, tvec, x0, nb: int, opts: SolveOptions):
    """All-prefix actions ``a_k = (Phi_k o ... o Phi_0)(x0)``, i.e.
    ``x_{k+1}``: an odd-even prefix scan whose down-sweep propagates only
    the maps' action on ``x0`` (JAX pscan.py:355-383)."""
    L = Phi.shape[0]
    if L == 1:
        return (la.bgemv(Phi[0], x0, nb) + tvec[0])[None]
    if L % 2 == 1:
        head = _prefix_action(Phi[:-1], tvec[:-1], x0, nb, opts)
        last = la.bgemv(Phi[-1], head[-1], nb) + tvec[-1]
        return torch.cat([head, last[None]], dim=0)
    Phi_e, Phi_o = _even_odd(Phi)
    t_e, t_o = _even_odd(tvec)
    Phi_c = la.bgemm(Phi_o, Phi_e, nb, opts)  # segment [2i, 2i+1]
    t_c = la.bgemv(Phi_o, t_e, nb) + t_o
    a_pair = _prefix_action(Phi_c, t_c, x0, nb, opts)  # a_{2i+1}
    a0 = la.bgemv(Phi_e[0], x0, nb) + t_e[0]
    if L > 2:
        a_even_rest = la.bgemv(Phi_e[1:], a_pair[:-1], nb) + t_e[1:]
        a_even = torch.cat([a0[None], a_even_rest], dim=0)
    else:
        a_even = a0[None]
    return _interleave(a_even, a_pair)


def _forward_scan(prob_bl: LQRProblem, K, d, nb: int, opts: SolveOptions):
    """Prefix-scan the closed-loop rollout ``x_{k+1} = Phi_k x_k + t_k``."""
    A, B = prob_bl.A[:-1], prob_bl.B[:-1]
    Phi = A + la.bgemm(B, K, nb, opts)
    tvec = la.bgemv(B, d, nb) + prob_bl.f[:-1]
    xs = _prefix_action(Phi, tvec, prob_bl.x0, nb, opts)  # [N-1, n, *b]
    return torch.cat([prob_bl.x0[None], xs], dim=0)


# ---------------------------------------------------------------------------
# Mid blocks: the element-major path (``[p, q, L, B]``, nb = 2).
# ---------------------------------------------------------------------------


def _combine_leaf_pair(l1, l2, nb: int, opts: SolveOptions):
    """Full combine of two LEAF elements ``(A, Brinv, Bt, c, eta, Qd)``:
    ``C1 = U V`` has rank m and ``J2 = diag(Qd2)``, so the n-by-n ``I + C1
    J2`` solve collapses to the m-by-m Woodbury solve ``Sm = I + V J2 U``,
    and ``M1 U = U Sm^-1`` carries every M1 application (JAX
    pscan.py:396-441)."""
    A1, U1, V1, c1, eta1, Qd1 = l1
    A2, U2, V2, c2, eta2, Qd2 = l2

    T = V1 * Qd2[None]  # B1' J2: column j scaled by Qd2[j]
    Sm = la.bgemm_tt(T, U1, nb, dconst=1.0, options=opts)
    (G_I,) = la.bsolve_multi(Sm, (_eye_like(Sm, nb),), nb, opts)
    M1U = la.bgemm_tt(U1, G_I, nb, options=opts)  # U Sm^-1 [n, m]
    TA1 = la.bgemm_tt(T, A1, nb, options=opts)    # [m, n]
    MF1 = A1 - la.bgemm_tt(M1U, TA1, nb, options=opts)

    F = la.bgemm_tt(A2, MF1, nb, options=opts)
    # C = F2 (M1 C1) F2' + C2 = (F2 M1U) (V1 F2') + C2.
    W = la.bgemm_tt(A2, M1U, nb, options=opts)            # [n, m]
    Vt = la.bgemm_tt(V1, A2, nb, tbt=True, options=opts)  # B1' A2' [m, n]
    C2 = la.bgemm_tt(U2, V2, nb, options=opts)            # Brinv2 B2'
    C = la.bgemm_tt(W, Vt, nb, cin=C2, sub=False, sym=True, options=opts)
    # J = F1' diag(Qd2) (M1 F1) + diag(Qd1).
    J = la.bgemm_tt(A1, MF1, nb, ta=True, kscale=Qd2, diag=Qd1, sym=True,
                    options=opts)

    b_c = c1 + la.bgemv(U1, la.bgemv(V1, eta2, nb), nb)
    c = la.bgemv(A2, b_c - la.bgemv(M1U, la.bgemv(T, b_c, nb), nb), nb) + c2
    w = eta2 - Qd2 * c1
    MCw = la.bgemv(M1U, la.bgemv(V1, w, nb), nb)  # M1 C1 w = M1U (V1 w)
    eta = la.bgemv(la.transpose_block(A1, nb), w - Qd2 * MCw, nb) + eta1
    return (F, c, C, eta, J)


def _combine_reduced_leaf(l1, pj2, nb: int, opts: SolveOptions, gains=None):
    """Reduced combine with a LEAF left element (the rank-m Woodbury form of
    :func:`_combine_reduced`): one backward Riccati step. ``gains``:
    ``(rinv1 [m, *b], r1 [m, *b])``; when given, also the step's gains
    ``K = -R^-1 (Sm^-1 Qux)``, ``d = R^-1 (Sm^-1 (B' w) - r)`` from the
    Woodbury intermediates (``Sm = Quu R^-1``, ``TA1 = Qux``; JAX
    pscan.py:444-492)."""
    A1, U1, V1, c1, eta1, Qd1 = l1
    eta2, J2 = pj2

    T = la.bgemm_tt(V1, J2, nb, options=opts)  # B1' J2 [m, n]
    Sm = la.bgemm_tt(T, U1, nb, dconst=1.0, options=opts)
    (G_I,) = la.bsolve_multi(Sm, (_eye_like(Sm, nb),), nb, opts)
    M1U = la.bgemm_tt(U1, G_I, nb, options=opts)
    TA1 = la.bgemm_tt(T, A1, nb, options=opts)
    MF1 = A1 - la.bgemm_tt(M1U, TA1, nb, options=opts)

    J2MF1 = la.bgemm_tt(J2, MF1, nb, options=opts)
    J = la.bgemm_tt(A1, J2MF1, nb, ta=True, diag=Qd1, sym=True, options=opts)
    w = eta2 - la.bgemv(J2, c1, nb)
    Vw = la.bgemv(V1, w, nb)  # B1' w [m]
    MCw = la.bgemv(M1U, Vw, nb)
    eta = la.bgemv(la.transpose_block(A1, nb), w - la.bgemv(J2, MCw, nb),
                   nb) + eta1
    if gains is None:
        return eta, J
    rinv1, r1 = gains
    K = -rinv1.unsqueeze(-(nb + 1)) * la.bgemm_tt(G_I, TA1, nb, options=opts)
    d = rinv1 * (la.bgemv(G_I, Vw, nb) - r1)
    return eta, J, K, d


def _combine_leaf_full(l1, e2, nb: int, opts: SolveOptions):
    """Full combine of a LEAF left element with a generic right element
    (the rank-m Woodbury route of :func:`_combine`): the serial fold step of
    the chunked scan (JAX pscan.py:495-534)."""
    A1, U1, V1, c1, eta1, Qd1 = l1
    F2, c2, C2, eta2, J2 = e2

    T = la.bgemm_tt(V1, J2, nb, options=opts)  # B1' J2 [m, n]
    Sm = la.bgemm_tt(T, U1, nb, dconst=1.0, options=opts)
    (G_I,) = la.bsolve_multi(Sm, (_eye_like(Sm, nb),), nb, opts)
    M1U = la.bgemm_tt(U1, G_I, nb, options=opts)  # U Sm^-1 [n, m]
    TA1 = la.bgemm_tt(T, A1, nb, options=opts)    # [m, n]
    MF1 = A1 - la.bgemm_tt(M1U, TA1, nb, options=opts)  # M1 A1

    F = la.bgemm_tt(F2, MF1, nb, options=opts)
    # C = F2 (M1 C1) F2' + C2 with M1 C1 = M1U V1 (rank m).
    W = la.bgemm_tt(F2, M1U, nb, options=opts)            # [n, m]
    Vt = la.bgemm_tt(V1, F2, nb, tbt=True, options=opts)  # V1 F2' [m, n]
    C = la.bgemm_tt(W, Vt, nb, cin=C2, sub=False, sym=True, options=opts)
    # J = F1' (J2 M1 F1) + diag(Qd1).
    J2MF1 = la.bgemm_tt(J2, MF1, nb, options=opts)
    J = la.bgemm_tt(A1, J2MF1, nb, ta=True, diag=Qd1, sym=True, options=opts)

    b_c = c1 + la.bgemv(U1, la.bgemv(V1, eta2, nb), nb)
    c = la.bgemv(F2, b_c - la.bgemv(M1U, la.bgemv(T, b_c, nb), nb), nb) + c2
    w = eta2 - la.bgemv(J2, c1, nb)
    MCw = la.bgemv(M1U, la.bgemv(V1, w, nb), nb)  # M1 C1 w
    eta = la.bgemv(la.transpose_block(A1, nb), w - la.bgemv(J2, MCw, nb),
                   nb) + eta1
    return (F, c, C, eta, J)


def _suffix_pj_leaf_em(leaf, nb: int, opts: SolveOptions):
    """Unchunked scan on structured leaves: leaf-pair combines, the generic
    :func:`_suffix_pj` over the composites, the finest down-sweep level by
    :func:`_combine_reduced_leaf` (JAX pscan.py:537-572)."""
    sp = [_even_odd(x, em=True) for x in leaf]
    l1 = tuple(p[0] for p in sp)
    l2 = tuple(p[1] for p in sp)
    comp = _combine_leaf_pair(l1, l2, nb, opts)
    eta_p, J_p = _suffix_pj(comp, nb, opts, em=True)
    L2 = l1[0].shape[-2]
    eta2, Qd2 = l2[4], l2[5]
    eta_last = eta2[..., L2 - 1:, :]  # terminal element: eta = -q_N
    J_last = _diag_blocks(Qd2[..., L2 - 1:, :])
    if L2 > 1:
        head = lambda x: x[..., :L2 - 1, :]
        tail = lambda x: x[..., 1:, :]
        eta_o, J_o = _combine_reduced_leaf(
            tuple(head(x) for x in l2), (tail(eta_p), tail(J_p)), nb, opts
        )
        eta_odd = _cat([eta_o, eta_last], em=True)
        J_odd = _cat([J_o, J_last], em=True)
    else:
        eta_odd, J_odd = eta_last, J_last
    return (_interleave(eta_p, eta_odd, em=True),
            _interleave(J_p, J_odd, em=True))


def _leaf_em(pem, nb: int, opts: SolveOptions):
    """Element-major structured leaves ``(A, Brinv, Bt, c, eta, Qd)`` over
    all N slots; the terminal slot's zeroed dynamics make it the pure-cost
    element (JAX pscan.py:575-600)."""
    A, B = pem["A"], pem["B"]
    n, m = A.shape[0], B.shape[1]
    N = A.shape[2]
    Brinv = B * (1.0 / pem["Rdiag"])[None]
    S = lambda x: x[..., :N - 1, :]
    c_dyn = S(pem["f"]) - la.bgemv(S(Brinv), S(pem["r"]), nb)
    zero = lambda x: torch.zeros_like(x[..., :1, :])
    last0 = lambda x: _cat([S(x), zero(x)], em=True)
    return (
        last0(A),
        last0(Brinv),
        last0(B.transpose(0, 1)),
        _cat([c_dyn, zero(c_dyn)], em=True),
        -pem["q"],
        pem["Qdiag"],
    )


def _value_scan_chunked_em(pem, nb: int, opts: SolveOptions, s: int,
                           gains: bool = False, batched: bool = False):
    """Chunked hybrid suffix scan (JAX pscan.py:603-757): serial Woodbury
    leaf folds build one full composite per ``s``-knot chunk, the odd-even
    tree reduces the ``N/s`` composites, and the interior cost-to-gos come
    from ``s - 1`` serial Woodbury-Riccati steps seeded by the next chunk's
    boundary suffix. The leaves are laid out once as contiguous ``[s, p,
    q, C, B]`` slabs, so every serial step reads contiguous ``[p, q, C, B]``
    slices. ``gains``: run the down-sweep at every in-chunk position and
    return ``(P, p, K, d)`` from its Woodbury intermediates; with
    ``batched`` the interior cost-to-gos come instead from ONE reduced
    combine of the fold's emitted composites at ``C*(s-1)*B`` width, and
    the gains from one full-width gains pass. Stages in their spans:
    ``leaf``, ``fold``, ``scan`` (across chunks) and ``down``."""
    N = pem["A"].shape[-2]
    C = N // s

    def chunkify(x):  # [.., N, B] -> [s, .., C, B], contiguous
        y = x.reshape(x.shape[:-2] + (C, s, x.shape[-1]))
        return y.movedim(-2, 0).contiguous()

    def unchunk_s(y):  # [s, .., C, B] -> [.., N, B]
        y = y.movedim(0, -2)
        return y.reshape(y.shape[:-3] + (N, y.shape[-1]))

    with span("leaf"):
        lc = tuple(chunkify(x) for x in _leaf_em(pem, nb, opts))
    lj = lambda j: tuple(x[j] for x in lc)
    emit = gains and batched

    # Serial fold, in-chunk positions s-3 .. 0: comp covers j .. s-1.
    with span("fold"):
        comp0 = _combine_leaf_pair(lj(s - 2), lj(s - 1), nb, opts)
        comp = comp0
        suffix_comps = [comp0]  # emit: the composites of positions s-2 .. 0
        for j in reversed(range(s - 2)):
            comp = _combine_leaf_full(lj(j), comp, nb, opts)
            if emit:
                suffix_comps.append(comp)

    with span("scan"):
        eta_s, J_s = _suffix_pj(comp, nb, opts, em=True)  # at chunk starts
    with span("down"):
        # Interior seeds: the NEXT chunk's boundary suffix; zeros for the
        # last chunk (annihilated by the terminal leaf's zeroed dynamics).
        shift = lambda x: torch.cat(
            [x[..., 1:, :], torch.zeros_like(x[..., :1, :])], dim=-2)
        eta_v, J_v = shift(eta_s), shift(J_s)

        if emit:
            sm1 = s - 1
            # [s-1, .., C, B] composites of positions 0 .. s-2 ->
            # [.., C*(s-1), B], chunk-major, position-minor.
            comps = tuple(torch.stack([c[i] for c in reversed(suffix_comps)])
                          for i in range(5))

            def flat_j(y):
                y = y.movedim(0, -2)
                return y.reshape(y.shape[:-3] + (C * sm1, y.shape[-1]))

            rep = lambda x: x.repeat_interleave(sm1, dim=-2)
            eta_i, J_i = _combine_reduced(
                tuple(flat_j(x) for x in comps), (rep(eta_v), rep(J_v)), nb,
                opts
            )
            eta_l, J_l = _combine_reduced_leaf(lj(s - 1), (eta_v, J_v), nb,
                                               opts)

            def fin(yi, yl):
                yi = yi.reshape(yi.shape[:-2] + (C, sm1, yi.shape[-1]))
                y = torch.cat([yi, yl.unsqueeze(-2)], dim=-2)
                return y.reshape(y.shape[:-3] + (N, y.shape[-1]))

            P_all, p_all = fin(J_i, J_l), -fin(eta_i, eta_l)
            S = lambda x: x[..., :N - 1, :]
            Sn = lambda x: x[..., 1:, :]
            K, d = _gains_from(
                S(pem["A"]), S(pem["B"]), S(pem["Rdiag"]), S(pem["r"]),
                S(pem["f"]), Sn(P_all), Sn(p_all), nb, opts,
            )
            return P_all, p_all, K, d

        if not gains:
            # Down-sweep over in-chunk positions s-1 .. 1 (position 0 is the
            # scanned chunk-start suffix).
            carry = (eta_v, J_v)
            outs = [(eta_s, J_s)] + [None] * (s - 1)
            for j in reversed(range(1, s)):
                carry = _combine_reduced_leaf(lj(j), carry, nb, opts)
                outs[j] = carry
            return (unchunk_s(torch.stack([o[1] for o in outs])),
                    -unchunk_s(torch.stack([o[0] for o in outs])))

        # Fused gains: the down-sweep at EVERY in-chunk position (position
        # 0 recomputes the chunk-start suffix: C cheap extra steps) emits
        # (K, d).
        rinv_c = chunkify(1.0 / pem["Rdiag"])
        r_c = chunkify(pem["r"])
        carry = (eta_v, J_v)
        outs = [None] * s
        for j in reversed(range(s)):
            outs[j] = _combine_reduced_leaf(lj(j), carry, nb, opts,
                                            gains=(rinv_c[j], r_c[j]))
            carry = outs[j][:2]
        st = lambda i: unchunk_s(torch.stack([o[i] for o in outs]))
        Sl = lambda x: x[..., :N - 1, :]
        return st(1), -st(0), Sl(st(2)), Sl(st(3))


def _auto_chunk(N: int, chunk: int) -> int:
    """Resolve ``pscan_chunk``: 0 = auto (the largest of 32, 16, 8, 4 that
    divides N, when N >= 64), 1 = unchunked, >= 2 = explicit (must divide N
    with at least two chunks). JAX pscan.py:760-778."""
    if chunk == 0:
        for s in (32, 16, 8, 4):
            if N % s == 0 and N >= 64:
                return s
        return 1
    if chunk >= 2 and (N % chunk != 0 or N // chunk < 2):
        raise ValueError(
            f"pscan_chunk={chunk} must divide the horizon N={N} with at "
            "least two chunks"
        )
    return chunk


def _value_scan_em(pem, nb: int, opts: SolveOptions, chunk: int = 0):
    """Element-major value scan: ``(P [n, n, N, B], p [n, N, B])`` (JAX
    pscan.py:781-835). Even N >= 4: the chunked scan, or the unchunked scan
    on structured leaves; else the generic scan on full leaf elements."""
    A, B = pem["A"], pem["B"]
    N = A.shape[2]
    if N >= 4 and N % 2 == 0:
        s = _auto_chunk(N, chunk)
        if s >= 2:
            return _value_scan_chunked_em(pem, nb, opts, s)
        eta_all, J_all = _suffix_pj_leaf_em(_leaf_em(pem, nb, opts), nb, opts)
        return J_all, -eta_all

    S = lambda x, sl: x[..., sl, :]
    Brinv = B * (1.0 / pem["Rdiag"])[None]
    head = slice(0, N - 1)
    c = S(pem["f"], head) - la.bgemv(S(Brinv, head), S(pem["r"], head), nb)
    C = S(la.bgemm(Brinv, B.transpose(0, 1), nb, opts), head)
    zF = torch.zeros_like(A[..., :1, :])
    elems = (
        _cat([S(A, head), zF], em=True),
        _cat([c, torch.zeros_like(c[..., :1, :])], em=True),
        _cat([C, zF], em=True),
        -pem["q"],
        _diag_blocks(pem["Qdiag"]),
    )
    eta_all, J_all = _suffix_pj(elems, nb, opts, em=True)
    return J_all, -eta_all


def _prefix_action_em(Phi, tvec, x0, nb: int, opts: SolveOptions):
    """Element-major :func:`_prefix_action`: scan axis -2, keepdims slices;
    ``x0`` is ``[n, 1, B]`` (JAX pscan.py:838-868)."""
    S = lambda x, sl: x[..., sl, :]
    L = Phi.shape[-2]
    if L == 1:
        return la.bgemv(Phi, x0, nb) + tvec
    if L % 2 == 1:
        head = _prefix_action_em(S(Phi, slice(0, -1)), S(tvec, slice(0, -1)),
                                 x0, nb, opts)
        last = la.bgemv(S(Phi, slice(-1, None)), S(head, slice(-1, None)),
                        nb) + S(tvec, slice(-1, None))
        return _cat([head, last], em=True)
    Phi_e, Phi_o = _even_odd(Phi, em=True)
    t_e, t_o = _even_odd(tvec, em=True)
    Phi_c = la.bgemm(Phi_o, Phi_e, nb, opts)
    t_c = la.bgemv(Phi_o, t_e, nb) + t_o
    a_pair = _prefix_action_em(Phi_c, t_c, x0, nb, opts)  # a_{2i+1}
    a0 = la.bgemv(S(Phi_e, slice(0, 1)), x0, nb) + S(t_e, slice(0, 1))
    if L > 2:
        a_even_rest = la.bgemv(S(Phi_e, slice(1, None)),
                               S(a_pair, slice(0, -1)), nb) + S(
            t_e, slice(1, None))
        a_even = _cat([a0, a_even_rest], em=True)
    else:
        a_even = a0
    return _interleave(a_even, a_pair, em=True)


def _prefix_action_chunked_em(Phi, tvec, x0, nb: int, opts: SolveOptions,
                              s: int, batched: bool = False):
    """Chunked :func:`_prefix_action_em` (JAX pscan.py:871-964): serial
    within-chunk map composition (one product per step) builds one affine
    composite per ``s``-step chunk, the odd-even prefix runs over the
    composites, and the interior states follow from each chunk's start
    state by ``s`` serial steps (``batched``: by one gemv at
    ``C*(s-1)*B`` width over the fold's emitted prefix composites). Pads
    with identity maps when ``s`` does not divide the length."""
    L = Phi.shape[-2]
    pad = (-L) % s
    if pad:
        n = Phi.shape[0]
        ones = Phi.new_ones((n, pad) + Phi.shape[3:])
        Phi = _cat([Phi, _diag_blocks(ones)], em=True)
        tvec = _cat([tvec, tvec.new_zeros((n, pad) + tvec.shape[2:])],
                    em=True)
    Lp = L + pad
    C = Lp // s

    def chunkify(x):  # [.., Lp, B] -> [s, .., C, B], contiguous
        y = x.reshape(x.shape[:-2] + (C, s, x.shape[-1]))
        return y.movedim(-2, 0).contiguous()

    Phc, tc = chunkify(Phi), chunkify(tvec)
    # Prefix composites: after step j, (Phi_c, t_c) maps the chunk start to
    # the state after in-chunk step j.
    Phi_c, t_c = Phc[0], tc[0]
    prefix = [(Phi_c, t_c)]
    for j in range(1, s):
        Phi_c, t_c = (la.bgemm(Phc[j], Phi_c, nb, opts),
                      la.bgemv(Phc[j], t_c, nb) + tc[j])
        if batched and j < s - 1:
            prefix.append((Phi_c, t_c))
    ends = _prefix_action_em(Phi_c, t_c, x0, nb, opts)  # x_{(k+1)s}
    starts = _cat([x0, ends[..., :C - 1, :]], em=True)

    if batched:
        sm1 = s - 1

        def flat_j(y):  # [s-1, .., C, B] -> [.., C*(s-1), B]
            y = y.movedim(0, -2)
            return y.reshape(y.shape[:-3] + (C * sm1, y.shape[-1]))

        Php = torch.stack([pc[0] for pc in prefix])
        tp = torch.stack([pc[1] for pc in prefix])
        xi = la.bgemv(flat_j(Php), starts.repeat_interleave(sm1, dim=-2),
                      nb) + flat_j(tp)
        xi = xi.reshape(xi.shape[:-2] + (C, sm1, xi.shape[-1]))
        out = torch.cat([xi, ends.unsqueeze(-2)], dim=-2)
    else:
        xv, xs = starts, []
        for j in range(s):
            xv = la.bgemv(Phc[j], xv, nb) + tc[j]  # x_{ks+j+1}
            xs.append(xv)
        out = torch.stack(xs).movedim(0, -2)  # [n, C, s, B]
    out = out.reshape(out.shape[:-3] + (Lp, out.shape[-1]))
    return out[..., :L, :]


def _solve_pscan_em(prob: LQRProblem, opts: SolveOptions) -> RiccatiSolution:
    """The mid-block path: the whole scan on element-major ``[p, q, N, B]``
    slabs (JAX pscan.py:967-1051). ``prob`` has ONE leading batch axis."""
    pbl = _to_batch_last(prob, 1)
    em = lambda x: x.movedim(0, -2)  # [N, p(, q), B] -> [p(, q), N, B]
    pem = {k: em(getattr(pbl, k))
           for k in ("A", "B", "f", "q", "r", "Qdiag", "Rdiag")}
    nb = 2
    N = pem["A"].shape[2]
    S = lambda x, sl: x[..., sl, :]
    head = slice(0, N - 1)

    s = _auto_chunk(N, opts.pscan_chunk) if (N >= 4 and N % 2 == 0) else 1
    with span("factor"):
        if s >= 2:
            # Chunked scan with the gains fused into its down-sweep.
            P, p, K, d = _value_scan_chunked_em(
                pem, nb, opts, s, gains=True,
                batched=opts.pscan_batched_interior,
            )
        else:
            with span("scan"):
                P, p = _value_scan_em(pem, nb, opts, 1)
            with span("gains"):
                K, d = _gains_from(
                    S(pem["A"], head), S(pem["B"], head),
                    S(pem["Rdiag"], head), S(pem["r"], head),
                    S(pem["f"], head), S(P, slice(1, N)), S(p, slice(1, N)),
                    nb, opts,
                )
    with span("sweep"):
        with span("prefix"):
            Phi = S(pem["A"], head) + la.bgemm(S(pem["B"], head), K, nb,
                                               opts)
            tvec = la.bgemv(S(pem["B"], head), d, nb) + S(pem["f"], head)
            x0e = pbl.x0[:, None, :]  # [n, 1, B]
            if s >= 2:
                xs = _prefix_action_chunked_em(
                    Phi, tvec, x0e, nb, opts, s,
                    batched=opts.pscan_batched_interior)
            else:
                xs = _prefix_action_em(Phi, tvec, x0e, nb, opts)
        with span("outputs"):
            X = _cat([x0e, xs], em=True)  # [n, N, B]
            U = la.bgemv(K, S(X, head), nb) + d
            Y = la.bgemv(P, X, nb) + p

    # [p(, q), N, B] -> [B, N, p(, q)].
    out = lambda x: x.movedim(-2, 0).movedim(-1, 0)
    return RiccatiSolution(K=out(K), d=out(d), P=out(P), p=out(p), X=out(X),
                           U=out(U), Y=out(Y))


def _solve_pscan_impl(prob: LQRProblem, opts: SolveOptions) -> RiccatiSolution:
    """Route one flattened batch (JAX pscan.py:1078-1132): mid blocks to the
    element-major path unless ``layout="grid"``; small blocks, ``"grid"``
    and blocks above 64 to the batch-last path."""
    big = max(prob.nstates, prob.ninputs)
    if (opts.mxu_block_threshold < big <= MAX_BLOCK
            and opts.layout != "grid"):
        return _solve_pscan_em(prob, opts)
    pbl = _to_batch_last(prob, 1)
    with span("factor"):
        with span("scan"):
            P, p = _value_scan(pbl, 1, opts)
        with span("gains"):
            K, d = _gains(pbl, P, p, 1, opts)
    with span("sweep"):
        with span("prefix"):
            X = _forward_scan(pbl, K, d, 1, opts)
        with span("outputs"):
            U = la.bgemv(K, X[:-1], 1) + d
            Y = la.bgemv(P, X, 1) + p
    return RiccatiSolution(K=_bf(K, 1), d=_bf(d, 1), P=_bf(P, 1),
                           p=_bf(p, 1), X=_bf(X, 1), U=_bf(U, 1),
                           Y=_bf(Y, 1))


def solve_pscan(prob: LQRProblem,
                options: Optional[SolveOptions] = None) -> RiccatiSolution:
    """Full parallel-scan LQR solve of a single problem or a batch (leading
    batch axes on every field), on the device of the problem's tensors;
    the same outputs as :func:`rslqr_tpu_torch.solve_riccati`.

    Mid blocks (8 < max(n, m) <= 64 at the default threshold) run the
    element-major path unless ``layout="grid"``; small blocks, ``"grid"``
    and blocks above 64 the batch-last path. Options read here:
    ``layout``, ``kernels``, ``mxu_block_threshold``, ``pscan_chunk``,
    ``pscan_batched_interior``. Sets TF32 off, as ``rslqr.solve`` does.

    Differentiable through ``Y``, ``X``, ``U`` when grad is enabled and a
    field requires grad (:mod:`rslqr_tpu_torch.autodiff`: the backward
    scans the shadow problem); the gains then come back detached.
    """
    with entry():
        return _solve_pscan(prob, options)


def _solve_pscan(prob: LQRProblem,
                 options: Optional[SolveOptions] = None) -> RiccatiSolution:
    """:func:`solve_pscan` inside its ``solve`` span."""
    from . import autodiff

    if autodiff.wants_grad(prob):
        return autodiff.solve_pscan(prob, options)
    flat, bshape = _one_batch_axis(prob)
    sol = _solve_pscan_impl(flat, resolve_options(options))
    return RiccatiSolution(**{
        f.name: getattr(sol, f.name).reshape(
            bshape + getattr(sol, f.name).shape[1:])
        for f in dataclasses.fields(sol)
    })


def solve_pscan_kkt(prob: LQRProblem,
                    options: Optional[SolveOptions] = None) -> torch.Tensor:
    """Solve and return the flat KKT vector(s) ``[*b, nvars]``."""
    with entry():
        sol = _solve_pscan(prob, options)
        with span("pack"):
            return pack_solution(sol.Y, sol.X, sol.U)
