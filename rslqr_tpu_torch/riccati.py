"""Riccati-recursion LQR solver: the serial oracle.

Counterpart of ``rslqr_tpu.riccati`` (the reference's
``src/riccati_solve.{h,c}``). The two ``lax.scan`` loops become Python loops
over knots of batched small ``torch.linalg`` ops; leading batch axes run
together. Not on the main path and carries no kernel: it is the independent
check that ``chip_smoke.py`` holds the tree solve against on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .problem import LQRProblem, pack_solution


@dataclasses.dataclass(frozen=True)
class RiccatiSolution:
    """Riccati outputs (ref riccati_solver.h:62-86), leading batch axes
    first: K ``[N-1, m, n]``, d ``[N-1, m]``, P ``[N, n, n]``, p ``[N, n]``,
    X ``[N, n]``, U ``[N-1, m]``, Y ``[N, n]``."""

    K: torch.Tensor
    d: torch.Tensor
    P: torch.Tensor
    p: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    Y: torch.Tensor

    def kkt_vector(self) -> torch.Tensor:
        return pack_solution(self.Y, self.X, self.U)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def backward_step(P_next, p_next, A, B, f, Qd, Rd, q, r):
    """One backward Riccati step (riccati_solve.c:50-109). Returns
    ``(Qx, Qu, Qxx, Quu, Qux, K, d, P, p)``."""
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    Pf_p = _mv(P_next, f) + p_next
    Qx = q + _mv(At, Pf_p)
    Qu = r + _mv(Bt, Pf_p)
    AtP = At @ P_next
    BtP = Bt @ P_next
    Qxx = torch.diag_embed(Qd) + AtP @ A
    Quu = torch.diag_embed(Rd) + BtP @ B
    Qux = BtP @ A
    L = torch.linalg.cholesky(Quu)
    rhs = torch.cat([Qux, Qu.unsqueeze(-1)], dim=-1)
    sol = torch.cholesky_solve(rhs, L)
    K = -sol[..., :-1]
    dgain = -sol[..., -1]
    Kt = K.transpose(-1, -2)
    P = Qxx + Kt @ (Quu @ K) + Kt @ Qux + Qux.transpose(-1, -2) @ K
    # Keep P exactly symmetric. The reference's update (riccati_solve.c and
    # rslqr_tpu.riccati) leaves a rounding-level antisymmetric part, which
    # A' (.) A amplifies each step: with unstable dynamics (the quadruped
    # config's A = I + 0.1 randn, spectral radius ~1.6) it reaches O(1)
    # within ~80 steps and the Cholesky of Quu fails (ROADMAP C3).
    P = 0.5 * (P + P.transpose(-1, -2))
    p = Qx + _mv(Kt, _mv(Quu, dgain)) + _mv(Kt, Qu) + _mv(
        Qux.transpose(-1, -2), dgain
    )
    return Qx, Qu, Qxx, Quu, Qux, K, dgain, P, p


def backward_pass(prob: LQRProblem):
    """Backward recursion (riccati_solve.c:26-112): ``(K, d, P, p)``."""
    N = prob.nhorizon
    P_next = torch.diag_embed(prob.Qdiag[..., -1, :])
    p_next = prob.q[..., -1, :]
    Ks, ds, Ps, ps = [], [], [P_next], [p_next]
    for k in reversed(range(N - 1)):
        *_, K, dgain, P_next, p_next = backward_step(
            P_next, p_next, prob.A[..., k, :, :], prob.B[..., k, :, :],
            prob.f[..., k, :], prob.Qdiag[..., k, :], prob.Rdiag[..., k, :],
            prob.q[..., k, :], prob.r[..., k, :],
        )
        Ks.append(K)
        ds.append(dgain)
        Ps.append(P_next)
        ps.append(p_next)
    K = torch.stack(Ks[::-1], dim=-3)
    d = torch.stack(ds[::-1], dim=-2)
    P = torch.stack(Ps[::-1], dim=-3)
    p = torch.stack(ps[::-1], dim=-2)
    return K, d, P, p


def forward_pass(prob: LQRProblem, K, d, P, p):
    """Forward rollout (riccati_solve.c:114-150): ``(X, U, Y)``."""
    N = prob.nhorizon
    x = prob.x0
    Xs, Us, Ys = [], [], []
    for k in range(N - 1):
        y = _mv(P[..., k, :, :], x) + p[..., k, :]
        u = _mv(K[..., k, :, :], x) + d[..., k, :]
        Xs.append(x)
        Us.append(u)
        Ys.append(y)
        x = (
            _mv(prob.A[..., k, :, :], x)
            + _mv(prob.B[..., k, :, :], u)
            + prob.f[..., k, :]
        )
    Xs.append(x)
    Ys.append(_mv(P[..., N - 1, :, :], x) + p[..., N - 1, :])
    return (
        torch.stack(Xs, dim=-2),
        torch.stack(Us, dim=-2),
        torch.stack(Ys, dim=-2),
    )


def solve_riccati(prob: LQRProblem) -> RiccatiSolution:
    """Full Riccati solve (ref ndlqr_SolveRiccati, riccati_solve.c:7-24)."""
    K, d, P, p = backward_pass(prob)
    X, U, Y = forward_pass(prob, K, d, P, p)
    return RiccatiSolution(K=K, d=d, P=P, p=p, X=X, U=U, Y=Y)
