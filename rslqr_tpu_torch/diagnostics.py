"""Solve diagnostics: failure detection and solution verification.

Counterpart of ``rslqr_tpu.diagnostics`` (the reference's error machinery:
return codes and the per-factorization ``CholeskyInfo.success`` flags,
linalg.c:84, that its callers never check mid-solve). A factorization
failure (a separator block that is not SPD) leaves NaN in the factors,
which propagates to the solution: the small and mid-block Cholesky stages
produce it by their arithmetic, the mat-last route writes it
(``linalg._cholesky_ml``). These functions reduce it to a per-instance
status, in batched tensor ops with no host sync, except
:func:`assert_solution_ok`, which reads the status on the host by design.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from .problem import LQRProblem, kkt_residual
from .rslqr import RsLqrFactorization
from .rslqr_em import EmFactorization


class SolveStatus(enum.IntEnum):
    """Per-instance solve outcome (reference analogue: CholeskyInfo.success
    and clap_kCholeskyFail, linalg_custom.c:100-102)."""

    OK = 0
    FACTORIZATION_FAILED = 1  # NaN/Inf in the solution (non-SPD Sbar)
    DIVERGED = 2  # finite solution with a KKT residual above the tolerance


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Batched diagnostics; tensors have the instance batch shape."""

    status: torch.Tensor  # int32 SolveStatus codes
    max_residual: torch.Tensor  # KKT residual per instance
    finite: torch.Tensor  # bool, solution entirely finite


def factorization_ok(fact) -> torch.Tensor:
    """Per-instance "all Cholesky factors finite" predicate.

    Takes either factorization: an :class:`RsLqrFactorization` (grid path,
    ``fact.nbatch`` trailing batch axes: a tensor of that batch shape, a
    scalar for a single problem) or an :class:`EmFactorization`
    (element-major, one trailing batch axis: shape ``[B]``, ``[1]`` for a
    single problem, which the front door solves as a batch of one)."""
    if isinstance(fact, RsLqrFactorization):
        chol = fact.chol
        return torch.isfinite(chol).flatten(0, chol.dim() - fact.nbatch - 1
                                            ).all(0)
    if isinstance(fact, EmFactorization):
        oks = [torch.isfinite(c).flatten(0, c.dim() - 2).all(0)
               for c in fact.chols]
        return torch.stack(oks).all(0)
    raise TypeError(f"not a factorization: {type(fact).__name__}")


def check_solution(prob: LQRProblem, soln_vec: torch.Tensor,
                   tol: float = 1e-4) -> SolveReport:
    """Verify KKT optimality of (possibly batched) solution vectors
    ``[*b, nvars]`` against the optimality system itself (no oracle): one
    batched residual over every instance."""
    res = kkt_residual(prob, soln_vec)
    finite = torch.isfinite(soln_vec).all(-1)
    status = torch.where(
        ~finite,
        int(SolveStatus.FACTORIZATION_FAILED),
        torch.where(res > tol, int(SolveStatus.DIVERGED),
                    int(SolveStatus.OK)),
    ).to(torch.int32)
    return SolveReport(status=status, max_residual=res, finite=finite)


def assert_solution_ok(prob: LQRProblem, soln_vec: torch.Tensor,
                       tol: float = 1e-4) -> SolveReport:
    """Host-side hard check (test and CI use): raises ``RuntimeError`` on
    any failed instance."""
    report = check_solution(prob, soln_vec, tol)
    status = report.status.cpu().reshape(-1)
    bad = torch.nonzero(status != int(SolveStatus.OK)).reshape(-1)
    if len(bad):
        res = report.max_residual.cpu().reshape(-1)
        raise RuntimeError(
            f"solve failed for instances {bad.tolist()}: "
            f"status={status[bad].tolist()}, "
            f"residuals={res[bad[:8]].tolist()}"
        )
    return report
