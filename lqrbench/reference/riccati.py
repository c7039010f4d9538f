"""Plain PyTorch reference: the serial Riccati recursion of the upstream
``riccati_solve.c`` (bjack205/rsLQR), over a batch of problems.

It imports nothing of the program under test and works everything out
from the problem fields the harness made. ``precision`` chooses how it
computes:

* ``"float64"``: the reference;
* ``"tf32"``: f32, with both inputs of every matrix product rounded to
  TF32 (10 explicit mantissa bits, round to nearest even), as the card's
  tensor cores take them with TF32 on; everything else in f32. This is
  the control: the step below f32 with TF32 off.

The output is the KKT vector of every instance, ``[B, (2n+m)N - m]`` in
the order ``[y_0 x_0 u_0 ... y_{N-2} x_{N-2} u_{N-2} y_{N-1} x_{N-1}]``
(the upstream ``solve.h`` variable order), ``y_k`` the dynamics
multiplier ``P_k x_k + p_k``.
"""

import torch

_WORK = {"float64": torch.float64, "tf32": torch.float32}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (the low 13 mantissa bits cleared, to
    nearest even); infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


class _Ops:
    def __init__(self, precision: str):
        self.dtype = _WORK[precision]
        self.tf32 = precision == "tf32"

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def mv(self, a, v):
        return self.mm(a, v.unsqueeze(-1)).squeeze(-1)


def _solve_block(p: dict, ops: _Ops) -> torch.Tensor:
    """Riccati solve of one block of instances; fields ``[b, N, ...]``."""
    A, Bm, f = p["A"], p["B"], p["f"]
    Qd, Rd, q, r, x0 = p["Qdiag"], p["Rdiag"], p["q"], p["r"], p["x0"]
    N = A.shape[1]
    P = torch.diag_embed(Qd[:, -1])
    pv = q[:, -1]
    Ks, ds, Ps, ps = [None] * (N - 1), [None] * (N - 1), [None] * N, [None] * N
    Ps[-1], ps[-1] = P, pv
    for k in reversed(range(N - 1)):
        Ak, Bk = A[:, k], Bm[:, k]
        At, Bt = Ak.transpose(-1, -2), Bm[:, k].transpose(-1, -2)
        Pf_p = ops.mv(P, f[:, k]) + pv
        Qx = q[:, k] + ops.mv(At, Pf_p)
        Qu = r[:, k] + ops.mv(Bt, Pf_p)
        AtP, BtP = ops.mm(At, P), ops.mm(Bt, P)
        Qxx = torch.diag_embed(Qd[:, k]) + ops.mm(AtP, Ak)
        Quu = torch.diag_embed(Rd[:, k]) + ops.mm(BtP, Bk)
        Qux = ops.mm(BtP, Ak)
        L = torch.linalg.cholesky(Quu)
        sol = torch.cholesky_solve(torch.cat([Qux, Qu.unsqueeze(-1)], -1), L)
        K, d = -sol[..., :-1], -sol[..., -1]
        Quxt = Qux.transpose(-1, -2)
        P = Qxx + ops.mm(Quxt, K)
        P = 0.5 * (P + P.transpose(-1, -2))  # round-off kept symmetric
        pv = Qx + ops.mv(Quxt, d)
        Ks[k], ds[k], Ps[k], ps[k] = K, d, P, pv
    x, parts = x0, []
    for k in range(N - 1):
        u = ops.mv(Ks[k], x) + ds[k]
        parts += [ops.mv(Ps[k], x) + ps[k], x, u]
        x = ops.mv(A[:, k], x) + ops.mv(Bm[:, k], u) + f[:, k]
    parts += [ops.mv(Ps[-1], x) + ps[-1], x]
    return torch.cat(parts, dim=-1)


def solve(problem: dict, precision: str = "float64",
          block: int = 1024) -> torch.Tensor:
    """KKT vectors ``[B, nvars]`` of every instance of ``problem`` (fields
    batch-first, on any device), computed in ``precision``, ``block``
    instances at a time; returned in the working dtype."""
    ops = _Ops(precision)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = problem["A"].shape[0]
        outs = []
        for s in range(0, batch, block):
            sub = {k: v[s:s + block].to(ops.dtype) for k, v in problem.items()}
            outs.append(_solve_block(sub, ops))
        return torch.cat(outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
