"""LQR problem definition as a frozen dataclass of stacked tensors.

Counterpart of ``rslqr_tpu.problem`` (and of the reference's
``src/lqr_data.{h,c}`` / ``src/lqr_problem.{h,c}``). The whole horizon is
stored as dense tensors stacked over the knot axis; any number of leading
batch axes may precede it.

The problem solved (ref docs/Overview.dox:10-14):

  minimize   0.5 x_N' Q_N x_N + q_N' x_N + c_N
             + sum_{k<N-1} 0.5 x_k' Q_k x_k + q_k' x_k + 0.5 u_k' R_k u_k + r_k' u_k + c_k
  subject to x_{k+1} = A_k x_k + B_k u_k + f_k,   x0 = x0

``Q`` and ``R`` are diagonal and stored as vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils import is_power_of_two

_FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")


@dataclasses.dataclass(frozen=True)
class LQRProblem:
    """A discrete-time affine LQR problem over ``N`` knot points.

    Index ``N-1`` of the dynamics arrays (``A``, ``B``, ``f``) and of
    ``Rdiag``/``r`` is carried for format fidelity but unused.

    Attributes (leading batch axes ``*b`` optional on every field):
      A: ``[*b, N, n, n]``; B: ``[*b, N, n, m]``; f: ``[*b, N, n]``;
      Qdiag: ``[*b, N, n]``; Rdiag: ``[*b, N, m]``; q: ``[*b, N, n]``;
      r: ``[*b, N, m]``; c: ``[*b, N]``; x0: ``[*b, n]``.
    """

    A: torch.Tensor
    B: torch.Tensor
    f: torch.Tensor
    Qdiag: torch.Tensor
    Rdiag: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor
    x0: torch.Tensor

    @property
    def nhorizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nstates(self) -> int:
        return self.A.shape[-1]

    @property
    def ninputs(self) -> int:
        return self.B.shape[-1]

    @property
    def nvars(self) -> int:
        """Length of the KKT variable vector (ref solver.c:64)."""
        n, m, N = self.nstates, self.ninputs, self.nhorizon
        return (2 * n + m) * N - m

    @property
    def batch_shape(self) -> torch.Size:
        return self.A.shape[:-3]

    def validate(self) -> None:
        """Shape/consistency checks (ref lqr_problem.c:16-37 error paths)."""
        n, m, N = self.nstates, self.ninputs, self.nhorizon
        if not is_power_of_two(N):
            raise ValueError(f"nhorizon must be a power of two, got {N}")
        expect = {
            "A": (N, n, n), "B": (N, n, m), "f": (N, n), "Qdiag": (N, n),
            "Rdiag": (N, m), "q": (N, n), "r": (N, m), "c": (N,), "x0": (n,),
        }
        for name, shape in expect.items():
            arr = getattr(self, name)
            if tuple(arr.shape[-len(shape):]) != shape:
                raise ValueError(
                    f"{name}: expected trailing shape {shape}, got "
                    f"{tuple(arr.shape)}"
                )

    def map(self, fn) -> "LQRProblem":
        """Apply ``fn`` to every field."""
        return LQRProblem(*(fn(getattr(self, k)) for k in _FIELDS))

    def to(self, device=None, dtype=None) -> "LQRProblem":
        return self.map(lambda x: x.to(device=device, dtype=dtype))


def _card(device) -> torch.device:
    """The device a builder puts its problem on. The builders default to the
    card (``"cuda"``); a CUDA device without a visible card raises instead
    of falling back to the CPU, which a caller asks for with ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={device!r}: pass device='cpu' to "
            "build the problem on the CPU"
        )
    return dev


def problem_from_arrays(A, B, f, Qdiag, Rdiag, q, r, c, x0, *, dtype=None,
                        device="cuda") -> LQRProblem:
    """Build and validate an :class:`LQRProblem` from array-likes
    (counterpart of ``ndlqr_InitializeLQRProblem``, lqr_problem.c:39-52),
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = _card(device)
    conv = lambda x: torch.as_tensor(np.asarray(x)).to(
        device=dev, dtype=dtype
    )
    prob = LQRProblem(*(conv(x) for x in (A, B, f, Qdiag, Rdiag, q, r, c, x0)))
    prob.validate()
    return prob


def problem_from_numpy(obj, *, dtype=None, device="cuda") -> LQRProblem:
    """Carry a problem given as a mapping or as an object with the nine
    fields (for example a ``rslqr_tpu.LQRProblem``) into the port exactly:
    each field goes through ``np.asarray``, so both packages solve the same
    numbers. The dtype is kept unless ``dtype`` is given."""
    get = obj.__getitem__ if isinstance(obj, dict) else (
        lambda k: getattr(obj, k)
    )
    return problem_from_arrays(
        *(np.array(get(k), copy=True) for k in _FIELDS),
        dtype=dtype, device=device,
    )


def double_integrator_problem(
    nhorizon: int,
    nstates: int = 6,
    ninputs: int = 3,
    dt: float = 0.1,
    dtype=torch.float64,
    device="cuda",
) -> LQRProblem:
    """The double-integrator benchmark problem of
    ``rslqr_tpu.problem.double_integrator_problem``, value for value: block
    dynamics ``[[I, 0], [dt*I, I]]`` with input ``[dt^2/2; dt]``, unit state
    cost (100 at the last knot), 1e-2 input cost."""
    if nstates % 2 != 0 or ninputs * 2 != nstates:
        raise ValueError("double integrator needs nstates = 2 * ninputs")
    n, m, N = nstates, ninputs, nhorizon
    eye = np.eye(m)
    A1 = np.block([[np.eye(m), np.zeros((m, m))], [dt * eye, np.eye(m)]])
    B1 = np.vstack([0.5 * dt * dt * eye, dt * eye])
    A = np.broadcast_to(A1, (N, n, n)).copy()
    B = np.broadcast_to(B1, (N, n, m)).copy()
    f = np.full((N, n), 1.5)
    Qdiag = np.ones((N, n))
    Qdiag[-1] = 100.0
    Rdiag = np.full((N, m), 0.01)
    ks = np.arange(1, N + 1)[:, None]
    q = np.linspace(-2.0, 2.0, n)[None, :] * ks
    r = np.linspace(-1.0, 1.0, m)[None, :] * np.ones((N, 1))
    c = np.ones(N)
    x0 = np.array([1.0, -1.0, 2.0, -2.0, 3.0, -3.0][:n] or np.ones(n))
    if len(x0) != n:
        x0 = np.arange(1, n + 1) * (-1.0) ** np.arange(n)
    return problem_from_arrays(
        A, B, f, Qdiag, Rdiag, q, r, c, x0, dtype=dtype, device=device
    )


def _randn(gen: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def _rand(gen: torch.Generator, shape, dtype):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def random_problem(
    generator: torch.Generator,
    nhorizon: int,
    nstates: int,
    ninputs: int,
    dtype=torch.float32,
    device="cuda",
) -> LQRProblem:
    """A random well-conditioned LQR instance, drawn from ``generator`` on
    the generator's device and moved to ``device`` (the distribution of
    ``rslqr_tpu.problem.random_problem``; the numbers differ, since the two
    generators differ)."""
    dev = _card(device)
    n, m, N = nstates, ninputs, nhorizon
    g = generator
    A = torch.eye(n, dtype=dtype, device=g.device) + 0.1 * _randn(
        g, (N, n, n), dtype
    )
    prob = LQRProblem(
        A=A,
        B=0.2 * _randn(g, (N, n, m), dtype),
        f=0.1 * _randn(g, (N, n), dtype),
        Qdiag=0.5 + _rand(g, (N, n), dtype),
        Rdiag=0.1 + _rand(g, (N, m), dtype),
        q=_randn(g, (N, n), dtype),
        r=_randn(g, (N, m), dtype),
        c=torch.zeros((N,), dtype=dtype, device=g.device),
        x0=_randn(g, (n,), dtype),
    )
    return prob.to(device=dev)


def perturb_problem(
    prob: LQRProblem, generator: torch.Generator, scale: float = 0.1
) -> LQRProblem:
    """Perturb initial state and cost gradients: one MPC-style scenario."""
    return batch_problems(prob, 1, generator, scale).map(lambda x: x[0])


def batch_problems(
    prob: LQRProblem, batch: int, generator: torch.Generator,
    scale: float = 0.1,
) -> LQRProblem:
    """Stack ``batch`` perturbed copies of ``prob`` along a new leading axis
    (the "1024 perturbed instances" configs of BASELINE.json). The noise is
    drawn in bulk on the generator's device, then moved to the problem's."""
    dt, dev = prob.x0.dtype, prob.x0.device
    noise = lambda x: scale * _randn(generator, (batch,) + x.shape, dt).to(dev)
    rep = lambda x: x.unsqueeze(0).expand((batch,) + x.shape).contiguous()
    out = prob.map(rep)
    return dataclasses.replace(
        out,
        x0=out.x0 + noise(prob.x0),
        q=out.q + noise(prob.q),
        r=out.r + noise(prob.r),
    )


# ---------------------------------------------------------------------------
# Verification helpers: objective + KKT residual of a candidate solution.
# ---------------------------------------------------------------------------


def unpack_solution(prob: LQRProblem, soln: torch.Tensor):
    """Split flat KKT vector(s) ``[..., (y0 x0 u0 ... y_{N-1} x_{N-1})]``
    into ``(Y, X, U)`` (ref variable ordering: solve.h:50-53). Returns
    Y ``[..., N, n]``, X ``[..., N, n]``, U ``[..., N-1, m]``."""
    n, m, N = prob.nstates, prob.ninputs, prob.nhorizon
    stride = 2 * n + m
    batch = soln.shape[:-1]
    body = soln[..., : stride * (N - 1)].reshape(batch + (N - 1, stride))
    tail = soln[..., stride * (N - 1):]
    Y = torch.cat([body[..., :n], tail[..., None, :n]], dim=-2)
    X = torch.cat([body[..., n: 2 * n], tail[..., None, n: 2 * n]], dim=-2)
    U = body[..., 2 * n:]
    return Y, X, U


def pack_solution(Y: torch.Tensor, X: torch.Tensor, U: torch.Tensor):
    """Inverse of :func:`unpack_solution`; leading batch axes pass through."""
    N = X.shape[-2]
    batch = X.shape[:-2]
    body = torch.cat([Y[..., : N - 1, :], X[..., : N - 1, :], U], dim=-1)
    body = body.reshape(batch + (-1,))
    tail = torch.cat([Y[..., N - 1, :], X[..., N - 1, :]], dim=-1)
    return torch.cat([body, tail], dim=-1)


def objective(prob: LQRProblem, X: torch.Tensor, U: torch.Tensor):
    """Total LQR objective of ``X [..., N, n]``, ``U [..., N-1, m]``; one
    value per problem of the batch."""
    qcost = 0.5 * (prob.Qdiag * X * X).sum((-2, -1)) + (prob.q * X).sum(
        (-2, -1)
    )
    Ru = prob.Rdiag[..., :-1, :] * U
    rcost = 0.5 * (Ru * U).sum((-2, -1)) + (prob.r[..., :-1, :] * U).sum(
        (-2, -1)
    )
    return qcost + rcost + prob.c.sum(-1)


def kkt_residual(prob: LQRProblem, soln: torch.Tensor) -> torch.Tensor:
    """Max-norm residual of the KKT optimality system at ``soln``, one value
    per problem of the batch.

    Stationarity:  Q_k x_k + q_k - y_k + A_k' y_{k+1} = 0   (k < N-1)
                   R_k u_k + r_k + B_k' y_{k+1} = 0         (k < N-1)
                   Q_N x_N + q_N - y_N = 0
    Primal:        x_0 = x0;  x_{k+1} = A_k x_k + B_k u_k + f_k.
    """
    Y, X, U = unpack_solution(prob, soln)
    A, B = prob.A[..., :-1, :, :], prob.B[..., :-1, :, :]
    mv = lambda M, v: torch.einsum("...kij,...kj->...ki", M, v)
    mtv = lambda M, v: torch.einsum("...kji,...kj->...ki", M, v)
    r_dyn0 = X[..., 0, :] - prob.x0
    r_dyn = X[..., 1:, :] - (
        mv(A, X[..., :-1, :]) + mv(B, U) + prob.f[..., :-1, :]
    )
    r_x = (
        prob.Qdiag[..., :-1, :] * X[..., :-1, :]
        + prob.q[..., :-1, :]
        - Y[..., :-1, :]
        + mtv(A, Y[..., 1:, :])
    )
    r_u = prob.Rdiag[..., :-1, :] * U + prob.r[..., :-1, :] + mtv(
        B, Y[..., 1:, :]
    )
    r_xN = prob.Qdiag[..., -1, :] * X[..., -1, :] + prob.q[..., -1, :] - Y[
        ..., -1, :
    ]
    amax = lambda t: t.abs().flatten(-2).amax(-1)
    return torch.stack(
        [
            r_dyn0.abs().amax(-1),
            amax(r_dyn),
            amax(r_x),
            amax(r_u),
            r_xN.abs().amax(-1),
        ]
    ).amax(0)
