"""The 3-D double integrator of the upstream sample problem, as a base LQR
problem (bjack205/rsLQR ``test/sample_problem_test.c``; the repo's
``double_integrator_problem``, value for value, frozen here).

Block dynamics ``[[I, 0], [dt*I, I]]`` with input ``[dt^2/2; dt]``, unit
state cost (100 at the last knot), 1e-2 input cost, ``f = 1.5``, linear
costs growing with the knot index.
"""

import numpy as np
import torch


def base(config: dict, gen: torch.Generator, device, dtype) -> dict:
    """One base problem: a dict of the nine fields, knot axis first.
    ``gen`` is not drawn from: the problem is fixed by its configuration."""
    n, m, N = config["nstates"], config["ninputs"], config["nhorizon"]
    dt = config["dt"]
    if n != 2 * m:
        raise ValueError("double integrator needs nstates = 2 * ninputs")
    eye = np.eye(m)
    A1 = np.block([[np.eye(m), np.zeros((m, m))], [dt * eye, np.eye(m)]])
    B1 = np.vstack([0.5 * dt * dt * eye, dt * eye])
    Qdiag = np.ones((N, n))
    Qdiag[-1] = 100.0
    ks = np.arange(1, N + 1)[:, None]
    x0 = (np.array([1.0, -1.0, 2.0, -2.0, 3.0, -3.0][:n]) if n <= 6
          else np.arange(1, n + 1) * (-1.0) ** np.arange(n))
    fields = dict(
        A=np.broadcast_to(A1, (N, n, n)),
        B=np.broadcast_to(B1, (N, n, m)),
        f=np.full((N, n), 1.5),
        Qdiag=Qdiag,
        Rdiag=np.full((N, m), 0.01),
        q=np.linspace(-2.0, 2.0, n)[None, :] * ks,
        r=np.linspace(-1.0, 1.0, m)[None, :] * np.ones((N, 1)),
        c=np.ones(N),
        x0=x0,
    )
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device=device,
                                                           dtype=dtype)
            for k, v in fields.items()}
