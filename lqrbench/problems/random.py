"""A random, well-conditioned LQR problem of a stated size, drawn on the
generator's device (the distribution of the repo's ``random_problem``,
frozen here): ``A = I + 0.1 N(0, 1)``, ``B = 0.2 N(0, 1)``,
``f = 0.1 N(0, 1)``, ``Qdiag = 0.5 + U(0, 1)``, ``Rdiag = 0.1 + U(0, 1)``,
``q, r, x0 = N(0, 1)``, ``c = 0``.
"""

import torch


def base(config: dict, gen: torch.Generator, device, dtype) -> dict:
    n, m, N = config["nstates"], config["ninputs"], config["nhorizon"]
    randn = lambda *s: torch.randn(s, generator=gen, device=device,
                                   dtype=dtype)
    rand = lambda *s: torch.rand(s, generator=gen, device=device,
                                 dtype=dtype)
    return dict(
        A=torch.eye(n, device=device, dtype=dtype) + 0.1 * randn(N, n, n),
        B=0.2 * randn(N, n, m),
        f=0.1 * randn(N, n),
        Qdiag=0.5 + rand(N, n),
        Rdiag=0.1 + rand(N, m),
        q=randn(N, n),
        r=randn(N, m),
        c=torch.zeros(N, device=device, dtype=dtype),
        x0=randn(n),
    )
