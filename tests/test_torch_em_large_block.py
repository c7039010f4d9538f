"""Port tests: ``layout="em"`` above the plane kernels' 64 (nx=72, nu=24,
N=8, B=2, f64, CPU).

The element-major path takes every block size under ``layout="em"``, as
the JAX package's does (rslqr_tpu/rslqr.py:508-509); above
``planes.MAX_BLOCK`` its mid-block route runs the plain versions of the
plane kernels (``rslqr_em._plane_options``), where JAX's plane kernels
stand aside (rslqr_tpu/linalg.py:172-193). Bar: 1e-10 relative
(``max|a-b| / (1 + max|b|)``) against ``rslqr_tpu.solve_kkt`` with
``layout="em"``; most of the file's time is that eager JAX solve's first
call (~45 s on one core: each op compiles at its new shape).
"""

import jax
import numpy as np

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt

BAR = 1e-10


def _big_block_arrays(N=8, nx=72, nu=24, B=2, seed=72):
    """A batch of ``B`` random problems with a state dim above 64, in
    numpy (f64), shaped as ``rslqr_tpu.random_problem`` shapes them."""
    rng = np.random.default_rng(seed)
    return dict(
        A=np.eye(nx) + 0.1 * rng.standard_normal((B, N, nx, nx)),
        B=0.2 * rng.standard_normal((B, N, nx, nu)),
        f=0.1 * rng.standard_normal((B, N, nx)),
        Qdiag=0.5 + rng.random((B, N, nx)),
        Rdiag=0.1 + rng.random((B, N, nu)),
        q=rng.standard_normal((B, N, nx)),
        r=rng.standard_normal((B, N, nu)),
        c=np.zeros((B, N)),
        x0=rng.standard_normal((B, nx)),
    )


def test_em_layout_above_64_matches_jax():
    """``layout="em"`` at nx=72, nu=24: the port's element-major solve
    (the mid-block route on the plain plane versions) against
    ``rslqr_tpu.solve_kkt`` with ``layout="em"`` on the same f64 batch."""
    arrays = _big_block_arrays()
    jb = rt.LQRProblem(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    ref = np.asarray(rt.solve_kkt(jb, options=JaxOptions(layout="em")))
    tb = pt.problem_from_numpy(arrays, device="cpu")
    sol = pt.solve(tb, options=pt.SolveOptions(layout="em"))
    assert isinstance(sol.fact, pt.EmFactorization)
    got = sol.kkt_vector().numpy()
    assert got.shape == ref.shape
    assert rel_err(got, ref) < BAR
    assert float(pt.kkt_residual(tb, sol.kkt_vector()).max()) < 1e-8


def test_em_layout_above_64_asks_no_plane_kernel(monkeypatch):
    """The route above 64 is static: every plane wrapper the element-major
    solve calls at nx=72 is asked for its plain version (``kernels="off"``)
    under ``kernels="auto"``, not for a kernel whose refusal is caught."""
    from rslqr_tpu_torch.ops import planes

    asked = []
    real = planes.kernel_applies

    def spy(kernels, device, dtype):
        asked.append(kernels)
        return real(kernels, device, dtype)

    monkeypatch.setattr(planes, "kernel_applies", spy)
    tb = pt.problem_from_numpy(_big_block_arrays(), device="cpu")
    sol = pt.solve(tb, options=pt.SolveOptions(layout="em", kernels="auto"))
    assert isinstance(sol.fact, pt.EmFactorization)
    assert asked and set(asked) == {"off"}
