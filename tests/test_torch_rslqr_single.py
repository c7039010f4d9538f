"""Port tests: unbatched and random problems through
``rslqr_tpu_torch.solve_kkt`` against ``rslqr_tpu.solve_kkt`` with its XLA
stages (``pallas="off"``), f64 on CPU.

Tolerance: ``1e-10 * (1 + max|ref|)`` (see tests/test_torch_rslqr.py).
A single problem runs in the port as a batch of one through the same
kernel path.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt

BAR = 1e-10

# The JAX reference, its XLA stages, compiled as one program (op-by-op
# dispatch costs 3-4x more compile time on these shapes).
_jax_ref = jax.jit(lambda p: rt.solve_kkt(p, options=JaxOptions(pallas="off")))


def test_single_problem_matches_jax():
    prob = rt.double_integrator_problem(16)
    ref = np.asarray(_jax_ref(prob))
    tp = pt.problem_from_numpy(prob, device="cpu")
    got = pt.solve_kkt(tp)
    assert got.shape == (prob.nvars,)
    assert rel_err(got.numpy(), ref) < BAR
    assert float(pt.kkt_residual(tp, got)) < 1e-9
    ric = pt.solve_riccati(tp).kkt_vector().numpy()
    assert rel_err(got.numpy(), ric) < 1e-6


@pytest.mark.parametrize("N", [2, 8])
def test_random_batches_match_jax(N):
    """Random dynamics and costs; N=2 (depth 1: no fused leaf, no update)
    and N=8 (leaf, one pair)."""
    prob = rt.random_problem(jax.random.PRNGKey(N), N, 6, 3, jnp.float64)
    batch = rt.batch_problems(prob, jax.random.split(jax.random.PRNGKey(1), 3))
    ref = np.asarray(_jax_ref(batch))
    tb = pt.problem_from_numpy(batch, device="cpu")
    got = pt.solve_kkt(tb)
    assert rel_err(got.numpy(), ref) < BAR
    assert float(pt.kkt_residual(tb, got).max()) < 1e-9


def test_two_leading_batch_axes():
    """Leading batch axes are flattened to one and restored."""
    prob = pt.double_integrator_problem(8, device="cpu")
    b = pt.batch_problems(prob, 6, torch.Generator().manual_seed(0))
    b2 = b.map(lambda x: x.reshape((2, 3) + x.shape[1:]))
    got = pt.solve_kkt(b2)
    assert got.shape == (2, 3, prob.nvars)
    np.testing.assert_array_equal(
        got.reshape(6, -1).numpy(), pt.solve_kkt(b).numpy()
    )


def test_chip_smoke_refuses_without_cuda():
    """The GPU smoke run exits non-zero and prints no result where no CUDA
    device is visible."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
