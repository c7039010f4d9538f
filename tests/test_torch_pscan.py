"""Port tests: ``rslqr_tpu_torch.solve_pscan`` against
``rslqr_tpu.pscan.solve_pscan`` on the same f64 problems.

The JAX side runs its element-major path (``layout="em"``) with
``pallas="off"``: off a TPU, ``layout="auto"`` would send mid blocks to its
vmap route, and ``"off"`` is its plain reference, the same algorithm through
XLA fallbacks; one case runs ``pallas="interpret"`` (the Pallas kernels in
interpret mode). On CPU the port runs the plain versions of its kernels
through the same structure. Cases mirror tests/test_planes_ops.py:211-302 at
N=16-24, nx=12, nu=4, B=8-16: every chunk size, an odd chunk count, the
unchunked scan, the batched interior recovery; and the small-block
batch-last path at nx=6, nu=3. The N=16 cases run at B=16: JAX takes its
Pallas route only on planes of a multiple of 128 elements
(``rslqr_tpu/linalg.py:121``), which the unchunked scan's leaf-pair
combines (8 pairs x 16 columns) are the first to reach, so the
interpret-mode case runs there; the other N=16 cases share its shapes, and
so JAX's compiled ops.

Tolerance: ``1e-10 * (1 + max|ref|)`` in each of the seven fields K, d, P,
p, X, U, Y (the same sums in f64, in another order). The JAX references
are computed once per case and module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu import pscan as jps
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt

BAR = 1e-10
FIELDS = ("K", "d", "P", "p", "X", "U", "Y")

# case -> (N, nx, nu, B, options): the port's SolveOptions fields, the same
# on the JAX side.
CASES = {
    "s1": (16, 12, 4, 16, dict(pscan_chunk=1)),
    "s2": (16, 12, 4, 16, dict(pscan_chunk=2)),
    "s4": (16, 12, 4, 16, dict(pscan_chunk=4)),
    "s8": (16, 12, 4, 16, dict(pscan_chunk=8)),
    "N24_s8": (24, 12, 4, 8, dict(pscan_chunk=8)),  # 3 chunks: odd peel
    "N24_unchunked": (24, 12, 4, 8, dict()),        # auto: N < 64 -> 1
    "s4_batched": (16, 12, 4, 16, dict(pscan_chunk=4,
                                      pscan_batched_interior=True)),
    "N24_s8_batched": (24, 12, 4, 8, dict(pscan_chunk=8,
                                          pscan_batched_interior=True)),
    "small": (16, 6, 3, 8, dict()),                 # batch-last path
}


@functools.lru_cache(maxsize=None)
def _problem(N: int, nx: int, nu: int, nbatch: int):
    """(JAX batch, the same numbers as a port problem on the CPU). Built
    field by field: ``problem_from_numpy`` validates a power-of-two N."""
    prob = rt.random_problem(jax.random.PRNGKey(N + nx), N, nx, nu,
                             jnp.float64)
    batch = rt.batch_problems(
        prob, jax.random.split(jax.random.PRNGKey(N + nx + 1), nbatch))
    tb = pt.LQRProblem(*(
        torch.as_tensor(np.array(getattr(batch, f.name)))
        for f in dataclasses.fields(pt.LQRProblem)))
    return batch, tb


@functools.lru_cache(maxsize=None)
def _jax_ref(case: str, pallas: str = "off"):
    N, nx, nu, nb, kw = CASES[case]
    batch, _ = _problem(N, nx, nu, nb)
    opts = JaxOptions(layout="em", pallas=pallas, **kw)
    if nx <= 8:  # the small-block path compiles faster than it dispatches
        sol = jax.jit(lambda p: jps.solve_pscan(p, options=opts))(batch)
    else:
        sol = jps.solve_pscan(batch, options=opts)
    return {f: np.asarray(getattr(sol, f)) for f in FIELDS}


def _port(case: str):
    N, nx, nu, nb, kw = CASES[case]
    _, tb = _problem(N, nx, nu, nb)
    return pt.solve_pscan(tb, pt.SolveOptions(**kw)), tb


@pytest.mark.parametrize("case", list(CASES))
def test_solve_pscan_matches_jax(case):
    sol, _ = _port(case)
    ref = _jax_ref(case)
    for f in FIELDS:
        got = getattr(sol, f)
        assert got.dtype == torch.float64
        assert tuple(got.shape) == ref[f].shape, f
        assert rel_err(got.numpy(), ref[f]) < BAR, f


def test_solve_pscan_matches_jax_interpret(monkeypatch):
    """JAX with its Pallas kernels in interpret mode, unchunked: the leaf
    pairs' products run ``_pgemm_call`` with its flags (``dconst``,
    ``tbt``, ``Cin`` + ``sym``, ``ta`` + ``kscale`` + ``diag`` + ``sym``);
    the rest of the scan's planes are too small for JAX's kernel route."""
    from rslqr_tpu.ops import planes_pallas as jpp

    calls = []
    orig = jpp._pgemm_call
    monkeypatch.setattr(jpp, "_pgemm_call",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    sol, _ = _port("s1")
    ref = _jax_ref.__wrapped__("s1", "interpret")
    assert calls, "JAX took no Pallas kernel"
    for f in FIELDS:
        assert rel_err(getattr(sol, f).numpy(), ref[f]) < BAR, f


@pytest.mark.parametrize("case", ["s4", "N24_s8_batched", "small"])
def test_solve_pscan_kkt_residual(case):
    sol, tb = _port(case)
    kkt = pt.solve_pscan_kkt(tb, pt.SolveOptions(**CASES[case][4]))
    assert torch.equal(kkt, sol.kkt_vector())
    assert float(pt.kkt_residual(tb, kkt).max()) < 1e-9


@pytest.mark.parametrize("case", ["s8", "N24_unchunked", "small"])
def test_solve_pscan_matches_riccati(case):
    """The port's own independent oracle, all seven fields (cross-solver
    bar 1e-6, tests/test_rslqr.py:143-148)."""
    sol, tb = _port(case)
    ric = pt.solve_riccati(tb)
    for f in FIELDS:
        assert rel_err(getattr(sol, f).numpy(),
                       getattr(ric, f).numpy()) < 1e-6, f


@pytest.mark.parametrize("chunk", [5, 16])
def test_pscan_chunk_invalid_raises(chunk):
    """An explicit chunk must divide N with at least two chunks."""
    _, tb = _problem(16, 12, 4, 16)
    with pytest.raises(ValueError, match="pscan_chunk"):
        pt.solve_pscan(tb, pt.SolveOptions(pscan_chunk=chunk))


def test_solve_pscan_batch_shapes():
    """A single problem and two leading batch axes give the flattened
    batch's answers in their own shapes; blocks above 64 take the
    batch-last scan (the large-block route) and match the Riccati oracle."""
    sol, tb = _port("s8")
    one = pt.solve_pscan(tb.map(lambda x: x[3]),
                         pt.SolveOptions(pscan_chunk=8))
    two = pt.solve_pscan(tb.map(lambda x: x.reshape((2, 8) + x.shape[1:])),
                         pt.SolveOptions(pscan_chunk=8))
    for f in FIELDS:
        full = getattr(sol, f)
        assert rel_err(getattr(one, f).numpy(), full[3].numpy()) < 1e-14
        assert tuple(getattr(two, f).shape) == (2, 8) + full.shape[1:]
        assert rel_err(getattr(two, f).reshape(full.shape).numpy(),
                       full.numpy()) < 1e-14
    big = pt.random_problem(torch.Generator().manual_seed(0), 2, 65, 2,
                            dtype=torch.float64, device="cpu")
    got = pt.solve_pscan_kkt(big)
    ric = pt.solve_riccati(big).kkt_vector()
    assert rel_err(got.numpy(), ric.numpy()) < 1e-9
