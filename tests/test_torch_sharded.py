"""Port tests: the sharded solvers (``rslqr_tpu_torch.parallel``) on
spawned gloo ranks (CPU), against the JAX package's sharded and
single-device solves on conftest's 8-device CPU mesh, on the same f64
inputs; their communication structure, read from ``comm``'s recorder; and
the dry run. Every case of a world size runs in ONE spawn of ranks (D = 1,
2, 4, 8), while the parent computes the JAX references.

Horizon-sharded rsLQR (``solve_seq_sharded``) and scan
(``solve_pscan_sharded``): the cases of tests/test_seq_sharded.py and
tests/test_pscan_seq.py, their golden problems (absent) replaced by f64
``random_problem`` s: N=8 at D = 1, 2, 4 (bar 1e-6, the golden file's; the
scan also 1e-10 against the single-device scan), N=128 at D = 8 (the N=256
file's case, at a horizon whose JAX references compile in seconds), a
batch of 4 on a ``(2, 4)`` dp x sp mesh (1e-9 absolute) and N=64 at D = 4
(KKT residual < 1e-7). Every rank gets the same full vector. The scan's
chunk N/D must be a power of two (N=24 over D=4 raises).

Collectives: the closed-form models of tests/test_collective_audit.py,
copied here (not imported) with the port's trailing batch axis (``b = 1``
for a single problem): only the top ``log2(D)`` tree levels communicate,
every collective carries O(1) blocks per rank, and the signature does not
change from N=32 to N=64. The one ``"assemble"`` all_gather that hands
every rank the full vector is filed under its own label and left out of
the signature. The batch-sharded solve makes no collective. The dry run
(``dryrun_multichip(8, "cpu")``'s ranks and its report) runs in the D=8
spawn.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import problem_arrays, spawn_cases_beside

import rslqr_tpu as rt
from rslqr_tpu import pscan as jpscan
from rslqr_tpu import rslqr
from rslqr_tpu.parallel import make_mesh
from rslqr_tpu.parallel import pscan_seq as jpscan_seq
from rslqr_tpu.parallel import seq as jseq

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.parallel import comm, pscan_seq
from rslqr_tpu_torch.parallel.dryrun import dryrun_report, mesh_shape


def _prob(N, n=6, m=3, seed=None):
    return rt.random_problem(jax.random.PRNGKey(N if seed is None else seed),
                             N, n, m, jnp.float64)


def _batch():
    return rt.batch_problems(_prob(8), jax.random.split(
        jax.random.PRNGKey(0), 4))


# Parity cases, each for "seq" and "pscan".
# name: (world size, JAX problem, mesh shape, axes, dp axis)
PARITY = {
    "n8_d1": (1, _prob(8), (1,), ("sp",), None),
    "n8_d2": (2, _prob(8), (2,), ("sp",), None),
    "n8_d4": (4, _prob(8), (4,), ("sp",), None),
    "random_d4": (4, _prob(64, 4, 2, seed=5), (4,), ("sp",), None),
    "n128_d8": (8, _prob(128), (8,), ("sp",), None),
    "batch_2x4": (8, _batch(), (2, 4), ("dp", "sp"), "dp"),
}
JAX_SHARDED = {"seq": jseq.solve_seq_sharded,
               "pscan": jpscan_seq.solve_pscan_sharded}
JAX_SINGLE = {"seq": rslqr.solve_kkt, "pscan": jpscan.solve_pscan_kkt}


def _audit_prob(N, n=6, m=3):
    return problem_arrays(
        rt.random_problem(jax.random.PRNGKey(0), N, n, m, jnp.float64))


def _audit_case(solver, D, N):
    return (D, {"solver": solver, "problem": _audit_prob(N), "mesh": (D,),
                "axes": ("sp",), "sp": "sp", "dp": None})


# Audit cases: name: (world size, case).
AUDIT = {
    **{f"audit_{s}_d{D}": _audit_case(s, D, 32) for s in ("seq", "pscan")
       for D in (2, 4, 8)},
    **{f"audit_{s}_d4_n64": _audit_case(s, 4, 64) for s in ("seq", "pscan")},
    "audit_seq_d8_n64": _audit_case("seq", 8, 64),
}

BATCH = rt.batch_problems(
    rt.random_problem(jax.random.PRNGKey(1), 16, 6, 3, jnp.float64),
    jax.random.split(jax.random.PRNGKey(2), 4))
DRYRUN_SHAPE = mesh_shape(8)


def _jax_refs():
    """JAX's sharded and single-device solve of every parity case, and its
    single-device solve of the batch-sharded case."""
    devs = jax.devices()
    refs = {}
    for solver in ("seq", "pscan"):
        for k, (w, p, shp, axes, dp) in PARITY.items():
            mesh = make_mesh(shp, axes, devs[:w])
            refs[f"{solver}_{k}"] = (
                np.asarray(JAX_SHARDED[solver](p, mesh, "sp", dp)),
                np.asarray(jax.jit(JAX_SINGLE[solver])(p)))
    refs["batch_d2"] = np.asarray(jax.jit(rslqr.solve_kkt)(BATCH))
    return refs


@pytest.fixture(scope="module")
def runs():
    """Every rank's result of every case, one spawn per world size, and
    the JAX references."""
    cases = {
        f"{solver}_{k}": (w, {"solver": solver, "problem": problem_arrays(p),
                              "mesh": shp, "axes": axes, "sp": "sp",
                              "dp": dp})
        for solver in ("seq", "pscan")
        for k, (w, p, shp, axes, dp) in PARITY.items()}
    cases.update(AUDIT)
    cases["batch_d2"] = (2, {"solver": "batch",
                             "problem": problem_arrays(BATCH), "mesh": (2,),
                             "axes": ("dp",), "dp": "dp"})
    cases["dryrun_8"] = (8, {"solver": "dryrun", "mesh": DRYRUN_SHAPE})
    return spawn_cases_beside(cases, _jax_refs)


# -- parity -------------------------------------------------------------

def _check(runs, name, bar, single_bar=None):
    got, refs = runs
    sharded, single = refs[name]
    outs = [r["kkt"] for r in got[name]]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert outs[0].shape == single.shape
    assert np.abs(outs[0] - sharded).max() < bar, name
    assert np.abs(outs[0] - single).max() < (single_bar or bar), name
    return outs[0]


def _residual(name, out):
    prob = pt.problem_from_numpy(PARITY[name][1], device="cpu")
    return float(pt.kkt_residual(prob, torch.as_tensor(out)))


@pytest.mark.parametrize("n_sp", [1, 2, 4])
def test_seq_sharded_matches_serial_n8(runs, n_sp):
    _check(runs, f"seq_n8_d{n_sp}", 1e-6)


def test_seq_sharded_matches_serial_long(runs):
    _check(runs, "seq_n128_d8", 1e-6)


def test_seq_sharded_batched_2d_mesh(runs):
    """dp x sp mesh: batch and horizon sharded at once."""
    _check(runs, "seq_batch_2x4", 1e-9)


def test_seq_sharded_random(runs):
    out = _check(runs, "seq_random_d4", 1e-6)
    assert _residual("random_d4", out) < 1e-7


@pytest.mark.parametrize("n_sp", [1, 2, 4])
def test_pscan_sharded_matches_serial_n8(runs, n_sp):
    _check(runs, f"pscan_n8_d{n_sp}", 1e-6, single_bar=1e-10)


def test_pscan_sharded_matches_serial_long(runs):
    _check(runs, "pscan_n128_d8", 1e-6)


def test_pscan_sharded_batched_2d_mesh(runs):
    """dp x sp mesh: batch and horizon sharded at once."""
    _check(runs, "pscan_batch_2x4", 1e-9)


def test_pscan_sharded_random(runs):
    out = _check(runs, "pscan_random_d4", 1e-6)
    assert _residual("random_d4", out) < 1e-7


class _FourRanks:
    """A mesh stand-in: the chunk check runs before any collective."""

    mesh_dim_names = ("sp",)

    def size(self, i):
        return 4

    def get_local_rank(self, i):
        return 0

    def get_group(self, i):
        return None


def test_pscan_sharded_chunk_power_of_two():
    prob = pt.random_problem(torch.Generator().manual_seed(0), 24, 4, 2,
                             dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        pscan_seq.solve_pscan_sharded(prob, _FourRanks(), "sp")


# -- collectives --------------------------------------------------------

def _seq_expected(D, N, n, m, b=1):
    """The design's collective signature for solve_seq_sharded: two
    dynamics gathers, then per top level (T = log2 D of them, upper count
    U = T..1) four factor-block gathers in the sweep and four vector
    gathers in the RHS pass."""
    T = int(np.log2(D))
    shapes = collections.Counter()
    shapes[("all_gather", (D, n, n, b))] += 1  # A_last
    shapes[("all_gather", (D, n, m, b))] += 1  # B_last
    for U in range(T, 0, -1):
        shapes[("all_gather", (D, U, n, n, b))] += 3  # lasts_x, firsts_x/_l
        shapes[("all_gather", (D, U, m, n, b))] += 1  # lasts_u
    shapes[("all_gather", (D, n, b))] += 3 * T  # last_zx, first_zx/_zy
    shapes[("all_gather", (D, m, b))] += T  # last_zu
    return shapes


def _pscan_expected(D, N, n, m, b=1):
    """Design signature for solve_pscan_sharded: one gather of the five
    chunk-reduced element components, one of the two chunk affine-map
    components, one ppermute pair for the gain boundary."""
    shapes = collections.Counter()
    shapes[("all_gather", (D, n, n, b))] += 3 + 1  # F, C, J; forward M
    shapes[("all_gather", (D, n, b))] += 2 + 1  # c, eta; forward t
    shapes[("ppermute", (n, n, b))] += 1  # next chunk's P[0]
    shapes[("ppermute", (n, b))] += 1  # next chunk's p[0]
    return shapes


def _signature(calls):
    return collections.Counter(
        (name, tuple(s)) for name, s in calls
        if name in comm.SOLVE_COLLECTIVES)


def _calls(runs, name):
    per_rank = [r["calls"] for r in runs[0][name]]
    for calls in per_rank[1:]:  # one program: the same calls on every rank
        assert calls == per_rank[0]
    return per_rank[0]


@pytest.mark.parametrize("D", [2, 4, 8])
def test_seq_collective_signature(runs, D):
    calls = _calls(runs, f"audit_seq_d{D}")
    assert _signature(calls) == _seq_expected(D, 32, 6, 3)
    assert [c for c in calls if c[0] not in comm.SOLVE_COLLECTIVES] == [
        ("assemble", (D, 32 // D, 15, 1))]


@pytest.mark.parametrize("D", [2, 4, 8])
def test_pscan_collective_signature(runs, D):
    calls = _calls(runs, f"audit_pscan_d{D}")
    assert _signature(calls) == _pscan_expected(D, 32, 6, 3)


@pytest.mark.parametrize("solver", ["seq", "pscan"])
def test_volume_independent_of_horizon(runs, solver):
    """Doubling N must not change the communication signature."""
    sig32 = _signature(_calls(runs, f"audit_{solver}_d4"))
    sig64 = _signature(_calls(runs, f"audit_{solver}_d4_n64"))
    assert sig32 == sig64
    assert sum(sig32.values()) > 0  # the audit saw the collectives


def test_seq_volume_matches_model(runs):
    """Total gathered bytes == the closed-form O(D log D (n^2+nm) b) model
    (f64; b = 1)."""
    D, N, n, m = 8, 64, 6, 3
    got = sum(int(np.prod(s)) * 8
              for name, s in _calls(runs, "audit_seq_d8_n64")
              if name == "all_gather")
    T = int(np.log2(D))
    model = 8 * D * (
        n * n + n * m
        + sum(U * (3 * n * n + m * n) for U in range(1, T + 1))
        + T * (3 * n + m)
    )
    assert got == model


def test_batch_sharded_is_communication_free(runs):
    """Each rank solves its contiguous half of the batch, no collective;
    the halves make JAX's single-device solve of the batch (1e-9)."""
    got, refs = runs
    for r in got["batch_d2"]:
        assert r["calls"] == [] and r["transports"] == []
        assert r["kkt"].shape[0] == 2
    out = np.concatenate([r["kkt"] for r in got["batch_d2"]])
    np.testing.assert_allclose(out, refs["batch_d2"], atol=1e-9)


def test_dryrun_multichip_cpu(runs):
    """``dryrun_multichip(8, "cpu")``: its ranks ran in the D=8 spawn; its
    report holds them to the 1e-4 bars."""
    line = dryrun_report(8, DRYRUN_SHAPE, runs[0]["dryrun_8"])
    assert line.startswith("dryrun_multichip(8): ok, rslqr mesh "
                           "{'dp': 2, 'sp': 4}")
