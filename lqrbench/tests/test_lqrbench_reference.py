"""The plain reference against the port's own f64 solves with its kernels
off, at tiny shapes on the CPU; the control (TF32) against both limits;
and the reference's independence of the program."""

import ast
import subprocess
import sys

import pytest
import torch

from lqrbench import compare, generator, run
from lqrbench.reference import riccati

SHAPES = [  # (problem, N, n, m)
    ("double_integrator", 8, 2, 1),
    ("double_integrator", 16, 6, 3),
    ("random", 8, 3, 2),
    ("random", 16, 12, 4),
]


def _pool(kind, N, n, m, batch=3, seed=2 ** 31 + 5):
    config = {"problem": kind, "nhorizon": N, "nstates": n, "ninputs": m,
              "dt": 0.1, "dtype": "float64"}
    return generator.make_pool(config, {"batch": batch, "pool": 1}, seed,
                               "cpu")[0]


@pytest.mark.parametrize("entry", ["rslqr", "pscan"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_port_f64(shape, entry):
    import rslqr_tpu_torch as rt

    p = _pool(*shape)
    off = rt.SolveOptions(kernels="off")
    prob = rt.LQRProblem(**p)
    port = (rt.solve_kkt(prob, options=off) if entry == "rslqr"
            else rt.solve_pscan_kkt(prob, options=off))
    ref = riccati.solve(p, "float64", block=2)
    assert port.shape == ref.shape
    assert compare.kkt_rel_err(port, ref) < 1e-9
    assert compare.kkt_dev_err(port, ref) < 1e-9


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -10 + 2 ** -11), float("inf")])
    want = [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -9), float("inf")]
    assert riccati.round_tf32(x).tolist() == want


@pytest.mark.parametrize("cell", ["di3d-n256.rslqr-b4096",
                                  "quadruped-n512.rslqr-b256",
                                  "quadruped-n512.pscan-b256"])
def test_control_fails_cell_limit(cell):
    """The control, the reference in TF32, at the cell's widths and
    horizon (a small batch, on the CPU), fails one of the cell's
    numbers; the f64 reference against itself passes them."""
    spec = run.load_cell(cell)
    p = generator.make_pool(spec["config"], spec["traffic"], 2 ** 31 + 9,
                            "cpu", batch=4)[0]
    ref = riccati.solve(p, "float64")
    lim = {k: v["limit"] for k, v in spec["check"]["numbers"].items()}
    got = compare.numbers(riccati.solve(p, "tf32"), ref)
    assert any(got[k] > lim[k] for k in lim), got
    same = compare.numbers(ref.clone(), ref)
    assert all(same[k] <= lim[k] for k in lim)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (run.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"rslqr_tpu_torch", "rslqr_tpu", "jax"}, path
    code = ("import sys; import lqrbench.reference.riccati; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"rslqr_tpu_torch", "rslqr_tpu", "jax", "jaxlib"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["di3d-n256.rslqr-b4096",
                                  "quadruped-n512.rslqr-b256"])
def test_control_fails_at_cell_size(card, cell):
    """On the card at the cell's own batch: the control fails the limit."""
    spec = run.load_cell(cell)
    for seed in (11, 12, 13):
        p = generator.make_pool(spec["config"], spec["traffic"], seed,
                                card)[0]
        ref = riccati.solve(p, "float64")
        got = compare.numbers(riccati.solve(p, "tf32"), ref)
        lim = {k: v["limit"] for k, v in spec["check"]["numbers"].items()}
        assert any(got[k] > lim[k] for k in lim), got
