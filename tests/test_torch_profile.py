"""Port tests: utilities and the per-phase profiler
(``rslqr_tpu_torch.utils``, ``.profile``), mirroring
tests/test_utils_profile.py on the CPU (no reference file: the problem is
built), and ``examples/quickstart_torch.py`` with ``--device cpu``."""

import os
import sys

import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

from rslqr_tpu.profile import linalg_flop_estimate as jax_flop_estimate

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import utils
from rslqr_tpu_torch.profile import (
    SolveProfile,
    linalg_flop_estimate,
    print_solve_summary,
    profile_riccati,
    profile_solve,
)

PHASES = ("leaves", "products", "cholesky", "cholsolve", "shur")


def test_power_of_two_predicates():
    # ref utils.c:7-15
    assert utils.is_power_of_two(1)
    assert utils.is_power_of_two(8)
    assert not utils.is_power_of_two(0)
    assert not utils.is_power_of_two(6)
    assert not utils.is_power_of_two(-8)
    assert utils.power_of_two(5) == 32
    assert utils.log2_int(256) == 8
    with pytest.raises(ValueError):
        utils.log2_int(6)


def test_profile_print_and_compare(capsys):
    a = SolveProfile(t_total_ms=10.0, t_leaves_ms=2.0, num_devices=1)
    b = SolveProfile(t_total_ms=5.0, t_leaves_ms=1.0, num_devices=8)
    a.print()
    a.compare(b)
    out = capsys.readouterr().out
    assert "Solve Total" in out and "2.00 speedup" in out and "host" in out
    c = a.copy()
    c.reset()
    assert c.t_total_ms == 0.0 and a.t_total_ms == 10.0


def test_solve_summary(capsys):
    print_solve_summary(1.25, num_devices=4, backend="cpu")
    out = capsys.readouterr().out
    assert "Solve time" in out and "4 device" in out


@pytest.mark.parametrize("layout", ["auto", "grid"])
def test_profile_solve_populates_all_five_phases(layout):
    """All five reference phases (solver.h:31-39) get nonzero device and
    host times, on the element-major path and on the grid path, and the
    whole solve's total is measured."""
    prob = pt.double_integrator_problem(16, device="cpu")
    batch = pt.batch_problems(prob, 4, torch.Generator().manual_seed(0))
    p = profile_solve(batch, repeats=1,
                      options=pt.SolveOptions(layout=layout))
    assert p.t_total_ms > 0 and p.host_total_ms > 0
    for name in PHASES:
        assert getattr(p, f"t_{name}_ms") > 0, name
        assert getattr(p, f"host_{name}_ms") > 0, name
    assert p.num_devices == 1
    p.compare(p)


def test_profile_riccati_pass_times(capsys):
    prob = pt.double_integrator_problem(16, device="cpu")
    p = profile_riccati(prob, repeats=1)
    assert p.t_backward_pass_ms > 0
    assert p.t_forward_pass_ms > 0
    assert p.t_solve_ms > 0
    p.print()
    out = capsys.readouterr().out
    assert "Backward pass" in out and "%" in out


def test_solve_summary_roofline(capsys):
    prob = pt.double_integrator_problem(8, device="cpu")
    print_solve_summary(1.25, num_devices=1, backend="cpu", problem=prob)
    out = capsys.readouterr().out
    assert "GFLOP/s" in out and "roofline" in out


@pytest.mark.parametrize("shape", [(6, 3, 256), (36, 12, 512)])
def test_linalg_flop_estimate_matches_jax(shape):
    est = linalg_flop_estimate(*shape)
    assert est == jax_flop_estimate(*shape)
    assert est["flops_shur"] > est["flops_cholesky"]


def test_quickstart_torch_on_cpu(capsys):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "examples"))
    try:
        import quickstart_torch
    finally:
        sys.path.pop(0)
    res = quickstart_torch.main(["--device", "cpu"])
    assert res < 1e-8
    out = capsys.readouterr().out
    for line in ("rsLQR    KKT residual", "pscan    KKT residual",
                 "batched solve: 256 instances", "multi-RHS KKT residual"):
        assert line in out
