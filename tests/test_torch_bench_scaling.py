"""Port tests: the port's scaling harness (``bench_scaling_torch.py``) in
its three modes at two rank counts on the CPU (tests/test_bench_scaling.py's
cases), and ``examples/multichip_torch.py`` on two CPU ranks. Both run as
subprocesses that spawn their own ranks."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,solver", [("dp", "rslqr"), ("sp", "rslqr"),
                                         ("sp", "pscan")])
def test_bench_scaling_runs(mode, solver):
    env = dict(
        os.environ,
        SCALE_DEVICES="1,2",
        SCALE_BATCH="4",
        SCALE_HORIZON="16",
        SCALE_MODE=mode,
        SCALE_SOLVER=solver,
        SCALE_REPS="1",
        SCALE_CHAIN="2",
        SCALE_PLATFORM="cpu",
    )
    out = subprocess.run([sys.executable, "bench_scaling_torch.py"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert len(lines) == 2  # one JSON line per rank count
    for rec in lines:
        assert rec["value"] > 0
        assert "efficiency_vs_1dev" in rec
        assert rec["method"] == "finite_diff" or rec["method"].startswith(
            "chained_mean")
        assert rec["device"] == "cpu"


def test_multichip_example_cpu():
    """Two ranks: the batch over dp, then the (2, 1) dp x sp mesh (the
    example's choice for two ranks; the horizon-sharded cases are
    test_torch_sharded.py's): the tree solve within 1e-4 of the
    single-device one (the dry run's bar); the scan's distance to it is
    that of two f32 solvers (max|x| ~2e4), reported below 1e-2."""
    out = subprocess.run(
        [sys.executable, "examples/multichip_torch.py", "--ranks", "2",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "2 ranks: cpu"
    diffs = [float(line.split()[-1]) for line in lines
             if "rel max diff" in line]
    assert len(diffs) == 2 and diffs[0] < 1e-4 and diffs[1] < 1e-2
