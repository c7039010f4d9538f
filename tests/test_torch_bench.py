"""Port tests: ``bench_torch.py``, the port's bench entry, against bench.py.

On the CPU at a small size (N=8, B=4): the chain is K sequential solves
with the same ``Qdiag`` nudges, and its sum equals the JAX bench's chain
(``bench._chained(rslqr.solve_kkt, 3)``) on the same f64 batch, carried
across with ``problem_from_numpy``, within 1e-10 relative; the JSON line
has bench.py's keys with ``device`` and without ``vs_baseline``; a wrong
solver injected through ``SOLVERS`` fails a gate and the run exits
nonzero; importing ``bench_torch`` loads neither JAX nor the JAX package.

Importing ``bench.py`` sets JAX's matmul precision and persistent-cache
options (bench.py:44-53); the fixture restores them, so that the other
tests of the same worker run as before.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

import bench_torch
import rslqr_tpu as rj
import rslqr_tpu_torch as pt

ROOT = Path(__file__).resolve().parent.parent
N, B = 8, 4
OFF = pt.SolveOptions(kernels="off")
JAX_KEYS = ("jax_default_matmul_precision", "jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
STAT_KEYS = {"mean", "std", "min", "median", "max", "best",
             "ms_per_batched_solve", "compile_first_s", "compile_first_k2_s",
             "method", "rep_ms"}
# A small run of every default family: main config N=8, B=4, quadruped
# N=8, B=2.
SMALL_ENV = {"BENCH_HORIZON": "8", "BENCH_BATCH": "4", "BENCH_REPS": "1",
             "BENCH_QUAD_HORIZON": "8", "BENCH_QUAD_BATCH": "2"}


@pytest.fixture(scope="module")
def jax_bench():
    """``bench.py`` as a module, with JAX's options and the cache variable
    of the environment as they were before."""
    saved = {k: getattr(jax.config, k) for k in JAX_KEYS}
    env = os.environ.get(CACHE_ENV)
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = env
    return mod


@pytest.fixture
def small_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)


def _jax_batch():
    prob = rj.double_integrator_problem(N, dtype=jnp.float64)
    return rj.batch_problems(prob, jax.random.split(jax.random.PRNGKey(0),
                                                    B))


def _run_main(capsys):
    rc = bench_torch.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_jax_bench_import_leaves_jax_options(jax_bench):
    assert jax_bench.BASELINE_SOLVES_PER_SEC == 10_000.0
    assert jax.config.jax_compilation_cache_dir != "/tmp/jax_cache"


@pytest.mark.parametrize("K", [1, 3])
def test_chain_is_sequential_solves(K):
    b = pt.problem_from_numpy(_jax_batch(), device="cpu")
    kkt = lambda p: pt.solve_kkt(p, options=OFF)
    got = bench_torch._chained(kkt, K)(b)
    eps = acc = torch.zeros((), dtype=torch.float64)
    for _ in range(K):
        s = kkt(dataclasses.replace(b, Qdiag=b.Qdiag + eps)).sum()
        eps, acc = s * 1e-38, acc + s
    assert got.dtype == torch.float64 and torch.equal(got, acc)


def test_chain_matches_jax_bench(jax_bench):
    jb = _jax_batch()
    want = float(jax_bench._chained(jax_bench.rslqr.solve_kkt, 3)(jb))
    b = pt.problem_from_numpy(jb, device="cpu")
    got = float(bench_torch._chained(
        lambda p: pt.solve_kkt(p, options=OFF), 3)(b))
    assert abs(got - want) <= 1e-10 * abs(want)


def test_json_line_has_bench_keys(small_env, capsys):
    rc, rec = _run_main(capsys)
    assert rc == 0
    assert set(rec) == {"metric", "value", "unit", "detail", "device"}
    assert rec["device"] == "cpu" and rec["unit"] == "solves/s"
    assert rec["metric"].startswith("lqr_solves_per_sec_cpu_n8_b4_f32_")
    d = rec["detail"]
    for fam in ("pscan", "rslqr", "refine", "rslqr_quadruped",
                "pscan_quadruped"):
        assert STAT_KEYS <= set(d[fam]), fam
        assert d[fam]["method"] == "finite_diff" and d[fam]["median"] > 0
    assert d["rslqr_quadruped"]["chunk"] == 2
    assert rec["value"] == max(d[f]["median"]
                               for f in ("pscan", "rslqr", "refine"))
    for key in ("refined_f64_residual", "refined_f64_device_residual"):
        assert d[key] < bench_torch.ACCURACY_BAR
    assert d["refined_f64_solves_per_s"] > 0
    assert d["rslqr_vs_pscan_quadruped_max_diff_rel"] < (
        bench_torch.QUAD_AGREE_BAR)


def test_failed_gate_exits_nonzero(small_env, monkeypatch, capsys):
    """pscan replaced by a solver 1% off: the quadruped agreement gate
    fails at its own bar and the run exits 1 after printing its line."""
    monkeypatch.setenv("BENCH_CONFIG", "quadruped")
    monkeypatch.setitem(bench_torch.SOLVERS, "pscan",
                        lambda p: 1.01 * pt.solve_kkt(p))
    rc, rec = _run_main(capsys)
    assert rc == 1
    d = rec["detail"]
    assert d["rslqr_vs_pscan_quadruped_max_diff_rel"] > (
        bench_torch.QUAD_AGREE_BAR)
    assert d["rslqr_quadruped_kkt_residual_rel"] < (
        bench_torch.QUAD_RESIDUAL_BAR)


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 2
    assert capsys.readouterr().out == ""


def test_import_loads_no_jax():
    code = ("import sys; before = set(sys.modules); import bench_torch; "
            "new = set(sys.modules) - before; "
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rslqr_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_factor_dtype_knob(monkeypatch):
    """``BENCH_FACTOR_DTYPE`` (bench.py:60-63) reaches the families: bf16
    factor slabs in the rsLQR family, read at each call; unset, the
    problem dtype."""
    assert bench_torch._options().factor_dtype == ""
    monkeypatch.setenv("BENCH_FACTOR_DTYPE", "bfloat16")
    assert bench_torch._options(flat_planes=True) == pt.SolveOptions(
        factor_dtype="bfloat16", flat_planes=True)
    prob = pt.double_integrator_problem(16, dtype=torch.float32,
                                        device="cpu")
    b = pt.batch_problems(prob, 2, torch.Generator().manual_seed(0))
    assert torch.equal(bench_torch.SOLVERS["rslqr"](b), pt.solve_kkt(
        b, options=pt.SolveOptions(factor_dtype="bfloat16")))
