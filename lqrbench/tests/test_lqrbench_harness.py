"""The harness driven on the CPU at a small batch, past its look for a
card: a sound run is correct, each planted fault makes ``correct`` false,
a traced run reduces its trace, and nothing of JAX is loaded."""

import json
import subprocess
import sys
import time

import pytest

from lqrbench import faults, program, run

SMALL = {"di3d-n256.rslqr-b4096": 4, "quadruped-n512.pscan-b256": 2}


def _spec(cell, pool=2):
    spec = run.load_cell(cell)
    spec["traffic"] = {**spec["traffic"], "pool": pool}
    return spec


def _run(cell, fault=None, trace=False):
    spec = _spec(cell)
    solve = program.entry(spec["traffic"]["entry"])
    if fault:
        solve = faults.FAULTS[fault](solve)
    return run.run_cell(spec, 2 ** 31 + 3, 0.2, trace, "cpu",
                        time.perf_counter(), solve=solve,
                        batch=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    rc, res = _run(cell)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"solves_per_s", "batch_ms_p95",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_qualified_metric_reports_its_quantity():
    # The card-paced cell's own end-to-end metrics, on a small run.
    e2e = run.load_cell("quadruped-n512.rslqr-b256")["end_to_end"]
    spec = _spec("di3d-n256.rslqr-b4096")
    spec["end_to_end"] = e2e
    rc, res = run.run_cell(spec, 7, 0.2, False, "cpu", time.perf_counter(),
                           batch=SMALL["di3d-n256.rslqr-b4096"])
    got = res["metrics"]
    assert rc == 0 and set(got) == {m["name"] for m in e2e}
    for name in ("solves_per_s", "batch_ms_p95"):
        assert got[name + ".card_paced"] == got[name]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_planted_fault_is_caught(cell, fault):
    rc, res = _run(cell, fault)
    assert rc == 0 and not res["correct"] and res["failed"] >= 1


def test_traced_run_reports_layers():
    rc, res = _run("di3d-n256.rslqr-b4096", trace=True)
    assert rc == 0 and res["correct"]
    assert "host.issue_ms" in res["metrics"]
    assert "solves_per_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_module_refuses_the_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, res = _run("di3d-n256.rslqr-b4096")
    assert rc != 0 and res is None


def test_cpu_only_machine_exits_without_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from lqrbench.run import main; "
            "sys.exit(main(['--workload', 'di3d-n256.rslqr-b4096', "
            "'--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_in_a_run():
    code = (
        "import sys, time, json; from lqrbench import run; "
        "spec = run.load_cell('di3d-n256.rslqr-b4096'); "
        "spec['traffic']['pool'] = 1; "
        "rc, res = run.run_cell(spec, 5, 0.1, False, 'cpu', "
        "time.perf_counter(), batch=2); "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, check=True)
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "rslqr_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rslqr_tpu"}
