"""The program's stages in a trace made by hand, the readers of the
per-layer metrics that read them, and a traced run on the CPU."""

import importlib
import json
import time
import types

import pytest

from lqrbench import program, run, stagetrace, trace
from lqrbench.tests.test_lqrbench_trace import _trace as _harness_trace

P = stagetrace.PREFIX
NEW = ("core.factor_host_ms", "core.sweep_host_ms", "core.factor_device_ms",
       "core.sweep_device_ms", "host.copy_wait_ms")


def _events(program_spans=True):
    """``test_lqrbench_trace``'s trace (harness spans [0, 40] and [40,
    100]; device operations [10, 40], [30, 50], [70, 90]) with the
    operations' launch events and, optionally, the program's spans inside
    the issue."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "lqrbench.issue",
         "ts": 0, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "lqrbench.sync",
         "ts": 40, "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "void rows_kernel<36>(A)",
         "ts": 10, "dur": 30, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "at::native::copy", "ts": 30,
         "dur": 20, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 70,
         "dur": 20, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 3.5, "dur": 0.5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 25, "dur": 0.5, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync",
         "ts": 37.5, "dur": 0.2, "args": {"correlation": 9}},
    ]
    if program_spans:
        ev += [{"ph": "X", "cat": "user_annotation", "name": P + n,
                "ts": s, "dur": d}
               for n, s, d in (("solve", 2, 36), ("factor", 3, 17),
                               ("h2d", 4, 5), ("sweep", 20, 10),
                               ("rhs.L0", 21, 8), ("pack", 30, 7))]
    return ev


def _write(tmp_path, ev, name="t.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_harness_reduction_unchanged(tmp_path):
    """The program's spans and the launch events change nothing that
    ``trace.summarize`` returns."""
    pats = [r"\brows_kernel\b"]
    before = trace.summarize(_harness_trace(tmp_path), pats, calls=1)
    after = trace.summarize(
        trace.load_chrome(_write(tmp_path, _events(), "u.json")), pats,
        calls=1)
    assert after == before


def test_stages_host_device_and_gaps(tmp_path):
    s = stagetrace.summarize(stagetrace.load(_write(tmp_path, _events())),
                             calls=1)
    assert s["host_us"] == {"solve": 36, "factor": 17, "h2d": 5,
                            "sweep": 10, "rhs.L0": 8, "pack": 7}
    # Launched at 3.5 (factor), 25 (sweep, through the driver API) and
    # 37.5 (inside solve, after pack: solve's own).
    assert s["device_us"] == {"factor": 30, "sweep": 20, "solve": 20}
    assert s["stage_device_us"] == {"factor": 30, "rhs.L0": 20, "solve": 20}
    assert s["ops_us"] == 70
    assert s["issue_us"] == 40
    gaps = sorted((round(d * 1e6), n) for n, d in s["idle_gaps"])
    # [0, 10]'s middle lies in the program's h2d span; the others in the
    # harness's sync.
    assert gaps == [(10, "lqrbench.sync"), (10, P + "h2d"),
                    (20, "lqrbench.sync")]


def test_stacks_nest():
    spans = [("a", 0, 10), ("b", 1, 5), ("c", 5, 9)]
    assert stagetrace.stacks(spans, [0.5, 2, 5, 9.5, 11]) == [
        ("a",), ("a", "b"), ("a", "b", "c"), ("a",), ()]


def _read(monkeypatch, tmp_path, events, name):
    """``name``'s reader on a run whose profiler's events are ``events``
    (a stand-in profiler, read as the exported trace)."""
    path = _write(tmp_path, events)
    monkeypatch.setattr(stagetrace, "_profiler", object)
    monkeypatch.setattr(stagetrace, "from_profiler",
                        lambda prof: stagetrace.load(path))
    summary = {"calls": 2}
    return run.metric_reader(name)(types.SimpleNamespace(summary=summary))


@pytest.mark.parametrize("name,want", [
    ("core.factor_host_ms", 17e-3 / 2), ("core.sweep_host_ms", 10e-3 / 2),
    ("core.factor_device_ms", 30e-3 / 2), ("core.sweep_device_ms", 20e-3 / 2),
    ("host.copy_wait_ms", 5e-3 / 2)])
def test_readers(monkeypatch, tmp_path, name, want):
    assert _read(monkeypatch, tmp_path, _events(), name) == pytest.approx(
        want)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_program_spans(monkeypatch, tmp_path,
                                                    name):
    """A program without the spans (an older one) reads as nothing, not
    as zero."""
    assert _read(monkeypatch, tmp_path, _events(program_spans=False),
                 name) is None


def test_copies_reader_without_counter(monkeypatch):
    monkeypatch.setattr(program, "PACKAGE", "no_such_package_here")
    reader = run.metric_reader("host.copies_per_solve")
    assert reader(types.SimpleNamespace(summary=None)) is None


def test_traced_cpu_run_reports_the_host_stages():
    """A traced run of the di3d cell on the CPU at a small batch: the host
    readers and the copies counter report (5 knot masks a level of the
    depth-8 tree and 2 more: 42 a call); the device readers find no device
    operation and stay out of the line."""
    spec = run.load_cell("di3d-n256.rslqr-b4096")
    spec["traffic"] = {**spec["traffic"], "pool": 2}
    # The counters count from the process's start: a run's own process in
    # the benchmark, every earlier test here.
    importlib.import_module(program.PACKAGE + ".spans").reset_counters()
    rc, res = run.run_cell(spec, 2 ** 31 + 5, 0.2, True, "cpu",
                           time.perf_counter(), batch=4)
    assert rc == 0 and res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["host.copies_per_solve"] == 42
    for name in ("core.factor_host_ms", "core.sweep_host_ms",
                 "host.copy_wait_ms"):
        assert got[name] > 0, name
    assert got["core.factor_host_ms"] + got["core.sweep_host_ms"] <= (
        1e3 * res["device"]["window_s"] / 4)
    assert "core.factor_device_ms" not in got
    assert "core.sweep_device_ms" not in got
