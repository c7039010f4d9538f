"""Every cell's files resolve by name, and BENCHMARK.json keeps to the
shape the harness reads."""

import json
import re

import pytest

from lqrbench import compare, program, run, trace

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    spec = run.load_cell(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert callable(program.entry(spec["traffic"]["entry"]))
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    assert set(spec["check"]["numbers"]) <= set(compare.NUMBERS)
    stages = run.stage_counts(spec["config"], spec["traffic"])
    assert stages and all(f >= 0 and b > 0 for _, f, b in stages)


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["name"].split(".")[0] in {"solves_per_s", "batch_ms_p95",
                                           "setup_s"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        assert (run.ROOT / c["file"]).exists()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_kernel_patterns_match_only_their_kernel():
    pats = trace.hand_patterns(run.HERE / "kernels")
    assert pats
    for kernel, pat in pats.items():
        rx = re.compile(pat)
        assert rx.search(f"void (anonymous namespace)::{kernel}<36>(Args)")
        assert not rx.search("void at::native::elementwise_kernel<4>(int)")
        for other in pats:
            if other != kernel:
                assert not rx.search(f"void {other}<1>(Args)")
