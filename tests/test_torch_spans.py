"""Port tests: the stage spans and host counters of
``rslqr_tpu_torch.spans`` on the solve paths, read from an exported
``torch.profiler`` trace (CPU activity; the labels and their nesting are
the same on the card)."""

import contextlib
import dataclasses
import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_setup  # noqa: F401  (one torch thread per worker)

import rslqr_tpu_torch as pt
from rslqr_tpu_torch import spans
from rslqr_tpu_torch.tree import build_tree_tables

# The stage each span runs inside (h2d: any of the stages that copy).
PARENT = {
    "factor": "solve", "sweep": "solve", "pack": "solve",
    "leaves": "factor", "products": "factor", "cholesky": "factor",
    "cholsolve": "factor", "shur": "factor", "rhs": "sweep",
    "leaf": "factor", "fold": "factor", "scan": "factor", "down": "factor",
    "gains": "factor", "prefix": "sweep", "outputs": "sweep",
    "h2d": ("products", "leaves"),
}
CALLS = 2


def _di(N=16, B=4):
    prob = pt.double_integrator_problem(N, device="cpu")
    return pt.batch_problems(prob, B, torch.Generator().manual_seed(0))


def _mid(N=16, nx=12, nu=4, B=4):
    g = torch.Generator().manual_seed(1)
    prob = pt.random_problem(g, N, nx, nu, dtype=torch.float64,
                             device="cpu")
    return pt.batch_problems(prob, B, g)


def _grad(batch):
    return dataclasses.replace(batch, q=batch.q.clone().requires_grad_(True))


def _rslqr_copies(N, path):
    """Host arrays a solve copies to its device (``spans.host_copy``), in
    closed form: the fused small-block leaf copies 5 knot masks a level
    (``_leaf_products0``) and 2 for the RHS (``_leaf_z``); the plain
    element-major leaf (mid blocks) 3 index tables a level, 1 more at level
    0, and the 2 masks; the grid leaf 4 index tables."""
    depth = build_tree_tables(N).depth
    return {"fused": 5 * depth + 2, "plain": 3 * depth + 3, "grid": 4}[path]


# name: (problem, entry, options, tree solve, host copies per call)
CASES = {
    "em-small": (_di, pt.solve_kkt, None, True, _rslqr_copies(16, "fused")),
    "em-mid": (_mid, pt.solve_kkt, None, True, _rslqr_copies(16, "plain")),
    "grid": (_di, pt.solve_kkt, pt.SolveOptions(layout="grid"), True,
             _rslqr_copies(16, "grid")),
    "em-small-solve": (_di, pt.solve, None, True,
                       _rslqr_copies(16, "fused")),
    "em-small-grad": (lambda: _grad(_di()), pt.solve, None, True,
                      _rslqr_copies(16, "fused")),
    "pscan-em": (_mid, pt.solve_pscan_kkt, None, False, 0),
    "pscan-em-chunked": (_mid, pt.solve_pscan_kkt,
                         pt.SolveOptions(pscan_chunk=4), False, 0),
    "pscan-batch-last": (_di, pt.solve_pscan_kkt, None, False, 0),
}


def _spans(prof, tmp_path):
    """``[(name, start, end)]`` of the program's spans in the exported
    trace, by start, the prefix taken off."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events["traceEvents"]
    out = [(e["name"][len(spans.PREFIX):], float(e["ts"]),
            float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(spans.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(sp, all_spans):
    """The innermost other span around ``sp``."""
    around = [o for o in all_spans if o is not sp
              and o[1] <= sp[1] and sp[2] <= o[2]]
    return min(around, key=lambda o: o[2] - o[1]) if around else None


def _outputs(out):
    return [out] if torch.is_tensor(out) else [out.Y, out.X, out.U]


def _run(case):
    make, fn, opts, _, _ = CASES[case]
    batch = make()
    return lambda: _outputs(fn(batch, options=opts))


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_by_stage(case, tmp_path):
    """Each front-door call opens one ``solve`` span holding ``factor``,
    ``sweep`` and (KKT entries) ``pack``; every stage lies inside its
    parent; a tree solve has one span of each compact stage and of the RHS
    sweep per level; the counters count each call's solve and copies."""
    _, fn, _, tree, copies = CASES[case]
    call = _run(case)
    call()  # first-call work (allocator, tables) out of the trace
    spans.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            call()
    assert spans.counters() == {"solves": CALLS,
                                "host_copies": CALLS * copies}
    got = _spans(prof, tmp_path)
    names = [s[0] for s in got]
    assert names.count("solve") == CALLS
    want = {"factor", "sweep"} | ({"pack"} if "kkt" in fn.__name__ else set())
    for top in want:
        assert names.count(top) == CALLS, top
    assert "pack" in want or "pack" not in names
    for sp in got:
        parent = _parent(sp, got)
        if sp[0] == "solve":
            assert parent is None
            continue
        base = sp[0].split(".")[0]
        allowed = PARENT[base]
        allowed = (allowed,) if isinstance(allowed, str) else allowed
        assert parent is not None and parent[0].split(".")[0] in allowed, (
            sp, parent)
    levels = {}
    for name in names:
        m = re.fullmatch(r"(\w+)\.L(\d+)", name)
        if m:
            levels.setdefault(m.group(1), []).append(int(m.group(2)))
    if tree:
        depth = build_tree_tables(16).depth
        for stage in ("products", "cholesky", "cholsolve", "rhs"):
            assert sorted(levels[stage]) == sorted(
                list(range(depth)) * CALLS), stage
        assert set(levels.get("shur", [])) <= set(range(depth))
    else:
        assert not levels


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_equal_with_profiler_on(case):
    """The spans change nothing the solve computes: bit for bit with the
    profiler recording and without."""
    call = _run(case)
    off = call()
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    for a, b in zip(off, on):
        assert torch.equal(a.detach(), b.detach())


def test_span_off_is_the_shared_nullcontext():
    """With nothing listening a span is one shared ``nullcontext``; a
    listener gets each stage's name, tagged with its level."""
    assert isinstance(spans.OFF, contextlib.nullcontext)
    assert spans.span("factor") is spans.OFF
    assert spans.span("products", 3) is spans.OFF
    seen = []

    @contextlib.contextmanager
    def clock(name):
        seen.append(name)
        yield

    with spans.listening(clock):
        assert spans.span("products", 3) is not spans.OFF
        with spans.span("products", 3), spans.span("factor"):
            pass
    assert seen == ["products.L3", "factor"]
    assert spans.span("products", 3) is spans.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("factor") is not spans.OFF


@pytest.mark.parametrize("shape,path,want", [
    ((256, 6, 3), "fused", 42),   # di3d-n256
    ((512, 36, 12), "plain", 30),  # quadruped-n512
])
def test_host_copies_at_the_cells_shapes(shape, path, want):
    """The closed form at the benchmark's shapes, against one counted
    solve (the count depends on the horizon and the path, not the
    batch)."""
    N, nx, nu = shape
    assert _rslqr_copies(N, path) == want
    g = torch.Generator().manual_seed(2)
    prob = (pt.double_integrator_problem(N, device="cpu", dtype=torch.float32)
            if nx == 6 else
            pt.random_problem(g, N, nx, nu, device="cpu"))
    batch = pt.batch_problems(prob, 1, g)
    spans.reset_counters()
    pt.solve_kkt(batch)
    pt.solve_pscan_kkt(batch)
    assert spans.counters() == {"solves": 2, "host_copies": want}
