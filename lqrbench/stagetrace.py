"""The program's own stages in the traced slice.

The port brackets each stage of a solve with ``torch.profiler.record_function``
while the profiler records (``rslqr_tpu_torch/spans.py``): ``user_annotation``
ranges named ``rslqr_tpu_torch.<stage>`` (``solve``; its children
``factor``, ``sweep``, ``pack``; their stages; ``h2d`` around each host
array copied to the card), on the microsecond clock of the device
operations. Each device operation carries ``args.correlation``, as does
the host event that launched it (category ``cuda_runtime``, or
``cuda_driver`` for launches through the driver API), so an operation's
launch time puts it in the stage the host was in.

:func:`summarize` reduces a trace loaded by :func:`load`, over the window
that ``trace.summarize`` takes (the first harness span's start to the
last one's end), to:

* ``host_us``: host µs inside the program's spans, by stage name;
* ``device_us``: device µs (summed durations, as ``trace.summarize``'s
  ``hand_us`` and ``glue_us``) of the operations launched inside each
  child of ``solve``, with ``solve`` for what it launches outside its
  children and ``outside`` for launches outside any ``solve``;
* ``stage_device_us``: the same by the innermost program span around the
  launch;
* ``idle_gaps``: the ten longest idle gaps of the device, each named by the
  innermost span, the harness's or the program's, the host was in at its
  middle.

The per-layer readers reach the slice through :func:`of_run`: ``run.py``
hands them its reduction, not the trace, and a profiler exports its trace
once, so this module reads the run's profiler, still alive in the run,
through its own event list (:func:`from_profiler`: the same events and
correlations), keeps the result for the other readers and prints it on
standard error. Against a program without the spans every reader finds
nothing and returns ``None``.
"""

import gc
import json
import sys

from . import trace

PREFIX = "rslqr_tpu_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CHILDREN = ("factor", "sweep", "pack")

_kept = [None, None]  # the run last read, and its summary


def load(path) -> dict:
    """``trace.load_chrome``'s harness spans and device operations, with
    each operation's ``correlation`` (``ops``: ``(name, start, end,
    correlation)``), the launch times by correlation (``launches``) and
    the program's spans (``program``: ``(stage, start, end)``, by start)."""
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, launches, spans, program = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        end = start + float(e["dur"])
        name, cat = e.get("name", ""), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS:
            ops.append((name, start, end, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = start
        elif cat == trace.SPAN_CAT and name.startswith(trace.SPAN_PREFIX):
            spans.append((name, start, end))
        elif cat == trace.SPAN_CAT and name.startswith(PREFIX):
            program.append((name[len(PREFIX):], start, end))
    order = lambda x: (x[1], -x[2])
    return {"ops": sorted(ops, key=order), "launches": launches,
            "spans": sorted(spans, key=order),
            "program": sorted(program, key=order)}


def from_profiler(prof) -> dict:
    """:func:`load`'s lists from a stopped ``torch.profiler.profile``'s own
    events (``kineto_results.events()``, which stay readable after the
    export): host events of the CUDA runtime and driver APIs (``cuda*``,
    ``cu*``) are the launches, device events the operations but the
    device copies of the spans, both with the launch's correlation."""
    launches, ops, spans, program = {}, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = 1e-3 * e.start_ns()
        end = start + 1e-3 * e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            if name.startswith(trace.SPAN_PREFIX):
                spans.append((name, start, end))
            elif name.startswith(PREFIX):
                program.append((name[len(PREFIX):], start, end))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = start
        elif not name.startswith((PREFIX, trace.SPAN_PREFIX)):
            ops.append((name, start, end, e.correlation_id()))
    order = lambda x: (x[1], -x[2])
    return {"ops": sorted(ops, key=order), "launches": launches,
            "spans": sorted(spans, key=order),
            "program": sorted(program, key=order)}


def stacks(spans, times) -> list:
    """For each time of ``times``, the names of the spans open at it,
    outermost first (the spans of one host thread nest)."""
    marks = []
    for i, (_, s, e) in enumerate(spans):
        marks.append((s, 0, i))
        marks.append((e, 2, i))
    for j, t in enumerate(times):
        marks.append((t, 1, j))
    marks.sort()
    out, open_ = [None] * len(times), []
    for _, kind, k in marks:
        if kind == 0:
            open_.append(k)
        elif kind == 2:
            open_.remove(k)
        else:
            out[k] = tuple(spans[i][0] for i in open_)
    return out


def _child(stack) -> str:
    """The child of ``solve`` (or ``solve`` itself, or ``outside``) that a
    stack of open spans puts a launch in."""
    names = [n[len(PREFIX):] for n in stack if n.startswith(PREFIX)]
    if "solve" not in names:
        return "outside"
    i = names.index("solve")
    if i + 1 < len(names) and names[i + 1] in CHILDREN:
        return names[i + 1]
    return "solve"


def summarize(tr: dict, calls: int) -> dict:
    """The program's stages in the window of ``tr`` (from :func:`load`);
    ``calls``: the traced calls, for the readers' per-call numbers."""
    if not tr["spans"]:
        raise ValueError("the trace holds no harness span")
    w0 = tr["spans"][0][1]
    w1 = max(e for _, _, e in tr["spans"])
    program = [p for p in tr["program"] if p[1] >= w0 and p[2] <= w1]
    host_us = {}
    for name, s, e in program:
        host_us[name] = host_us.get(name, 0.0) + (e - s)
    ops = [o for o in tr["ops"] if o[2] > w0 and o[1] < w1]
    both = sorted(tr["spans"] + [(PREFIX + n, s, e) for n, s, e in program],
                  key=lambda x: (x[1], -x[2]))
    launch = [tr["launches"].get(o[3]) for o in ops]
    at = stacks(both, [t for t in launch if t is not None])
    device_us, stage_us = {}, {}
    it = iter(at)
    for (_, s, e, _), t in zip(ops, launch):
        stack = next(it) if t is not None else ()
        child = _child(stack)
        device_us[child] = device_us.get(child, 0.0) + (e - s)
        inner = [n for n in stack if n.startswith(PREFIX)]
        stage = inner[-1][len(PREFIX):] if inner else "outside"
        stage_us[stage] = stage_us.get(stage, 0.0) + (e - s)
    busy = trace.merged((o[0], o[1], o[2]) for o in ops)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:10]
    names = stacks(both, [0.5 * (a + b) for a, b in gaps])
    return {
        "calls": calls,
        "issue_us": sum(e - s for n, s, e in tr["spans"]
                        if n == trace.SPAN_PREFIX + "issue"),
        "spans": len(program),
        "host_us": host_us,
        "device_us": device_us,
        "stage_device_us": stage_us,
        "ops_us": sum(o[2] - o[1] for o in ops),
        "idle_gaps": [[(n[-1] if n else "outside"), (b - a) * 1e-6]
                      for n, (a, b) in zip(names, gaps)],
    }


def _profiler():
    """The run's profiler: ``run_cell`` holds it until it returns, and the
    readers run inside it (the profilers of runs that have returned are
    collected first)."""
    from torch.profiler import profile

    gc.collect()
    # By type alone: ``isinstance`` would ask each object its
    # ``__class__``, which some lazy and deprecated objects answer in code.
    found = [o for o in gc.get_objects() if issubclass(type(o), profile)]
    return found[-1] if found else None


def of_run(run):
    """:func:`summarize` of the run's traced slice, or ``None`` without
    one or without the program's spans in it."""
    if run.summary is None:
        return None
    if _kept[0] is not run:
        prof = _profiler()
        s = (None if prof is None
             else summarize(from_profiler(prof), run.summary["calls"]))
        if s is not None:
            print("[lqrbench] program stages: " + json.dumps(s),
                  file=sys.stderr, flush=True)
            if "solve" not in s["host_us"]:
                s = None
        _kept[:] = [run, s]
    return _kept[1]


def host_ms(run, stage: str):
    """Host ms per traced call inside ``stage``'s spans (0 where the
    program opened none), or ``None``."""
    s = of_run(run)
    if s is None:
        return None
    return 1e-3 * s["host_us"].get(stage, 0.0) / s["calls"]


def device_ms(run, child: str):
    """Device ms per traced call of the operations launched inside
    ``child`` of ``solve``, or ``None`` (also where no device operation
    was traced: a CPU run)."""
    s = of_run(run)
    if s is None or not s["ops_us"]:
        return None
    return 1e-3 * s["device_us"].get(child, 0.0) / s["calls"]
