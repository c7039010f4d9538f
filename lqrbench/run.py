"""Run one cell of the benchmark.

    python3 -m lqrbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its correctness limit is
``checks/<cell>.json``, its per-layer metrics are ``metrics/<name>.py``,
the solver family's stage counts ``stages/<family>.py`` and the hand
kernels' name patterns ``kernels/<kernel>.txt``. All are found by name.

The traffic is a closed loop with one client and no think time: the
client sends one batched solve (the traffic's entry point on one pool
batch, then ``torch.cuda.synchronize()``), waits for it, and sends the
next, cycling through the pool of P batches made on the device from the
seed during set-up. Set-up (process start to the first timed call: CUDA,
the program's kernel build on a cold checkout, the pool, one warm-up pass
over the pool) is ``setup_s``. The window then runs for ``--seconds``:
``solves_per_s`` is B times the calls completed over the window's
seconds, ``batch_ms_p95`` the 95th percentile of every call's time from
issue to the return of its synchronize. An end-to-end metric named
``<quantity>.<qualifier>`` reports ``<quantity>`` under a bound of its
own, in the cells that its ``workloads`` list names.

With ``--trace 1`` the run is the same, and once the window has closed
``torch.profiler`` records a fixed slice of the next ``trace_calls``
calls of the same cycle (outside the window: the profiler slows every
launch after it starts); the result carries the per-layer metrics,
``busy_s``, ``window_s`` (the slice's) and a breakdown.

Once the window has closed, a sample of the calls drawn from the seed is
held against the configuration's plain reference (``reference/riccati.py``,
f64) on the same pool batch: the numbers of ``compare.py``, each against the cell's
limit in ``checks/<cell>.json``. The last
line of standard output is the result as one JSON object.
"""

import argparse
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rslqr_tpu")
CHECK_SAMPLES = 4  # calls of the window held against the reference
CACHE = ROOT / ".lqrbench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic, check and the per-layer metrics it reports."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    shape = (traffic["loop"], traffic["clients"], traffic["think_ms"])
    if shape != ("closed", 1, 0):
        raise SystemExit(f"traffic {cell['traffic']}: the harness drives a "
                         f"closed loop of 1 client with no think time, "
                         f"not {shape}")
    reports = lambda m: name in m.get("workloads", [name])
    return {
        "cell": cell,
        "config": _json(ROOT / cfg["file"]),
        "traffic": traffic,
        "check": _json(HERE / "checks" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: dict):
    """The configuration's plain reference (its ``reference`` key, a file
    under ``lqrbench/``)."""
    return _module(HERE / config["reference"],
                   "lqrbench_reference_" + Path(config["reference"]).stem)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _module(HERE / "metrics" / f"{name}.py",
                   "lqrbench_metric_" + name.replace(".", "_")).read


def stage_counts(config: dict, traffic: dict) -> list:
    """``stages/<family>.py``'s count at the cell's shapes."""
    mod = _module(HERE / "stages" / f"{traffic['family']}.py",
                  "lqrbench_stages_" + traffic["family"])
    return mod.count(config, traffic)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, solve=None, batch: int = None) -> tuple:
    """Run the cell ``spec`` (from :func:`load_cell`) on ``device``.
    Returns ``(exit code, result dict)``. ``solve`` replaces the traffic's
    entry point (the tests plant faults through it); ``batch`` replaces
    its batch (the CPU tests run small)."""
    import torch

    from . import compare, generator, program

    config, traffic, check = spec["config"], spec["traffic"], spec["check"]
    reference = reference_module(config)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    B = batch or traffic["batch"]

    # Set-up: the device, the pool, then one warm-up pass over it (the
    # kernel build on a cold checkout happens in the first call).
    marks = [("start", t0), ("imports", time.perf_counter())]
    torch.zeros(1, device=dev)
    sync()
    marks.append(("device", time.perf_counter()))
    pool = generator.make_pool(config, traffic, seed, dev, batch=B)
    probs = [program.problem(p) for p in pool]
    opts = program.options(traffic.get("options", {}))
    solve = solve or program.entry(traffic["entry"])
    call = lambda i: solve(probs[i % len(probs)], options=opts)
    sync()
    marks.append(("pool", time.perf_counter()))
    for i in range(len(probs)):
        call(i)
        sync()
        if i == 0:
            marks.append(("first_call", time.perf_counter()))
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    log("[lqrbench] setup s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    program.reset_launch_counts()

    rng = random.Random(seed)
    samples, nsamp = [], CHECK_SAMPLES
    lat, issue = [], []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i, t3 = 0, t_start
    while t3 < t_end:
        t1 = time.perf_counter()
        out = call(i)
        t2 = time.perf_counter()
        sync()
        t3 = time.perf_counter()
        lat.append(t3 - t1)
        issue.append(t2 - t1)
        # Reservoir sample of the calls, drawn from the seed.
        if len(samples) < nsamp:
            samples.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < nsamp:
                samples[j] = (i, out)
        del out
        i += 1
    window_s = t3 - t_start
    calls = i
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = program.launch_counts()
    print(json.dumps({"launch_counts": counts, "calls": calls}), flush=True)

    summary = None
    if trace:
        # The traced slice: the next calls of the same cycle, after the
        # window, so that the profiler's cost stays out of the window.
        nslice = traffic.get("trace_calls", 4)
        with _profiler(torch, cuda) as prof:
            call(i)  # outside the spans: the profiler's start-up
            sync()
            for k in range(i + 1, i + 1 + nslice):
                with torch.profiler.record_function("lqrbench.issue"):
                    out = call(k)
                with torch.profiler.record_function("lqrbench.sync"):
                    sync()
                del out
        summary = _reduce_trace(prof, nslice)
        seen = summary["hand_seen"]
        log(f"[lqrbench] hand kernels in the trace: {seen}; expected "
            f"{traffic.get('expect_kernels', [])}")

    # The check, after the window, on the sampled calls' own outputs.
    if cuda:
        torch.cuda.empty_cache()
    limits = {k: v["limit"] for k, v in check["numbers"].items()}
    refs, worst, failed = {}, dict.fromkeys(limits, -math.inf), 0
    for idx, out in sorted(samples, key=lambda s: s[0]):
        k = idx % len(pool)
        if k not in refs:
            refs[k] = reference.solve(pool[k], "float64", block=B)
        got = compare.numbers(out, refs[k])
        failed += any(not got[n] <= lim for n, lim in limits.items())
        worst = {n: max(worst[n], got[n]) for n in limits}
    checks = {n: {"value": worst[n] if samples else math.inf,
                  "limit": lim} for n, lim in limits.items()}
    correct = bool(samples) and failed == 0

    # What the per-layer readers read.
    run = types.SimpleNamespace(
        issue_s=issue, summary=summary, window_peak=window_peak,
        stages=stage_counts(config, {**traffic, "batch": B}),
        peaks=_json(HERE / "peaks.json"))
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "solves_per_s": B * calls / window_s,
            "batch_ms_p95": 1e3 * statistics.quantiles(
                lat, n=100, method="inclusive")[94] if len(lat) > 1
            else 1e3 * lat[0],
            "setup_s": setup_s,
        }
        # ``<quantity>.<qualifier>`` is ``<quantity>`` again, held to a
        # bound of its own in the cells its ``workloads`` lists.
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}

    card = power_limit() if cuda else ""
    devinfo = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "power": card,
    }
    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics, "device": devinfo}
    if trace:
        devinfo["busy_s"] = summary["busy_us"] * 1e-6
        devinfo["window_s"] = summary["window_us"] * 1e-6
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        log(f"[lqrbench] forbidden modules loaded: {bad}")
        return 4, None
    log(f"[lqrbench] {calls} calls in {window_s:.3f} s, setup "
        f"{setup_s:.3f} s, card {card!r}, sampled calls "
        f"{sorted(s[0] for s in samples)}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def _profiler(torch, cuda):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _reduce_trace(prof, calls: int) -> dict:
    from . import trace

    fd, path = tempfile.mkstemp(suffix=".json", prefix="lqrbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.summarize(
            trace.load_chrome(path),
            trace.hand_patterns(HERE / "kernels").values(), calls)
    finally:
        os.unlink(path)


def _env() -> None:
    """Fixed cache directories inside the checkout (the program keeps its
    own kernel build in ``rslqr_tpu_torch/_build/``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    spec = load_cell(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[lqrbench] needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(1)
    rc, result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", t0)
    if rc == 0:
        print(json.dumps(result), flush=True)
    return rc
