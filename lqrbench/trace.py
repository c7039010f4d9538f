"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read.

The profiler's Chrome trace (``export_chrome_trace``) carries every
device operation (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``)
and every host span the harness opened with ``record_function``
(category ``user_annotation``), all on one microsecond clock. From them:
the device operations of the traced slice, the union of their intervals
(the device's busy time; a sum of durations would count overlaps twice),
the idle gaps between them, each named by the innermost harness span the
host was in at the gap's middle, and the traced window itself (the first
harness span's start to the last one's end).
"""

import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"
SPAN_PREFIX = "lqrbench."


def load_chrome(path) -> dict:
    """``{"ops": [(name, start_us, end_us)], "spans": [...]}`` of the
    trace at ``path``, each list sorted by start."""
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        item = (e.get("name", ""), start, start + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            ops.append(item)
        elif (e.get("cat") == SPAN_CAT
              and item[0].startswith(SPAN_PREFIX)):
            spans.append(item)
    return {"ops": sorted(ops, key=lambda x: x[1]),
            "spans": sorted(spans, key=lambda x: x[1])}


def merged(ops) -> list:
    """The union of the operations' intervals, as sorted disjoint
    ``[start, end]`` pairs."""
    out = []
    for _, s, e in sorted(ops, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(spans, t: float) -> str:
    """The name of the shortest harness span that covers time ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "outside"


def summarize(trace: dict, hand_patterns, calls: int) -> dict:
    """The slice's numbers: ``window_us``, ``busy_us``, ``ops`` (count),
    ``hand_us`` and ``glue_us`` (summed durations), ``calls``, the hand
    kernels seen, the ten device operations that took most time and the
    ten longest idle gaps, in seconds."""
    spans, ops = trace["spans"], trace["ops"]
    if not spans:
        raise ValueError("the trace holds no harness span")
    w0, w1 = spans[0][1], max(e for _, _, e in spans)
    ops = [o for o in ops if o[2] > w0 and o[1] < w1]
    pats = [re.compile(p) for p in hand_patterns]
    hand = lambda name: any(p.search(name) for p in pats)
    busy = merged(ops)
    busy_us = sum(min(e, w1) - max(s, w0) for s, e in busy)
    by_name = {}
    hand_us = glue_us = 0.0
    seen = set()
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if hand(name):
            hand_us += e - s
            seen.add(name)
        else:
            glue_us += e - s
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "calls": calls,
        "window_us": w1 - w0,
        "busy_us": busy_us,
        "ops": len(ops),
        "hand_us": hand_us,
        "glue_us": glue_us,
        "hand_seen": sorted(seen),
        "device_ops": [[n, d * 1e-6] for n, d in top_ops],
        "idle_gaps": [[innermost(spans, 0.5 * (a + b)), (b - a) * 1e-6]
                      for a, b in gaps[:10]],
    }


def hand_patterns(kernel_dir: Path) -> dict:
    """``{kernel: regex}`` from ``kernels/<kernel>.txt`` (first line)."""
    return {p.stem: p.read_text().strip().splitlines()[0]
            for p in sorted(kernel_dir.glob("*.txt"))}
