"""The reduction of a profiler trace on a trace made by hand."""

import json

from lqrbench import trace


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "lqrbench.issue",
         "ts": 0, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "lqrbench.sync",
         "ts": 40, "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "void rows_kernel<36>(A)",
         "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "at::native::copy", "ts": 30,
         "dur": 20},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 70,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.load_chrome(path)


def test_union_gaps_and_split(tmp_path):
    s = trace.summarize(_trace(tmp_path), [r"\brows_kernel\b"], calls=1)
    assert s["window_us"] == 100
    assert s["busy_us"] == 60  # [10, 50] and [70, 90]: overlaps once
    assert s["ops"] == 3
    assert s["hand_us"] == 30 and s["glue_us"] == 40
    assert s["hand_seen"] == ["void rows_kernel<36>(A)"]
    gaps = sorted((round(d * 1e6), n) for n, d in s["idle_gaps"])
    # [0, 10] while issuing, [50, 70] and [90, 100] while synchronizing.
    assert gaps == [(10, "lqrbench.issue"), (10, "lqrbench.sync"),
                    (20, "lqrbench.sync")]
    name, secs = s["device_ops"][0]
    assert name == "void rows_kernel<36>(A)" and abs(secs - 30e-6) < 1e-12


def test_merged_intervals():
    ops = [("a", 0, 5), ("b", 3, 8), ("c", 10, 12), ("d", 11, 11.5)]
    assert trace.merged(ops) == [[0, 8], [10, 12]]
