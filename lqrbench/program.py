"""What the benchmark takes from the program under test, the PyTorch and
CUDA port ``rslqr_tpu_torch``: its entry points (named in each traffic
file as ``"module:function"``), its problem and options types, and its
hand-kernel launch counters. Nothing here reaches the JAX package.
"""

import importlib

PACKAGE = "rslqr_tpu_torch"
COUNTERS = ("ops.schur", "ops.planes", "ops.flat")


def entry(spec: str):
    """The callable ``"module:function"`` of the program."""
    mod, fn = spec.split(":")
    if mod.split(".")[0] != PACKAGE:
        raise ValueError(f"entry {spec!r} is not in {PACKAGE}")
    return getattr(importlib.import_module(mod), fn)


def problem(fields: dict):
    """The program's problem object holding the harness's tensors."""
    mod = importlib.import_module(f"{PACKAGE}.problem")
    return mod.LQRProblem(**fields)


def options(spec: dict):
    mod = importlib.import_module(f"{PACKAGE}.config")
    return mod.SolveOptions(**spec)


def _counters():
    return [importlib.import_module(f"{PACKAGE}.{m}") for m in COUNTERS]


def reset_launch_counts() -> None:
    for mod in _counters():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    """Hand-kernel launches by wrapper since the last reset, non-zero
    only."""
    out = {}
    for mod in _counters():
        out.update({k: v for k, v in mod.launch_counts().items() if v})
    return out
