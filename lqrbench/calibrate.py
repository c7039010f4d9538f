"""Readings that a cell's correctness limit is set from (run on the card).

    python3 -m lqrbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--bf16-control] [--faults]

For each seed, in one process: the cell's pool at its own size, one
warm-up pass, then one call of the timed entry point on every pool batch,
each held against the f64 reference as a run holds its sampled calls
(the lower reading of each number of ``compare.py`` is the largest
over the seeds). For each control seed:
the control, the reference computed in TF32 (``reference/riccati.py``,
``precision="tf32"``) in the program's place on the same pool batches
(the upper reading is the smallest). ``--bf16-control`` also reads the
program's own lower-precision path, its bf16 factor slabs
(``factor_dtype="bfloat16"``); ``--faults`` reads each fault of ``faults.py`` planted under the
timed path. One JSON line per reading on standard output, a summary last.
"""

import argparse
import json
import sys
import time

import torch

from . import faults, generator, program
from .compare import numbers
from .run import _env, load_cell, reference_module


def _readings(spec, seed, opts_extra=None, control=False, fault=None):
    config, traffic = spec["config"], spec["traffic"]
    riccati = reference_module(config)
    pool = generator.make_pool(config, traffic, seed, "cuda:0")
    errs = []
    if control:
        for p in pool:
            ref = riccati.solve(p, "float64", block=traffic["batch"])
            errs.append(numbers(riccati.solve(p, "tf32",
                                              block=traffic["batch"]), ref))
        return errs
    opts = program.options({**traffic.get("options", {}),
                            **(opts_extra or {})})
    solve = program.entry(traffic["entry"])
    if fault:
        solve = faults.FAULTS[fault](solve)
    probs = [program.problem(p) for p in pool]
    for p in probs:
        solve(p, options=opts)
    outs = [solve(p, options=opts) for p in probs]
    torch.cuda.synchronize()
    for p, out in zip(pool, outs):
        ref = riccati.solve(p, "float64", block=traffic["batch"])
        errs.append(numbers(out, ref))
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--bf16-control", action="store_true",
                    help="also read the program with bf16 factor slabs")
    ap.add_argument("--faults", action="store_true",
                    help="also read each planted fault on the control seeds")
    args = ap.parse_args(argv)
    _env()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = load_cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    lower, upper, prog = [], [], []
    worst = lambda errs: {n: max(e[n] for e in errs) for n in errs[0]}
    least = lambda errs: {n: min(e[n] for e in errs) for n in errs[0]}
    for seed in ints(args.seeds):
        t = time.perf_counter()
        errs = _readings(spec, seed)
        lower.append(worst(errs))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": errs, "s": time.perf_counter() - t}),
              flush=True)
    for seed in ints(args.control_seeds):
        errs = _readings(spec, seed, control=True)
        upper.append(least(errs))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_tf32": errs}), flush=True)
        if args.bf16_control:
            perrs = _readings(spec, seed, {"factor_dtype": "bfloat16"})
            prog.append(least(perrs))
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "program_bf16": perrs}), flush=True)
        if args.faults:
            for name in faults.FAULTS:
                ferrs = _readings(spec, seed, fault=name)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  f"fault_{name}": ferrs}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": worst(lower) if lower else None, "lower_all": lower,
        "upper": least(upper) if upper else None, "upper_all": upper,
        "program_bf16_min": least(prog) if prog else None,
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
