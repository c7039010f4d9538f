#!/usr/bin/env python3
"""Time the port's small-block batched solve on one GPU, for comparing two
versions of the package on one card.

    python3 tools/time_solve.py [--root DIR] [--reps 20]

Imports ``rslqr_tpu_torch`` from ``DIR`` (default: the checkout this script
lies in), builds its kernels, and prints the card's name and power limit,
then one line: the median and the minimum ms per batched ``solve_kkt`` on
chip_smoke.py's small-block configuration (double integrator, N=256, B=1024
perturbed instances, f32; the kernel path), host clock around each solve
with the device synchronized. To compare two trees, unpack the other one
(``git archive``) into a git-ignored directory and run the script on both
in one machine, alternating: A, B, B, A.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, BATCH = 256, 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import rslqr_tpu_torch as pt
    from rslqr_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("time_solve: no CUDA device", file=sys.stderr)
        return 2
    if not Path(pt.__file__).resolve().is_relative_to(root):
        print(f"time_solve: imported {pt.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    prob = pt.double_integrator_problem(N, dtype=torch.float32, device="cuda")
    b = pt.batch_problems(prob, BATCH, torch.Generator().manual_seed(N))
    for _ in range(3):
        pt.solve_kkt(b)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.solve_kkt(b)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"time_solve root={root.name} N={N} B={BATCH} f32 kernel path: "
          f"median {statistics.median(times):.3f} ms/solve, min "
          f"{min(times):.3f} ms, over {args.reps} solves (build/load "
          f"{build_s:.1f} s) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
