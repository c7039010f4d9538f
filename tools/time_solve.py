#!/usr/bin/env python3
"""Time the port's batched solve (and, optionally, the mid-block plane
kernels) on one GPU, for comparing two versions of the package on one card.

    python3 tools/time_solve.py [--root DIR] [--config small|quad]
                                [--solver rslqr|pscan] [--reps 20]
                                [--kernels]

Imports ``rslqr_tpu_torch`` from ``DIR`` (default: the checkout this script
lies in), builds its kernels, and prints the card's name and power limit,
then one line: the median and the minimum ms per batched ``solve_kkt``
(``--solver pscan``: ``solve_pscan_kkt``), host clock around each solve with
the device synchronized, on one of chip_smoke.py's configurations (f32, the
kernel path):

* ``small``: double integrator, N=256, B=1024 perturbed instances;
* ``quad``: the quadruped config, ``random_problem`` nx=36, nu=12, N=512,
  B=256 perturbed instances, one batch.

``--kernels`` also prints the median ms over 10 launches
(CUDA events) of chip_smoke.py's phase-2b cases of B5 (``pgemm``, no flags)
and B9 (``schur3_update_planes``), which every tree since the mid-block
slice has. To compare two trees, unpack the other one (``git archive``)
into a git-ignored directory and run the script on both in one machine,
alternating: A, B, B, A.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

CONFIGS = {"small": (256, 6, 3, 1024), "quad": (512, 36, 12, 256)}


def kernel_times(torch, planes, reps=10):
    """``{case: median ms}`` of the phase-2b B5 and B9 cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    R = lambda *s: torch.randn(s, generator=gen, device="cuda")
    G, Bb, N = 256, 256, 512

    def med(fn, make):
        ts = []
        for _ in range(reps + 1):
            args = make()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts[1:])

    out = {}
    for p, K, q in ((36, 36, 36), (36, 12, 36), (12, 12, 12)):
        A, Bm = R(p, K, G, Bb), R(K, q, G, Bb)
        out[f"pgemm {p}x{K}.{K}x{q}"] = med(planes.pgemm, lambda: (A, Bm))
    for q, level in ((36, 0), (36, 7), (1, 0)):
        Gl = N >> (level + 1)
        FL = [R(36, 36, N, Bb), R(36, 36, N, Bb), R(12, 36, N, Bb)]
        fs = R(36, q, Gl, Bb)
        C = [R(36, q, N, Bb), R(36, q, N, Bb), R(12, q, N, Bb)]
        out[f"schur3 q={q} L{level}"] = med(
            lambda *a: planes.schur3_update_planes(*a, level=level),
            lambda: (*FL, fs, *(c.clone() for c in C)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--config", choices=sorted(CONFIGS), default="small")
    ap.add_argument("--solver", choices=("rslqr", "pscan"), default="rslqr")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import rslqr_tpu_torch as pt
    from rslqr_tpu_torch.ops import _build, planes

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
    N, nx, nu, B = CONFIGS[args.config]
    if args.config == "small":
        prob = pt.double_integrator_problem(N, dtype=torch.float32,
                                            device="cuda")
        b = pt.batch_problems(prob, B, torch.Generator().manual_seed(N))
    else:
        prob = pt.random_problem(torch.Generator().manual_seed(1), N, nx, nu,
                                 dtype=torch.float32, device="cuda")
        b = pt.batch_problems(prob, B, torch.Generator().manual_seed(0))
    solve = pt.solve_kkt if args.solver == "rslqr" else pt.solve_pscan_kkt
    for _ in range(3):
        solve(b)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(b)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"time_solve root={root.name} {args.solver} {args.config} N={N} "
          f"nx={nx} nu={nu} B={B} f32 kernel path: median "
          f"{statistics.median(times):.3f} ms/solve, min {min(times):.3f} "
          f"ms, over {args.reps} solves (build/load {build_s:.1f} s) on "
          f"{card}", flush=True)
    if args.kernels:
        for case, ms in kernel_times(torch, planes).items():
            print(f"time_solve root={root.name} kernel {case}: {ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
