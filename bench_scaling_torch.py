#!/usr/bin/env python
"""Scaling-efficiency benchmark of the port: fixed total batch, varying
rank count (the counterpart of ``bench_scaling.py``).

Each rank count runs as that many spawned ranks
(``rslqr_tpu_torch.parallel.launch.run_ranks``). With one card, every rank
shares it (gloo on the card): the efficiency then measures how ranks
time-share one H100, not scaling, as bench_scaling.py's virtual CPU mesh
measures its harness rather than a pod. The numbers mean scaling only with
a card a rank. Prints one JSON line per rank count, with the card's name
and power limit on CUDA.

Env: SCALE_DEVICES (e.g. "1,2,4,8"), SCALE_BATCH (512), SCALE_HORIZON
(256), SCALE_MODE (dp|sp), SCALE_SOLVER (rslqr|pscan: which
horizon-sharded solver the sp mode runs), SCALE_REPS (3), SCALE_CHAIN (5),
SCALE_PLATFORM (cuda, the default, or cpu for gloo ranks on the CPU).

    python3 bench_scaling_torch.py
"""

import json
import os
import sys
import time

import torch
import torch.distributed as dist


def _scale_rank(rank, world, device_type, cfg):
    """One rank: K=1 and K=``chain`` chains of the sharded solve, each
    timed from a barrier to a barrier (so the slowest rank bounds it)."""
    import rslqr_tpu_torch as pt
    from bench_torch import _chained
    from rslqr_tpu_torch.parallel import (make_mesh, solve_batch_sharded,
                                          solve_pscan_sharded,
                                          solve_seq_sharded)

    mode, solver, N, B, reps, k2 = cfg
    dev = torch.device(device_type)
    prob = pt.double_integrator_problem(N, dtype=torch.float32, device=dev)
    batch = pt.batch_problems(prob, B, torch.Generator().manual_seed(0))
    if mode == "dp":
        mesh = make_mesh((world,), ("dp",), device_type)
        kkt = lambda b: solve_batch_sharded(b, mesh).kkt_vector()
    else:
        mesh = make_mesh((1, world), ("dp", "sp"), device_type)
        fn = solve_pscan_sharded if solver == "pscan" else solve_seq_sharded
        kkt = lambda b: fn(b, mesh, "sp", "dp")
    sync = torch.cuda.synchronize if device_type == "cuda" else lambda: None

    def timed(f):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        f(batch)
        sync()
        dist.barrier()
        return time.perf_counter() - t0

    f1, f2 = _chained(kkt, 1), _chained(kkt, k2)
    f1(batch), f2(batch)  # warm-up
    return [(timed(f1), timed(f2)) for _ in range(reps)]


def main():
    from rslqr_tpu_torch.bench_kernels import device_name
    from rslqr_tpu_torch.parallel.launch import run_ranks

    counts = [int(x) for x in
              os.environ.get("SCALE_DEVICES", "1,2,4,8").split(",")]
    B = int(os.environ.get("SCALE_BATCH", "512"))
    N = int(os.environ.get("SCALE_HORIZON", "256"))
    mode = os.environ.get("SCALE_MODE", "dp")
    solver = os.environ.get("SCALE_SOLVER", "rslqr")
    reps = int(os.environ.get("SCALE_REPS", "3"))
    k1, k2 = 1, int(os.environ.get("SCALE_CHAIN", "5"))
    device_type = os.environ.get("SCALE_PLATFORM", "cuda")
    if device_type == "cuda" and not torch.cuda.is_available():
        print("bench_scaling_torch: no CUDA device (SCALE_PLATFORM=cpu runs "
              "the ranks on the CPU)", file=sys.stderr)
        return 2
    card = device_name(device_type)
    times = {}
    for d in counts:
        runs = run_ranks(_scale_rank, d, device_type,
                         args=((mode, solver, N, B, reps, k2),))[0]
        ts, fell_back = [], 0
        for t1, t2 in runs:
            # The chained mean when noise swamps the finite difference,
            # and the method says so (bench_scaling.py's rule).
            diff = (t2 - t1) / (k2 - k1)
            if diff > 0.25 * t2 / k2:
                ts.append(diff)
            else:
                ts.append(t2 / k2)
                fell_back += 1
        t = min(ts)
        times[d] = t
        eff = (times[counts[0]] / (t * d / counts[0])
               if counts[0] in times else 1.0)
        print(json.dumps({
            "metric": f"scaling_{mode}_{solver}_d{d}_n{N}_b{B}",
            "value": round(B / t, 1),
            "unit": "solves/s",
            "efficiency_vs_1dev": round(eff, 3),
            "method": ("finite_diff" if fell_back == 0
                       else f"chained_mean_{fell_back}_of_{reps}"),
            "device": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
