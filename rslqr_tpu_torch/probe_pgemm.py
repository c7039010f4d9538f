"""Probe of register blocking for B5 and of the f32 FMA rate, on the card.

    python -m rslqr_tpu_torch.probe_pgemm [--rounds R] [--ptxas]

Counterpart of ``probes/probe_pgemm.py``. Prints, after the card's name:

1. the FMA peak (``ops.probe.fma_peak``) at the probe's shape (F = 512*128
   elements, reps = 4096: ~8 us of work, too short to time well) and at a
   shape that fills the card (F = 132*2048*4, four chains for each of the
   2048 threads of every SM; reps = 32768, ~1 ms at the published peak);
2. ``ops.probe.pgemm_ib`` for ib in (1, 2, 4) and t1 (warps per block) in
   (8, 16), at the probe's shape p = K = q = 36, F = 512*128: ms, TFLOP/s
   and GB/s (A and B read, C written);
3. for the same A and B, B5's ``rows_kernel`` (``ops.planes.pgemm``) and
   one ``torch.matmul`` on mat-last views ``[F, 36, 36]``.

The variants of 2 and 3 run ``--rounds`` times in turns, and a summary per
variant (median and least ms, and the ratio to ``rows_kernel``) follows.
Times are ``bench_kernels.chain_diff``: a chain ``c = f(A, c)`` (the output
is the next right-hand operand; ``x = fma_peak(x)`` for 1), graph-replayed.
``--ptxas`` first prints the ``-Xptxas -v`` report of
``csrc/probe_kernels.cu`` (registers and spills of each kernel). Needs a
card; exits with 2 without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from .bench_kernels import chain_diff
from .ops import _build, planes, probe

P1, P2 = 512, 128           # the probe's plane: F = 512 * 128
N_BLK = 36
FMA_CASES = ((P1 * P2, 4096), (132 * 2048 * 4, 32768))
PEAK_F32 = 67e12            # published H100 SXM f32 rate outside the tensor cores


def chain(f, A, B):
    """``make_run(Kc)``: ``c = f(A, c)`` Kc times from ``c = B``."""
    def make_run(Kc):
        def run():
            c = B
            for _ in range(Kc):
                c = f(A, c)
            return c
        return run
    return make_run


def fma_chain(X, reps):
    """``make_run(Kc)``: ``x = fma_peak(x, reps)`` Kc times from ``X``.
    For x in (-1, 0) the chain's fixed point x / (1 - x) lies in (-1/2, 0),
    so the values stay bounded however long the chain."""
    return chain(lambda _, x: probe.fma_peak(x, reps=reps), None, X)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_pgemm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    if args.ptxas:
        print(_build.ptxas_report(_build._PKG / "csrc" / "probe_kernels.cu"),
              flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    for F, reps in FMA_CASES:
        X = -0.5 + 0.4 * torch.rand((1, F), generator=gen, device=dev)
        t, _ = chain_diff(fma_chain(X, reps), 4, 3, dev)
        print(f"fma_peak F={F} reps={reps}: {t * 1e3:.4f} ms -> "
              f"{2 * reps * F / t / 1e12:.3f} TFLOP/s (published "
              f"{PEAK_F32 / 1e12:.0f})", flush=True)

    p = K = q = N_BLK
    F = P1 * P2
    A = torch.randn((p, K, F), generator=gen, device=dev) / N_BLK ** 0.5
    B = torch.randn((K, q, F), generator=gen, device=dev)
    ml = lambda x: x.permute(2, 0, 1).contiguous()
    flops = 2 * p * K * q * F
    traffic = 4 * F * (p * K + K * q + p * q)
    variants = [
        (f"pgemm_ib ib={ib} t1={t1}",
         lambda a, c, ib=ib, t1=t1: probe.pgemm_ib(a, c, ib=ib, t1=t1), A, B)
        for t1 in probe.T1S for ib in probe.IBS
    ] + [("rows_kernel (planes.pgemm)", planes.pgemm, A, B),
         ("torch.matmul mat-last", torch.matmul, ml(A), ml(B))]
    times = {name: [] for name, *_ in variants}
    for r in range(args.rounds):
        for name, f, a, b in variants:
            t, _ = chain_diff(chain(f, a, b), 8, 3, dev)
            times[name].append(t)
            print(f"round {r} {name} p=K=q={p} F={F}: {t * 1e3:.4f} ms -> "
                  f"{flops / t / 1e12:.3f} TFLOP/s, {traffic / t / 1e9:.0f} "
                  f"GB/s", flush=True)
    ref = statistics.median(times["rows_kernel (planes.pgemm)"])
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"summary {name}: median {med * 1e3:.4f} ms, least "
              f"{min(ts) * 1e3:.4f} ms over {len(ts)} rounds, "
              f"{med / ref:.3f}x rows_kernel", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
