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
slice has, and of its phase-2c/2d cases of the scan's nine flagged B5
products and of B10 (``schur_update_level_flat``) at levels 1-6, each of
those also chained (CUDA-graph replays of 10 back-to-back calls against
one), beside the same timings of one PyTorch library call
(``matmul``/``baddbmm`` on mat-last views; an unmasked ``baddbmm`` over
every B10 slab row). The clock is the timed tree's
``bench_kernels.launch_ms``/``chain_ms``. To compare two trees, unpack the
other one (``git archive``) into a git-ignored directory and run the
script on both in one machine, alternating: A, B, B, A.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

CONFIGS = {"small": (256, 6, 3, 1024), "quad": (512, 36, 12, 256)}


# The quadruped scan's flagged products (chip_smoke.py phase 2c): label,
# p, K, q, plane, flags.
FLAGGED = (
    ("Sm", 12, 36, 12, (16, 256), dict(dconst=1.0)),
    ("Vt", 12, 36, 36, (16, 256), dict(tbt=True)),
    ("C_leaf", 36, 12, 36, (16, 256), dict(cin=True, sub=False, sym=True)),
    ("J_leaf", 36, 36, 36, (16, 256), dict(ta=True, diag=True, sym=True)),
    ("J_pair", 36, 36, 36, (16, 256), dict(ta=True, ks=True, diag=True,
                                           sym=True)),
    ("IC", 36, 36, 36, (8, 256), dict(dconst=1.0)),
    ("C_comb", 36, 36, 36, (8, 256), dict(tbt=True, cin=True, sub=False,
                                          sym=True)),
    ("J_comb", 36, 36, 36, (8, 256), dict(cin=True, sub=False, sym=True)),
    ("Quu", 12, 36, 12, (511, 256), dict(diag=True, sym=True)),
)


def _med(torch, fn, make, reps=10):
    """Median ms of ``fn(*make())`` over ``reps`` single launches
    (``bench_kernels.launch_ms``)."""
    from rslqr_tpu_torch.bench_kernels import launch_ms

    return launch_ms(fn, make, reps)


def _chained(torch, call):
    """Device ms of one ``call()`` chained (``bench_kernels.chain_ms``:
    CUDA-graph replays of 10 back-to-back calls against one, min over 3)."""
    from rslqr_tpu_torch.bench_kernels import chain_ms

    return chain_ms(call)


def _ml(x):
    """``[p, q, *plane] -> [F, p, q]`` contiguous (the library's layout)."""
    return x.reshape(x.shape[0], x.shape[1], -1).permute(2, 0, 1).contiguous()


def flagged_times(torch, planes, R):
    """``{case: (single ms, chained ms)}`` of the nine flagged products and
    of their library calls."""
    out = {}
    for label, p, K, q, plane, fl in FLAGGED:
        ta, tbt, sym = (fl.get(k, False) for k in ("ta", "tbt", "sym"))
        A = R(*((K, p) if ta else (p, K)), *plane)
        Bm = R(*((q, K) if tbt else (K, q)), *plane)
        cin = R(p, q, *plane) if fl.get("cin") else None
        if cin is not None and sym:
            cin = 0.5 * (cin + cin.transpose(0, 1))
        diag = R(p, *plane) if fl.get("diag") else None
        ks = R(K, *plane) if fl.get("ks") else None
        kw = dict(ta=ta, tbt=tbt, sub=fl.get("sub", True),
                  dconst=fl.get("dconst", 0.0), sym=sym)
        call = lambda: planes.pgemm(A, Bm, cin, diag, ks, **kw)
        out[f"flagged {label}"] = (_med(torch, lambda: call(), tuple),
                                   _chained(torch, call))
        a = _ml(A).transpose(1, 2) if ta else _ml(A)
        b = _ml(Bm).transpose(1, 2) if tbt else _ml(Bm)
        c = None if cin is None else _ml(cin)
        lib = ((lambda: torch.baddbmm(c, a, b)) if c is not None
               else (lambda: torch.matmul(a, b)))
        out[f"library flagged {label}"] = (_med(torch, lib, tuple),
                                           _chained(torch, lib))
    return out


def flat_level_times(torch, flat, R):
    """``{case: (single ms, chained ms)}`` of B10 at levels 1-6 (N=256,
    B=1024 flat planes; level 1 emits) and of one unmasked ``baddbmm``
    over the same slab rows."""
    n, m, N, B = 6, 3, 256, 1024
    nn, mn = n * n, m * n
    rows = lambda G: G * B // 128
    depth = N.bit_length() - 1
    out = {}
    for level in range(1, depth - 1):
        U = depth - level - 1
        G, G2 = N >> (level + 1), N >> (level + 2)
        emit = flat._flat_emits(level, N)
        FL = [R(nn, rows(N), 128), R(nn, rows(N), 128), R(mn, rows(N), 128)]
        up = [[R(e, rows(N), 128) for _ in range(U)] for e in (nn, nn, mn)]
        fs = [0.1 * R(nn, rows(G), 128) for _ in range(U)]
        sep = ([R(nn, rows(G2), 128), R(n * m, rows(G2), 128)] if emit
               else [None, None])
        kw = dict(level=level, n=n, m=m, N=N)
        fresh = lambda: ([[x.clone() for x in u] for u in up],)
        call = lambda u: flat.schur_update_level_flat(*FL, *u, fs, *sep, **kw)
        work = [[x.clone() for x in u] for u in up]
        out[f"B10 L{level} U={U}"] = (
            _med(torch, lambda u: call(u), fresh),
            _chained(torch, lambda: call(work)))
        span = 2 << level
        FLml = torch.cat([x.view(-1, n, N * B) for x in FL]).permute(
            2, 0, 1).contiguous()
        C = torch.cat([torch.cat([x.view(-1, n, N * B) for x in trio])
                       for trio in zip(*up)], dim=1).permute(2, 0, 1)
        C = C.contiguous()
        f = torch.cat([x.view(n, n, G, 1, B).expand(n, n, G, span, B).reshape(
            n, n, N * B) for x in fs], dim=1).permute(2, 0, 1).contiguous()
        lib = lambda: torch.baddbmm(C, FLml, f, alpha=-1.0)
        out[f"library B10 L{level} U={U}"] = (_med(torch, lib, tuple),
                                              _chained(torch, lib))
        del FL, up, fs, sep, work, FLml, C, f
    return out


def kernel_times(torch, planes, reps=10):
    """``{case: median ms}`` of the phase-2b B5 and B9 cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    R = lambda *s: torch.randn(s, generator=gen, device="cuda")
    G, Bb, N = 256, 256, 512
    med = lambda fn, make: _med(torch, fn, make, reps)

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
    from rslqr_tpu_torch.ops import _build, flat, planes

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
        gen = torch.Generator(device="cuda").manual_seed(1)
        R = lambda *s: torch.randn(s, generator=gen, device="cuda")
        for case, (single, chained) in {**flagged_times(torch, planes, R),
                                        **flat_level_times(torch, flat,
                                                           R)}.items():
            print(f"time_solve root={root.name} kernel {case}: single "
                  f"{single:.4f} ms, chained {chained:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
