#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rslqr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device: the card's name and power limit (nvidia-smi), then the kernel
   build from ``rslqr_tpu_torch/csrc/*.cu`` (one nvcc per source, in
   parallel, timed), and beside it a ``-Xptxas -v`` compile of the two
   small-block sources: the registers, stack and spills of every
   instantiation of the fused leaf kernel (B3 and B11,
   ``csrc/leaf_rows.cuh``);
2. each of the four small-block sweep kernels (B1-B4) against its plain
   PyTorch version on clones of the same random f32 inputs, at the small
   path's shapes (N=256, B=1024; B1 at N=128 and with level pairing off),
   with the median time of each over 10 launches, and for B1 and B2 one
   unmasked ``baddbmm`` on mat-last views (as B10, B12 in phase 2d); B1,
   B3 and B4 (on row groups, ``csrc/row_groups.cuh`` and
   ``csrc/leaf_rows.cuh``; B4 at levels 1, 3 and 5) also chained;
2b. each of the four mid-block plane kernels (B5 pgemm, B6 pchol, B7
   pcho_solve, B9 schur3_update_planes) the same way, at the quadruped
   path's shapes (nx=36, nu=12, N=512, B=256) and once at n=12, m=4, with
   the time of one PyTorch library call on the same inputs beside each; B5
   and B9 (``rows_kernel``), B6 and B7 also chained, kernel and library
   call (B6's and B7's library calls single only), B6 also at the level-4
   and level-8 planes, B7 at the level-0 and level-4 planes (w=36), at w=1
   and at n=12 and 16;
3. the small-block slice: ``solve_kkt`` on the BASELINE batched-MPC config
   (the double integrator, nx=6, nu=3, N=256, perturbed into B=1024
   instances, f32) and again at N=128 so that B1 launches, with launch
   counts, agreement with ``kernels="off"`` and with the f64 Riccati
   oracle, and the KKT residual; then one default-option f64 solve, where
   no kernel applies (f64 runs the plain stages: no launch, equal to
   ``kernels="off"``; so in 3b and 3c);
2c. the parallel scan's kernels the same way: every flag combination of B5
   (``pgemm`` with ``ta``/``tbt``/``Cin``/``diag``/``dconst``/``sym``/
   ``kscale``: ``flagged_kernel``) that ``solve_pscan`` calls, at its
   shapes, each also chained (CUDA-graph replays, kernel and library call),
   B5's ``schur_update_planes`` (lambda masked and not; ``rows_kernel``,
   also chained) and B8
   ``plu_solve_multi`` with each right-hand-side pattern of the path, also
   chained (its library call single only);
3b. the mid-block slice: ``solve_kkt`` on BASELINE.json's quadruped config
   (``random_problem`` nx=36, nu=12, N=512, perturbed into B=256 instances,
   f32, one batch), with launch counts, agreement with ``kernels="off"``,
   the f64 Riccati oracle on 4 instances, the relative KKT residual and
   the peak device memory;
3c. the parallel-scan slice: ``solve_pscan_kkt`` on the same quadruped
   batch (launch counts, B8's by (n, widths), peak memory, agreement with
   ``kernels="off"``, with
   the rsLQR kernel path and, with ``pscan_batched_interior``, with the
   default; f64 plain pscan vs the f64 Riccati oracle on 4 instances; the
   relative KKT residual), and on the small-block batch of phase 3 (f64 vs
   Riccati on 16 instances; f32 difference to rsLQR, reported);
2d. the three flat-plane kernels (B10 ``schur_update_level_flat`` at
   levels 1-6, and B11 ``leaf_schur_level0_flat``, also chained, B12
   ``rhs_update_level_flat`` at levels 0 and 5) the same way at the flat
   path's shapes (N=256, B=1024), each beside its em twin (B1, B3, B2 on
   the same data with group-major compacts) and, for B10 and B12, one
   unmasked ``baddbmm`` on mat-last views;
3d. the flat-plane slice: ``solve_kkt(flat_planes=True)`` on phase 3's
   N=256 batch (launch counts B11 1 / B10 6 / B12 8 and no B1-B4, agreement
   with flat ``kernels="off"`` and with phase 3's em result, the f64
   Riccati check), then mixed-precision refinement on the same batch in f64
   (``solve_refined`` with 2 iterations: B11 1 / B10 6 / B12 24;
   ``solve_refined_host`` and ``solve_refined_device`` with 3), each held
   to the f64 bar against the f64 Riccati oracle on 16 instances;
2e. the two probe kernels of ``probes/probe_pgemm.py`` the same way, at
   the probe's shapes: P1 ``pgemm_ib`` (p = K = q = 36, F = 512*128) at
   every ib (1, 2, 4) and t1 (8, 16 warps per block), each beside one
   ``torch.matmul`` on mat-last views, and P2 ``fma_peak`` at a shape that
   fills the card (F = 132*2048*4, reps = 32768) and at the probe's (F =
   512*128, reps = 4096);
2f. B1-B4 and B10-B12 the same way at the other small block sizes, (n, m)
   = (4, 2), (8, 8), (5, 4) (the generic instantiations of
   ``csrc/small_blocks.cuh``), and the wide inputs (6, 12) and (8, 64) (its
   wide tag), at the small path's shapes, B3 and B11 also chained;
3e. default-option f32 solves at those block sizes, em (N=256, and N=128
   where B1 launches) and flat schedule, with their launch counts and
   agreement with ``kernels="off"``; then a state dim past 8 under
   ``mxu_block_threshold=16`` (nx=12, nu=4, N=256, B=1024, f32), which
   takes the plane kernels (B7 and B9 launch, no small-block kernel) and
   equals ``kernels="off"``;
4. time per batched solve of both slices, kernel path and
   ``kernels="off"``; 4c the same for the parallel scan; 4d for the flat
   solve and the refined solve;
5. one batched solve of each slice (and one quadruped pscan solve, one flat
   solve and one refined solve) traced with ``torch.profiler``: device time
   by kernel (the top kernels and every hand kernel), device kernel
   launches, and the device's busy share of the solve's wall time;
6. the kernel-measurement entry points: ``bench_kernels``' six sections
   (update, leaf, rhs, sep, prod, planes) at their defaults, one JSON row
   per stage and level (chained, graph-replayed times with the card's name),
   with the launch counts of that run (set to 0 just before it); 6b
   ``probe_pgemm.main(["--rounds", "1"])``, with the probe kernels' launch
   counts of that run (wrapper calls: the eager warm-ups and the graph
   captures; replays launch without counting).

Then a JSON line with every kernel's launches, error, times and bound, and
last ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without that last line; so does a machine without CUDA. Imports no JAX.
"""

import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_MAIN, N_ODD, BATCH = 256, 128, 1024
# BASELINE.json quadruped config (bench.py:373-381): one batch on the card.
QN, QX, QU, QB = 512, 36, 12, 256
REPS = 10
QREPS = 5
# Chained device times (phases 2c, 2d): CUDA-graph replays of CHAIN_K
# back-to-back calls against one call, min over CHAIN_REPS
# (bench_kernels.chain_diff).
CHAIN_K, CHAIN_REPS = 10, 3
KERNEL_BAR = 1e-4     # max|k - p| <= 1e-4 (1 + max|p|): summation order only
SLICE_BAR = 1e-4      # vs kernels="off" (__graft_entry__.dryrun_multichip)
QUAD_SLICE_BAR = 3e-3  # two f32 solvers on the quadruped config (bench.py:322)
QUAD_RESIDUAL_BAR = 3e-2  # relative f32 KKT residual (bench.py:321)
F64_BAR = 1e-6        # f64 rsLQR vs f64 Riccati (tests/test_rslqr.py:143-148)
# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores (the kernels' FMAs).
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SCHUR_SRC = "rslqr_tpu_torch/csrc/schur_kernels.cu"
PLANES_SRC = "rslqr_tpu_torch/csrc/planes_kernels.cu"
FLAGGED_SRC = "rslqr_tpu_torch/csrc/flagged_kernels.cu"
PLU_SRC = "rslqr_tpu_torch/csrc/plu_kernels.cu"
FLAT_SRC = "rslqr_tpu_torch/csrc/flat_kernels.cu"
PROBE_SRC = "rslqr_tpu_torch/csrc/probe_kernels.cu"
# The probe's shape (probes/probe_pgemm.py:27-28): 36x36 blocks over a
# 512 x 128 plane.
PROBE_BLK, PROBE_F = 36, 512 * 128
REPLACES = {
    "schur_update_level_em": "rslqr_tpu/ops/schur_pallas.py:373",
    "rhs_update_level_em": "rslqr_tpu/ops/schur_pallas.py:303",
    "leaf_schur_level0_em": "rslqr_tpu/ops/schur_pallas.py:705",
    "schur_update_pair_em": "rslqr_tpu/ops/schur_pallas.py:601",
    "pgemm": "rslqr_tpu/ops/planes_pallas.py:185",
    "pgemm_flagged": "rslqr_tpu/ops/planes_pallas.py:185",
    "pchol": "rslqr_tpu/ops/planes_pallas.py:377",
    "pcho_solve": "rslqr_tpu/ops/planes_pallas.py:400",
    "schur3_update_planes": "rslqr_tpu/ops/planes_pallas.py:503",
    "schur_update_planes": "rslqr_tpu/ops/planes_pallas.py:270",
    "plu_solve_multi": "rslqr_tpu/ops/planes_pallas.py:425",
    "schur_update_level_flat": "rslqr_tpu/ops/schur_planes.py:338",
    "leaf_schur_level0_flat": "rslqr_tpu/ops/schur_planes.py:429",
    "rhs_update_level_flat": "rslqr_tpu/ops/schur_planes.py:518",
    "pgemm_ib": "probes/probe_pgemm.py:54",
    "fma_peak": "probes/probe_pgemm.py:83",
}
PROBES = ("pgemm_ib", "fma_peak")
SOURCES = {k: PROBE_SRC if k in PROBES else SCHUR_SRC if k.endswith("_em")
           else FLAT_SRC if k.endswith("_flat") else PLU_SRC
           if k.startswith("plu") else FLAGGED_SRC if k == "pgemm_flagged"
           else PLANES_SRC for k in REPLACES}
# B1's and B4's kernels (instantiated by schur_kernels.cu; B10's at the
# wide blocks), and B3's and B11's shared one.
SOURCES["schur_update_level_em"] = "rslqr_tpu_torch/csrc/row_groups.cuh"
SOURCES["schur_update_pair_em"] = "rslqr_tpu_torch/csrc/row_groups.cuh"
SOURCES["leaf_schur_level0_em"] = "rslqr_tpu_torch/csrc/leaf_rows.cuh"
SOURCES["leaf_schur_level0_flat"] = "rslqr_tpu_torch/csrc/leaf_rows.cuh"
# The kernels of each mid-block path (the others launch no time there).
RSLQR_MID = ("pgemm", "pchol", "pcho_solve", "schur3_update_planes")
PSCAN_MID = ("pgemm", "pgemm_flagged", "plu_solve_multi")
# The solve each kernel's JSON ``launches`` count comes from (counts set to
# 0 just before it, read just after).
LAUNCHES_FROM = {
    **{k: "rslqr N=256 B=1024" for k in (
        "rhs_update_level_em", "leaf_schur_level0_em",
        "schur_update_pair_em")},
    "schur_update_level_em": "rslqr N=128 B=1024",
    **{k: "rslqr quadruped" for k in RSLQR_MID},
    **{k: "pscan quadruped" for k in (
        "pgemm", "pgemm_flagged", "plu_solve_multi", "schur_update_planes")},
    **{k: "rslqr flat N=256 B=1024" for k in REPLACES if k.endswith("_flat")},
    **{k: "probe_pgemm --rounds 1 (on no solver path)" for k in PROBES},
}
# The kernels of each bench_kernels section (phase 6).
BENCH_KERNELS = {
    "update": ("schur_update_level_em",), "leaf": ("leaf_schur_level0_em",),
    "rhs": ("rhs_update_level_em",),
    "planes": ("pgemm", "schur_update_planes"),
}
n, m = 6, 3
nn, mn = n * n, m * n
# The block sizes of the generic small-block instantiations held against
# their plain versions (phase 2f) and solved (phase 3e): (4, 2) in the
# (4, 4) capacity, (8, 8) and (5, 4) in the (8, 8) one, and the wide inputs
# (6, 12) and (8, 64) (n <= 8 < m <= 64, the wide tag).
EXTRA_BLOCKS = ((4, 2), (8, 8), (5, 4), (6, 12), (8, 64))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def leaf_ptxas(build, report: str):
    """One line per instantiation of the fused leaf kernel in a
    ``-Xptxas -v`` report: block tag, layout, registers, stack and spills."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        if "leaf_row_kernel" not in name:
            continue
        np_, mp, ex, wide = re.search(
            r"BlkILi(\d+)ELi(\d+)ELb([01])ELb([01])E", name).groups()
        tag = (f"Blk<{np_}, {mp}{', exact' if ex == '1' else ''}"
               f"{', wide' if wide == '1' else ''}>")
        lay = "GroupMajor (B3)" if "GroupMajor" in name else (
            "ElementMajor (B11)")
        lines.append(f"phase1 ptxas leaf_row_kernel {tag} {lay}: {regs} "
                     f"registers, {stack} bytes stack, {st}/{ld} bytes spill "
                     f"stores/loads")
    return lines


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / (1.0 + ref.abs().max()))


def tensors(x):
    """Every tensor in a (nested) argument or output list."""
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in tensors(a)]
    return [] if x is None else [x]


def clone_args(args):
    """Fresh copies of a kernel's (nested) argument list."""
    return [
        [x.clone() for x in a] if isinstance(a, (list, tuple))
        else (None if a is None else a.clone())
        for a in args
    ]


def bound(in_bytes: int, ops: float):
    """Least time of the work on the card: (ms, what bounds it)."""
    t_bytes, t_ops = in_bytes / PEAK_BYTES, ops / PEAK_F32
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def lam_knots(N, level):
    """Knots of a level-``level`` update whose lambda rows calc_lambda
    keeps (k mod 2^L != 0, or k = 0), and its separator knots (k mod
    2^(L+1) = 2^L), where the solved separator is written instead."""
    half = 1 << level
    keep = sum(1 for k in range(N) if k % half or k == 0)
    return keep, N >> (level + 1)


def update_ops(nx, nu, q, N, B, level, U):
    """FLOPs of U masked slab-trio updates at one level: the x/u rows at
    every knot, the lambda rows where calc_lambda keeps them."""
    keep, _ = lam_knots(N, level)
    return 2 * nx * q * B * U * ((nx + nu) * N + nx * keep)


def update_moved(nx, nu, q, N, B, level, U):
    """Bytes (f32) U masked slab-trio updates at one level need: the x/u
    multipliers in full and the lambda multiplier where calc_lambda keeps
    the row; per trio its x/u slabs read and written, its lambda slab read
    where kept and written there and at the separator knots, and its
    solved separators once."""
    keep, nsep = lam_knots(N, level)
    G = N >> (level + 1)
    return 4 * B * ((nx + nu) * nx * N + nx * nx * keep + U * (
        2 * (nx + nu) * q * N + nx * q * (2 * keep + nsep) + nx * q * G))


def emit_moved(G2, B, S):
    """Bytes (f32) the emission of S next-level products at G2 separator
    groups needs beyond the update: A and B at those separators, the lambda
    rows after them (left unchanged by the update) of each slab, the
    products, and the first slab's separator rows written back."""
    return 4 * G2 * B * ((nn + n * m) + 2 * S * nn + nn)


def sweep_ops(N, B, level, U, emitted=0, G2=0, nx=n, nu=m):
    """FLOPs of a small-block sweep kernel at one level: U slab-trio
    updates plus the emitted products."""
    return update_ops(nx, nu, nx, N, B, level, U) \
        + 2 * (nx + nu) * nx * nx * G2 * B * emitted


class Smoke:
    def __init__(self, torch, pt, schur, planes, flat, probe, dev):
        self.torch, self.pt, self.dev = torch, pt, dev
        self.schur, self.planes, self.flat = schur, planes, flat
        self.probe = probe
        self.failures = []
        self.launches = {}
        self.gen = torch.Generator().manual_seed(0)
        self.dgen = torch.Generator(device=dev).manual_seed(0)
        self.kernel_stats = {}

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAIL: {what}", flush=True)

    # -- inputs --------------------------------------------------------
    def rand(self, *shape, scale=1.0):
        t = self.torch
        return (scale * t.randn(shape, generator=self.gen)).to(self.dev)

    def drand(self, *shape, scale=1.0):
        """Random inputs drawn on the card (the large phase-2b cases)."""
        t = self.torch
        return scale * t.randn(shape, generator=self.dgen, device=self.dev)

    def pos(self, *shape):
        t = self.torch
        return (0.5 + t.rand(shape, generator=self.gen)).to(self.dev)

    # -- timing ----------------------------------------------------------
    @staticmethod
    def time_call(fn, make_args):
        """Median ms of ``fn(*make_args())`` over REPS launches
        (``bench_kernels.launch_ms``: CUDA events around each call; inputs
        re-made, untimed, before each call since the kernels update them in
        place)."""
        from rslqr_tpu_torch.bench_kernels import launch_ms

        return launch_ms(fn, make_args, REPS)

    def chained(self, call):
        """Device ms of one ``call()`` chained (``bench_kernels.chain_ms``:
        CUDA-graph replays of CHAIN_K back-to-back calls against one, min
        over CHAIN_REPS)."""
        from rslqr_tpu_torch.bench_kernels import chain_ms

        return chain_ms(call, self.dev, CHAIN_K, CHAIN_REPS)

    def compare(self, name, case, fn, args, kwargs, ops, library=None,
                moved=None, phase="phase2", twin=None, chain=False,
                chain_library=True):
        """Kernel vs plain on clones of ``args``; record error, times and
        the bound of the first case of each kernel. ``ops``: the FLOPs the
        call does; ``library``: ``(fn, args)`` of one PyTorch call on the
        same inputs, timed beside it; ``moved``: the bytes the call needs,
        where it needs less than every input read once and every output
        written once; ``twin``: ``(fn, args, kwargs)`` of another kernel
        doing the same work, timed beside it; ``chain``: also the chained
        device times of the kernel and the library call (the single-launch
        times include the wrapper's host time while the card idles);
        ``chain_library=False``: the library call single only (the batched
        Cholesky calls go through MAGMA, whose queue setup fails once such a
        call has been captured in a CUDA graph)."""
        t = self.torch
        clones = lambda: clone_args(args)

        def flat(out):
            res = []
            for o in out:
                if isinstance(o, (list, tuple)):
                    res.extend(o)
                elif o is not None:
                    res.append(o)
            return res

        p = flat(fn(*clones(), kernels="off", **kwargs))
        k = flat(fn(*clones(), **kwargs))
        t.cuda.synchronize()
        if moved is None:
            moved = 4 * (sum(x.numel() for x in tensors(args))
                         + sum(x.numel() for x in k))
        bound_ms, bound_by = bound(moved, ops)
        ok = len(p) == len(k)
        err = 0.0
        scale = 1.0
        for a, b in zip(k, p):
            err = max(err, float((a - b).abs().max()))
            scale = max(scale, 1.0 + float(b.abs().max()))
            ok = ok and bool(t.isfinite(a).all())
        ok = ok and err <= KERNEL_BAR * scale
        self.check(ok, f"{name} {case}: kernel vs plain max_abs_err {err:.3e}"
                       f" > {KERNEL_BAR} * {scale:.3e}")
        ms = self.time_call(lambda *a: fn(*a, **kwargs), clones)
        plain_ms = self.time_call(
            lambda *a: fn(*a, kernels="off", **kwargs), clones
        )
        lib_ms = twin_ms = None
        if library is not None:
            lib_fn, lib_args = library
            lib_ms = self.time_call(lib_fn, lambda: lib_args)
        fmt = lambda x: x if x is None else f"{x:.4f}"
        extra = ""
        if twin is not None:
            tw_fn, tw_args, tw_kw = twin
            twin_ms = self.time_call(lambda *a: tw_fn(*a, **tw_kw),
                                     lambda: clone_args(tw_args))
            extra = f" em_twin_ms={twin_ms:.4f} ({tw_fn.__name__})"
        ch_ms = ch_lib = None
        if chain:
            a = clones()
            ch_ms = self.chained(lambda: fn(*a, **kwargs))
            if library is not None and chain_library:
                ch_lib = self.chained(lambda: lib_fn(*lib_args))
            extra += (f" chained_ms={ch_ms:.4f} library_chained_ms="
                      f"{fmt(ch_lib)}")
        print(f"{phase} {name} {case}: max_abs_err={err:.3e} "
              f"rel_diff={err / scale:.3e} (bar {KERNEL_BAR}) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={fmt(lib_ms)}{extra} "
              f"bound_ms={bound_ms:.4f} ({bound_by}: {moved / 1e9:.3f} GB, "
              f"{ops / 1e9:.3f} GFLOP) x_bound={ms / bound_ms:.2f}"
              + (f" chained_x_bound={ch_ms / bound_ms:.2f}" if chain else ""),
              flush=True)
        st = self.kernel_stats.setdefault(
            name, {"max_abs_err": 0.0, "case": case, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms}
        )
        if twin is not None:
            st.setdefault("em_twin_ms", twin_ms)
        if chain:
            st.setdefault("chained_ms", ch_ms)
            st.setdefault("library_chained_ms", ch_lib)
        st["max_abs_err"] = max(st["max_abs_err"], err)

    # -- phase 2 ---------------------------------------------------------
    def kernel_cases(self):
        s = self.schur
        R = self.rand
        N, B = N_MAIN, BATCH
        depth = N.bit_length() - 1
        # B3: the fused leaf at depth 8.
        self.compare(
            "leaf_schur_level0_em", f"N={N} B={B}", s.leaf_schur_level0_em,
            [R(nn, N, B), R(n * m, N, B, scale=0.2), self.pos(n, N, B),
             self.pos(m, N, B), R(N // 2, nn, B),
             [R(N // 2, nn, B, scale=0.1) for _ in range(depth - 1)],
             R(N // 4, nn, B), R(N // 4, n * m, B)],
            dict(depth=depth, n=n, m=m),
            sweep_ops(N, B, 0, depth - 1, depth - 1, N // 4), chain=True,
        )
        # B2 at levels 0, 3, 7 (the first, a middle and the top level).
        for level in (0, 3, depth - 1):
            G = N >> (level + 1)
            args = [R(nn, N, B), R(nn, N, B), R(mn, N, B), R(n, N, B),
                    R(n, N, B), R(m, N, B), R(G, n, B, scale=0.1)]
            self.compare(
                "rhs_update_level_em", f"N={N} B={B} level={level}",
                s.rhs_update_level_em, args, dict(level=level, n=n, m=m),
                update_ops(n, m, 1, N, B, level, 1),
                library=self.trio_library(
                    args[:3], [[z] for z in args[3:6]],
                    [args[6].transpose(0, 1).contiguous()], level, N, B),
                moved=update_moved(n, m, 1, N, B, level, 1),
            )
        # B4 at levels 1, 3 and 5 (the main path's three pairs; emission as
        # the main path chooses it), also chained.
        for level in (1, 3, depth - 3):
            U = depth - level - 1
            args = self.pair_args(N, B, level)
            emitted = 0 if args[-1] is None else U - 1
            G2, G3 = N >> (level + 2), N >> (level + 3)
            # Level L+1 adds per slab its separator rows (slab 0: the
            # folded Sbar) and the solved separators (Sbar for slab 0).
            self.compare(
                "schur_update_pair_em", f"N={N} B={B} level={level}",
                s.schur_update_pair_em, args,
                dict(level=level, n=n, m=m),
                sweep_ops(N, B, level, U, emitted, G3)
                + update_ops(n, m, n, N, B, level + 1, U - 1),
                moved=update_moved(n, m, n, N, B, level, U)
                + 4 * B * 2 * U * nn * G2
                + (emit_moved(G3, B, emitted) if emitted else 0),
                chain=True,
            )
        # B1 at N=128 levels 1 and 5 (level 5 is on the main path there),
        # and at N=256 level 1 (the level_pairing=False path).
        d_odd = N_ODD.bit_length() - 1
        for NN, level in ((N_ODD, 1), (N_ODD, d_odd - 2), (N_MAIN, 1)):
            U = NN.bit_length() - 1 - level - 1
            args = self.level_args(NN, B, level)
            emitted = 0 if args[-1] is None else U
            G2 = NN >> (level + 2)
            self.compare(
                "schur_update_level_em", f"N={NN} B={B} level={level}",
                s.schur_update_level_em, args,
                dict(level=level, n=n, m=m),
                sweep_ops(NN, B, level, U, emitted, G2),
                library=self.trio_library(
                    args[:3], args[3:6],
                    [f.transpose(0, 1).contiguous() for f in args[6]], level,
                    NN, B),
                moved=update_moved(n, m, n, NN, B, level, U)
                + (emit_moved(G2, B, emitted) if emitted else 0),
                chain=True,
            )

    def level_args(self, N, B, level, nx=n, nu=m, R=None):
        R = R or self.rand
        xx, ux = nx * nx, nu * nx
        depth = N.bit_length() - 1
        U = depth - level - 1
        G, G2 = N >> (level + 1), N >> (level + 2)
        emit = self.schur._level_emits(level, N) and level + 2 <= depth
        return [R(xx, N, B), R(xx, N, B), R(ux, N, B),
                [R(xx, N, B) for _ in range(U)],
                [R(xx, N, B) for _ in range(U)],
                [R(ux, N, B) for _ in range(U)],
                [R(G, xx, B, scale=0.1) for _ in range(U)],
                R(G2, xx, B) if emit else None,
                R(G2, ux, B) if emit else None]

    def pair_args(self, N, B, level, nx=n, nu=m, R=None):
        R = R or self.rand
        xx, ux = nx * nx, nu * nx
        depth = N.bit_length() - 1
        U = depth - level - 1
        G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
        emit = (self.schur._pair_emits(level, N, B, U, nx, nu)
                and level + 2 <= depth - 1)
        return [R(xx, N, B), R(xx, N, B), R(ux, N, B),
                [R(xx, N, B) for _ in range(U)],
                [R(xx, N, B) for _ in range(U)],
                [R(ux, N, B) for _ in range(U)],
                [R(G1, xx, B, scale=0.1) for _ in range(U)],
                R(G2, xx, B),
                [R(G2, xx, B, scale=0.1) for _ in range(U - 1)],
                R(G3, xx, B) if emit else None,
                R(G3, ux, B) if emit else None]

    def block_cases(self):
        """B1-B4 and B10-B12 at the block sizes of the generic
        instantiations (``csrc/small_blocks.cuh``): (4, 2) in the (4, 4)
        capacity, (8, 8) and (5, 4) in the (8, 8) one (B10's last row
        groups masked at (4, 2) and (5, 4)), at the small path's shapes
        (N=256, B=1024; B1 at N=128)."""
        s, f, R = self.schur, self.flat, self.drand
        N, B = N_MAIN, BATCH
        depth = N.bit_length() - 1
        rows = lambda G: G * B // 128
        for nx, nu in EXTRA_BLOCKS:
            xx, ux = nx * nx, nu * nx
            blk = dict(n=nx, m=nu)
            tag = f"n={nx} m={nu}"
            self.compare(
                "leaf_schur_level0_em", f"{tag} N={N} B={B}",
                s.leaf_schur_level0_em,
                [R(xx, N, B), R(ux, N, B, scale=0.2), self.pos(nx, N, B),
                 self.pos(nu, N, B), R(N // 2, xx, B),
                 [R(N // 2, xx, B, scale=0.1) for _ in range(depth - 1)],
                 R(N // 4, xx, B), R(N // 4, ux, B)],
                dict(blk, depth=depth),
                sweep_ops(N, B, 0, depth - 1, depth - 1, N // 4, nx, nu),
                phase="phase2f", chain=True,
            )
            self.compare(
                "rhs_update_level_em", f"{tag} N={N} B={B} level=0",
                s.rhs_update_level_em,
                [R(xx, N, B), R(xx, N, B), R(ux, N, B), R(nx, N, B),
                 R(nx, N, B), R(nu, N, B), R(N // 2, nx, B, scale=0.1)],
                dict(blk, level=0), update_ops(nx, nu, 1, N, B, 0, 1),
                phase="phase2f",
            )
            U = depth - 2
            args = self.pair_args(N, B, 1, nx, nu, R)
            self.compare(
                "schur_update_pair_em", f"{tag} N={N} B={B} level=1",
                s.schur_update_pair_em, args, dict(blk, level=1),
                sweep_ops(N, B, 1, U, 0 if args[-1] is None else U - 1,
                          N >> 4, nx, nu)
                + update_ops(nx, nu, nx, N, B, 2, U - 1),
                phase="phase2f",
            )
            for level in (1, N_ODD.bit_length() - 3):
                U = N_ODD.bit_length() - 1 - level - 1
                args = self.level_args(N_ODD, B, level, nx, nu, R)
                self.compare(
                    "schur_update_level_em",
                    f"{tag} N={N_ODD} B={B} level={level}",
                    s.schur_update_level_em, args, dict(blk, level=level),
                    sweep_ops(N_ODD, B, level, U,
                              0 if args[-1] is None else U,
                              N_ODD >> (level + 2), nx, nu),
                    phase="phase2f",
                )
            q, r = self.pos(nx, rows(N), 128), self.pos(nu, rows(N), 128)
            self.compare(
                "leaf_schur_level0_flat", f"{tag} N={N} B={B}",
                f.leaf_schur_level0_flat,
                [R(xx, rows(N), 128), R(ux, rows(N), 128, scale=0.2), q, r,
                 R(xx, rows(N // 2), 128),
                 [R(xx, rows(N // 2), 128, scale=0.1)
                  for _ in range(depth - 1)],
                 R(xx, rows(N // 4), 128), R(ux, rows(N // 4), 128)],
                dict(blk, depth=depth, N=N),
                sweep_ops(N, B, 0, depth - 1, depth - 1, N // 4, nx, nu),
                phase="phase2f", chain=True,
            )
            for level in (1, 3):
                U = depth - level - 1
                G, G2 = N >> (level + 1), N >> (level + 2)
                emit = f._flat_emits(level, N)
                self.compare(
                    "schur_update_level_flat",
                    f"{tag} N={N} B={B} level={level} U={U}",
                    f.schur_update_level_flat,
                    [R(xx, rows(N), 128), R(xx, rows(N), 128),
                     R(ux, rows(N), 128),
                     [R(xx, rows(N), 128) for _ in range(U)],
                     [R(xx, rows(N), 128) for _ in range(U)],
                     [R(ux, rows(N), 128) for _ in range(U)],
                     [R(xx, rows(G), 128, scale=0.1) for _ in range(U)],
                     R(xx, rows(G2), 128) if emit else None,
                     R(ux, rows(G2), 128) if emit else None],
                    dict(blk, level=level, N=N),
                    sweep_ops(N, B, level, U, U if emit else 0, G2, nx, nu),
                    phase="phase2f",
                )
            self.compare(
                "rhs_update_level_flat", f"{tag} N={N} B={B} level=0",
                f.rhs_update_level_flat,
                [R(xx, rows(N), 128), R(xx, rows(N), 128),
                 R(ux, rows(N), 128), R(nx, rows(N), 128),
                 R(nx, rows(N), 128), R(nu, rows(N), 128),
                 R(nx, rows(N // 2), 128, scale=0.1)],
                dict(blk, level=0, N=N), update_ops(nx, nu, 1, N, B, 0, 1),
                phase="phase2f",
            )

    # -- phase 2b --------------------------------------------------------
    def spd(self, d, *plane):
        """Random SPD blocks ``[d, d, *plane]`` (f32, well conditioned)."""
        t = self.torch
        M = self.drand(*plane, d, d)
        S = M @ M.transpose(-1, -2) + d * t.eye(d, device=self.dev)
        return S.movedim((-2, -1), (0, 1)).contiguous()

    @staticmethod
    def mat_last(x):
        """``[p, q, *plane] -> [F, p, q]`` contiguous (untimed layout
        change for the library calls)."""
        p, q = x.shape[:2]
        return x.reshape(p, q, -1).permute(2, 0, 1).contiguous()

    def plane_cases(self):
        """B5, B6, B7, B9 at the quadruped path's level-0 shapes (G=256
        groups of the N=512 horizon, B=256), B9 also at the top level and
        with one column, and one case each at n=12, m=4."""
        t, pl, R = self.torch, self.planes, self.drand
        ml = self.mat_last
        G, Bb = QN // 2, QB
        F = G * Bb
        for (p, K, q) in ((QX, QX, QX), (QX, QU, QX), (12, 12, 12)):
            A, Bm = R(p, K, G, Bb), R(K, q, G, Bb)
            self.compare(
                "pgemm", f"{p}x{K}.{K}x{q} G={G} B={Bb}",
                lambda a, b, **k: (pl.pgemm(a, b, **k),), [A, Bm], {},
                2 * p * K * q * F, (t.matmul, (ml(A), ml(Bm))), chain=True,
            )
        # B6 at the quadruped rsLQR's level-0 plane (G=256 groups), its
        # level-4 and level-8 planes (G=16 and 1), and n=12.
        for d, Gs in ((QX, G), (QX, G >> 4), (QX, G >> 8), (12, G)):
            S = self.spd(d, Gs, Bb)
            Fs = Gs * Bb
            self.compare(
                "pchol", f"n={d} G={Gs} B={Bb}",
                lambda a, **k: (pl.pchol(a, **k),), [S], {},
                Fs * sum(2 * j * (d - j) + (d - j) for j in range(d)),
                (t.linalg.cholesky_ex, (ml(S),)),
                # A's lower triangle read, L (zeros included) written.
                moved=4 * Fs * (d * (d + 1) // 2 + d * d), chain=True,
                chain_library=False,
            )
        # B7 at the quadruped rsLQR's shapes: the separator solves at level
        # 0 (G=256 groups) and level 4 (G=16), w=36, and the RHS sweep's
        # w=1; then n=12 and, under a raised threshold (C6), n=16.
        for d, w, Gs in ((QX, QX, G), (QX, QX, G >> 4), (QX, 1, G),
                         (12, 12, G), (16, 16, G)):
            Lc = pl.pchol_plain(self.spd(d, Gs, Bb))
            X = R(d, w, Gs, Bb)
            Fs = Gs * Bb
            self.compare(
                "pcho_solve", f"n={d} w={w} G={Gs} B={Bb}",
                lambda a, b, **k: (pl.pcho_solve(a, b, **k),), [Lc, X], {},
                2 * d * d * w * Fs, (t.cholesky_solve, (ml(X), ml(Lc))),
                # L's lower triangle read, the right-hand side read and
                # written.
                moved=4 * Fs * (d * (d + 1) // 2 + 2 * d * w), chain=True,
                chain_library=False,
            )
        depth = QN.bit_length() - 1
        for nx, nu, q, level in ((QX, QU, QX, 0), (QX, QU, QX, depth - 2),
                                 (QX, QU, 1, 0), (12, 4, 12, 0)):
            self.compare(
                "schur3_update_planes",
                f"n={nx} m={nu} q={q} N={QN} B={Bb} level={level}",
                pl.schur3_update_planes, *self.schur3_case(nx, nu, q, level),
                chain=True,
            )

    def schur3_case(self, nx, nu, q, level):
        """Arguments, kwargs, FLOPs and the library call (one unmasked
        ``baddbmm`` over the stacked lambda/x/u rows, with the separators
        broadcast per knot) of one B9 case at N=QN, B=QB."""
        t, R = self.torch, self.drand
        N, Bb = QN, QB
        G = N >> (level + 1)
        span = N // G
        FL = [R(nx, nx, N, Bb), R(nx, nx, N, Bb), R(nu, nx, N, Bb)]
        fsol = R(nx, q, G, Bb, scale=0.1)
        C = [R(nx, q, N, Bb), R(nx, q, N, Bb), R(nu, q, N, Bb)]
        k = t.arange(N)
        keep = int((((k % (1 << level)) != 0) | (k == 0)).sum())
        ops = 2 * (nx + nu) * nx * q * N * Bb + 2 * nx * nx * q * keep * Bb
        # Bytes the update needs: the x/u slabs and their multipliers in
        # full, the solved separators once, the lambda multiplier and slab
        # read only at knots where calc_lambda holds, the lambda slab
        # written there and at the separator knots (N / 2^(L+1) of them).
        nsep = N >> (level + 1)
        moved = 4 * Bb * (
            (nx + nu) * nx * N + 2 * (nx + nu) * q * N + nx * q * G
            + nx * nx * keep + nx * q * (2 * keep + nsep))
        rows = 2 * nx + nu
        FLml = t.cat(FL).reshape(rows, nx, -1).permute(2, 0, 1).contiguous()
        Cml = t.cat(C).reshape(rows, q, -1).permute(2, 0, 1).contiguous()
        fsml = fsol.permute(2, 3, 0, 1)[:, None].expand(
            G, span, Bb, nx, q).reshape(N * Bb, nx, q)
        lib = (lambda c, a, b: t.baddbmm(c, a, b, alpha=-1.0),
               (Cml, FLml, fsml))
        return [*FL, fsol, *C], dict(level=level), ops, lib, moved

    # -- phase 2c --------------------------------------------------------
    def scan_cases(self):
        """B5's flags, schur_update_planes and B8 at the shapes of the
        quadruped pscan solve: C=16 chunks x B=256 planes (F=4096) for the
        serial fold and down-sweep, 8 x 256 for the first level of the
        suffix tree over the composites, 511 x 256 for the batched interior
        gains pass's Quu."""
        t, pl, R = self.torch, self.planes, self.drand
        ml = self.mat_last
        Bb, C = QB, QN // 32
        X, U = QX, QU
        fold, tree, tree2, full = (C, Bb), (C // 2, Bb), (C // 2 - 1, Bb), (
            QN - 1, Bb)
        # (label, p, K, q, plane, flags) from pscan.py's call sites.
        cases = [
            ("Sm", U, X, U, fold, dict(dconst=1.0)),
            ("Vt", U, X, X, fold, dict(tbt=True)),
            ("C_leaf", X, U, X, fold, dict(cin=True, sub=False, sym=True)),
            ("J_leaf", X, X, X, fold, dict(ta=True, diag=True, sym=True)),
            ("J_pair", X, X, X, fold, dict(ta=True, ks=True, diag=True,
                                           sym=True)),
            ("IC", X, X, X, tree, dict(dconst=1.0)),
            ("C_comb", X, X, X, tree, dict(tbt=True, cin=True, sub=False,
                                           sym=True)),
            ("J_comb", X, X, X, tree, dict(cin=True, sub=False, sym=True)),
            ("Quu", U, X, U, full, dict(diag=True, sym=True)),
        ]
        for label, p, K, q, plane, fl in cases:
            F = plane[0] * plane[1]
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
            # Each input read once (Cin's lower triangle under sym), the
            # output written once; sym does the lower triangle's FLOPs.
            cols = p * (p + 1) // 2 if sym else p * q
            moved = 4 * F * (p * K + K * q + p * q
                             + (0 if cin is None else cols)
                             + (0 if diag is None else p)
                             + (0 if ks is None else K))
            ops = 2 * K * cols * F
            a_ml = ml(A).transpose(1, 2) if ta else ml(A)
            b_ml = ml(Bm).transpose(1, 2) if tbt else ml(Bm)
            lib = ((lambda c, a, b: t.baddbmm(c, a, b), (ml(cin), a_ml, b_ml))
                   if cin is not None else (t.matmul, (a_ml, b_ml)))
            flags = "+".join(k for k in fl if k != "sub") + (
                "(add)" if fl.get("sub") is False else "")
            self.compare(
                "pgemm_flagged",
                f"{label} {p}x{K}.{K}x{q} {flags} plane={plane}",
                lambda a, b, c, d, s, **k: (pl.pgemm(a, b, c, d, s, **k),),
                [A, Bm, cin, diag, ks], kw, ops, lib, moved, phase="phase2c",
                chain=True,
            )
        for lam in (True, False):
            self.compare(
                "schur_update_planes",
                f"n={X} q={X} N={QN} B={Bb} level=0 lam={lam}",
                lambda *a, **k: (pl.schur_update_planes(*a, **k),),
                *self.schur1_case(lam), phase="phase2c", chain=True,
            )
        # B8: the Woodbury solve (m=12, identity right-hand side) of every
        # fold / down-sweep step, and the suffix tree's I + C J solves.
        for n, ws, plane in ((U, (U,), fold), (X, (X, 1, X, 1), tree),
                             (X, (X, 1), tree2)):
            F = plane[0] * plane[1]
            M = self.drand(*plane, n, n, scale=n ** -0.5)
            P = self.drand(*plane, n, n, scale=n ** -0.5)
            IC = t.eye(n, device=self.dev) + (M @ M.transpose(-1, -2)) @ (
                P @ P.transpose(-1, -2))
            A = IC.movedim((-2, -1), (0, 1)).contiguous()
            Bs = [R(n, w, *plane) for w in ws]
            wt = sum(ws)
            Aml = ml(A)
            Bml = t.cat([ml(b) for b in Bs], dim=2)

            def lu_lib(a, b):
                LU, piv, _ = t.linalg.lu_factor_ex(a)
                return t.linalg.lu_solve(LU, piv, b)

            self.compare(
                "plu_solve_multi", f"n={n} w={ws} plane={plane}",
                lambda a, bs, **k: pl.plu_solve_multi(a, *bs, **k),
                [A, Bs], {}, F * (2 * n ** 3 / 3 + 2 * n * n * wt),
                (lu_lib, (Aml, Bml)), 4 * F * (n * n + 2 * n * wt),
                phase="phase2c", chain=True, chain_library=False,
            )

    def schur1_case(self, lam):
        """Arguments, kwargs, FLOPs, library call and bytes of one
        ``schur_update_planes`` case (n=q=36, N=QN, B=QB, level 0)."""
        t, R = self.torch, self.drand
        n, N, Bb, level = QX, QN, QB, 0
        G = N >> (level + 1)
        FL, fsol, Fin = R(n, n, N, Bb), R(n, n, G, Bb, scale=0.1), R(
            n, n, N, Bb)
        keep, nsep = lam_knots(N, level) if lam else (N, 0)
        ops = 2 * n * n * n * keep * Bb
        # Masked like B9's lambda slab: FL and Fin read where calc_lambda
        # keeps the row, Fin written there and at the separator knots.
        moved = 4 * Bb * (n * n * keep + n * n * G
                          + n * n * (2 * keep + nsep))
        fsml = fsol.permute(2, 3, 0, 1)[:, None].expand(
            G, N // G, Bb, n, n).reshape(N * Bb, n, n)
        lib = (lambda c, a, b: t.baddbmm(c, a, b, alpha=-1.0),
               (self.mat_last(Fin), self.mat_last(FL), fsml))
        return [FL, fsol, Fin], dict(level=level, lam=lam), ops, lib, moved

    # -- phase 2d --------------------------------------------------------
    def flat_cases(self):
        """B10-B12 at the flat path's shapes (N=256, B=1024 as [e, N*B/128,
        128] planes): B11 at depth 8, B10 at levels 1-6 (level 1 emitting,
        U=6; then U=5..1, not), B12 at levels 0 and 5. Each beside its em
        twin on the same data (B3, B1 without emission at levels 2-6, B2),
        and B10/B12 beside one unmasked ``baddbmm`` over all their slab
        rows; B10 also chained, kernel and ``baddbmm``."""
        t, f, s = self.torch, self.flat, self.schur
        R = self.drand
        N, B = N_MAIN, BATCH
        depth = N.bit_length() - 1
        rows = lambda G: G * B // 128
        em = lambda x: x.view(x.shape[0], N, B)
        gm = lambda x, G: x.view(x.shape[0], G, B).transpose(0, 1).contiguous()
        pos = lambda e: 0.5 + t.rand((e, rows(N), 128), generator=self.dgen,
                                     device=self.dev)

        A, Bm = R(nn, rows(N), 128), R(n * m, rows(N), 128, scale=0.2)
        q, r, S0 = pos(n), pos(m), R(nn, rows(N // 2), 128)
        fs = [R(nn, rows(N // 2), 128, scale=0.1) for _ in range(depth - 1)]
        As, Bs = R(nn, rows(N // 4), 128), R(n * m, rows(N // 4), 128)
        kw = dict(depth=depth, n=n, m=m)
        self.compare(
            "leaf_schur_level0_flat", f"N={N} B={B}", f.leaf_schur_level0_flat,
            [A, Bm, q, r, S0, fs, As, Bs], dict(kw, N=N),
            sweep_ops(N, B, 0, depth - 1, depth - 1, N // 4), phase="phase2d",
            chain=True, twin=(s.leaf_schur_level0_em,
                  [em(A), em(Bm), em(q), em(r), gm(S0, N // 2),
                   [gm(x, N // 2) for x in fs], gm(As, N // 4),
                   gm(Bs, N // 4)], kw),
        )
        del A, Bm, q, r, S0, fs, As, Bs
        for level in range(1, depth - 1):
            U = depth - level - 1
            G, G2 = N >> (level + 1), N >> (level + 2)
            emit = f._flat_emits(level, N)
            FL = [R(nn, rows(N), 128), R(nn, rows(N), 128),
                  R(mn, rows(N), 128)]
            up = [[R(e, rows(N), 128) for _ in range(U)] for e in (nn, nn, mn)]
            fs = [R(nn, rows(G), 128, scale=0.1) for _ in range(U)]
            sep = [R(nn, rows(G2), 128), R(n * m, rows(G2), 128)]
            kw = dict(level=level, n=n, m=m)
            self.compare(
                "schur_update_level_flat", f"N={N} B={B} level={level} U={U}",
                f.schur_update_level_flat, [*FL, *up, fs, *sep],
                dict(kw, N=N), sweep_ops(N, B, level, U, U if emit else 0, G2),
                library=self.trio_library(FL, up, fs, level),
                moved=update_moved(n, m, n, N, B, level, U)
                + (emit_moved(G2, B, U) if emit else 0), phase="phase2d",
                chain=True,
                twin=(s.schur_update_level_em,
                      [*map(em, FL), *[[em(x) for x in u] for u in up],
                       [gm(x, G) for x in fs],
                       *([gm(sep[0], G2), gm(sep[1], G2)] if emit
                         else [None, None])], kw),
            )
            del FL, up, fs, sep
        for level in (0, depth - 3):
            G = N >> (level + 1)
            FL = [R(nn, rows(N), 128), R(nn, rows(N), 128),
                  R(mn, rows(N), 128)]
            z = [R(n, rows(N), 128), R(n, rows(N), 128), R(m, rows(N), 128)]
            zb = R(n, rows(G), 128, scale=0.1)
            kw = dict(level=level, n=n, m=m)
            self.compare(
                "rhs_update_level_flat", f"N={N} B={B} level={level}",
                f.rhs_update_level_flat, [*FL, *z, zb], dict(kw, N=N),
                update_ops(n, m, 1, N, B, level, 1),
                library=self.trio_library(FL, [[x] for x in z], [zb], level),
                moved=update_moved(n, m, 1, N, B, level, 1), phase="phase2d",
                twin=(s.rhs_update_level_em,
                      [*map(em, FL), *map(em, z), gm(zb, G)], kw),
            )

    def trio_library(self, FL, up, fs, level, N=N_MAIN, B=BATCH):
        """One unmasked ``baddbmm`` on mat-last views doing the update of
        every upper trio of ``up`` (``[[l_u], [x_u], [u_u]]`` element-major
        slabs, flat or ``[e, N, B]``, q columns each) by the level-``level``
        multipliers ``FL`` and the element-major compact separators ``fs``:
        the U trios' columns side by side,
        ``C[NB, 2n+m, qU] -= FL[NB, 2n+m, n] @ f[NB, n, qU]``."""
        t = self.torch
        span = 2 << level
        q = up[0][0].shape[0] // n
        FLml = t.cat([x.view(-1, n, N * B) for x in FL]).permute(
            2, 0, 1).contiguous()
        C = t.cat([t.cat([x.view(-1, q, N * B) for x in trio])
                   for trio in zip(*up)], dim=1)
        f = t.cat([x.view(n, q, N >> (level + 1), 1, B).expand(
            n, q, N >> (level + 1), span, B).reshape(n, q, N * B)
            for x in fs], dim=1)
        return (lambda c, a, b: t.baddbmm(c, a, b, alpha=-1.0),
                (C.permute(2, 0, 1).contiguous(), FLml,
                 f.permute(2, 0, 1).contiguous()))

    # -- phase 2e --------------------------------------------------------
    def probe_cases(self):
        """P1 at every ib and t1, beside one ``torch.matmul`` on mat-last
        views; P2 at the card-filling shape (its JSON entry), then at the
        probe's. P2's inputs lie in (-0.5, -0.1), where the chain stays
        bounded (``probe_pgemm.fma_chain``)."""
        from rslqr_tpu_torch.probe_pgemm import FMA_CASES

        t, pr, R = self.torch, self.probe, self.drand
        p = K = q = PROBE_BLK
        F = PROBE_F
        A, Bm = R(p, K, F), R(K, q, F)
        lib = (t.matmul, (self.mat_last(A), self.mat_last(Bm)))
        for t1 in pr.T1S:
            for ib in pr.IBS:
                self.compare(
                    "pgemm_ib", f"ib={ib} t1={t1} {p}x{K}.{K}x{q} F={F}",
                    lambda a, b, **k: (pr.pgemm_ib(a, b, **k),), [A, Bm],
                    dict(ib=ib, t1=t1), 2 * p * K * q * F, lib,
                    phase="phase2e",
                )
        del A, Bm, lib
        for Fx, reps in FMA_CASES[::-1]:
            X = -0.5 + 0.4 * t.rand((1, Fx), generator=self.dgen,
                                    device=self.dev)
            self.compare(
                "fma_peak", f"F={Fx} reps={reps}",
                lambda x, **k: (pr.fma_peak(x, **k),), [X], dict(reps=reps),
                2 * reps * Fx, phase="phase2e",
            )

    # -- phase 3 ---------------------------------------------------------
    def default_f64(self, label, solve, b64):
        """One default-option f64 solve (no kernel applies: the plain
        stages on the card) against ``kernels="off"``, with every wrapper's
        launches counted from 0 just before it; returns the rel diff."""
        t, pt = self.torch, self.pt
        mods = (self.schur, self.flat, self.planes)
        for mod in mods:
            mod.reset_launch_counts()
        got = solve(b64)
        t.cuda.synchronize()
        launched = {k: v for mod in mods
                    for k, v in mod.launch_counts().items() if v}
        ref = solve(b64, options=pt.SolveOptions(kernels="off"))
        d = rel_err(got, ref)
        self.check(not launched and got.dtype == t.float64
                   and bool(t.isfinite(got).all()) and d <= SLICE_BAR,
                   f"{label}: default-option f64 solve launched {launched}, "
                   f"rel diff vs off {d:.3e}")
        print(f"{label} default options f64 B={b64.x0.shape[0]}: "
              f"rel_diff_vs_off={d:.3e} (bar {SLICE_BAR}) launches "
              f"{json.dumps(launched)}", flush=True)
        return d

    def batch(self, N, dtype):
        pt = self.pt
        prob = pt.double_integrator_problem(N, dtype=dtype, device=self.dev)
        gen = self.torch.Generator().manual_seed(N)
        return pt.batch_problems(prob, BATCH, gen)

    def slice_checks(self):
        t, pt, s = self.torch, self.pt, self.schur
        off = pt.SolveOptions(kernels="off")
        batches = {N: self.batch(N, t.float32) for N in (N_MAIN, N_ODD)}
        # Each path's counts: set to 0 just before its solve, read just
        # after. B2-B4 run on the N=256 path, B1 on the N=128 one.
        out, counts = {}, {}
        for N in (N_MAIN, N_ODD):
            s.reset_launch_counts()
            out[N] = pt.solve_kkt(batches[N])
            t.cuda.synchronize()
            counts[N] = s.launch_counts()
        c_main, c_odd = counts[N_MAIN], counts[N_ODD]
        path = {"rhs_update_level_em": N_MAIN, "leaf_schur_level0_em": N_MAIN,
                "schur_update_pair_em": N_MAIN, "schur_update_level_em": N_ODD}
        for k, N in path.items():
            self.launches[k] = counts[N][k]
            self.check(counts[N][k] > 0, f"{k} not launched at N={N}")
        print(f"phase3 launches N={N_MAIN}: {json.dumps(c_main)} "
              f"N={N_ODD}: {json.dumps(c_odd)}", flush=True)

        for N in (N_MAIN, N_ODD):
            b, got = batches[N], out[N]
            nvars = b.nvars
            self.check(tuple(got.shape) == (BATCH, nvars),
                       f"N={N}: output shape {tuple(got.shape)}")
            self.check(bool(t.isfinite(got).all()), f"N={N}: non-finite")
            ref = pt.solve_kkt(b, options=off)
            d_off = rel_err(got, ref)
            self.check(d_off <= SLICE_BAR,
                       f"N={N}: kernel vs plain rel diff {d_off:.3e}")
            sub = b.map(lambda x: x[:16])
            sub64 = sub.to(dtype=t.float64)
            ric = pt.solve_riccati(sub64).kkt_vector()
            e_k = rel_err(got[:16].double(), ric)
            e_p = rel_err(ref[:16].double(), ric)
            self.check(e_k <= 2.0 * e_p + 1e-6,
                       f"N={N}: f32 kernel err vs f64 Riccati {e_k:.3e} > "
                       f"2 x plain {e_p:.3e} + 1e-6")
            f64 = pt.solve_kkt(sub64, options=off)
            e64 = float((f64 - ric).abs().max())
            bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
            self.check(e64 <= bar64,
                       f"N={N}: f64 plain vs f64 Riccati {e64:.3e} > "
                       f"{bar64:.3e}")
            self.default_f64(f"phase3 N={N}", pt.solve_kkt, sub64)
            one = b.map(lambda x: x[0])
            res = float(pt.kkt_residual(one, got[0]))
            res_off = float(pt.kkt_residual(one, ref[0]))
            self.check(res == res, f"N={N}: residual is NaN")
            print(f"phase3 slice N={N} B={BATCH} f32: "
                  f"rel_diff_vs_off={d_off:.3e} err_vs_f64_riccati="
                  f"{e_k:.3e} (plain {e_p:.3e}) f64_plain_vs_riccati="
                  f"{e64:.3e} (bar {bar64:.3e}) kkt_residual[0]={res:.4e} "
                  f"(plain {res_off:.4e}) max|x|={float(ref.abs().max()):.4e}",
                  flush=True)
            if N == N_MAIN:
                self.main_ric = ric
        self.main_batch = batches[N_MAIN]
        self.main_got = out[N_MAIN]

    # -- phase 3b --------------------------------------------------------
    def quad_checks(self):
        """The mid-block slice on the quadruped config, one batch."""
        t, pt = self.torch, self.pt
        off = pt.SolveOptions(kernels="off")
        prob = pt.random_problem(t.Generator().manual_seed(1), QN, QX, QU,
                                 dtype=t.float32, device=self.dev)
        b = pt.batch_problems(prob, QB, t.Generator().manual_seed(0))
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        self.schur.reset_launch_counts()
        self.planes.reset_launch_counts()
        got = pt.solve_kkt(b)
        t.cuda.synchronize()
        counts = self.planes.launch_counts()
        small = self.schur.launch_counts()
        peak = t.cuda.max_memory_allocated()
        for k in RSLQR_MID:
            self.launches[k] = counts[k]
            self.check(counts[k] > 0,
                       f"{k} launched no time on the quadruped path")
        print(f"phase3b launches N={QN} B={QB} nx={QX} nu={QU}: "
              f"{json.dumps(counts)} small-block kernels: "
              f"{json.dumps(small)}; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)

        self.check(tuple(got.shape) == (QB, b.nvars),
                   f"quadruped: output shape {tuple(got.shape)}")
        self.check(bool(t.isfinite(got).all()), "quadruped: non-finite")
        ref = pt.solve_kkt(b, options=off)
        d_off = rel_err(got, ref)
        self.check(d_off <= QUAD_SLICE_BAR,
                   f"quadruped: kernel vs plain rel diff {d_off:.3e}")
        sub64 = b.map(lambda x: x[:4]).to(dtype=t.float64)
        ric = pt.solve_riccati(sub64).kkt_vector()
        e_k = rel_err(got[:4].double(), ric)
        e_p = rel_err(ref[:4].double(), ric)
        self.check(e_k <= 2.0 * e_p + 1e-6,
                   f"quadruped: f32 kernel err vs f64 Riccati {e_k:.3e} > "
                   f"2 x plain {e_p:.3e} + 1e-6")
        f64 = pt.solve_kkt(sub64, options=off)
        e64 = float((f64 - ric).abs().max())
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        self.check(e64 <= bar64, f"quadruped: f64 plain vs f64 Riccati "
                                 f"{e64:.3e} > {bar64:.3e}")
        self.default_f64(f"phase3b quadruped N={QN}", pt.solve_kkt, sub64)
        res = max(float(pt.kkt_residual(b.map(lambda x: x[i]), got[i]))
                  for i in range(2))
        scale = max(float(got[:2].abs().max()), 1.0)
        self.check(res / scale <= QUAD_RESIDUAL_BAR,
                   f"quadruped: relative KKT residual {res / scale:.3e}")
        print(f"phase3b slice N={QN} B={QB} f32: rel_diff_vs_off={d_off:.3e} "
              f"(bar {QUAD_SLICE_BAR}) err_vs_f64_riccati={e_k:.3e} (plain "
              f"{e_p:.3e}) f64_plain_vs_riccati={e64:.3e} (bar {bar64:.3e}) "
              f"kkt_residual={res:.4e} rel={res / scale:.3e} (bar "
              f"{QUAD_RESIDUAL_BAR}) max|x|={scale:.4e}", flush=True)
        self.quad_batch = b
        self.quad_got, self.quad_ric, self.quad_sub64 = got, ric, sub64

    # -- phase 3c --------------------------------------------------------
    def pscan_checks(self):
        """The parallel-scan slice: ``solve_pscan_kkt`` on phase 3b's
        quadruped batch (launch counts, peak memory, agreement with
        ``kernels="off"``, with the rsLQR kernel path and with the batched
        interior recovery; f64 plain vs f64 Riccati; residual), then on the
        small-block batch of phase 3."""
        t, pt = self.torch, self.pt
        off = pt.SolveOptions(kernels="off")
        b = self.quad_batch
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        self.schur.reset_launch_counts()
        self.planes.reset_launch_counts()
        got = pt.solve_pscan_kkt(b)
        t.cuda.synchronize()
        counts = self.planes.launch_counts()
        small = self.schur.launch_counts()
        peak = t.cuda.max_memory_allocated()
        # B5 (its flags) and B8 are this path's; schur_update_planes runs
        # on no path of either package.
        for k in ("pgemm", "pgemm_flagged", "plu_solve_multi",
                  "schur_update_planes"):
            self.launches[k] = counts[k]
        for k in PSCAN_MID:
            self.check(counts[k] > 0,
                       f"{k} launched no time on the quadruped pscan path")
        shapes = {f"n={k[0]} w={k[1]}": v for k, v in
                  self.planes.plu_solve_multi.shape_launches.items()}
        print(f"phase3c launches pscan N={QN} B={QB} nx={QX} nu={QU}: "
              f"{json.dumps(counts)} small-block kernels: "
              f"{json.dumps(small)}; plu_solve_multi by (n, widths): "
              f"{json.dumps(shapes)}; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)

        self.check(tuple(got.shape) == (QB, b.nvars),
                   f"pscan quadruped: output shape {tuple(got.shape)}")
        self.check(bool(t.isfinite(got).all()), "pscan quadruped: non-finite")
        ref = pt.solve_pscan_kkt(b, options=off)
        d_off = rel_err(got, ref)
        self.check(d_off <= QUAD_SLICE_BAR,
                   f"pscan quadruped: kernel vs plain rel diff {d_off:.3e}")
        d_rs = rel_err(got, self.quad_got)
        self.check(d_rs <= QUAD_SLICE_BAR,
                   f"pscan quadruped: vs rsLQR rel diff {d_rs:.3e}")
        res = max(float(pt.kkt_residual(b.map(lambda x: x[i]), got[i]))
                  for i in range(2))
        scale = max(float(got[:2].abs().max()), 1.0)
        self.check(res / scale <= QUAD_RESIDUAL_BAR,
                   f"pscan quadruped: relative KKT residual {res / scale:.3e}")
        ric = self.quad_ric
        f64 = pt.solve_pscan_kkt(self.quad_sub64, options=off)
        e64 = float((f64 - ric).abs().max())
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        self.check(e64 <= bar64, f"pscan quadruped: f64 plain vs f64 "
                                 f"Riccati {e64:.3e} > {bar64:.3e}")
        self.default_f64(f"phase3c pscan quadruped N={QN}",
                         pt.solve_pscan_kkt, self.quad_sub64)
        self.planes.reset_launch_counts()
        bi = pt.solve_pscan_kkt(
            b, options=pt.SolveOptions(pscan_batched_interior=True))
        t.cuda.synchronize()
        c_bi = self.planes.launch_counts()
        d_bi = rel_err(bi, got)
        self.check(bool(t.isfinite(bi).all()) and d_bi <= QUAD_SLICE_BAR,
                   f"pscan quadruped: batched interior vs default rel diff "
                   f"{d_bi:.3e}")
        print(f"phase3c pscan N={QN} B={QB} f32: rel_diff_vs_off={d_off:.3e} "
              f"rel_diff_vs_rslqr={d_rs:.3e} (bar {QUAD_SLICE_BAR}) "
              f"f64_plain_vs_riccati={e64:.3e} (bar {bar64:.3e}) "
              f"kkt_residual={res:.4e} rel={res / scale:.3e} (bar "
              f"{QUAD_RESIDUAL_BAR}); batched_interior: rel_diff_vs_default="
              f"{d_bi:.3e} launches {json.dumps(c_bi)}", flush=True)

        sb = self.main_batch
        sg = pt.solve_pscan_kkt(sb)
        d_small = rel_err(sg, self.main_got)
        sub64 = sb.map(lambda x: x[:16]).to(dtype=t.float64)
        ric = pt.solve_riccati(sub64).kkt_vector()
        e64 = float((pt.solve_pscan_kkt(sub64) - ric).abs().max())
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        self.check(bool(t.isfinite(sg).all()), "pscan small: non-finite")
        self.check(e64 <= bar64, f"pscan small: f64 vs f64 Riccati "
                                 f"{e64:.3e} > {bar64:.3e}")
        print(f"phase3c pscan N={N_MAIN} B={BATCH} nx={n} nu={m} f32: "
              f"rel_diff_vs_rslqr={d_small:.3e} (reported) "
              f"f64_vs_riccati={e64:.3e} (bar {bar64:.3e})", flush=True)

    # -- phase 3d --------------------------------------------------------
    def flat_options(self, options=None):
        """``flat_planes=True`` with ``options``' kernel mode."""
        return self.pt.SolveOptions(
            flat_planes=True,
            kernels=options.kernels if options is not None else "auto")

    def flat_solve(self, b, options=None):
        """``solve_kkt`` on the flat schedule."""
        return self.pt.solve_kkt(b, options=self.flat_options(options))

    def refined_solve(self, b, options=None):
        """``solve_refined`` (2 iterations, f32 factorization) on the flat
        schedule: the f64 KKT vectors."""
        return self.pt.solve_refined(
            b, iterations=2, solve_dtype=self.torch.float32,
            options=self.flat_options(options)).kkt_vector()

    def flat_checks(self):
        """The flat-plane slice on phase 3's N=256 batch, then refinement
        of the same batch in f64 on the flat schedule."""
        t, pt, f, s = self.torch, self.pt, self.flat, self.schur
        b = self.main_batch
        depth = N_MAIN.bit_length() - 1
        expect = {"schur_update_level_flat": depth - 2,
                  "leaf_schur_level0_flat": 1, "rhs_update_level_flat": depth}

        def counted(run):
            """``run()``'s result and the flat and em kernel launches it
            made (counts set to 0 just before it)."""
            s.reset_launch_counts()
            f.reset_launch_counts()
            out = run()
            t.cuda.synchronize()
            return out, f.launch_counts(), s.launch_counts()

        got, counts, em_counts = counted(lambda: self.flat_solve(b))
        for k in expect:
            self.launches[k] = counts[k]
        self.check(counts == expect and not any(em_counts.values()),
                   f"flat: launches {counts} (want {expect}), em {em_counts}")
        print(f"phase3d launches flat N={N_MAIN} B={BATCH}: "
              f"{json.dumps(counts)} em kernels: {json.dumps(em_counts)}",
              flush=True)
        self.check(tuple(got.shape) == (BATCH, b.nvars) and bool(
            t.isfinite(got).all()), "flat: output shape or non-finite")
        ref = self.flat_solve(b, pt.SolveOptions(kernels="off"))
        d_off, d_em = rel_err(got, ref), rel_err(got, self.main_got)
        self.check(d_off <= SLICE_BAR and d_em <= SLICE_BAR,
                   f"flat: rel diff vs off {d_off:.3e}, vs em {d_em:.3e}")
        ric = self.main_ric
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        e_k = rel_err(got[:16].double(), ric)
        e_p = rel_err(ref[:16].double(), ric)
        self.check(e_k <= 2.0 * e_p + 1e-6,
                   f"flat: f32 kernel err vs f64 Riccati {e_k:.3e} > 2 x "
                   f"plain {e_p:.3e} + 1e-6")
        print(f"phase3d flat N={N_MAIN} B={BATCH} f32: rel_diff_vs_off="
              f"{d_off:.3e} rel_diff_vs_em={d_em:.3e} (bar {SLICE_BAR}) "
              f"err_vs_f64_riccati={e_k:.3e} (plain {e_p:.3e})", flush=True)

        b64 = b.to(dtype=t.float64)
        self.main_batch64 = b64
        rk, counts, em_counts = counted(lambda: self.refined_solve(b64))
        want = dict(expect, rhs_update_level_flat=3 * depth)
        self.check(counts == want and not any(em_counts.values()),
                   f"refined: launches {counts} (want {want}), em "
                   f"{em_counts}")
        e_r = float((rk[:16] - ric).abs().max())
        kh, res_h = pt.solve_refined_host(b64, iterations=3,
                                          options=self.flat_options())
        kd, res_d = pt.solve_refined_device(b64, iterations=3,
                                            options=self.flat_options())
        ric_np = ric.cpu().numpy()
        e_h = float(abs(kh[:16] - ric_np).max())
        e_d = float(abs(kd[:16] - ric_np).max())
        for what, e in (("solve_refined", e_r), ("solve_refined_host", e_h),
                        ("solve_refined_device", e_d)):
            self.check(e <= bar64, f"{what} vs f64 Riccati {e:.3e} > "
                                   f"{bar64:.3e}")
        e_f32 = float((got[:16].double() - ric).abs().max())
        print(f"phase3d refined flat N={N_MAIN} B={BATCH} f64 (f32 factor): "
              f"launches {json.dumps(counts)}; max|x - riccati| over 16: "
              f"solve_refined(2 it) {e_r:.3e}, host(3 it) {e_h:.3e} "
              f"(kkt_residual {res_h:.3e}), device(3 it) {e_d:.3e} "
              f"(kkt_residual {res_d:.3e}); bar {bar64:.3e} "
              f"(one f32 solve: {e_f32:.3e})", flush=True)

    # -- phase 3e --------------------------------------------------------
    def block_solves(self):
        """Default-option f32 solves at the generic and wide block sizes:
        the em schedule (``solve_kkt``, N=256: B2-B4 launch; N=128: B1 too)
        and the flat one (N=256: B10-B12 launch, no B1-B4), each against
        ``kernels="off"``; counts set to 0 just before each solve."""
        t, pt, s, f = self.torch, self.pt, self.schur, self.flat
        B = BATCH
        off = pt.SolveOptions(kernels="off")
        runs = ((N_MAIN, "em", None), (N_ODD, "em", None),
                (N_MAIN, "flat", pt.SolveOptions(flat_planes=True)))
        for (nx, nu), (N, label, opts) in itertools.product(EXTRA_BLOCKS,
                                                            runs):
            prob = (pt.double_integrator_problem(
                N, nx, nu, dtype=t.float32, device=self.dev) if nx == 2 * nu
                else pt.random_problem(t.Generator().manual_seed(nx), N, nx,
                                       nu, dtype=t.float32, device=self.dev))
            b = pt.batch_problems(prob, B, t.Generator().manual_seed(N + nx))
            s.reset_launch_counts()
            f.reset_launch_counts()
            got = pt.solve_kkt(b, options=opts)
            t.cuda.synchronize()
            em, fl = s.launch_counts(), f.launch_counts()
            ref_opts = off if opts is None else pt.SolveOptions(
                flat_planes=True, kernels="off")
            d = rel_err(got, pt.solve_kkt(b, options=ref_opts))
            want = (("rhs_update_level_em", "leaf_schur_level0_em",
                     "schur_update_pair_em")
                    + (("schur_update_level_em",) if N == N_ODD else ())
                    if opts is None else tuple(fl))
            ran = {**em, **fl}
            ok = (all(ran[k] > 0 for k in want) and d <= SLICE_BAR
                  and bool(t.isfinite(got).all())
                  and (opts is None or not any(em.values())))
            self.check(ok, f"n={nx} m={nu} {label}: launches {ran}, rel "
                           f"diff vs off {d:.3e}")
            print(f"phase3e {label} n={nx} m={nu} N={N} B={B} f32 "
                  f"default options: rel_diff_vs_off={d:.3e} (bar "
                  f"{SLICE_BAR}) launches {json.dumps(ran)}", flush=True)
        self.raised_threshold_solve()

    def raised_threshold_solve(self):
        """A state dim past the small-block kernels' 8 under a raised
        ``mxu_block_threshold`` (ROADMAP C6): f32, threshold 16, nx=12,
        nu=4, N=256, B=1024. It takes the planes route (B7 and B9 launch,
        no small-block or flat kernel) and equals ``kernels="off"``."""
        t, pt = self.torch, self.pt
        N, B, nx, nu = N_MAIN, BATCH, 12, 4
        opts = pt.SolveOptions(mxu_block_threshold=16)
        prob = pt.random_problem(t.Generator().manual_seed(nx), N, nx, nu,
                                 dtype=t.float32, device=self.dev)
        b = pt.batch_problems(prob, B, t.Generator().manual_seed(N + nx))
        for mod in (self.schur, self.flat, self.planes):
            mod.reset_launch_counts()
        got = pt.solve_kkt(b, options=opts)
        t.cuda.synchronize()
        planes_c = self.planes.launch_counts()
        small = {k: v for mod in (self.schur, self.flat)
                 for k, v in mod.launch_counts().items() if v}
        d = rel_err(got, pt.solve_kkt(b, options=pt.SolveOptions(
            mxu_block_threshold=16, kernels="off")))
        ok = (planes_c["pcho_solve"] > 0
              and planes_c["schur3_update_planes"] > 0 and not small
              and d <= SLICE_BAR and bool(t.isfinite(got).all()))
        self.check(ok, f"raised threshold n={nx} m={nu}: planes launches "
                       f"{planes_c}, small-block {small}, rel diff vs off "
                       f"{d:.3e}")
        print(f"phase3e raised threshold (16) n={nx} m={nu} N={N} B={B} "
              f"f32: rel_diff_vs_off={d:.3e} (bar {SLICE_BAR}) launches "
              f"{json.dumps(planes_c)} small-block {json.dumps(small)}",
              flush=True)

    # -- phase 5 ---------------------------------------------------------
    def profile(self, b, label, solve=None, top=14):
        """Device kernel time of one batched solve by kernel name
        (``torch.profiler``, CUDA activity), against its wall time."""
        t, pt = self.torch, self.pt
        from torch.profiler import ProfilerActivity, profile

        solve = solve or pt.solve_kkt
        solve(b)
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(b)
            t.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        print(f"phase5 {label}: wall {wall:.3f} ms (profiled), device "
              f"kernel time {busy:.3f} ms, busy share {busy / wall:.3f}, "
              f"{sum(e.count for e in dev)} device kernel launches",
              flush=True)
        ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
        # The top kernels, then every kernel below them that is not
        # PyTorch's own (at::native): the hand kernels.
        for e in ranked[:top] + [e for e in ranked[top:]
                                 if "at::native::" not in e.key]:
            print(f"phase5   {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:5d}x {e.key[:90]}", flush=True)

    # -- phase 6 ---------------------------------------------------------
    def bench_sections(self):
        """``bench_kernels``' six sections at their defaults: every section
        gives rows, each with the card's name and a finite positive time,
        and runs its kernels (counts set to 0 just before the run)."""
        from rslqr_tpu_torch import bench_kernels as bk

        t = self.torch
        self.schur.reset_launch_counts()
        self.planes.reset_launch_counts()
        rows = bk.run(bk.SECTIONS, self.dev)
        t.cuda.synchronize()
        counts = {**self.schur.launch_counts(),
                  **self.planes.launch_counts()}
        card = t.cuda.get_device_name(0)
        for r in rows:
            print(f"phase6 {json.dumps(r)}", flush=True)
            ms = r["ms_per_call"]
            self.check(r["device"] == card and ms == ms and 0 < ms < 1e4,
                       f"bench_kernels row {r}")
        stages = {r["stage"].split("_")[0] for r in rows}
        self.check(stages == set(bk.SECTIONS),
                   f"bench_kernels sections {sorted(stages)}")
        for section, names in BENCH_KERNELS.items():
            for k in names:
                self.check(counts[k] > 0,
                           f"bench_kernels {section}: {k} launched no time")
        print(f"phase6 launches: {json.dumps(counts)}", flush=True)

    def probe_entry(self):
        """``probe_pgemm``'s entry point with one round; the probe kernels'
        counts set to 0 just before it and read just after."""
        from rslqr_tpu_torch import probe_pgemm

        self.probe.reset_launch_counts()
        rc = probe_pgemm.main(["--rounds", "1"])
        self.torch.cuda.synchronize()
        counts = self.probe.launch_counts()
        self.check(rc == 0, f"probe_pgemm exited with {rc}")
        for k in PROBES:
            self.launches[k] = counts[k]
            self.check(counts[k] > 0, f"probe_pgemm: {k} launched no time")
        print(f"phase6b launches: {json.dumps(counts)}", flush=True)

    # -- phase 4 ---------------------------------------------------------
    def time_solves(self, card, b, reps, label, solve=None):
        """Median host-clock ms per batched solve (CUDA-synchronized), the
        kernel path and ``kernels="off"`` in turns."""
        t, pt = self.torch, self.pt
        solve = solve or pt.solve_kkt
        B = b.x0.shape[0]
        off = pt.SolveOptions(kernels="off")
        for _ in range(2 if reps >= REPS else 1):
            solve(b)
            solve(b, options=off)
        t.cuda.synchronize()
        tk, tp = [], []
        for _ in range(reps):
            for opts, acc in ((None, tk), (off, tp)):
                t.cuda.synchronize()
                t0 = time.perf_counter()
                solve(b, options=opts)
                t.cuda.synchronize()
                acc.append(1e3 * (time.perf_counter() - t0))
        mk, mp = statistics.median(tk), statistics.median(tp)
        dt = str(b.x0.dtype).removeprefix("torch.")
        print(f"{label} B={B} {dt} on {card}: kernel path "
              f"{mk:.3f} ms/solve ({B / mk * 1e3:.1f} solves/s), "
              f"kernels=off {mp:.3f} ms/solve ({B / mp * 1e3:.1f} "
              f"solves/s); median of {reps}, min {min(tk):.3f} / "
              f"{min(tp):.3f} ms", flush=True)


def main() -> int:
    try:
        import torch

        import rslqr_tpu_torch as pt
        from rslqr_tpu_torch.ops import _build, flat, planes, probe, schur
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = nvidia_smi()
    print(card, flush=True)
    small = [src for src in _build.SOURCES
             if src.name in ("schur_kernels.cu", "flat_kernels.cu")]
    with ThreadPoolExecutor(len(small)) as pool:
        reports = [pool.submit(_build.ptxas_report, src) for src in small]
        t0 = time.perf_counter()
        lib = _build.build()
        build_s = time.perf_counter() - t0
        ptxas = [line for r in reports
                 for line in leaf_ptxas(_build, r.result())]
    _build.load()
    print(f"phase1 device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} build_s={build_s:.2f} lib={lib.name}",
          flush=True)
    print("\n".join(ptxas), flush=True)

    smoke = Smoke(torch, pt, schur, planes, flat, probe, dev)
    phases = (
        ("phase2", smoke.kernel_cases),
        ("phase2b", smoke.plane_cases),
        ("phase2c", smoke.scan_cases),
        ("phase2d", smoke.flat_cases),
        ("phase2e", smoke.probe_cases),
        ("phase2f", smoke.block_cases),
        ("phase3", smoke.slice_checks),
        ("phase3b", smoke.quad_checks),
        ("phase3c", smoke.pscan_checks),
        ("phase3d", smoke.flat_checks),
        ("phase3e", smoke.block_solves),
        ("phase4", lambda: smoke.time_solves(
            card, smoke.main_batch, REPS, f"phase4 N={N_MAIN}")),
        ("phase4b", lambda: smoke.time_solves(
            card, smoke.quad_batch, QREPS,
            f"phase4b quadruped N={QN} nx={QX} nu={QU}")),
        ("phase4c", lambda: (
            smoke.time_solves(card, smoke.main_batch, QREPS,
                              f"phase4c pscan N={N_MAIN}",
                              pt.solve_pscan_kkt),
            smoke.time_solves(card, smoke.quad_batch, QREPS,
                              f"phase4c pscan quadruped N={QN} nx={QX} "
                              f"nu={QU}", pt.solve_pscan_kkt))),
        ("phase4d", lambda: (
            smoke.time_solves(card, smoke.main_batch, REPS,
                              f"phase4d flat N={N_MAIN}", smoke.flat_solve),
            smoke.time_solves(card, smoke.main_batch64, QREPS,
                              f"phase4d refined flat (2 iterations, f64) "
                              f"N={N_MAIN}", smoke.refined_solve))),
        ("phase5", lambda: (
            smoke.profile(smoke.main_batch, f"N={N_MAIN} B={BATCH}"),
            smoke.profile(smoke.quad_batch, f"quadruped N={QN} B={QB}"),
            smoke.profile(smoke.quad_batch, f"pscan quadruped N={QN} B={QB}",
                          pt.solve_pscan_kkt),
            smoke.profile(smoke.main_batch, f"flat N={N_MAIN} B={BATCH}",
                          smoke.flat_solve),
            smoke.profile(smoke.main_batch64,
                          f"refined flat (2 iterations, f64) N={N_MAIN} "
                          f"B={BATCH}", smoke.refined_solve))),
        ("phase6", smoke.bench_sections),
        ("phase6b", smoke.probe_entry),
    )
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(f"{name} seconds={time.perf_counter() - t0:.1f}", flush=True)

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed:",
              file=sys.stderr)
        for f in smoke.failures:
            print("  " + f, file=sys.stderr)
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": smoke.launches[name],
         "max_abs_err": st["max_abs_err"], "ms": st["ms"],
         "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
         "bound_by": st["bound_by"], "library_ms": st["library_ms"],
         "case": st["case"], "launches_from": LAUNCHES_FROM.get(name),
         **{k: st[k] for k in ("em_twin_ms", "chained_ms",
                               "library_chained_ms") if k in st}}
        for name, st in smoke.kernel_stats.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
