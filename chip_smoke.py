#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rslqr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device: the card's name and power limit (nvidia-smi), then the kernel
   build from ``rslqr_tpu_torch/csrc/*.cu`` (one nvcc per source, in
   parallel, timed), with ``-Xptxas -v``, whose report gives the registers,
   stack and spills of every instantiation of the fused leaf kernel (B3 and
   B11, ``csrc/leaf_rows.cuh``), of every bf16-slab instantiation of B1-B4
   (B2's in ``schur_kernels.cu``; B1's, B3's and B4's own kernels in
   ``csrc/bf16_rows.cuh``), of B8 at every width (``csrc/plu_kernels.cu``),
   of ``rows_kernel`` and ``levels::rows_kernel`` (B5, B9), of B6's and
   B7's ``pchol_kernel`` and ``pcho_solve_kernel`` at every register width
   (W = 80 for the wide blocks 65..80; with each one's SASS instructions,
   from ``cuobjdump -sass``) and of the probe kernels (P1 at
   every ib, column tile and t1; P2);
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
   ``plu_solve_multi`` with each right-hand-side pattern of the path, and
   at n=48 and 64 (``plu_wide``: its W = 48 and 64 instantiations, the LU
   in dynamic shared memory), also chained, beside the median of 50
   single launches of ``lu_factor_ex`` + ``lu_solve`` taken in turns with
   50 of the kernel (kernel, library, library, kernel; the library call
   is not captured in a CUDA graph);
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
   ``torch.matmul`` on mat-last views, both also chained, and P2
   ``fma_peak`` at a shape that fills the card (F = 132*2048*4, reps =
   32768) and at the probe's (F = 512*128, reps = 4096);
2f. B1-B4 and B10-B12 the same way at the other small block sizes, (n, m)
   = (4, 2), (8, 8), (5, 4) (the generic instantiations of
   ``csrc/small_blocks.cuh``), and the wide inputs (6, 12) and (8, 64) (its
   wide tag), at the small path's shapes, B3 and B11 also chained;
2g. ROADMAP C8, the quadruped kernel path's f32 error: B5 (plain), B6, B7
   (w=36 and w=1) and B9 at the quadruped rsLQR's level-0 and level-4
   shapes, each in f32 as kernel and as plain version and in f64 as plain
   version on the same inputs, with each f32 result's error relative to
   the f64 one and the ratio kernel / plain, B6 and B7 also in the JAX
   kernels' order of operations in plain f32 ops in place of the kernel
   (each term subtracted in turn, as their unrolled loops do); then the
   quadruped f32 solve
   with each of the four wrappers alone run plain, and alone run as a
   kernel, each against the f64 Riccati solve of 4 instances;
2h. B9 across the upper levels (``schur3_update_levels``,
   ``levels::rows_kernel``) at the quadruped rsLQR's shapes (n=36, m=12,
   q=36, N=512, B=256), every level 0-7 with all its upper levels: bit for
   bit the per-level kernel (``schur3_update_planes``, ``rows_kernel``, once
   per upper level), within the kernel bar of the plain version, and both
   chained in turns (fused, per-level, per-level, fused) against the bound
   (2U + 1) X + R bytes at 3.35 TB/s (X one slab trio, R the U solved
   separators); then the standard comparison line at level 0;
2i. the wide blocks (65..80) at the Unitree G1 config's level-0 shapes
   (nx=70, nu=29, N=512, B=128: G=256 groups): B5 (``rows_kernel``, its
   6-column tile past 48 KB), B6 and B7 at W = 80 (also n=80, the limit),
   B9 with n columns and one, each against its plain version with its
   time, bound and library call as in 2b; then 2h at the G1's shapes
   (``levels::rows_kernel``'s 7-column tiles, every level 0-7), against
   the larger of its bytes and its FLOPs at the card's peaks;
3e. default-option f32 solves at those block sizes, em (N=256, and N=128
   where B1 launches) and flat schedule, with their launch counts and
   agreement with ``kernels="off"``; then a state dim past 8 under
   ``mxu_block_threshold=16`` (nx=12, nu=4, N=256, B=1024, f32), which
   takes the plane kernels (B7 and B9 launch, no small-block kernel) and
   equals ``kernels="off"``;
3f. the grid and large-block slice: (a) ``solve_kkt(layout="grid")`` on
   phase 3b's quadruped batch at full width and batch, with no hand-kernel
   launch (as JAX's grid path reaches no Pallas kernel), its peak device
   memory, agreement with 3b's em kernel path (3e-3 relative), the f64
   grid solve of 4 instances against the f64 Riccati oracle and the
   relative KKT residual; (b) ``factorize`` once and ``solve_rhs`` of the
   batch with ``x0 + 0.1``, ``q + 0.5``, ``r - 0.25``, against a fresh grid
   solve (bit for bit, or within 1e-6 relative); (c) the large-block route
   (``random_problem`` N=64, nx=84, nu=24, B=32, past the plane kernels'
   80): rsLQR and pscan in f64
   against the f64 Riccati oracle and in f32 against the f64 answer, and
   ``solve_refined`` (2 iterations, grid branch) against the oracle, and
   ``layout="em"`` in f32 (the element-major path on the plain plane
   versions) within 3e-3 relative of the f32 grid solve with no
   hand-kernel launch; (d)
   phase 3's first instance through the JSON writer and reader, bit for
   bit, and ``check_solution`` / ``factorization_ok`` on a batch with one
   poisoned instance on both layouts;
3g. gradients through the solve (``rslqr_tpu_torch.autodiff``) at full
   width: the loss ``Σ U² + <wX, X>`` (seeded ``wX``) differentiated with
   respect to every field on phase 3's N=256 batch (em kernel path), phase
   3b's quadruped batch, the same batch on the grid path and through
   ``solve_pscan``; each field's f32 gradient error against the f64 plain
   gradient of the same solver (16 instances; 4 on the quadruped) at most
   2x the f32 ``kernels="off"`` error + 1e-6, the f64 gradient against a
   fourth-order central difference on 3 seeded coordinates of each field
   (1e-4 max(1, |fd|)), forward and backward ms, each one's hand-kernel
   launches (the backward's solves, one for the adjoint and one refinement
   step each for it and the solution: rsLQR sweeps through the cached
   factorization, B2 at least 8 times on the small batch, B7 and B9 on the
   quadruped, none on the grid path; pscan scans again, B5's flagged
   products and B8) and the peak device memory;
3h. the sharded solvers (``rslqr_tpu_torch.parallel``) on 2 and 4 spawned
   ranks that share the card (gloo on cuda:0, the ``all_reduce``
   transport) on phase 3's N=256 batch: ``solve_seq_sharded`` on (1, D)
   and (2, 2), ``solve_pscan_sharded`` on (1, D), ``solve_batch_sharded``
   on (D,), each within 1e-4 relative of the single-device solve, the
   collective signature equal to the closed-form model of
   tests/test_collective_audit.py:71-102, every batch shard's em kernels
   launched, no hand kernel in seq; then ``dryrun_multichip(4, "cuda")``;
3i. bf16 factor slabs (``SolveOptions(factor_dtype="bfloat16")``): (a)
   ``solve`` on phase 3's batches at N=256 and N=128 (B3, B4, B2 and B1
   launch their bf16 instantiations; the slabs are bf16; the kernel
   path's error against the f64 Riccati solve at most 2x the plain bf16
   path's + 1e-6, its distance to that path likewise); (b) the same
   batch with ``flat_planes`` (the flat kernels take f32 slabs only: the
   em kernels, equal to (a)); (c) ``solve_refined`` with 8 iterations on
   4 f64 instances of a seeded random problem (nx=6, nu=3, N=256: KKT
   residual below 1e-8 and within 1e-6 (1 + max|ref|) of the f64
   Riccati solve) and, reported, on the BASELINE batch's; (d) the
   quadruped batch (the plain mid-block update: no B9 launch, B6 and B7
   as in f32), its relative residual, distance to the f32-slab solve and
   peak device memory; (e) B1-B4 with bf16 slabs against their plain
   versions at phase 2's shapes (rounding flips in at most 0.1% of the
   elements; bit for bit on inputs whose every sum is exact in f32),
   single and chained ms against bounds from the bf16 byte counts, B1 and
   B2 beside one unmasked ``baddbmm`` on bf16 operands, and B1, B3 and B4
   chained in turns with their f32 instantiations on the same inputs;
   (f) ``factor_dtype`` ``"float32"`` on phase 3's N=256 batch equal to the
   default solve bit for bit, ``"float16"`` and ``"float64"`` (the plain
   single-level schedule: no launch of B1-B4 or B10-B12) against
   ``kernels="off"`` and, reported, the f32 solve and the f64 Riccati
   solve;
3j. the parallel scan at a mid block past 36 (``random_problem`` N=64,
   nx=48, nu=16, B=64 in one batch, f32): B8's wide launches (> 0, by (n,
   widths, plane)), agreement with ``kernels="off"`` (3e-3 relative,
   bench.py:322), the f64 plain scan of 4 instances against the f64
   Riccati oracle, and B8 against its plain twin (the kernel bar) on fresh
   inputs at each (n, widths, plane) the scan launched it at;
4. time per batched solve of both slices, kernel path and
   ``kernels="off"``; 4c the same for the parallel scan; 4d for the flat
   solve and the refined solve; 3k the wide-block slice on the Unitree
   G1 config (N=512, nx=70, nu=29, B=128, f32, one batch of the
   benchmark's pool size): ``solve_kkt`` on the element-major route with
   hand kernels only (B5, B6, B7, B9 launch, every plane launch counted
   wide, ``linalg`` routes nothing mat-last, no small-block kernel), peak
   device memory, agreement with ``kernels="off"``, f32 error against the
   f64 Riccati oracle of 4 instances within 2x the plain path's, the
   relative KKT residual; 4h times it beside ``kernels="off"``; 4e the
   grid slice in turns: the quadruped
   grid solve beside the em kernel path, the re-solve beside the full grid
   solve, large-block rsLQR and pscan; 4f forward against forward +
   backward (small and quadruped, and quadruped pscan) in turns, and each
   sharded solve's wall at each rank count (ranks sharing one card:
   time-sharing, not scaling); 4g bf16 slabs against f32 slabs in turns
   (the em solve and the quadruped);
5. one batched solve of each slice (and one quadruped pscan solve, one flat
   solve, one refined solve, one bf16-slab solve and one quadruped grid
   solve) traced with
   ``torch.profiler``: device time by kernel (the top kernels and every
   hand kernel) and device kernel launches beside the profiled wall (and
   the grid re-solve and large-block rsLQR and pscan; the device's busy
   and idle time of a solve is the benchmark's, ``lqrbench/trace.py``);
   5b ``profile_solve`` (per-phase device and host ms, read through the
   solve's stage spans) on the quadruped grid batch and the small em
   batch, with ``print_solve_summary``;
6. the kernel-measurement entry points: ``bench_kernels``' six sections
   (update, leaf, rhs, sep, prod, planes) at their defaults, one JSON row
   per stage and level (chained, graph-replayed times with the card's name),
   with the launch counts of that run (set to 0 just before it); 6b
   ``probe_pgemm.main(["--rounds", "1"])``, with the probe kernels' launch
   counts of that run (wrapper calls: the eager warm-ups and the graph
   captures; replays launch without counting);
7. the port's bench entry, ``bench_torch.main`` with ``BENCH_REPS=1`` and
   its default families (rslqr, pscan, refine at N=256, B=1024; rslqr and
   pscan on the quadruped) and gates: exit 0, and its JSON line printed as
   a line of its own.

Then a JSON line with every kernel's launches, error, times and bound, and
last ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without that last line; so does a machine without CUDA. Imports no JAX.
"""

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np

N_MAIN, N_ODD, BATCH = 256, 128, 1024
# BASELINE.json quadruped config (bench.py:373-381): one batch on the card.
QN, QX, QU, QB = 512, 36, 12, 256
# The large-block coverage case of phase 3f (c): a block past the plane
# kernels' 80 (no benchmark config has one).
LN, LX, LU, LB = 64, 84, 24, 32
# The Unitree G1 whole-body config (lqrbench/configs/g1-n512.json): N=512,
# nx=70, nu=29, and the benchmark cell's batch of 128 (phases 2i, 3k, 4h).
GN, GX, GU, GB = 512, 70, 29, 128
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
# Phase 3j: a mid block past 36 through the parallel scan.
WN, WX, WU, WB = 64, 48, 16, 64
# B8's wide instantiations: median of PLU_TURNS single launches in turns
# with the library call (phase 2c).
PLU_TURNS = 50
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
    "schur3_update_levels": "rslqr_tpu/ops/planes_pallas.py:503",
    "schur_update_planes": "rslqr_tpu/ops/planes_pallas.py:270",
    "plu_solve_multi": "rslqr_tpu/ops/planes_pallas.py:425",
    "plu_wide": "rslqr_tpu/ops/planes_pallas.py:425",
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
# B1's, B3's and B4's bf16-slab kernels (instantiated by bf16_kernels.cu).
BF16_SOURCES = {k: "rslqr_tpu_torch/csrc/bf16_rows.cuh" for k in (
    "schur_update_level_em", "schur_update_pair_em", "leaf_schur_level0_em")}
# The kernels of each mid-block path (the others launch no time there).
RSLQR_MID = ("pgemm", "pchol", "pcho_solve", "schur3_update_planes",
             "schur3_update_levels")
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
    "plu_wide": f"pscan N={WN} nx={WX} nu={WU} B={WB}",
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
# Phase 3g: the fields differentiated; phase 3h: timed repeats of each
# sharded solve and the kernels each batch shard's em solve must launch.
GRAD_FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")
SHARD_REPS = 3
SMALL_PATH = ("leaf_schur_level0_em", "schur_update_pair_em",
              "rhs_update_level_em")


def seq_signature(D, n, m, b):
    """The closed-form collective signature of ``solve_seq_sharded``
    (tests/test_collective_audit.py:71-92, with the trailing batch axis):
    two dynamics gathers, then per top level four factor-block gathers in
    the sweep and four vector gathers in the RHS pass."""
    T = D.bit_length() - 1
    sig = collections.Counter()
    sig[("all_gather", (D, n, n, b))] += 1
    sig[("all_gather", (D, n, m, b))] += 1
    for U in range(T, 0, -1):
        sig[("all_gather", (D, U, n, n, b))] += 3
        sig[("all_gather", (D, U, m, n, b))] += 1
    sig[("all_gather", (D, n, b))] += 3 * T
    sig[("all_gather", (D, m, b))] += T
    return sig


def pscan_signature(D, n, m, b):
    """The same for ``solve_pscan_sharded`` (tests/test_collective_audit.py
    :95-102): one gather of the chunk elements' five parts, one of the
    chunk maps' two, one ppermute pair."""
    sig = collections.Counter()
    sig[("all_gather", (D, n, n, b))] += 4
    sig[("all_gather", (D, n, b))] += 3
    sig[("ppermute", (n, n, b))] += 1
    sig[("ppermute", (n, b))] += 1
    return sig


def _blk_tag(name: str) -> str:
    """The block tag of a small-block kernel's mangled name."""
    np_, mp, ex, wide = re.search(
        r"BlkILi(\d+)ELi(\d+)ELb([01])ELb([01])E", name).groups()
    return (f"Blk<{np_}, {mp}{', exact' if ex == '1' else ''}"
            f"{', wide' if wide == '1' else ''}>")


def small_ptxas(build, report: str):
    """One line per instantiation of the fused leaf kernels (B3, B11, and
    B3's bf16 kernel) and per bf16-slab instantiation of every small-block
    kernel (B1-B4) in a ``-Xptxas -v`` report: kernel, block tag, layout
    or emission, registers, stack and spills."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        kern = re.search(r"(row_level2?_kernel|row_pair2?_kernel|"
                         r"leaf_row2?_kernel|rhs_kernel)", name)
        bf16 = "__nv_bfloat16" in name or "2_kernel" in name
        if kern is None or not (bf16 or "leaf_row_kernel" in name):
            continue
        kern = kern.group(1)
        # The template flags after the block tag: EMIT (B1, B4), then VEC
        # (bf16_rows.cuh: column pairs as one access, or two).
        flags = re.search(r"ELb[01]ELb[01]EEE((?:Lb[01]E)*)", name)
        flags = re.findall(r"Lb([01])E", flags.group(1)) if flags else []
        what = ""
        if kern.startswith("leaf_row"):
            what = " ElementMajor (B11)" if "ElementMajor" in name else (
                " GroupMajor (B3)")
        elif kern != "rhs_kernel" and flags:
            what = " emitting" if flags.pop(0) == "1" else " not emitting"
        if kern.endswith("2_kernel") and flags:
            what += (", column pairs" if flags[0] == "1"
                     else ", scalar pairs (odd B)")
        what += ", bf16 slabs" if bf16 else ""
        lines.append(f"phase1 ptxas {kern} {_blk_tag(name)}{what}: {regs} "
                     f"registers, {stack} bytes stack, {st}/{ld} bytes spill "
                     f"stores/loads")
    return lines


def plu_ptxas(build, report: str):
    """One line per width of B8's ``plu_kernel`` in a ``-Xptxas -v``
    report: registers, stack and spills."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        w = re.search(r"plu_kernelILi(\d+)E", name)
        if w:
            lines.append(f"phase1 ptxas plu_kernel W={w[1]}: {regs} "
                         f"registers, {stack} bytes stack, {st}/{ld} bytes "
                         f"spill stores/loads")
    return lines


def rows_ptxas(build, report: str):
    """One line per column tile of ``rows_kernel`` (B5, B9) and of
    ``levels::rows_kernel`` (B9 across the upper levels) in a ``-Xptxas -v``
    report of ``csrc/planes_kernels.cu``: registers, stack and spills."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        m = re.search(r"(6levels)?11rows_kernelILi(\d+)E", name)
        if m:
            lines.append(f"phase1 ptxas {'levels::' if m[1] else ''}"
                         f"rows_kernel TC={m[2]}: {regs} registers, {stack} "
                         f"bytes stack, {st}/{ld} bytes spill stores/loads")
    return lines


def chol_ptxas(build, report: str, sass: dict = None):
    """One line per register width of B6's ``pchol_kernel`` and B7's
    ``pcho_solve_kernel`` (staged or direct) in a ``-Xptxas -v`` report of
    ``csrc/planes_kernels.cu``: registers, stack and spills, and the SASS
    instructions of each kernel in ``sass`` (``build.sass_counts``)."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        m = re.search(r"(4wide)?\d+(pchol|pcho_solve)_kernelILi(\d+)E"
                      r"(?:Lb([01])E)?", name)
        if m:
            mode = (" wide" if m[1] else
                    {"1": " staged", "0": " direct"}.get(m[4], ""))
            lines.append(f"phase1 ptxas {m[2]}_kernel W={m[3]}{mode}: {regs} "
                         f"registers, {stack} bytes stack, {st}/{ld} bytes "
                         f"spill stores/loads"
                         + (f", {sass[name]} SASS instructions"
                            if sass and name in sass else ""))
    return lines


def probe_ptxas(build, report: str):
    """One line per kernel of ``csrc/probe_kernels.cu`` in a ``-Xptxas -v``
    report: P1's (ib, column tile, warps) or P2, registers, stack and
    spills."""
    lines = []
    for name, (regs, stack, st, ld) in sorted(
            build.ptxas_kernels(report).items()):
        m = re.search(r"pgemm_ib_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        what = (f"pgemm_ib_kernel ib={m[1]} TC={m[2]} t1={m[3]}" if m
                else "fma_peak_kernel" if "fma_peak" in name else name)
        lines.append(f"phase1 ptxas {what}: {regs} registers, {stack} bytes "
                     f"stack, {st}/{ld} bytes spill stores/loads")
    return lines


def jax_order_pchol(A):
    """B6 in the JAX kernel's order (planes_pallas.py:_chol_kernel),
    plain f32 ops: left-looking, each column's terms subtracted one at a
    time in ascending k, the column scaled by rsqrt of its pivot (the plain
    version, ``planes.pchol_plain``, sums each column's terms in one
    reduction)."""
    import torch

    n = A.shape[0]
    L = torch.zeros_like(A)
    for j in range(n):
        acc = A[j:, j]
        for k in range(j):
            acc = acc - L[j:, k] * L[j, k][None]
        L[j:, j] = acc * torch.rsqrt(acc[0])[None]
    return L


def jax_order_pcho_solve(L, B):
    """B7 in the JAX kernel's order (planes_pallas.py:_cho_solve_kernel),
    plain f32 ops, in place on ``B``: forward then back substitution, each
    row's terms subtracted one at a time, times the reciprocal of the
    diagonal."""
    n = L.shape[0]
    for i in range(n):
        acc = B[i]
        for k in range(i):
            acc = acc - L[i, k][None] * B[k]
        B[i] = acc * (1.0 / L[i, i])[None]
    for i in reversed(range(n)):
        acc = B[i]
        for k in range(i + 1, n):
            acc = acc - L[k, i][None] * B[k]
        B[i] = acc * (1.0 / L[i, i])[None]
    return B


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


def update_moved(nx, nu, q, N, B, level, U, msize=4, csize=4):
    """Bytes U masked slab-trio updates at one level need: the x/u
    multipliers in full and the lambda multiplier where calc_lambda keeps
    the row (``msize`` bytes an element: 4 for f32 slabs, 2 for bf16); per
    trio its x/u slabs read and written, its lambda slab read where kept
    and written there and at the separator knots (``csize`` bytes; the RHS
    sweep's z vectors are f32 whatever the slabs), and its solved
    separators (f32) once."""
    keep, nsep = lam_knots(N, level)
    G = N >> (level + 1)
    return B * (msize * ((nx + nu) * nx * N + nx * nx * keep) + U * (
        csize * (2 * (nx + nu) * q * N + nx * q * (2 * keep + nsep))
        + 4 * nx * q * G))


def emit_moved(G2, B, S, size=4):
    """Bytes the emission of S next-level products at G2 separator groups
    needs beyond the update: A and B at those separators and the products
    (f32), the lambda rows after them (left unchanged by the update) of
    each slab, and the first slab's separator rows written back (``size``
    bytes an element: 4 for f32 slabs, 2 for bf16)."""
    return G2 * B * (4 * (nn + n * m) + S * (size + 4) * nn + size * nn)


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
        self.grad_stats = {}
        self.bwd_launches = collections.Counter()
        self.shard_walls = {}
        self.bf16_stats = {}
        self.bf16_launches = {}

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAIL: {what}", flush=True)

    def hand_launches(self):
        """Every hand kernel wrapper's launches since the last reset."""
        return {k: v for mod in (self.schur, self.flat, self.planes)
                for k, v in mod.launch_counts().items() if v}

    def reset_hand_launches(self):
        for mod in (self.schur, self.flat, self.planes):
            mod.reset_launch_counts()

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
                chain_library=True, chain_args=None):
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
        call has been captured in a CUDA graph); ``chain_args``: the
        kernel's arguments for the chained time in place of ``args`` (an
        in-place chain whose values must stay normal over every call)."""
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
            moved = sum(x.numel() * x.element_size()
                        for x in tensors(args) + k)
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
            a = clone_args(args if chain_args is None else chain_args)
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

    def level_args(self, N, B, level, nx=n, nu=m, R=None, dtype=None):
        """B1's f32 arguments; the products as the level emits them for
        slabs stored in ``dtype`` (f32 by default)."""
        R = R or self.rand
        xx, ux = nx * nx, nu * nx
        depth = N.bit_length() - 1
        U = depth - level - 1
        G, G2 = N >> (level + 1), N >> (level + 2)
        emit = (self.schur._level_emits(level, N, dtype or self.torch.float32)
                and level + 2 <= depth)
        return [R(xx, N, B), R(xx, N, B), R(ux, N, B),
                [R(xx, N, B) for _ in range(U)],
                [R(xx, N, B) for _ in range(U)],
                [R(ux, N, B) for _ in range(U)],
                [R(G, xx, B, scale=0.1) for _ in range(U)],
                R(G2, xx, B) if emit else None,
                R(G2, ux, B) if emit else None]

    def pair_args(self, N, B, level, nx=n, nu=m, R=None, dtype=None):
        """B4's f32 arguments, as :meth:`level_args`."""
        R = R or self.rand
        xx, ux = nx * nx, nu * nx
        depth = N.bit_length() - 1
        U = depth - level - 1
        G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
        emit = (self.schur._pair_emits(level, N, B, U, nx, nu,
                                       dtype or self.torch.float32)
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

    # -- phase 2g --------------------------------------------------------
    def quad_problem(self, dtype):
        """BASELINE.json's quadruped config as one batch of QB perturbed
        instances (phases 2g, 3b, 3i)."""
        t, pt = self.torch, self.pt
        prob = pt.random_problem(t.Generator().manual_seed(1), QN, QX, QU,
                                 dtype=dtype, device=self.dev)
        return pt.batch_problems(prob, QB, t.Generator().manual_seed(0))

    @contextlib.contextmanager
    def plain_planes(self, names):
        """The plane wrappers ``names`` run their plain versions only (the
        solver looks them up in ``ops/planes.py`` at each call)."""
        pl = self.planes
        saved = {k: getattr(pl, k) for k in names}
        off = lambda fn: (lambda *a, **kw: fn(*a, **{**kw, "kernels": "off"}))
        try:
            for k, fn in saved.items():
                setattr(pl, k, off(fn))
            yield
        finally:
            for k, fn in saved.items():
                setattr(pl, k, fn)

    def c8_cases(self):
        """ROADMAP C8: which mid-block kernel makes the quadruped kernel
        path's f32 error larger than the plain path's. (a) B5 plain, B6,
        B7 (w=36, w=1) and B9 at the quadruped rsLQR's level-0 shapes and
        one upper level: the kernel in f32, its plain version in f32 and
        in f64 on the same inputs; each f32 result's max error relative to
        max|f64|, and the ratio kernel / plain. (b) The quadruped f32
        solve with each kernel alone swapped for its plain version, and
        with each alone left on, every error against the f64 Riccati
        solve of 4 instances (phase 3b's measure)."""
        t, pl, R = self.torch, self.planes, self.drand
        Bb = QB

        def errs(label, fn, args, kw=None):
            kw = kw or {}
            a32 = lambda: clone_args(args)
            a64 = clone_args([[x.double() for x in a]
                              if isinstance(a, list) else a.double()
                              for a in args])
            k = fn(*a32(), **kw)
            p = fn(*a32(), kernels="off", **kw)
            r = fn(*a64, kernels="off", **kw)
            t.cuda.synchronize()
            scale = float(r.abs().max())
            e_k = float((k.double() - r).abs().max()) / scale
            e_p = float((p.double() - r).abs().max()) / scale
            print(f"phase2g {label}: f32 kernel err {e_k:.3e}, f32 plain "
                  f"err {e_p:.3e} (relative to max|f64| {scale:.3e}), "
                  f"kernel / plain {e_k / e_p:.2f}", flush=True)

        def jax_order(order, wrapper):
            """``wrapper`` with the JAX kernel's ``order`` of operations in
            place of its kernel (:func:`errs`' first call)."""
            return lambda *a, kernels="auto": (
                order(*a) if kernels == "auto" else wrapper(*a,
                                                            kernels=kernels))

        for level in (0, 4):
            G = QN >> (level + 1)
            errs(f"B5 pgemm 36x36.36x36 level={level} G={G} B={Bb}",
                 pl.pgemm, [R(QX, QX, G, Bb), R(QX, QX, G, Bb)])
            S = self.spd(QX, G, Bb)
            errs(f"B6 pchol n=36 level={level} G={G} B={Bb}", pl.pchol, [S])
            errs(f"B6 pchol n=36 level={level} G={G} B={Bb}, the JAX "
                 f"kernel's order (in place of the kernel)",
                 jax_order(jax_order_pchol, pl.pchol), [S])
            Lc = pl.pchol_plain(S.double()).float()
            for w in (QX, 1):
                X = R(QX, w, G, Bb)
                errs(f"B7 pcho_solve n=36 w={w} level={level} G={G} B={Bb}",
                     pl.pcho_solve, [Lc, X])
                errs(f"B7 pcho_solve n=36 w={w} level={level} G={G} B={Bb}"
                     f", the JAX kernel's order (in place of the kernel)",
                     jax_order(jax_order_pcho_solve, pl.pcho_solve),
                     [Lc, X])
            args, kw, *_ = self.schur3_case(QX, QU, QX, level)
            errs(f"B9 schur3_update_planes q=36 level={level} N={QN} "
                 f"B={Bb} (x slab)",
                 lambda *a, **k: pl.schur3_update_planes(*a, **k)[1],
                 args, kw)

        pt = self.pt
        b = self.quad_problem(t.float32)
        ric = pt.solve_riccati(
            b.map(lambda x: x[:4]).to(dtype=t.float64)).kkt_vector()
        err = lambda x: rel_err(x[:4].double(), ric)
        e_on = err(pt.solve_kkt(b))
        e_off = err(pt.solve_kkt(b, options=pt.SolveOptions(kernels="off")))
        print(f"phase2g quadruped N={QN} B={QB} f32 err vs f64 Riccati: "
              f"kernel path {e_on:.3e}, plain {e_off:.3e}, ratio "
              f"{e_on / e_off:.2f}", flush=True)
        for name in RSLQR_MID:
            with self.plain_planes([name]):
                e1 = err(pt.solve_kkt(b))
            with self.plain_planes([k for k in RSLQR_MID if k != name]):
                e2 = err(pt.solve_kkt(b))
            print(f"phase2g quadruped {name}: only it plain {e1:.3e} "
                  f"(ratio to plain {e1 / e_off:.2f}); only it on "
                  f"{e2:.3e} (ratio {e2 / e_off:.2f})", flush=True)

    # -- phase 2h --------------------------------------------------------
    def levels_cases(self, nx=QX, nu=QU, N=QN, Bb=QB, phase="phase2h",
                     line=True):
        """B9 across the upper levels at the quadruped rsLQR's shapes (or
        the given ones), every level with all its upper levels (U = 8 - L
        at N = 512): the fused kernel against the per-level kernel bit for
        bit and against the plain version within KERNEL_BAR, then both
        chained in turns against the bound: (2U + 1) X + R bytes (X: one
        slab trio; R: the U compact solved separators) at PEAK_BYTES, or
        the update's FLOPs at PEAK_F32 where they take longer. ``line``:
        then the standard comparison line at level 0 (its clones of every
        upper slab do not fit the card at the G1's shapes)."""
        t, pl = self.torch, self.planes
        depth = N.bit_length() - 1
        X = 4 * (2 * nx + nu) * nx * N * Bb

        def rand(gen, *shape, scale=1.0):
            return scale * t.randn(shape, generator=gen, device=self.dev)

        for level in range(depth - 1):
            U = depth - 1 - level
            G = N >> (level + 1)
            g = t.Generator(device=self.dev).manual_seed(level)
            FL = [rand(g, nx, nx, N, Bb), rand(g, nx, nx, N, Bb),
                  rand(g, nu, nx, N, Bb)]
            fs = [rand(g, nx, nx, G, Bb, scale=0.1) for _ in range(U)]

            def fresh():
                """The upper slabs, the same numbers at each call."""
                gc = t.Generator(device=self.dev).manual_seed(100 + level)
                return [[rand(gc, r, nx, N, Bb) for _ in range(U)]
                        for r in (nx, nx, nu)]

            def per_level(C):
                for u in range(U):
                    pl.schur3_update_planes(*FL, fs[u], C[0][u], C[1][u],
                                            C[2][u], level=level)

            want = fresh()
            per_level(want)
            got = fresh()
            pl.schur3_update_levels(*FL, fs, *got, level=level)
            t.cuda.synchronize()
            same = all(t.equal(a, b) for ga, wa in zip(got, want)
                       for a, b in zip(ga, wa))
            del want
            plain = fresh()
            pl.schur3_update_levels(*FL, fs, *plain, level=level,
                                    kernels="off")
            err = scale = 0.0
            for ga, pa in zip(got, plain):
                for a, b in zip(ga, pa):
                    err = max(err, float((a - b).abs().max()))
                    scale = max(scale, 1.0 + float(b.abs().max()))
            del got, plain
            self.check(same, f"schur3_update_levels level={level}: not bit "
                             f"for bit the per-level kernel")
            self.check(err <= KERNEL_BAR * scale,
                       f"schur3_update_levels level={level}: vs plain "
                       f"{err:.3e} > {KERNEL_BAR} * {scale:.3e}")
            C = fresh()
            fused = lambda: pl.schur3_update_levels(*FL, fs, *C, level=level)
            turns = [self.chained(f) for f in (
                fused, lambda: per_level(C), lambda: per_level(C), fused)]
            moved = (2 * U + 1) * X + 4 * U * nx * nx * G * Bb
            ops = update_ops(nx, nu, nx, N, Bb, level, U)
            bound_ms, bound_by = bound(moved, ops)
            f_ms = min(turns[0], turns[3])
            p_ms = min(turns[1], turns[2])
            print(f"{phase} schur3_update_levels n={nx} m={nu} q={nx} N={N} "
                  f"B={Bb} level={level} U={U}: bit_for_bit={same} "
                  f"rel_diff_vs_plain={err / scale:.3e} (bar {KERNEL_BAR}) "
                  f"chained_ms fused={f_ms:.4f} per_level={p_ms:.4f} "
                  f"(turns {', '.join(f'{x:.4f}' for x in turns)}) "
                  f"bound_ms={bound_ms:.4f} ({bound_by}: {moved / 1e9:.3f} "
                  f"GB, {ops / 1e9:.1f} GFLOP) "
                  f"x_bound fused={f_ms / bound_ms:.2f} "
                  f"per_level={p_ms / bound_ms:.2f} "
                  f"fused_TBps={moved / f_ms / 1e9:.3f}", flush=True)
            del C, FL, fs
        if not line:
            return
        args, kw, ops, _, _ = self.schur3_case(nx, nu, nx, 0, N, Bb)
        FL, C = args[:3], args[4:]
        U = depth - 1
        fs = [args[3]] + [self.drand(nx, nx, N >> 1, Bb, scale=0.1)
                          for _ in range(U - 1)]
        Cs = [[c] + [c.clone() for _ in range(U - 1)] for c in C]
        self.compare(
            "schur3_update_levels", f"n={nx} m={nu} q={nx} N={N} B={Bb} "
            f"level=0 U={U}", pl.schur3_update_levels, [*FL, fs, *Cs], kw,
            ops * U, moved=(2 * U + 1) * X + 4 * U * nx * nx * (N >> 1) * Bb,
            phase=phase)

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
        from rslqr_tpu_torch.bench_kernels import chain_spd

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
        # The comparison's blocks give L's off-diagonal entries an O(1)
        # share of the answer. The chain solves in place, so its own blocks
        # keep X normal over every call of the timing
        # (bench_kernels.chain_spd).
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
                chain_args=[pl.pchol_plain(chain_spd(R(Gs, Bb, d, d))), X],
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

    def schur3_case(self, nx, nu, q, level, N=QN, Bb=QB):
        """Arguments, kwargs, FLOPs and the library call (one unmasked
        ``baddbmm`` over the stacked lambda/x/u rows, with the separators
        broadcast per knot) of one B9 case at N, B (the quadruped's)."""
        t, R = self.torch, self.drand
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

    # -- phase 2i --------------------------------------------------------
    def wide_cases(self):
        """B5, B6, B7, B9 at the wide widths, at the G1's level-0 shapes
        (G=256 groups of the N=512 horizon, B=128) and at the limit, as
        phase 2b runs them at the quadruped's; then phase 2h's fused B9 at
        the G1's shapes."""
        from rslqr_tpu_torch.bench_kernels import chain_spd

        t, pl, R = self.torch, self.planes, self.drand
        ml = self.mat_last
        G, Bb = GN // 2, GB
        F = G * Bb
        for (p, K, q) in ((GX, GX, GX), (GX, GU, GX), (GU, GX, GX)):
            A, Bm = R(p, K, G, Bb), R(K, q, G, Bb)
            self.compare(
                "pgemm", f"{p}x{K}.{K}x{q} G={G} B={Bb}",
                lambda a, b, **k: (pl.pgemm(a, b, **k),), [A, Bm], {},
                2 * p * K * q * F, (t.matmul, (ml(A), ml(Bm))), chain=True,
                phase="phase2i",
            )
        for d, Gs in ((GX, G), (GX, G >> 4), (pl.MAX_BLOCK, G)):
            S = self.spd(d, Gs, Bb)
            Fs = Gs * Bb
            self.compare(
                "pchol", f"n={d} G={Gs} B={Bb}",
                lambda a, **k: (pl.pchol(a, **k),), [S], {},
                Fs * sum(2 * j * (d - j) + (d - j) for j in range(d)),
                (t.linalg.cholesky_ex, (ml(S),)),
                moved=4 * Fs * (d * (d + 1) // 2 + d * d), chain=True,
                chain_library=False, phase="phase2i",
            )
        for d, w, Gs in ((GX, GX, G), (GX, GX, G >> 4), (GX, 1, G),
                         (pl.MAX_BLOCK, pl.MAX_BLOCK, G)):
            Lc = pl.pchol_plain(self.spd(d, Gs, Bb))
            X = R(d, w, Gs, Bb)
            Fs = Gs * Bb
            self.compare(
                "pcho_solve", f"n={d} w={w} G={Gs} B={Bb}",
                lambda a, b, **k: (pl.pcho_solve(a, b, **k),), [Lc, X], {},
                2 * d * d * w * Fs, (t.cholesky_solve, (ml(X), ml(Lc))),
                moved=4 * Fs * (d * (d + 1) // 2 + 2 * d * w), chain=True,
                chain_library=False,
                chain_args=[pl.pchol_plain(chain_spd(R(Gs, Bb, d, d))), X],
                phase="phase2i",
            )
            del Lc, X
        for q in (GX, 1):
            self.compare(
                "schur3_update_planes",
                f"n={GX} m={GU} q={q} N={GN} B={Bb} level=0",
                pl.schur3_update_planes,
                *self.schur3_case(GX, GU, q, 0, GN, Bb), chain=True,
                phase="phase2i",
            )
        t.cuda.empty_cache()
        self.levels_cases(GX, GU, GN, GB, phase="phase2i", line=False)

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
        # fold / down-sweep step, and the suffix tree's I + C J solves; and
        # n=48 and 64, past 36 (``plu_wide``: the W = 48 and 64
        # instantiations; phase 3j's scan reaches them).
        for n, ws, plane in ((U, (U,), fold), (X, (X, 1, X, 1), tree),
                             (X, (X, 1), tree2), (48, (48, 1), tree),
                             (64, (64, 1), tree)):
            name, case, fn, args, ops, lib, moved = self.plu_case(n, ws,
                                                                  plane)
            self.compare(name, case, fn, args, {}, ops, lib, moved,
                         phase="phase2c", chain=True, chain_library=False)
            if name == "plu_wide":
                self.plu_turns(case, fn, args, *lib)

    def plu_case(self, n, ws, plane):
        """B8 on a well-conditioned ``I + C J`` block (C, J PSD) of n at
        ``plane`` with right-hand sides of widths ``ws``: the JSON name
        (``plu_wide`` past 36), the case, the call, its arguments, FLOPs,
        library call (``lu_factor_ex`` + ``lu_solve`` on mat-last views)
        and bytes, for ``compare``."""
        t, pl, R, ml = self.torch, self.planes, self.drand, self.mat_last
        F = plane[0] * plane[1]
        M = R(*plane, n, n, scale=n ** -0.5)
        P = R(*plane, n, n, scale=n ** -0.5)
        IC = t.eye(n, device=self.dev) + (M @ M.transpose(-1, -2)) @ (
            P @ P.transpose(-1, -2))
        A = IC.movedim((-2, -1), (0, 1)).contiguous()
        Bs = [R(n, w, *plane) for w in ws]
        wt = sum(ws)

        def lu_lib(a, b):
            LU, piv, _ = t.linalg.lu_factor_ex(a)
            return t.linalg.lu_solve(LU, piv, b)

        name = "plu_wide" if n >= pl.LU_WIDE_MIN else "plu_solve_multi"
        return (name, f"n={n} w={ws} plane={plane}",
                lambda a, bs, **k: pl.plu_solve_multi(a, *bs, **k), [A, Bs],
                F * (2 * n ** 3 / 3 + 2 * n * n * wt),
                (lu_lib, (ml(A), t.cat([ml(b) for b in Bs], dim=2))),
                4 * F * (n * n + 2 * n * wt))

    def plu_turns(self, case, fn, args, lib_fn, lib_args):
        """B8's wide instantiations against ``lu_factor_ex`` + ``lu_solve``:
        the median of PLU_TURNS single launches of each, in turns (kernel,
        library, library, kernel); the library call single only (MAGMA,
        see ``compare``). The first case's library median is the JSON
        line's ``library_ms``."""
        from rslqr_tpu_torch.bench_kernels import launch_ms

        run_k = lambda: launch_ms(fn, lambda: clone_args(args), PLU_TURNS)
        run_l = lambda: launch_ms(lib_fn, lambda: lib_args, PLU_TURNS)
        ks, ls = [run_k()], [run_l(), run_l()]
        ks.append(run_k())
        k_ms, l_ms = min(ks), min(ls)
        self.check(k_ms <= l_ms,
                   f"plu_wide {case}: kernel {k_ms:.4f} ms slower than "
                   f"lu_factor_ex + lu_solve {l_ms:.4f} ms (medians of "
                   f"{PLU_TURNS}, in turns)")
        print(f"phase2c plu_wide {case}: in turns, medians of {PLU_TURNS} "
              f"single launches: kernel {ks[0]:.4f}, {ks[1]:.4f} ms; "
              f"lu_factor_ex + lu_solve {ls[0]:.4f}, {ls[1]:.4f} ms "
              f"(library / kernel {l_ms / k_ms:.2f}x)", flush=True)
        st = self.kernel_stats["plu_wide"]
        if st["case"] == case:
            st.update(library_ms=l_ms, turns_ms=k_ms)

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
                    phase="phase2e", chain=True,
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
        self.reset_hand_launches()
        got = solve(b64)
        t.cuda.synchronize()
        launched = self.hand_launches()
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
        b = self.quad_problem(t.float32)
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
        shapes = {f"n={k[0]} w={k[1]} plane={k[2]}": v for k, v in
                  self.planes.plu_solve_multi.shape_launches.items()}
        print(f"phase3c launches pscan N={QN} B={QB} nx={QX} nu={QU}: "
              f"{json.dumps(counts)} small-block kernels: "
              f"{json.dumps(small)}; plu_solve_multi by (n, widths, plane): "
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

    def grid_solve(self, b, options=None):
        """``solve_kkt`` on the knot-major grid path."""
        return self.pt.solve_kkt(b, options=self.pt.SolveOptions(
            layout="grid"))

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

    # -- phase 3f --------------------------------------------------------
    def grid_checks(self):
        """The grid and large-block slice: (a) the quadruped batch of phase
        3b through ``layout="grid"`` (no hand kernel), (b) the multi-RHS
        front door on it, (c) the large-block route at nx=84, (d) JSON I/O
        and diagnostics."""
        t, pt = self.torch, self.pt
        G = pt.SolveOptions(layout="grid")
        b = self.quad_batch
        # (a) Full width and batch, against phase 3b's em kernel path.
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        self.reset_hand_launches()
        got = pt.solve_kkt(b, options=G)
        t.cuda.synchronize()
        launched = self.hand_launches()
        peak = t.cuda.max_memory_allocated()
        self.check(not launched, f"grid quadruped launched hand kernels "
                                 f"{launched}")
        self.check(tuple(got.shape) == (QB, b.nvars)
                   and bool(t.isfinite(got).all()),
                   f"grid quadruped: shape {tuple(got.shape)} or non-finite")
        d_em = rel_err(got, self.quad_got)
        self.check(d_em <= QUAD_SLICE_BAR,
                   f"grid quadruped vs em kernel path rel diff {d_em:.3e}")
        ric = self.quad_ric
        g64 = pt.solve_kkt(self.quad_sub64, options=G)
        e64 = float((g64 - ric).abs().max())
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        self.check(e64 <= bar64, f"grid quadruped: f64 vs f64 Riccati "
                                 f"{e64:.3e} > {bar64:.3e}")
        res = max(float(pt.kkt_residual(b.map(lambda x: x[i]), got[i]))
                  for i in range(2))
        scale = max(float(got[:2].abs().max()), 1.0)
        self.check(res / scale <= QUAD_RESIDUAL_BAR,
                   f"grid quadruped: relative KKT residual {res / scale:.3e}")
        print(f"phase3f (a) grid quadruped N={QN} B={QB} nx={QX} nu={QU} "
              f"f32: rel_diff_vs_em_kernels={d_em:.3e} (bar "
              f"{QUAD_SLICE_BAR}) f64_vs_riccati={e64:.3e} (bar "
              f"{bar64:.3e}) kkt_residual={res:.4e} rel={res / scale:.3e} "
              f"(bar {QUAD_RESIDUAL_BAR}); hand-kernel launches "
              f"{json.dumps(launched)}; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del got, g64

        # (b) Factor once, re-solve a perturbed problem.
        b2 = self.perturbed(b)
        self.reset_hand_launches()
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        fact, _ = pt.factorize(b, options=G)
        re = pt.solve_rhs(b2, fact, pt.leaf_solve_rhs(b2),
                          options=G).kkt_vector()
        t.cuda.synchronize()
        peak = t.cuda.max_memory_allocated()
        del fact
        fresh = pt.solve_kkt(b2, options=G)
        t.cuda.synchronize()
        launched = self.hand_launches()
        same = bool(t.equal(re, fresh))
        d = rel_err(re, fresh)
        self.check((same or d <= 1e-6) and not launched,
                   f"grid re-solve vs fresh solve rel diff {d:.3e}, "
                   f"launches {launched}")
        print(f"phase3f (b) multi-RHS (x0 + 0.1, q + 0.5, r - 0.25): "
              f"re-solve {'equals the fresh grid solve bit for bit' if same
                          else f'within {d:.3e} of the fresh grid solve'} "
              f"(bar 1e-6); hand-kernel launches {json.dumps(launched)}; "
              f"peak device memory (factorize + re-solve) "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del re, fresh

        self.large_block_checks()
        self.io_diagnostics_checks()

    @staticmethod
    def perturbed(b):
        """Phase 3f (b)'s new right-hand side (tests/test_rslqr.py:174-189)."""
        return dataclasses.replace(b, x0=b.x0 + 0.1, q=b.q + 0.5,
                                   r=b.r - 0.25)

    def large_batch(self, dtype):
        """The large-block coverage case: ``random_problem`` N=64, nx=84,
        nu=24, B=32 (past the plane kernels' 80)."""
        t, pt = self.torch, self.pt
        prob = pt.random_problem(t.Generator().manual_seed(72), LN, LX, LU,
                                 dtype=t.float64, device=self.dev)
        b = pt.batch_problems(prob, LB, t.Generator().manual_seed(LX))
        return b.to(dtype=dtype)

    def large_block_checks(self):
        """(c) rsLQR and pscan in f32 and f64, f64 against the f64 Riccati
        oracle, f32 against the f64 answer, and ``solve_refined`` (grid
        branch, 2 iterations) against the oracle."""
        t, pt = self.torch, self.pt
        b64, b32 = self.large_batch(t.float64), self.large_batch(t.float32)
        ric = pt.solve_riccati(b64).kkt_vector()
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        out = []
        for name, solve in (("rslqr", pt.solve_kkt),
                            ("pscan", pt.solve_pscan_kkt)):
            self.reset_hand_launches()
            x64 = solve(b64)
            t.cuda.synchronize()
            t.cuda.reset_peak_memory_stats()
            x32 = solve(b32)
            t.cuda.synchronize()
            peak = t.cuda.max_memory_allocated()
            launched = self.hand_launches()
            e64 = float((x64 - ric).abs().max())
            d32 = rel_err(x32.double(), x64)
            self.check(e64 <= bar64 and d32 <= QUAD_SLICE_BAR
                       and bool(t.isfinite(x32).all()) and not launched,
                       f"large {name}: f64 vs Riccati {e64:.3e} (bar "
                       f"{bar64:.3e}), f32 vs f64 {d32:.3e}, launches "
                       f"{launched}")
            out.append(f"{name} f64_vs_riccati={e64:.3e} "
                       f"f32_vs_f64={d32:.3e} launches "
                       f"{json.dumps(launched)} f32 peak device memory "
                       f"{peak / 2**30:.2f} GiB")
        # layout="em" at nx=84: the element-major path on the plain plane
        # versions (no hand kernel), against the grid solve in f32.
        self.reset_hand_launches()
        em32 = pt.solve_kkt(b32, options=pt.SolveOptions(layout="em"))
        t.cuda.synchronize()
        launched = self.hand_launches()
        grid32 = pt.solve_kkt(b32)
        d_em = rel_err(em32.double(), grid32.double())
        self.check(d_em <= QUAD_SLICE_BAR and not launched
                   and bool(t.isfinite(em32).all()),
                   f"large layout='em': vs grid {d_em:.3e}, launches "
                   f"{launched}")
        out.append(f"layout='em' f32 vs grid f32 {d_em:.3e} launches "
                   f"{json.dumps(launched)}")
        ref = pt.solve_refined(b64, iterations=2)
        e_rf = float((ref.kkt_vector() - ric).abs().max())
        self.check(e_rf <= bar64 and isinstance(ref.fact,
                                                pt.RsLqrFactorization),
                   f"large refined: vs Riccati {e_rf:.3e} > {bar64:.3e}")
        print(f"phase3f (c) large block N={LN} nx={LX} nu={LU} B={LB}: "
              + "; ".join(out) + f"; refined (2 iterations, f32 grid "
              f"factor) f64_vs_riccati={e_rf:.3e}; bars: f64 {bar64:.3e}, "
              f"f32 {QUAD_SLICE_BAR}", flush=True)

    def io_diagnostics_checks(self):
        """(d) Phase 3's first instance written with the port's JSON writer
        and read back onto the card, bit for bit; ``check_solution`` and
        ``factorization_ok`` on a batch with one poisoned instance, on both
        layouts."""
        t, pt = self.torch, self.pt
        from rslqr_tpu_torch import diagnostics

        one = self.main_batch.map(lambda x: x[0])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "prob.json")
            pt.write_lqr_problem_json(path, one)
            back, _ = pt.read_lqr_problem_json(path, dtype=t.float32,
                                               device=self.dev)
        fields = [f.name for f in dataclasses.fields(one)]
        same = all(t.equal(getattr(back, k), getattr(one, k))
                   for k in fields)
        self.check(same and back.A.is_cuda, "JSON round trip differs")
        sub = self.main_batch.map(lambda x: x[:8])
        Q = sub.Qdiag.clone()
        Q[3] = -Q[3]
        bad = dataclasses.replace(sub, Qdiag=Q)
        want = [k != 3 for k in range(8)]
        notes = []
        for layout in ("auto", "grid"):
            sol = pt.solve(bad, options=pt.SolveOptions(layout=layout))
            vec = sol.kkt_vector()
            tol = QUAD_RESIDUAL_BAR * max(
                float(vec[[k for k in range(8) if want[k]]].abs().max()), 1.0)
            rep = diagnostics.check_solution(bad, vec, tol)
            status = rep.status.tolist()
            ok = diagnostics.factorization_ok(sol.fact).tolist()
            good = (ok == want and status[3] != 0
                    and all(s == 0 for k, s in enumerate(status) if k != 3))
            self.check(good, f"diagnostics {layout}: status {status}, "
                             f"factorization_ok {ok}")
            notes.append(f"{layout} ({type(sol.fact).__name__}): status "
                         f"{status} factorization_ok {ok}")
        print(f"phase3f (d) JSON round trip N={one.nhorizon} f32: "
              f"{'equal bit for bit' if same else 'DIFFERS'}; poisoned "
              f"instance 3 of 8: " + "; ".join(notes), flush=True)

    # -- phase 3g --------------------------------------------------------
    def grads(self, b, opts, wX, timed=False, solver=None):
        """Gradients of ``Σ U² + <wX, X>`` with respect to every field of
        ``b`` through ``solver`` (default ``solve``); with ``timed``, also
        the forward and backward walls (ms), their hand-kernel launches
        and the peak device memory."""
        t, pt = self.torch, self.pt
        solver = solver or pt.solve
        leaves = {k: getattr(b, k).detach().clone().requires_grad_(True)
                  for k in GRAD_FIELDS}
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        self.reset_hand_launches()
        t0 = time.perf_counter()
        sol = solver(dataclasses.replace(b, **leaves), options=opts)
        loss = (sol.U ** 2).sum() + (wX * sol.X).sum()
        t.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = self.hand_launches()
        self.reset_hand_launches()
        gs = t.autograd.grad(loss, [leaves[k] for k in GRAD_FIELDS])
        t.cuda.synchronize()
        t2 = time.perf_counter()
        out = dict(zip(GRAD_FIELDS, gs))
        if not timed:
            return out
        return out, {"fwd_ms": 1e3 * (t1 - t0), "bwd_ms": 1e3 * (t2 - t1),
                     "fwd_launches": fwd,
                     "bwd_launches": self.hand_launches(),
                     "peak_gib": t.cuda.max_memory_allocated() / 2**30}

    def fd_check(self, label, one, wX, g64, opts, solver):
        """The f64 plain gradient ``g64`` of instance 0 against a
        fourth-order central difference of its loss (``one``: that
        instance, f64), on 3 seeded coordinates of each field, step 1e-4
        max(1, |x|): within 1e-4 max(1, |fd|) (tests/test_rslqr.py:241-259's
        bar). Returns the worst ratio."""
        t, pt = self.torch, self.pt

        def loss(p):
            with t.no_grad():
                s = solver(p, options=opts)
                return float((s.U ** 2).sum() + (wX * s.X).sum())

        rng = np.random.default_rng(13)
        worst = 0.0
        for k in GRAD_FIELDS:
            x = getattr(one, k)
            for _ in range(3):
                idx = tuple(int(rng.integers(s)) for s in x.shape)
                h = 1e-4 * max(1.0, abs(float(x[idx])))

                def at(dx):
                    xx = x.clone()
                    xx[idx] += dx
                    return loss(dataclasses.replace(one, **{k: xx}))

                fd = (8 * (at(h) - at(-h)) - (at(2 * h) - at(-2 * h))) / (
                    12 * h)
                g = float(g64[k][idx])
                e = abs(g - fd) / max(1.0, abs(fd))
                worst = max(worst, e)
                self.check(e <= 1e-4, f"{label}: d/d{k}{idx} {g:.6e} vs "
                                      f"central difference {fd:.6e}")
        return worst

    def autodiff_checks(self):
        """Gradients through the solve at full width on phase 3's N=256
        batch (em kernel path), phase 3b's quadruped batch and the same
        batch on the grid path, and the quadruped batch through
        ``solve_pscan``: kernel-path f32 gradient error against the
        f64 plain gradient on 16 (4) instances at most 2x the f32
        ``kernels="off"`` error + 1e-6, field by field; the f64 gradient
        against a central difference; forward and backward walls, their
        hand-kernel launches, peak memory."""
        t, pt = self.torch, self.pt
        G = pt.SolveOptions(layout="grid")
        off = lambda o: dataclasses.replace(o or pt.SolveOptions(),
                                            kernels="off")
        for label, b, sub, opts, solver in (
                (f"small N={N_MAIN} B={BATCH}", self.main_batch, 16, None,
                 pt.solve),
                (f"quadruped N={QN} B={QB}", self.quad_batch, 4, None,
                 pt.solve),
                (f"grid quadruped N={QN} B={QB}", self.quad_batch, 4, G,
                 pt.solve),
                (f"pscan quadruped N={QN} B={QB}", self.quad_batch, 4, None,
                 pt.solve_pscan)):
            wX = t.randn(b.q.shape, generator=t.Generator().manual_seed(7),
                         dtype=t.float64)
            wX32 = wX.to(device=self.dev, dtype=b.q.dtype)
            got, st = self.grads(b, opts, wX32, timed=True, solver=solver)
            self.grad_stats[label] = st
            self.bwd_launches.update(st["bwd_launches"])
            bsub = b.map(lambda x: x[:sub])
            p32 = self.grads(bsub, off(opts), wX32[:sub], solver=solver)
            b64 = bsub.to(dtype=t.float64)
            w64 = wX.to(self.dev)[:sub]
            g64 = self.grads(b64, off(opts), w64, solver=solver)
            errs = {}
            for k in GRAD_FIELDS:
                ok = bool(t.isfinite(got[k]).all())
                e_k = rel_err(got[k][:sub].double(), g64[k])
                e_p = rel_err(p32[k].double(), g64[k])
                errs[k] = (e_k, e_p)
                self.check(ok and e_k <= 2.0 * e_p + 1e-6,
                           f"{label}: f32 d/d{k} err vs f64 {e_k:.3e} > "
                           f"2 x plain {e_p:.3e} + 1e-6 (finite {ok})")
            fd = self.fd_check(label, b64.map(lambda x: x[:1]), w64[:1],
                               g64, off(opts), solver)
            if solver is pt.solve_pscan:
                self.check(all(st["bwd_launches"].get(k, 0) > 0 for k in (
                    "pgemm_flagged", "plu_solve_multi")),
                    f"{label}: backward launches {st['bwd_launches']}")
            elif opts is None and b is self.main_batch:
                self.check(st["bwd_launches"].get("rhs_update_level_em", 0)
                           >= 8, f"{label}: backward launched B2 "
                                 f"{st['bwd_launches']}")
            elif opts is None:
                self.check(all(st["bwd_launches"].get(k, 0) > 0 for k in (
                    "pcho_solve", "schur3_update_planes")),
                    f"{label}: backward launches {st['bwd_launches']}")
            else:
                self.check(not st["fwd_launches"] and not st["bwd_launches"],
                           f"{label}: hand kernels launched on the grid "
                           f"path {st}")
            print(f"phase3g {label} f32: forward {st['fwd_ms']:.3f} ms, "
                  f"backward {st['bwd_ms']:.3f} ms (first call), peak "
                  f"device memory {st['peak_gib']:.2f} GiB; forward "
                  f"launches {json.dumps(st['fwd_launches'])}; backward "
                  f"launches {json.dumps(st['bwd_launches'])}", flush=True)
            print(f"phase3g {label}: grad err vs f64 on {sub} instances "
                  f"(kernel path / plain f32): " + ", ".join(
                      f"{k} {e:.2e}/{p:.2e}" for k, (e, p) in errs.items())
                  + f"; f64 vs central difference worst {fd:.2e} (bar "
                  f"1e-4)", flush=True)

    # -- phase 3h --------------------------------------------------------
    def sharded_checks(self):
        """The sharded solvers on 2 and 4 spawned ranks that share the card
        (gloo on cuda:0), on phase 3's N=256 batch: parity with the
        single-device solves, the collective signature against the
        closed-form model, the batch shards' kernel launches, and
        ``dryrun_multichip(4, "cuda")``."""
        from rslqr_tpu_torch.parallel import comm
        from rslqr_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                     solve_cases)
        from rslqr_tpu_torch.parallel.launch import run_ranks

        t, pt = self.torch, self.pt
        ref_seq = self.main_got.cpu().numpy()
        ref_ps = pt.solve_pscan_kkt(self.main_batch).cpu().numpy()
        base = {"baseline": (N_MAIN, BATCH, "float32"), "sp": "sp",
                "reps": SHARD_REPS}
        for D in (2, 4):
            cases = {
                f"seq (1, {D})": {**base, "solver": "seq", "mesh": (1, D),
                                  "axes": ("dp", "sp"), "dp": "dp"},
                f"pscan (1, {D})": {**base, "solver": "pscan",
                                    "mesh": (1, D), "axes": ("dp", "sp"),
                                    "dp": "dp"},
                f"batch ({D},)": {**base, "solver": "batch", "mesh": (D,),
                                  "axes": ("dp",), "dp": "dp"},
            }
            if D == 4:
                cases["seq (2, 2)"] = {**base, "solver": "seq",
                                       "mesh": (2, 2), "axes": ("dp", "sp"),
                                       "dp": "dp"}
            t0 = time.perf_counter()
            res = run_ranks(solve_cases, D, "cuda",
                            args=(list(cases.values()),))
            spawn_s = time.perf_counter() - t0
            for i, (name, case) in enumerate(cases.items()):
                per = [r[i] for r in res]
                solver, mesh = case["solver"], case["mesh"]
                if solver == "batch":
                    out = np.concatenate([r["kkt"] for r in per])
                else:
                    out = per[0]["kkt"]
                    self.check(all(np.array_equal(r["kkt"], out)
                                   for r in per), f"{name}: ranks differ")
                ref = ref_ps if solver == "pscan" else ref_seq
                d = rel_err(t.as_tensor(out), t.as_tensor(ref))
                self.check(out.shape == ref.shape and d <= SLICE_BAR,
                           f"phase3h {name}: rel diff {d:.3e} vs the "
                           f"single-device solve")
                launches = [r["launches"] for r in per]
                if solver == "batch":
                    self.check(all(r["calls"] == [] for r in per),
                               f"{name}: collectives in a batch-sharded "
                               f"solve")
                    self.check(all(l.get(k, 0) > 0 for l in launches
                                   for k in SMALL_PATH), f"{name}: rank "
                               f"launches {launches}")
                else:
                    b_loc, sp = BATCH // mesh[0], mesh[1]
                    model = (seq_signature if solver == "seq"
                             else pscan_signature)(sp, n, m, b_loc)
                    for r in per:
                        sig = collections.Counter(
                            (nm, tuple(s)) for nm, s in r["calls"]
                            if nm in comm.SOLVE_COLLECTIVES)
                        self.check(sig == model, f"{name}: signature "
                                                 f"{dict(sig)}")
                    if solver == "seq":
                        self.check(not any(launches), f"{name}: seq "
                                   f"launched hand kernels {launches}")
                walls = [statistics.median(r["walls_ms"]) for r in per]
                self.shard_walls[f"{name} D={D}"] = max(walls)
                print(f"phase3h {name} on {D} ranks sharing cuda:0: rel "
                      f"diff vs single-device {d:.3e} (bar {SLICE_BAR}); "
                      f"collectives {len(per[0]['calls'])} by "
                      f"{per[0]['transports']}; launches per rank "
                      f"{json.dumps(launches)}", flush=True)
            print(f"phase3h D={D}: spawn and run {spawn_s:.1f} s",
                  flush=True)
        dryrun_multichip(4, "cuda")

    # -- phase 3i --------------------------------------------------------
    def bf16_checks(self):
        """bf16 factor-slab storage (``SolveOptions(factor_dtype=
        "bfloat16")``): (a) the BASELINE batch at N=256 and N=128, (b) the
        same with ``flat_planes``, (c) refinement of 4 f64 instances, (d)
        the quadruped batch (the plain mid-block route)."""
        t, pt, s, pl, f = self.torch, self.pt, self.schur, self.planes, \
            self.flat
        bf = pt.SolveOptions(factor_dtype="bfloat16")
        bf_off = pt.SolveOptions(factor_dtype="bfloat16", kernels="off")
        # (a) The small-block kernel path: B3, B4, B2 at N=256, B1 at N=128.
        path = {N_MAIN: ("leaf_schur_level0_em", "schur_update_pair_em",
                         "rhs_update_level_em"),
                N_ODD: ("schur_update_level_em",)}
        self.bf16_batches = {}
        for N in (N_MAIN, N_ODD):
            b = self.batch(N, t.float32)
            self.bf16_batches[N] = b
            self.reset_hand_launches()
            sol = pt.solve(b, options=bf)
            t.cuda.synchronize()
            counts = self.hand_launches()
            got = sol.kkt_vector()
            dts = {x.dtype for F in (sol.fact.Fls, sol.fact.Fxs, sol.fact.Fus)
                   for x in F}
            self.check(dts == {t.bfloat16},
                       f"bf16 N={N}: slabs stored as {dts}")
            for k in path[N]:
                self.bf16_launches[k] = counts.get(k, 0)
                self.check(counts.get(k, 0) > 0,
                           f"bf16 N={N}: {k} not launched")
            print(f"phase3i (a) launches bf16 N={N} B={BATCH}: "
                  f"{json.dumps(counts)}; slab dtypes {sorted(map(str, dts))}",
                  flush=True)
            self.check(tuple(got.shape) == (BATCH, b.nvars)
                       and bool(t.isfinite(got).all()),
                       f"bf16 N={N}: output shape or non-finite")
            ref = pt.solve_kkt(b, options=bf_off)
            sub64 = b.map(lambda x: x[:16]).to(dtype=t.float64)
            ric = pt.solve_riccati(sub64).kkt_vector()
            e_k = rel_err(got[:16].double(), ric)
            e_p = rel_err(ref[:16].double(), ric)
            e_32 = rel_err(pt.solve_kkt(b)[:16].double(), ric)
            d_off = rel_err(got, ref)
            self.check(e_k <= 2.0 * e_p + 1e-6,
                       f"bf16 N={N}: kernel err vs f64 Riccati {e_k:.3e} > "
                       f"2 x plain {e_p:.3e} + 1e-6")
            self.check(d_off <= 2.0 * e_p + 1e-6,
                       f"bf16 N={N}: kernel vs plain rel diff {d_off:.3e} > "
                       f"2 x plain err {e_p:.3e} + 1e-6")
            res = float(pt.kkt_residual(b.map(lambda x: x[0]), got[0]))
            print(f"phase3i (a) bf16 N={N} B={BATCH}: rel_diff_vs_off="
                  f"{d_off:.3e} err_vs_f64_riccati={e_k:.3e} (plain bf16 "
                  f"{e_p:.3e}, f32 slabs {e_32:.3e}) kkt_residual[0]="
                  f"{res:.4e}", flush=True)
            if N == N_MAIN:
                self.bf16_got = got
        # (b) flat_planes: flat_ok takes f32 slabs only, so the em kernels.
        b = self.bf16_batches[N_MAIN]
        self.reset_hand_launches()
        got = pt.solve_kkt(b, options=pt.SolveOptions(
            factor_dtype="bfloat16", flat_planes=True))
        t.cuda.synchronize()
        counts = self.hand_launches()
        flat_k = {k: v for k, v in f.launch_counts().items() if v}
        self.check(not flat_k and all(counts.get(k, 0) > 0
                                      for k in path[N_MAIN])
                   and bool(t.equal(got, self.bf16_got)),
                   f"bf16 flat_planes: launches {counts}, equal to (a) "
                   f"{bool(t.equal(got, self.bf16_got))}")
        print(f"phase3i (b) bf16 flat_planes=True N={N_MAIN}: launches "
              f"{json.dumps(counts)} (flat kernels {json.dumps(flat_k)}); "
              f"equal to (a): {bool(t.equal(got, self.bf16_got))}",
              flush=True)
        # (c) Refinement (tests/test_rslqr_em.py:113-132's contract: 8
        # steps on the bf16 factorization reach 1e-8 at N=256), on 4 f64
        # instances of a seeded random problem (nx=6, nu=3); on the
        # BASELINE batch's, reported: both packages contract more slowly
        # on the double integrator at this depth (ROADMAP C9).
        prob = pt.random_problem(t.Generator().manual_seed(0), N_MAIN, n, m,
                                 dtype=t.float64, device=self.dev)
        cases = (("random nx=6 nu=3", pt.batch_problems(
            prob, 4, t.Generator().manual_seed(1)), True),
                 ("BASELINE batch", b.map(lambda x: x[:4]).to(
                     dtype=t.float64), False))
        for label, b64, gated in cases:
            ric = pt.solve_riccati(b64).kkt_vector()
            kkt = pt.solve_refined(b64, iterations=8,
                                   options=bf).kkt_vector()
            raw = pt.solve_kkt(b64.to(dtype=t.float32), options=bf).double()
            res = float(pt.kkt_residual(b64, kkt).max())
            res0 = float(pt.kkt_residual(b64, raw).max())
            e_r = float((kkt - ric).abs().max())
            bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
            if gated:
                self.check(res < 1e-8 and e_r <= bar64,
                           f"bf16 refined {label}: residual {res:.3e} (bar "
                           f"1e-8), vs f64 Riccati {e_r:.3e} (bar "
                           f"{bar64:.3e})")
            print(f"phase3i (c) solve_refined(8 iterations, bf16 slabs) "
                  f"{label} N={N_MAIN} B=4 f64: kkt_residual={res:.3e} "
                  f"(raw bf16 solve {res0:.3e}; "
                  f"{'bar 1e-8' if gated else 'reported'}) "
                  f"err_vs_f64_riccati={e_r:.3e} (bar {bar64:.3e})",
                  flush=True)
        # (d) The quadruped: bf16 slabs take the plain mid-block update.
        qb = self.quad_problem(t.float32)
        q32 = getattr(self, "quad_got", None)
        if q32 is None:
            q32 = pt.solve_kkt(qb)
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        self.reset_hand_launches()
        sol = pt.solve(qb, options=bf)
        t.cuda.synchronize()
        counts = self.hand_launches()
        peak = t.cuda.max_memory_allocated()
        got = sol.kkt_vector()
        want = {"pchol": QN.bit_length() - 1,
                "pcho_solve": self.launches.get("pcho_solve", 45)}
        self.check(counts.get("schur3_update_planes", 0) == 0
                   and counts.get("schur3_update_levels", 0) == 0
                   and all(counts.get(k, 0) == v for k, v in want.items())
                   and bool(t.isfinite(got).all()),
                   f"bf16 quadruped: launches {counts} (want no B9 and "
                   f"{want})")
        dts = {x.dtype for x in sol.fact.Fxs}
        self.check(dts == {t.bfloat16}, f"bf16 quadruped: slabs {dts}")
        res = max(float(pt.kkt_residual(qb.map(lambda x: x[i]), got[i]))
                  for i in range(2))
        scale = max(float(got[:2].abs().max()), 1.0)
        print(f"phase3i (d) bf16 quadruped N={QN} B={QB}: launches "
              f"{json.dumps(counts)}; rel KKT residual {res / scale:.3e}, "
              f"rel diff vs f32 slabs {rel_err(got, q32):.3e}; peak device "
              f"memory {peak / 2**30:.2f} GiB (f32 slabs: phase 3b)",
              flush=True)
        self.bf16_quad = (qb, got)

    def storage_checks(self):
        """(f) ``factor_dtype`` names other than bf16 on phase 3's N=256
        f32 batch: ``"float32"`` is the default solve bit for bit;
        ``"float16"`` and ``"float64"`` take the plain single-level
        schedule (``rslqr_em._kernel_schedule``; the kernels take f32 and
        bf16 slabs): no launch of B1-B4 or B10-B12, equal to their
        ``kernels="off"`` solves within SLICE_BAR; their distance to the f32
        solve and to the f64 Riccati solve (16 instances) reported."""
        t, pt = self.torch, self.pt
        b = self.main_batch
        sub64 = b.map(lambda x: x[:16]).to(dtype=t.float64)
        ric = pt.solve_riccati(sub64).kkt_vector()
        same = pt.solve_kkt(b, options=pt.SolveOptions(factor_dtype="float32"))
        self.check(bool(t.equal(same, self.main_got)),
                   "factor_dtype float32: not the default solve bit for bit")
        for name in ("float16", "float64"):
            self.reset_hand_launches()
            sol = pt.solve(b, options=pt.SolveOptions(factor_dtype=name))
            t.cuda.synchronize()
            counts = self.hand_launches()
            sweep = {k: v for k, v in counts.items()
                     if k in self.schur.launch_counts()
                     or k in self.flat.launch_counts()}
            got = sol.kkt_vector()
            dts = {x.dtype for F in (sol.fact.Fls, sol.fact.Fxs, sol.fact.Fus)
                   for x in F}
            off = pt.solve_kkt(b, options=pt.SolveOptions(
                factor_dtype=name, kernels="off"))
            d_off = rel_err(got, off)
            self.check(not sweep and dts == {getattr(t, name)}
                       and bool(t.isfinite(got).all()) and d_off <= SLICE_BAR,
                       f"factor_dtype {name}: launches {counts}, slabs {dts},"
                       f" rel diff vs off {d_off:.3e}")
            print(f"phase3i (f) factor_dtype={name} N={N_MAIN} B={BATCH}: "
                  f"hand launches {json.dumps(counts)}; slabs "
                  f"{sorted(map(str, dts))}; rel_diff_vs_off={d_off:.3e} "
                  f"(bar {SLICE_BAR}); vs the f32 solve "
                  f"{rel_err(got, self.main_got):.3e}, err_vs_f64_riccati="
                  f"{rel_err(got[:16].double(), ric):.3e} (reported)",
                  flush=True)

    # -- phase 3j --------------------------------------------------------
    def wide_pscan_checks(self):
        """The parallel scan at a mid block past 36 (nx=48, nu=16, N=64,
        B=64 in one batch, f32), where B8 runs its wide instantiations:
        their launches, agreement with ``kernels="off"``, and the f64 plain
        scan of 4 instances against the f64 Riccati oracle; then B8 against
        its twin at each (n, widths, plane) the scan launched it at, on
        fresh inputs, at KERNEL_BAR."""
        t, pt, pl = self.torch, self.pt, self.planes
        off = pt.SolveOptions(kernels="off")
        prob = pt.random_problem(t.Generator().manual_seed(4), WN, WX, WU,
                                 device=self.dev)
        b = pt.batch_problems(prob, WB, t.Generator().manual_seed(5))
        self.reset_hand_launches()
        got = pt.solve_pscan_kkt(b)
        t.cuda.synchronize()
        counts = self.hand_launches()
        wide = pl.wide_launches()
        launched = dict(pl.plu_solve_multi.shape_launches)
        shapes = {f"n={k[0]} w={k[1]} plane={k[2]}": v
                  for k, v in launched.items()}
        self.launches["plu_wide"] = wide
        ref = pt.solve_pscan_kkt(b, options=off)
        d_off = rel_err(got, ref)
        sub64 = b.map(lambda x: x[:4]).to(dtype=t.float64)
        ric = pt.solve_riccati(sub64).kkt_vector()
        f64 = pt.solve_pscan_kkt(sub64, options=off)
        e64 = float((f64 - ric).abs().max())
        bar64 = F64_BAR * (1.0 + float(ric.abs().max()))
        self.check(wide > 0, f"pscan nx={WX}: B8's wide instantiations "
                             f"launched no time ({shapes})")
        self.check(tuple(got.shape) == (WB, b.nvars)
                   and bool(t.isfinite(got).all()) and d_off <= QUAD_SLICE_BAR,
                   f"pscan nx={WX}: shape {tuple(got.shape)}, rel diff vs "
                   f"off {d_off:.3e}")
        self.check(e64 <= bar64, f"pscan nx={WX}: f64 plain vs f64 Riccati "
                                 f"{e64:.3e} > {bar64:.3e}")
        print(f"phase3j pscan N={WN} B={WB} nx={WX} nu={WU} f32: launches "
              f"{json.dumps(counts)}; plu_solve_multi by (n, widths, plane): "
              f"{json.dumps(shapes)}; wide {wide}; rel_diff_vs_off="
              f"{d_off:.3e} (bar {QUAD_SLICE_BAR}); f64_plain_vs_riccati="
              f"{e64:.3e} (bar {bar64:.3e})", flush=True)
        for n, ws, plane in launched:
            name, case, fn, args, ops, lib, moved = self.plu_case(n, ws,
                                                                  plane)
            self.compare(name, case + " (as pscan nx=48 launches it)", fn,
                         args, {}, ops, lib, moved, phase="phase3j")

    @staticmethod
    def bf16_ulps(a, b):
        """Per-element distance of two bf16 tensors in units in the last
        place (their bit patterns on one ordered integer line)."""
        import torch

        def key(x):
            v = x.contiguous().view(torch.int16).to(torch.int32)
            return torch.where(v >= 0, v, -(v + 32768))

        return (key(a) - key(b)).abs()

    def bf16_compare(self, name, case, fn, args, kwargs, ops, moved,
                     exact_args=None, one_rounding=True, library=None,
                     f32=None):
        """bf16 slabs: kernel vs plain on clones of ``args``. The bf16
        outputs: the share of elements that differ (rounding flips of f32
        values that differ by summation order) at most 0.1%, their
        distance in ulps reported, and where each output is rounded once
        (``one_rounding``; B4's rounded multiplier feeds its second level)
        each element within one ulp at its magnitude or the kernel bar,
        and the f32 outputs within the kernel bar; on ``exact_args``,
        inputs whose every sum is exact in f32, bit for bit. Single and
        chained ms against the bound of ``moved`` bytes; ``library``:
        ``(fn, args)`` of one PyTorch call on bf16 operands, timed single
        and chained beside it; ``f32``: ``(args, kwargs)`` of the same
        kernel on f32 slabs, whose chained time is taken in turns with the
        bf16 one (f32, bf16, bf16, f32)."""
        t = self.torch

        def run(a, **kw):
            out = fn(*clone_args(a), **kw, **kwargs)
            res = []
            for o in out:
                res.extend(o if isinstance(o, (list, tuple)) else
                           ([] if o is None else [o]))
            return res

        k, p = run(args), run(args, kernels="off")
        t.cuda.synchronize()
        ulp, flips, total, err, scale, within = 0, 0, 0, 0.0, 1.0, True
        ok = len(k) == len(p)
        for a, b in zip(k, p):
            ok = ok and a.dtype == b.dtype and bool(t.isfinite(a).all())
            if a.dtype == t.bfloat16:
                d = self.bf16_ulps(a, b)
                ulp = max(ulp, int(d.max()))
                flips += int((d > 0).sum())
                total += d.numel()
                # A rounding flip moves an element by one ulp at its own
                # magnitude; where the update cancels, the f32 sums' own
                # order noise (the kernel bar, absolute) is the larger.
                af, bf = a.float(), b.float()
                one = t.ldexp(t.ones_like(bf), t.frexp(bf)[1] - 8)
                within = within and bool(((af - bf).abs() <= t.maximum(
                    one, KERNEL_BAR * (1.0 + bf.abs().max()))).all())
            else:
                err = max(err, float((a - b).abs().max()))
                scale = max(scale, 1.0 + float(b.abs().max()))
        share = flips / max(total, 1)
        ok = ok and share <= 1e-3 and ((within and err <= KERNEL_BAR * scale)
                                       or not one_rounding)
        self.check(ok, f"bf16 {name} {case}: {share:.2e} of the elements "
                       f"differ, each within one ulp or the kernel bar: "
                       f"{within}; f32 outputs {err:.3e}")
        exact = None
        if exact_args is not None:
            ke, pe = run(exact_args), run(exact_args, kernels="off")
            exact = all(bool(t.equal(a, b)) for a, b in zip(ke, pe))
            self.check(exact, f"bf16 {name} {case}: exact inputs not bit "
                              f"for bit")
        bound_ms, bound_by = bound(moved, ops)
        ms = self.time_call(lambda *a: fn(*a, **kwargs),
                            lambda: clone_args(args))
        plain_ms = self.time_call(lambda *a: fn(*a, kernels="off", **kwargs),
                                  lambda: clone_args(args))
        a = clone_args(args)
        ch = self.chained(lambda: fn(*a, **kwargs))
        lib_ms = lib_ch = None
        if library is not None:
            lib_fn, lib_args = library
            lib_ms = self.time_call(lib_fn, lambda: lib_args)
            lib_ch = self.chained(lambda: lib_fn(*lib_args))
        turns = ""
        f32_ch = None
        if f32 is not None:
            a32 = clone_args(f32[0])
            call32 = lambda: fn(*a32, **f32[1])
            t32 = [self.chained(call32)]
            t16 = [self.chained(lambda: fn(*a, **kwargs)) for _ in range(2)]
            t32.append(self.chained(call32))
            f32_ch = min(t32)
            ch = min([ch] + t16)
            turns = (f" in turns: f32 chained_ms {t32[0]:.4f}, "
                     f"{t32[1]:.4f}; bf16 {t16[0]:.4f}, {t16[1]:.4f}"
                     f" (f32/bf16 {f32_ch / ch:.2f}x)")
        fmt = lambda x: x if x is None else f"{x:.4f}"
        print(f"phase3i (e) bf16 {name} {case}: {share:.2e} of {total} "
              f"bf16 elements differ ({ulp} ulp max; each within one ulp at "
              f"its magnitude or the kernel bar: {within}), f32 outputs "
              f"max_abs_err="
              f"{err:.3e} (bar {KERNEL_BAR} x {scale:.3e}), exact inputs "
              f"bit for bit: {exact}; kernel_ms={ms:.4f} chained_ms="
              f"{ch:.4f} plain_ms={plain_ms:.4f} library_ms={fmt(lib_ms)} "
              f"library_chained_ms={fmt(lib_ch)} bound_ms={bound_ms:.4f} "
              f"({bound_by}: {moved / 1e9:.3f} GB) chained_x_bound="
              f"{ch / bound_ms:.2f}{turns}", flush=True)
        self.bf16_stats.setdefault(name, {
            "case": case, "ms": ms, "chained_ms": ch, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_ulp": ulp,
            "ulp_share": share, "library_ms": lib_ms,
            "library_chained_ms": lib_ch, "f32_chained_ms": f32_ch,
            **({"source": BF16_SOURCES[name]} if name in BF16_SOURCES
               else {})})

    def exact(self, *shape, scale=1.0, dtype=None):
        """Inputs on which the kernels' f32 sums are exact: small integers
        times ``scale`` (a power of two), on the card."""
        t = self.torch
        x = t.randint(-4, 5, shape, generator=self.gen).to(t.float32) * scale
        return x.to(device=self.dev, dtype=dtype or t.float32)

    def bf16_kernel_cases(self):
        """(e) B1-B4 with bf16 slabs at phase 2's shapes: against their
        plain versions, timed single and chained, with bounds from the
        bf16 byte counts."""
        t, s = self.torch, self.schur
        bf = t.bfloat16
        N, B = N_MAIN, BATCH
        depth = N.bit_length() - 1

        def slabs(args, k):
            """The first ``k`` argument groups (the slabs) in bf16."""
            conv = lambda x: x.to(bf)
            return [[conv(x) for x in a] if isinstance(a, list) else conv(a)
                    for a in args[:k]] + list(args[k:])

        def exact_like(args, k, lead=()):
            """Exact-arithmetic inputs of the same shapes: slabs and
            problem data integers in -4..4, separators eighths."""
            E = self.exact
            out = []
            for i, a in enumerate(args):
                sc = 1.0 if i < k or i in lead else 0.125
                mk = lambda x: None if x is None else E(*x.shape, scale=sc)
                out.append([mk(x) for x in a] if isinstance(a, list)
                           else mk(a))
            return slabs(out, k) if k else out

        # B3: problem data in, bf16 slabs out.
        args = [self.rand(nn, N, B), self.rand(n * m, N, B, scale=0.2),
                self.pos(n, N, B), self.pos(m, N, B), self.rand(N // 2, nn, B),
                [self.rand(N // 2, nn, B, scale=0.1)
                 for _ in range(depth - 1)],
                self.rand(N // 4, nn, B), self.rand(N // 4, n * m, B)]
        ex = exact_like(args, 0, lead=(0, 1, 4, 6, 7))
        ex[2] = t.full_like(ex[2], 0.5)
        ex[3] = t.full_like(ex[3], 0.25)
        U = depth - 1
        self.bf16_compare(
            "leaf_schur_level0_em", f"N={N} B={B}", s.leaf_schur_level0_em,
            args, dict(depth=depth, n=n, m=m, factor_dtype="bfloat16"),
            sweep_ops(N, B, 0, U, U, N // 4),
            4 * (sum(x.numel() for x in tensors(args)) + U * (N // 4) * nn
                 * B) + 2 * depth * (2 * nn + mn) * N * B,
            exact_args=ex, f32=(args, dict(depth=depth, n=n, m=m)))
        # B2 at level 0: bf16 slabs in, f32 z vectors updated.
        G = N >> 1
        args = [self.rand(nn, N, B), self.rand(nn, N, B), self.rand(mn, N, B),
                self.rand(n, N, B), self.rand(n, N, B), self.rand(m, N, B),
                self.rand(G, n, B, scale=0.1)]
        lib = self.trio_library(
            [x.to(bf) for x in args[:3]], [[z.to(bf)] for z in args[3:6]],
            [args[6].transpose(0, 1).contiguous().to(bf)], 0, N, B)
        self.bf16_compare(
            "rhs_update_level_em", f"N={N} B={B} level=0",
            s.rhs_update_level_em, slabs(args, 3), dict(level=0, n=n, m=m),
            update_ops(n, m, 1, N, B, 0, 1),
            update_moved(n, m, 1, N, B, 0, 1, msize=2),
            exact_args=exact_like(args, 3), library=lib)
        # B4 at level 1 (the main path's first pair, emitting).
        level = 1
        U = depth - level - 1
        args = self.pair_args(N, B, level, dtype=bf)
        emitted = 0 if args[-1] is None else U - 1
        G2, G3 = N >> (level + 2), N >> (level + 3)
        self.bf16_compare(
            "schur_update_pair_em", f"N={N} B={B} level={level}",
            s.schur_update_pair_em, slabs(args, 6), dict(level=level, n=n,
                                                         m=m),
            sweep_ops(N, B, level, U, emitted, G3)
            + update_ops(n, m, n, N, B, level + 1, U - 1),
            update_moved(n, m, n, N, B, level, U, msize=2, csize=2)
            + 2 * B * 2 * U * nn * G2
            + (emit_moved(G3, B, emitted, size=2) if emitted else 0),
            exact_args=exact_like(args, 6), one_rounding=False,
            f32=(args, dict(level=level, n=n, m=m)))
        # B1 at N=128 level 1 (emitting) and level 3 (bf16's last emitting
        # level).
        for level in (1, 3):
            NN = N_ODD
            U = NN.bit_length() - 1 - level - 1
            args = self.level_args(NN, B, level, dtype=bf)
            emitted = 0 if args[-1] is None else U
            G2 = NN >> (level + 2)
            lib = self.trio_library(
                [x.to(bf) for x in args[:3]],
                [[x.to(bf) for x in a] for a in args[3:6]],
                [f.transpose(0, 1).contiguous().to(bf) for f in args[6]],
                level, NN, B)
            self.bf16_compare(
                "schur_update_level_em", f"N={NN} B={B} level={level}",
                s.schur_update_level_em, slabs(args, 6),
                dict(level=level, n=n, m=m),
                sweep_ops(NN, B, level, U, emitted, G2),
                update_moved(n, m, n, NN, B, level, U, msize=2, csize=2)
                + (emit_moved(G2, B, emitted, size=2) if emitted else 0),
                exact_args=exact_like(args, 6), library=lib,
                f32=(self.level_args(NN, B, level),
                     dict(level=level, n=n, m=m)))

    def time_bf16(self, card):
        """Phase 4g: bf16 slabs against f32 slabs, in turns: the em solve
        (N=256, B=1024) and the quadruped (the plain mid-block update)."""
        t, pt = self.torch, self.pt
        bf = pt.SolveOptions(factor_dtype="bfloat16")
        for label, b, reps in (
                (f"em N={N_MAIN} B={BATCH}", self.bf16_batches[N_MAIN], REPS),
                (f"quadruped N={QN} B={QB}", self.bf16_quad[0], 3)):
            self.turns(card, f"phase4g bf16 slabs {label}", {
                "f32 slabs": lambda b=b: pt.solve_kkt(b),
                "bf16 slabs": lambda b=b: pt.solve_kkt(b, options=bf)},
                reps=reps)

    def time_autodiff(self, card):
        """Phase 4f: forward against forward + backward, in turns, small
        and quadruped (rsLQR and pscan); then each sharded solve's wall
        (ranks sharing the card, median over the rank's repeats, slowest
        rank)."""
        t, pt = self.torch, self.pt
        for label, b, solver in (
                (f"small N={N_MAIN} B={BATCH}", self.main_batch, pt.solve),
                (f"quadruped N={QN} B={QB}", self.quad_batch, pt.solve),
                (f"pscan quadruped N={QN} B={QB}", self.quad_batch,
                 pt.solve_pscan)):
            wX = t.randn(b.q.shape, generator=t.Generator().manual_seed(7),
                         dtype=t.float64).to(device=self.dev,
                                             dtype=b.q.dtype)
            self.turns(card, f"phase4f autodiff {label}", {
                "forward": lambda b=b, solver=solver: solver(b),
                "forward+backward": lambda b=b, wX=wX, solver=solver:
                    self.grads(b, None, wX, solver=solver)})
        print(f"phase4f sharded walls on {card}, ranks sharing one card "
              f"(time-sharing, not scaling): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in self.shard_walls.items())
              + f"; single-device em kernel path and pscan: phase 4, 4c",
              flush=True)

    # -- phase 4e --------------------------------------------------------
    def time_grid(self, card):
        """Median host-clock ms (CUDA-synchronized) of the grid slice, each
        beside its em twin where it has one, in turns: (a) the quadruped
        grid solve and em kernel path, (b) the re-solve through one
        factorization and the full grid solve, (c) large-block rsLQR and
        pscan, f32."""
        t, pt = self.torch, self.pt
        G = pt.SolveOptions(layout="grid")
        b = self.quad_batch
        b2 = self.perturbed(b)
        self.turns(card, f"phase4e (a) quadruped N={QN} B={QB}", {
            "grid": lambda: pt.solve_kkt(b, options=G),
            "em kernels": lambda: pt.solve_kkt(b)})
        fact, _ = pt.factorize(b, options=G)
        self.turns(card, f"phase4e (b) quadruped N={QN} B={QB}", {
            "re-solve": lambda: pt.solve_rhs(
                b2, fact, pt.leaf_solve_rhs(b2), options=G).kkt_vector(),
            "full grid solve": lambda: pt.solve_kkt(b2, options=G)})
        del fact
        b32 = self.large_batch(t.float32)
        self.turns(card, f"phase4e (c) large block N={LN} nx={LX} nu={LU} "
                         f"B={LB} f32", {
            "rslqr": lambda: pt.solve_kkt(b32),
            "pscan": lambda: pt.solve_pscan_kkt(b32)})

    def turns(self, card, label, fns, reps=QREPS):
        """Median wall of each of ``fns`` over ``reps`` rounds, in turns,
        after one warm-up round."""
        t = self.torch
        walls = {k: [] for k in fns}
        for r in range(reps + 1):
            for k, fn in fns.items():
                t.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t.cuda.synchronize()
                if r:
                    walls[k].append(1e3 * (time.perf_counter() - t0))
        print(f"{label} on {card}: " + ", ".join(
            f"{k} {statistics.median(v):.3f} ms (min {min(v):.3f})"
            for k, v in walls.items()) + f"; median of {reps}", flush=True)

    def profile_grid(self):
        """Phase 5's traces of the grid slice: the quadruped grid solve,
        the re-solve through one factorization, and large-block rsLQR and
        pscan (f32)."""
        t, pt = self.torch, self.pt
        G = pt.SolveOptions(layout="grid")
        b = self.quad_batch
        self.profile(b, f"grid quadruped N={QN} B={QB}", self.grid_solve)
        fact, _ = pt.factorize(b, options=G)
        self.profile(self.perturbed(b),
                     f"grid re-solve quadruped N={QN} B={QB}",
                     lambda b2, options=None: pt.solve_rhs(
                         b2, fact, pt.leaf_solve_rhs(b2),
                         options=G).kkt_vector())
        del fact
        b32 = self.large_batch(t.float32)
        self.profile(b32, f"large block rsLQR N={LN} nx={LX} nu={LU} "
                          f"B={LB}")
        self.profile(b32, f"large block pscan N={LN} nx={LX} nu={LU} "
                          f"B={LB}", pt.solve_pscan_kkt)

    # -- phase 5b --------------------------------------------------------
    def profiles(self):
        """``profile_solve`` on the quadruped grid batch and the small em
        batch, printed with ``print_solve_summary``."""
        pt = self.pt
        from rslqr_tpu_torch import profile

        for b, label, opts in (
                (self.quad_batch, f"grid quadruped N={QN} B={QB}",
                 pt.SolveOptions(layout="grid")),
                (self.main_batch, f"em N={N_MAIN} B={BATCH}", None)):
            p = profile.profile_solve(b, repeats=2, options=opts)
            print(f"phase5b profile_solve {label} (device ms, host ms "
                  f"issuing):", flush=True)
            p.print()
            profile.print_solve_summary(p.t_total_ms, problem=b)
            sys.stdout.flush()

    # -- phase 5 ---------------------------------------------------------
    def profile(self, b, label, solve=None, top=14):
        """Device kernel time of one batched solve by kernel name
        (``torch.profiler``, CUDA activity), beside its profiled wall."""
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
        # The solve's stage spans have device copies on the card's
        # timeline: ranges, not kernels.
        dev = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not e.key.startswith("rslqr_tpu_torch.")]
        kernel_ms = sum(e.self_device_time_total for e in dev) / 1e3
        print(f"phase5 {label}: wall {wall:.3f} ms (profiled), device "
              f"kernel time {kernel_ms:.3f} ms summed over kernels, "
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

    # -- phase 7 ---------------------------------------------------------
    def bench_entry(self, bench_torch, card):
        """``bench_torch.main`` with BENCH_REPS=1 and its default families
        (the environment's other BENCH_ variables set aside): exit 0, one
        JSON line with every family's statistics and the card, printed here
        as a line of its own."""
        import contextlib
        import io
        import os

        t = self.torch
        saved = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith("BENCH_")}
        os.environ["BENCH_REPS"] = "1"
        out = io.StringIO()
        t.cuda.empty_cache()
        try:
            with contextlib.redirect_stdout(out):
                rc = bench_torch.main()
        finally:
            del os.environ["BENCH_REPS"]
            os.environ.update(saved)
        lines = out.getvalue().strip().splitlines()
        self.check(rc == 0, f"bench_torch exited with {rc}")
        self.check(len(lines) == 1, f"bench_torch printed {len(lines)} "
                                    f"lines on stdout")
        if not lines:
            return
        print(lines[-1], flush=True)
        rec = json.loads(lines[-1])
        self.check(set(rec) == {"metric", "value", "unit", "detail",
                                "device"} and rec["device"] == card,
                   f"bench_torch line keys {sorted(rec)}, device "
                   f"{rec.get('device')!r}")
        d = rec.get("detail", {})
        for fam in ("pscan", "rslqr", "refine", "rslqr_quadruped",
                    "pscan_quadruped"):
            ms = d.get(fam, {}).get("ms_per_batched_solve", float("nan"))
            self.check(0 < ms < 1e5, f"bench_torch {fam}: {ms} ms")
        print(f"phase7 bench_torch: rc={rc} " + " ".join(
            f"{k}={v['ms_per_batched_solve']:.3f}ms" for k, v in d.items()
            if isinstance(v, dict) and "median" in v), flush=True)

    # -- phase 4 ---------------------------------------------------------
    # -- phase 3k --------------------------------------------------------
    def g1_checks(self):
        """The wide-block slice on the Unitree G1 config, one batch of the
        benchmark cell's size: the route (element-major, hand kernels
        only, every plane launch wide), peak memory, agreement with
        ``kernels="off"``, the f32 error against the f64 Riccati oracle
        of 4 instances and the relative KKT residual."""
        t, pt = self.torch, self.pt
        from rslqr_tpu_torch import linalg, spans

        prob = pt.random_problem(t.Generator().manual_seed(GX), GN, GX, GU,
                                 dtype=t.float64, device=self.dev)
        b = pt.batch_problems(prob, GB, t.Generator().manual_seed(GU)).to(
            dtype=t.float32)
        pt.solve_kkt(b)  # warm-up
        t.cuda.synchronize()
        routes = []
        real = linalg._mid
        linalg._mid = lambda *a, **k: routes.append(real(*a, **k)) or \
            routes[-1]
        try:
            self.reset_hand_launches()
            wide0 = spans.counters()["wide_launches"]
            t.cuda.reset_peak_memory_stats()
            sol = pt.solve(b)
            got = sol.kkt_vector()
            t.cuda.synchronize()
        finally:
            linalg._mid = real
        peak = t.cuda.max_memory_allocated()
        counts = self.hand_launches()
        wide = spans.counters()["wide_launches"] - wide0
        plane = sum(counts.get(k, 0) for k in RSLQR_MID)
        for k in RSLQR_MID:
            self.check(counts.get(k, 0) > 0,
                       f"g1: {k} launched no time on the G1 path")
        self.check(isinstance(sol.fact, pt.EmFactorization),
                   f"g1: took {type(sol.fact).__name__}, not the "
                   f"element-major path")
        kinds = set(counts) - {"schur3_update_levels_pairs"}
        self.check(wide == plane and kinds <= set(RSLQR_MID),
                   f"g1: {wide} wide launches of {plane}; launches "
                   f"{json.dumps(counts)}")
        self.check(linalg.MAT_LAST not in routes,
                   f"g1: {routes.count(linalg.MAT_LAST)} linalg ops on the "
                   f"mat-last route")
        print(f"phase3k launches N={GN} B={GB} nx={GX} nu={GU}: "
              f"{json.dumps(counts)} wide_launches={wide}; linalg routes "
              f"{json.dumps(collections.Counter(map(str, routes)))}; peak "
              f"device memory {peak / 2**30:.2f} GiB", flush=True)
        self.check(bool(t.isfinite(got).all()), "g1: non-finite")
        del sol  # its factorization: ~30 GB of slabs
        t.cuda.empty_cache()
        ref = pt.solve_kkt(b, options=pt.SolveOptions(kernels="off"))
        d_off = rel_err(got, ref)
        self.check(d_off <= QUAD_SLICE_BAR,
                   f"g1: kernel vs plain rel diff {d_off:.3e}")
        sub64 = b.map(lambda x: x[:4]).to(dtype=t.float64)
        ric = pt.solve_riccati(sub64).kkt_vector()
        e_k = rel_err(got[:4].double(), ric)
        e_p = rel_err(ref[:4].double(), ric)
        self.check(e_k <= 2.0 * e_p + 1e-6,
                   f"g1: f32 kernel err vs f64 Riccati {e_k:.3e} > 2 x "
                   f"plain {e_p:.3e} + 1e-6")
        res = max(float(pt.kkt_residual(b.map(lambda x: x[i]), got[i]))
                  for i in range(2))
        scale = max(float(got[:2].abs().max()), 1.0)
        self.check(res / scale <= QUAD_RESIDUAL_BAR,
                   f"g1: relative KKT residual {res / scale:.3e}")
        print(f"phase3k slice N={GN} B={GB} f32: rel_diff_vs_off={d_off:.3e} "
              f"(bar {QUAD_SLICE_BAR}) err_vs_f64_riccati={e_k:.3e} (plain "
              f"{e_p:.3e}) kkt_residual={res:.4e} rel={res / scale:.3e} "
              f"(bar {QUAD_RESIDUAL_BAR}) max|x|={scale:.4e}", flush=True)
        self.g1_batch = b

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

        import bench_torch
        import rslqr_tpu_torch as pt
        from rslqr_tpu_torch.bench_kernels import device_name
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

    card = device_name(dev)
    print(card, flush=True)
    # One compile of every source, with ptxas's report of each kernel.
    reports = {}
    t0 = time.perf_counter()
    lib = _build.build(extra_flags=("-Xptxas", "-v"), reports=reports)
    build_s = time.perf_counter() - t0
    ptxas = [line for name in ("schur_kernels.cu", "flat_kernels.cu",
                               "bf16_kernels.cu")
             for line in small_ptxas(_build, reports[name])]
    ptxas += plu_ptxas(_build, reports["plu_kernels.cu"])
    ptxas += rows_ptxas(_build, reports["planes_kernels.cu"])
    ptxas += chol_ptxas(_build, reports["planes_kernels.cu"],
                        _build.sass_counts(lib))
    ptxas += probe_ptxas(_build, reports["probe_kernels.cu"])
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
        ("phase2g", smoke.c8_cases),
        ("phase2h", smoke.levels_cases),
        ("phase2i", smoke.wide_cases),
        ("phase3", smoke.slice_checks),
        ("phase3b", smoke.quad_checks),
        ("phase3c", smoke.pscan_checks),
        ("phase3d", smoke.flat_checks),
        ("phase3e", smoke.block_solves),
        ("phase3f", smoke.grid_checks),
        ("phase3g", smoke.autodiff_checks),
        ("phase3h", smoke.sharded_checks),
        ("phase3i", lambda: (smoke.bf16_checks(),
                             smoke.bf16_kernel_cases(),
                             smoke.storage_checks())),
        ("phase3j", smoke.wide_pscan_checks),
        ("phase3k", smoke.g1_checks),
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
        ("phase4e", lambda: smoke.time_grid(card)),
        ("phase4h", lambda: smoke.time_solves(
            card, smoke.g1_batch, QREPS,
            f"phase4h G1 N={GN} nx={GX} nu={GU}")),
        ("phase4f", lambda: smoke.time_autodiff(card)),
        ("phase4g", lambda: smoke.time_bf16(card)),
        ("phase5", lambda: (
            smoke.profile(smoke.main_batch, f"N={N_MAIN} B={BATCH}"),
            smoke.profile(smoke.quad_batch, f"quadruped N={QN} B={QB}"),
            smoke.profile(smoke.quad_batch, f"pscan quadruped N={QN} B={QB}",
                          pt.solve_pscan_kkt),
            smoke.profile(smoke.main_batch, f"flat N={N_MAIN} B={BATCH}",
                          smoke.flat_solve),
            smoke.profile(smoke.bf16_batches[N_MAIN],
                          f"bf16 slabs N={N_MAIN} B={BATCH}",
                          lambda b: pt.solve_kkt(b, options=pt.SolveOptions(
                              factor_dtype="bfloat16"))),
            smoke.profile(smoke.main_batch64,
                          f"refined flat (2 iterations, f64) N={N_MAIN} "
                          f"B={BATCH}", smoke.refined_solve),
            smoke.profile_grid())),
        ("phase5b", smoke.profiles),
        ("phase6", smoke.bench_sections),
        ("phase6b", smoke.probe_entry),
        ("phase7", lambda: smoke.bench_entry(bench_torch, card)),
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
         "backward_launches": smoke.bwd_launches.get(name, 0),
         **{k: st[k] for k in ("em_twin_ms", "chained_ms",
                               "library_chained_ms", "turns_ms") if k in st},
         **({"bf16": {**smoke.bf16_stats[name],
                      "launches": smoke.bf16_launches.get(name)}}
            if name in smoke.bf16_stats else {})}
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
