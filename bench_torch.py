#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: batched LQR solves/s, one GPU.

    python3 bench_torch.py

Counterpart of ``bench.py`` (the JAX package's bench, which stays as it is)
for ``rslqr_tpu_torch``, with bench.py's names, so that each piece finds its
counterpart there. Prints ONE JSON line on stdout: ``{"metric", "value",
"unit", "detail", "device"}``. ``value`` is the median solves/s of the
fastest family of the main config, ``detail`` carries every family's
statistics (mean/std/min/median/max solves/s, the reference's kNruns
statistics, sample_problem_test.c:47-67) and the gates' numbers, and
``device`` the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them. There is
no ``vs_baseline``: bench.py's 10,000 solves/s is the target set for the
TPU framework (BASELINE.md, "Targets for the new TPU-native framework"),
and no TPU number is a baseline for the port. Logs go to stderr.

Families (``BENCH_SOLVER``):

* ``rslqr``, ``pscan`` and ``refine`` on the main config, the double
  integrator at N=256 perturbed into B=1024 instances, f32; ``refine`` is
  ``solve_refined`` with 2 iterations and an f32 factor; ``flat``
  (``SolveOptions(flat_planes=True)``) is opt-in. bench.py's ``rslqr_grid``
  has no counterpart (the port has no grid path), nor has its golden-file
  batch (the file is absent).
* ``rslqr`` and ``pscan`` on the quadruped config, ``random_problem`` at
  N=512, nx=36, nu=12, 256 scenarios in ONE batch (``chunk: 256``: JAX ran
  chunks of 128 to fit a TPU's memory; the whole batch fits the H100).

Timing is bench.py's chain (:func:`_chained`): iteration i of K solves adds
``s * 1e-38`` to ``Qdiag``, s the sum of iteration i-1's KKT vectors, and
every stage reads ``Qdiag``, so nothing can be hoisted out of the chain.
The per-solve time is the finite difference (t(K2) - t(K1)) / (K2 - K1),
K1=1, K2=9 (3 on the quadruped), each chain run eagerly and the clock read
only after ``torch.cuda.synchronize()`` (``method: "finite_diff"``).
``compile_first_s`` is a chain's first call; the first family's includes
the kernel build when the library is not built yet.

Gates (the line is printed, then the run exits 1 if one failed; a family
that raises ends the run with its traceback):

* refined f64 (:func:`accuracy_gate`): ``solve_refined_host`` and
  ``solve_refined_device``, 3 iterations on ``double_integrator_problem``
  in f64, each reach a KKT residual below 1e-6 and lie within
  1e-6 (1 + max|ref|) of the port's f64 ``solve_riccati`` (in place of
  bench.py's golden file); then the throughput of ``refined_kkt_device`` on
  the main batch;
* quadruped (:func:`quadruped_accuracy_gate`), on a sub-batch of 128: each
  family's relative KKT residual is below 3e-2, rsLQR and pscan agree
  within 3e-3 (bench.py:321-322).

Env knobs (bench.py's): BENCH_BATCH (1024), BENCH_HORIZON (256),
BENCH_REPS (5), BENCH_SOLVER (comma list of pscan|rslqr|refine|flat,
"all" = pscan+rslqr+refine+quadruped, "both" = pscan+rslqr only),
BENCH_K1/BENCH_K2 (1/9), BENCH_CONFIG=quadruped (quadruped only),
BENCH_QUAD_BATCH (256), BENCH_QUAD_HORIZON (512), BENCH_FACTOR_DTYPE
("" or "bfloat16": bf16 factor slabs, ``SolveOptions.factor_dtype``, in
every family and in the refined gates, as bench.py:60-63 sets the JAX
package's global config; ``refined_kkt_device`` ignores its options, C4;
no default run sets it). bench.py's chunking knobs have no counterpart:
every family runs its batch as one. The gates always run, and the
refinement takes 3 iterations.

Needs a card: :func:`main` exits 2 without one. The functions take an
explicit ``device``, so that the tests run them on the CPU.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

import rslqr_tpu_torch as rt
from rslqr_tpu_torch import pscan, refine, rslqr
from rslqr_tpu_torch.bench_kernels import device_name

def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _options(**kw) -> rt.SolveOptions:
    """The families' options, with ``BENCH_FACTOR_DTYPE`` read at each
    call."""
    return rt.SolveOptions(
        factor_dtype=os.environ.get("BENCH_FACTOR_DTYPE", ""), **kw)


def _rslqr_kkt(p):
    return rslqr.solve_kkt(p, options=_options())


def _refine_kkt(p):
    sol = refine.solve_refined(p, iterations=2, solve_dtype=torch.float32,
                               options=_options())
    return sol.kkt_vector()


def _flat_kkt(p):
    return rslqr.solve_kkt(p, options=_options(flat_planes=True))


SOLVERS = {
    "pscan": pscan.solve_pscan_kkt,
    "rslqr": _rslqr_kkt,
    "refine": _refine_kkt,
    "flat": _flat_kkt,
}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _release(device):
    """Return the cached blocks of the last family to the card, so that the
    next one (the quadruped's ~18 GiB) starts from an empty pool."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _chained(kkt_fn, K):
    """Runner of K sequentially dependent solves (bench.py's ``_chained``),
    returning the sum of their KKT vectors' sums.

    The dependence goes through ``Qdiag`` (not x0), which every stage of
    every family reads: iteration i solves with ``Qdiag + eps``, where eps
    is 1e-38 times iteration i-1's sum, noise below f32 resolution that
    still makes each solve wait for the one before.
    """

    def run(b):
        eps = acc = torch.zeros((), dtype=b.x0.dtype, device=b.x0.device)
        for _ in range(K):
            s = kkt_fn(dataclasses.replace(b, Qdiag=b.Qdiag + eps)).sum()
            eps, acc = s * 1e-38, acc + s
        return acc

    return run


def _time_stats(fn, batch, reps, label, device):
    """Run ``fn`` reps times; returns (per-rep seconds, first-call seconds).
    Each time is a host clock read after synchronizing the device; one
    warm-up run (dropped) follows the first call."""

    def timed():
        _sync(device)
        t0 = time.perf_counter()
        fn(batch)
        _sync(device)
        return time.perf_counter() - t0

    compile_s = timed()
    log(f"[bench] {label}: compile+first={compile_s:.1f}s")
    log(f"[bench] {label}: warmup {1e3 * timed():.1f}ms (dropped)")
    times = [timed() for _ in range(reps)]
    med = sorted(times)[len(times) // 2]
    log(f"[bench] {label}: best {min(times) * 1e3:.1f}ms median "
        f"{med * 1e3:.1f}ms reps={[round(t * 1e3, 1) for t in times]}ms")
    return times, compile_s


def time_solver(name, kkt_fn, batch, batch_size, reps, device,
                k2_default=9):
    """Per-family throughput statistics by the finite-difference method
    (bench.py's ``time_solver``): per-solve time for rep i =
    (t2_i - median(t1)) / (K2 - K1), so std reflects the run-to-run
    variance of the long chain."""
    k1 = int(os.environ.get("BENCH_K1", "1"))
    k2 = int(os.environ.get("BENCH_K2", str(k2_default)))
    if not 0 < k1 < k2:
        raise ValueError(f"BENCH_K1 < BENCH_K2 needed, got {k1}, {k2}")
    t1s, c1 = _time_stats(_chained(kkt_fn, k1), batch, reps,
                          f"{name} K={k1}", device)
    t2s, c2 = _time_stats(_chained(kkt_fn, k2), batch, reps,
                          f"{name} K={k2}", device)
    t1_med = sorted(t1s)[len(t1s) // 2]
    per = []
    for t2 in t2s:
        ps = (t2 - t1_med) / (k2 - k1)
        if ps <= 0.25 * t2 / k2:
            ps = t2 / k2  # host noise swamped the difference
        per.append(ps)
    per_sorted = sorted(per)
    sps = [batch_size / p for p in per]
    mean = sum(sps) / len(sps)
    std = (sum((s - mean) ** 2 for s in sps) / len(sps)) ** 0.5
    out = {
        "mean": mean,
        "std": std,
        "min": min(sps),
        "median": batch_size / per_sorted[len(per_sorted) // 2],
        "max": max(sps),
        "best": max(sps),
        "ms_per_batched_solve": per_sorted[len(per_sorted) // 2] * 1e3,
        "compile_first_s": c1,
        "compile_first_k2_s": c2,
        "method": "finite_diff",
        "rep_ms": [1e3 * t for t in t2s],
    }
    log(f"[bench] {name}: {out['ms_per_batched_solve']:.3f} ms/batched-solve"
        f" (median, diff method) -> {out['median']:,.0f} solves/s (mean "
        f"{mean:,.0f} +- {std:,.0f})")
    return out


ACCURACY_BAR = 1e-6  # the reference's assertion (sample_problem_test.c:150)
REFINE_F64_ITERS = 3


def accuracy_gate(results, batch, batch_size, nhorizon, reps, device):
    """The f64-accurate paths on the card, gated (bench.py's
    ``accuracy_gate``): ``solve_refined_host`` (host f64 residuals) and
    ``solve_refined_device`` (device f64 residuals) on the double
    integrator in f64, each held to a KKT residual below 1e-6 and to
    1e-6 (1 + max|ref|) of the port's f64 Riccati solve; then the
    throughput of ``refined_kkt_device`` on the main batch. Returns False
    if a bar fails."""
    prob64 = rt.double_integrator_problem(nhorizon, dtype=torch.float64,
                                          device=device)
    iters = REFINE_F64_ITERS
    ref = rt.solve_riccati(prob64).kkt_vector().cpu().numpy()
    bar = ACCURACY_BAR * (1.0 + float(np.max(np.abs(ref))))
    ok = True
    for key, solve in (("refined_f64", refine.solve_refined_host),
                       ("refined_f64_device", refine.solve_refined_device)):
        kkt, res = solve(prob64, iterations=iters, options=_options())
        dr = float(np.max(np.abs(kkt - ref)))
        results[f"{key}_residual"] = res
        results[f"{key}_vs_riccati"] = dr
        log(f"[bench] {key} ({iters} iters) KKT residual: {res:.3e}, max "
            f"|kkt - riccati|: {dr:.3e} (bar {bar:.3e})")
        ok = ok and res < ACCURACY_BAR and dr <= bar

    def run_kkt(b):
        hi, lo, res = refine.refined_kkt_device(b, iterations=iters)
        return hi.sum() + lo.sum() + res

    times, compile_s = _time_stats(run_kkt, batch, min(reps, 3),
                                   "refined_f64_device", device)
    med = sorted(times)[len(times) // 2]
    results["refined_f64_solves_per_s"] = batch_size / med
    results["refined_f64_detail"] = {
        "ms_per_batched_solve": med * 1e3,
        "compile_first_s": compile_s,
        "method": "wall_clock_device_f64",
        "rep_ms": [1e3 * t for t in times],
    }
    log(f"[bench] refined_f64_device: {batch_size / med:,.0f} solves/s "
        f"(wall)")
    if not ok:
        log(f"[bench] ACCURACY GATE FAILED: bar {ACCURACY_BAR}")
    return ok


def _main_batch(nhorizon, batch_size, device):
    prob = rt.double_integrator_problem(nhorizon, dtype=torch.float32,
                                        device=device)
    return rt.batch_problems(prob, batch_size,
                             torch.Generator().manual_seed(0))


# f32 quadruped bars (bench.py:321-322).
QUAD_RESIDUAL_BAR = 3e-2   # relative max-norm KKT residual
QUAD_AGREE_BAR = 3e-3      # relative max-norm rslqr vs pscan difference


def quadruped_accuracy_gate(results, qbatch, quad_names):
    """f32 KKT residuals of each family and their agreement on one
    sub-batch of 128 scenarios (bench.py's ``quadruped_accuracy_gate``),
    gated with its relative bars. Returns False if a bar fails."""
    gb = min(128, qbatch.x0.shape[0])
    sub = qbatch.map(lambda x: x[:gb])
    outs = {name: SOLVERS[name](sub) for name in quad_names}
    scale = max(float(out.abs().max()) for out in outs.values())
    ok = True
    for name, out in outs.items():
        res = max(float(rt.kkt_residual(sub.map(lambda x: x[i]), out[i]))
                  for i in range(min(2, gb)))
        rel = res / max(scale, 1.0)
        results[f"{name}_quadruped_kkt_residual"] = res
        results[f"{name}_quadruped_kkt_residual_rel"] = rel
        log(f"[bench] {name} quadruped f32 KKT residual: {res:.3e} (rel "
            f"{rel:.3e})")
        ok = ok and rel < QUAD_RESIDUAL_BAR
    if len(outs) == 2:
        a, b = (outs[n] for n in quad_names)
        diff = float((a - b).abs().max())
        rel = diff / max(scale, 1.0)
        results["rslqr_vs_pscan_quadruped_max_diff"] = diff
        results["rslqr_vs_pscan_quadruped_max_diff_rel"] = rel
        log(f"[bench] quadruped rslqr vs pscan max diff: {diff:.3e} (rel "
            f"{rel:.3e})")
        ok = ok and rel < QUAD_AGREE_BAR
    if not ok:
        log(f"[bench] QUADRUPED ACCURACY GATE FAILED (bars: residual "
            f"{QUAD_RESIDUAL_BAR}, agree {QUAD_AGREE_BAR})")
    return ok


def _quadruped_batch(nhorizon, batch_size, device):
    # BASELINE.md config: nx=36, nu=12, N=512, 256 scenarios in one batch.
    prob = rt.random_problem(torch.Generator().manual_seed(1), nhorizon, 36,
                             12, torch.float32, device=device)
    return rt.batch_problems(prob, batch_size,
                             torch.Generator().manual_seed(0))


def main(device="cuda") -> int:
    """Run the families and gates named by the environment, print the JSON
    line; 0, or 1 if a gate failed, or 2 without the CUDA device asked
    for."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        log("[bench] no CUDA device")
        return 2
    reps = int(os.environ.get("BENCH_REPS", "5"))
    which = os.environ.get("BENCH_SOLVER", "all")
    quad_only = os.environ.get("BENCH_CONFIG") == "quadruped"

    if quad_only:
        names = []
        quad_names = ["rslqr", "pscan"] if which == "all" else which.split(",")
    elif which == "all":
        names = ["pscan", "rslqr", "refine"]
        quad_names = ["rslqr", "pscan"]
    elif which == "both":
        names, quad_names = ["pscan", "rslqr"], []
    else:
        names, quad_names = which.split(","), []

    batch_size = int(os.environ.get("BENCH_BATCH", "1024"))
    nhorizon = int(os.environ.get("BENCH_HORIZON", "256"))
    qb = int(os.environ.get("BENCH_QUAD_BATCH", "256"))
    qn = int(os.environ.get("BENCH_QUAD_HORIZON", "512"))
    if quad_only:
        qb = int(os.environ.get("BENCH_BATCH", str(qb)))
        qn = int(os.environ.get("BENCH_HORIZON", str(qn)))

    card = device_name(device)
    log(f"[bench] torch={torch.__version__} device={card}")
    results = {}
    if _options().factor_dtype:
        results["factor_dtype"] = _options().factor_dtype
    gate_ok = True

    if names:
        batch = _main_batch(nhorizon, batch_size, device)
        log(f"[bench] main config B={batch_size} N={nhorizon} nx=6 nu=3 "
            f"solvers={names}")
        for name in names:
            results[name] = time_solver(name, SOLVERS[name], batch,
                                        batch_size, reps, device)
            _release(device)

        # f32 solution-quality context (not part of the headline metric).
        single = batch.map(lambda x: x[:1])
        first = batch.map(lambda x: x[0])
        res = float(rt.kkt_residual(first, SOLVERS["rslqr"](single)[0]))
        log(f"[bench] rslqr f32 KKT residual: {res:.3e}")
        results["rslqr_f32_kkt_residual"] = res
        if "refine" in names:
            resr = float(rt.kkt_residual(first, _refine_kkt(single)[0]))
            log(f"[bench] refined (2 iter) f32 KKT residual: {resr:.3e}")
            results["refine_f32_kkt_residual"] = resr
        gate_ok = accuracy_gate(results, batch, batch_size, nhorizon, reps,
                                device)
        del batch
        _release(device)

    if quad_names:
        qbatch = _quadruped_batch(qn, qb, device)
        log(f"[bench] quadruped config B={qb} N={qn} nx=36 nu=12 "
            f"solvers={quad_names}")
        for name in quad_names:
            st = time_solver(f"{name}_quadruped", SOLVERS[name], qbatch, qb,
                             min(reps, 3), device, k2_default=3)
            st["chunk"] = qb  # one batch (bench.py: chunks of 128)
            results[f"{name}_quadruped"] = st
            _release(device)
        gate_ok = quadruped_accuracy_gate(results, qbatch,
                                          quad_names) and gate_ok
        del qbatch
        _release(device)

    timed = {k: v for k, v in results.items()
             if isinstance(v, dict) and "median" in v}
    if names:
        head_pool = {k: v for k, v in timed.items() if k in names}
        cfg, hb, hn = "", batch_size, nhorizon
    else:
        head_pool = timed
        cfg, hb, hn = "_quadruped", qb, qn
    kind = torch.device(device).type
    best_name = max(head_pool, key=lambda k: head_pool[k]["median"])
    print(json.dumps({
        "metric": f"lqr_solves_per_sec_{kind}_n{hn}_b{hb}_f32{cfg}_"
                  f"{best_name}",
        "value": head_pool[best_name]["median"],
        "unit": "solves/s",
        "detail": results,
        "device": card,
    }), flush=True)
    if not gate_ok:
        # The reference's benchmark asserts accuracy beside speed
        # (sample_problem_test.c:150-157): a failed gate fails the run.
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
