"""Per-phase solve profiling: the ``NdLqrProfile`` analogue.

Counterpart of ``rslqr_tpu.profile`` (the reference's phase profiler,
``NdLqrProfile`` with OMP_TICK/OMP_TOC, solve.c:15-25, solver.h:31-74, and
its linalg time accumulator). The port runs eagerly, so the phases are timed
inside one real factorization: the solve's stages run in the spans of
:mod:`rslqr_tpu_torch.spans`, and :func:`profile_solve` listens to them with
a clock that brackets each stage, on the layout ``solve`` would take (the
element-major stages of ``rslqr_em.factorize_em``, or the knot-major
stages of ``rslqr._factorize_bl``), summed by phase over the tree levels.

The same spans need no call of this module: any ``torch.profiler`` run over
a caller's own solves shows the ``rslqr_tpu_torch.*`` stages (``solve``,
``factor``, ``sweep``, ``pack``, each tree level's phases, the scan's
stages, ``h2d``) as ``user_annotation`` ranges on the timeline of the
kernels they launch::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        pt.solve_kkt(batch)
    prof.export_chrome_trace("solve.json")

Each phase reports two times:

* ``t_*_ms``, device: on CUDA, the span between CUDA events recorded on
  the stream before and after the phase's launches (no synchronize in
  between, so the spans of consecutive phases add up to the device's span
  of the whole factorization); on the CPU, the host clock;
* ``host_*_ms``: the host clock around the phase's calls, the time to
  issue them. A phase whose host time nears its device time is host-bound
  (the small solves are: PERF.md §5); one whose device time is far above
  it is device-bound.

Phase mapping (ref solve.c:60-132): leaves / products / cholesky / cholsolve
/ shur, accumulated over levels as the reference's OMP_TICK/OMP_TOC do; the
RHS sweep (solve.c:137-182) is untimed in the reference too and enters only
the totals, which come from a separate run of the whole solve: ``t_total_ms``
its device span, ``host_total_ms`` its synchronized wall.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from . import riccati as _riccati
from . import rslqr, rslqr_em, spans
from .config import SolveOptions, resolve_options
from .problem import LQRProblem
from .tree import build_tree_tables


PHASES = ("leaves", "products", "cholesky", "cholsolve", "shur")


@dataclasses.dataclass
class SolveProfile:
    """Per-phase times of one rsLQR solve in ms (ref solver.h:31-39): device
    times ``t_*`` and host times ``host_*`` (module docstring).
    ``num_devices`` replaces the reference's ``num_threads``."""

    t_total_ms: float = 0.0
    t_leaves_ms: float = 0.0
    t_products_ms: float = 0.0
    t_cholesky_ms: float = 0.0
    t_cholsolve_ms: float = 0.0
    t_shur_ms: float = 0.0
    host_total_ms: float = 0.0
    host_leaves_ms: float = 0.0
    host_products_ms: float = 0.0
    host_cholesky_ms: float = 0.0
    host_cholsolve_ms: float = 0.0
    host_shur_ms: float = 0.0
    num_devices: int = -1

    def reset(self) -> None:
        """Zero all timings (ref ndlqr_ResetProfile, solver.c:16-23)."""
        for f in dataclasses.fields(self):
            if f.name.endswith("_ms"):
                setattr(self, f.name, 0.0)

    def copy(self) -> "SolveProfile":
        """Ref ndlqr_CopyProfile (solver.c:25-33)."""
        return dataclasses.replace(self)

    def print(self) -> None:
        """Ref ndlqr_PrintProfile (solver.c:35-43), device and host ms."""
        print(f"Solved with {self.num_devices} device(s)")
        for label, name in (("Total:   ", "total"), ("Leaves:  ", "leaves"),
                            ("Products:", "products"),
                            ("Cholesky:", "cholesky"),
                            ("Solve:   ", "cholsolve"), ("Shur:    ", "shur")):
            print(f"Solve {label} {getattr(self, f't_{name}_ms'):.3f} ms "
                  f"(host {getattr(self, f'host_{name}_ms'):.3f} ms)")

    def compare(self, other: "SolveProfile") -> None:
        """A/B comparison of the device times with speedups (ref
        ndlqr_CompareProfile, solver.c:49-58)."""

        def comp(label, base, new):
            ratio = base / new if new else float("inf")
            print(f"{label} {base:.3f} / {new:.3f} ({ratio:.2f} speedup)")

        print(f"Num Devices:     {self.num_devices} / {other.num_devices}")
        comp("Solve Total:    ", self.t_total_ms, other.t_total_ms)
        comp("Solve Leaves:   ", self.t_leaves_ms, other.t_leaves_ms)
        comp("Solve Products: ", self.t_products_ms, other.t_products_ms)
        comp("Solve Cholesky: ", self.t_cholesky_ms, other.t_cholesky_ms)
        comp("Solve CholSolve:", self.t_cholsolve_ms, other.t_cholsolve_ms)
        comp("Solve Shur Comp:", self.t_shur_ms, other.t_shur_ms)


@dataclasses.dataclass
class RiccatiProfile:
    """Riccati per-pass device times in ms (ref riccati_solver.h:82-85,
    populated by ndlqr_SolveRiccati, riccati_solve.c:16-22)."""

    t_solve_ms: float = 0.0
    t_backward_pass_ms: float = 0.0
    t_forward_pass_ms: float = 0.0

    def print(self) -> None:
        """Ref ndlqr_PrintRiccatiSummary (riccati_solver.c:155-165)."""
        t_bp, t_fp = self.t_backward_pass_ms, self.t_forward_pass_ms
        t_passes = t_bp + t_fp
        pct = (lambda t: 100.0 * t / t_passes if t_passes else 0.0)
        print("Riccati Solve Summary")
        print(f"  Solve time:    {self.t_solve_ms or t_passes:.3f} ms")
        print(f"  Backward pass: {t_bp:.3f} ms ({pct(t_bp):.1f}%)")
        print(f"  Forward pass:  {t_fp:.3f} ms ({pct(t_fp):.1f}%)")


class _Clock:
    """Brackets named stages: CUDA events on a CUDA device, the host clock
    on the CPU; the events are read once, after one synchronize
    (:meth:`times`). Installed as the spans' listener
    (``spans.listening``), it gets every stage's name."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def __call__(self, name: str):
        e0 = self._event()
        h0 = time.perf_counter()
        yield
        host = 1e3 * (time.perf_counter() - h0)
        self.marks.append((name, host, e0, self._event()))

    def times(self):
        """``{phase: (device_ms, host_ms)}``, summed over the marks by the
        phase part of each name (``products`` of ``products.L3``)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, host, e0, e1 in self.marks:
            dev = e0.elapsed_time(e1) if self.cuda else host
            phase = name.split(".")[0]
            d, h = out.get(phase, (0.0, 0.0))
            out[phase] = (d + dev, h + host)
        return out


def _num_devices(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def profile_solve(prob: LQRProblem, repeats: int = 3,
                  options: Optional[SolveOptions] = None) -> SolveProfile:
    """Time each solver phase (ref ENABLE_PROFILER path of ndlqr_Solve,
    solve.c:60-132) of the path ``solve(prob, options=options)`` takes:
    the element-major factorization, or the knot-major grid one. One
    warm-up run, then ``repeats`` runs, each a profiled factorization and
    one whole timed ``solve_kkt``; returns the run with the least total."""
    opts = resolve_options(options)
    dev = prob.A.device
    t = build_tree_tables(prob.nhorizon)
    if rslqr._use_em_layout(prob, opts):
        one, _ = rslqr._one_batch_axis(prob)

        def factor():
            rslqr_em.factorize_em(one, t, options=opts)
    else:
        nb = rslqr._num_batch_axes(prob)
        pbl = rslqr._to_batch_last(prob, nb)
        rslqr._no_tf32()

        def factor():
            rslqr._factorize_bl(pbl, t, nb, opts)

    def total():
        rslqr.solve_kkt(prob, options=opts)

    def run() -> SolveProfile:
        p = SolveProfile(num_devices=_num_devices(dev))
        with spans.listening(_Clock(dev)) as clock:
            factor()
        tm = clock.times()
        for name in PHASES:
            d, h = tm.get(name, (0.0, 0.0))
            setattr(p, f"t_{name}_ms", d)
            setattr(p, f"host_{name}_ms", h)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        h0 = time.perf_counter()
        tot = _Clock(dev)
        with tot("total"):
            total()
        p.t_total_ms = tot.times()["total"][0]
        p.host_total_ms = 1e3 * (time.perf_counter() - h0)
        return p

    run()  # warm-up: library handles, allocator, kernel loads
    return min((run() for _ in range(repeats)), key=lambda p: p.t_total_ms)


def profile_riccati(prob: LQRProblem, repeats: int = 3) -> RiccatiProfile:
    """Time the Riccati backward and forward passes separately (ref
    ndlqr_SolveRiccati + ndlqr_GetRiccatiSolveTimes, riccati_solve.c:7-24,
    riccati_solver.c:180-194); leading batch axes run together."""
    dev = prob.A.device

    def run() -> RiccatiProfile:
        clock = _Clock(dev)
        with clock("bw"):
            K, d, P, p_ = _riccati.backward_pass(prob)
        with clock("fw"):
            _riccati.forward_pass(prob, K, d, P, p_)
        with clock("solve"):
            _riccati.solve_riccati(prob).kkt_vector()
        tm = clock.times()
        return RiccatiProfile(t_solve_ms=tm["solve"][0],
                              t_backward_pass_ms=tm["bw"][0],
                              t_forward_pass_ms=tm["fw"][0])

    run()  # warm-up
    return min((run() for _ in range(repeats)), key=lambda p: p.t_solve_ms)


def linalg_flop_estimate(nstates: int, ninputs: int, nhorizon: int) -> dict:
    """Analytic FLOP and byte accounting of one rsLQR solve (JAX
    profile.py:386-439, host math): per-stage FLOPs and the minimum slab
    traffic of the fused-kernel flow (4-byte words), which with a measured
    time give the achieved intensity."""
    n, m, N = nstates, ninputs, nhorizon
    depth = (N - 1).bit_length()
    gemm_nn = 2 * n * n * n
    gemm_mn = 2 * m * n * n
    chol = n**3 // 3
    trsm_nn = 2 * n * n * n

    leaves = N * (2 * n * n + 2 * m * n)  # diagonal scalings
    products = sum(
        (1 << (depth - L - 1)) * (depth - L) * (gemm_nn + gemm_mn)
        for L in range(depth)
    )
    cholesky = (N - 1) * chol
    cholsolve = sum(
        (1 << (depth - L - 1)) * (depth - L - 1) * trsm_nn
        for L in range(depth)
    )
    shur = sum(
        N * (depth - L - 1) * (2 * gemm_nn + gemm_mn) for L in range(depth)
    )
    rhs = N * depth * (4 * n * n + 2 * m * n)
    total = leaves + products + cholesky + cholsolve + shur + rhs
    # Slab units: the leaf + level-0 writes (depth), each level 1..depth-2
    # reads its multiplier slab and reads and writes every upper slab, the
    # RHS sweep reads every slab once (depth). One unit = one full factor
    # slab (2 n^2 + m n elements per knot).
    slab = N * (2 * n * n + m * n)
    units = (
        depth
        + sum(1 + 2 * (depth - 1 - L) for L in range(1, max(depth - 1, 1)))
        + depth
    )
    bytes_min = 4 * slab * units
    return {
        "flops_leaves": leaves,
        "flops_products": products,
        "flops_cholesky": cholesky,
        "flops_cholsolve": cholsolve,
        "flops_shur": shur,
        "flops_rhs": rhs,
        "flops_total": total,
        "hbm_bytes_min_f32": bytes_min,
        "arithmetic_intensity": total / bytes_min,
    }


def print_solve_summary(
    solve_time_ms: float,
    num_devices: Optional[int] = None,
    backend: Optional[str] = None,
    problem: Optional[LQRProblem] = None,
    hbm_gbps: float = 3350.0,
) -> None:
    """Ref ndlqr_PrintSolveSummary (solver.c:196-209). With ``problem``,
    also the achieved rates of :func:`linalg_flop_estimate`'s model against
    ``hbm_gbps`` (the H100 SXM's published 3,350 GB/s by default)."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if num_devices is None:
        num_devices = (torch.cuda.device_count() if backend == "cuda"
                       else 1)
    print("rsLQR Solve Summary")
    print("-------------------")
    print("  Recursive Schur-complement LQR solver (PyTorch, CUDA kernels).")
    print(f"  Solve time:  {solve_time_ms:f} ms")
    if problem is not None and solve_time_ms > 0:
        nbatch = 1
        for s in problem.batch_shape:
            nbatch *= s
        est = linalg_flop_estimate(problem.nstates, problem.ninputs,
                                   problem.nhorizon)
        secs = solve_time_ms * 1e-3
        gflops = est["flops_total"] * nbatch / secs / 1e9
        gbps = est["hbm_bytes_min_f32"] * nbatch / secs / 1e9
        share = min(100.0, 100.0 * gbps / hbm_gbps)
        print(
            f"  Linear algebra: {gflops:.1f} GFLOP/s achieved, "
            f"{gbps:.1f} GB/s min HBM traffic "
            f"({share:.1f}% of {hbm_gbps:.0f} GB/s roofline)"
        )
    print(f"  Solved with {num_devices} device(s).")
    print(f"  Linear algebra backend: {backend}")
