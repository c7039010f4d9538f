#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rslqr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device: the card's name and power limit (nvidia-smi), then the kernel
   build from ``rslqr_tpu_torch/csrc/schur_kernels.cu`` (nvcc, timed);
2. each of the four CUDA kernels against its plain PyTorch version on
   clones of the same random f32 inputs, at the main path's shapes
   (N=256, B=1024; B1 at N=128 and with level pairing off), with the median
   time of each over 10 launches;
3. the slice: ``solve_kkt`` on the BASELINE batched-MPC config (the
   double integrator, nx=6, nu=3, N=256, perturbed into B=1024 instances,
   f32) and again at N=128 so that B1 launches, with launch counts,
   agreement with ``kernels="off"`` and with the f64 Riccati oracle, and
   the KKT residual;
4. time per batched solve, kernel path and ``kernels="off"``.

Then a JSON line with every kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that last line; so does a machine without CUDA. Imports no JAX.
"""

import json
import statistics
import subprocess
import sys
import time

N_MAIN, N_ODD, BATCH = 256, 128, 1024
REPS = 10
KERNEL_BAR = 1e-4     # max|k - p| <= 1e-4 (1 + max|p|): summation order only
SLICE_BAR = 1e-4      # vs kernels="off" (__graft_entry__.dryrun_multichip)
F64_BAR = 1e-6        # f64 rsLQR vs f64 Riccati (tests/test_rslqr.py:143-148)
SOURCE = "rslqr_tpu_torch/csrc/schur_kernels.cu"
REPLACES = {
    "schur_update_level_em": "rslqr_tpu/ops/schur_pallas.py:373",
    "rhs_update_level_em": "rslqr_tpu/ops/schur_pallas.py:303",
    "leaf_schur_level0_em": "rslqr_tpu/ops/schur_pallas.py:705",
    "schur_update_pair_em": "rslqr_tpu/ops/schur_pallas.py:601",
}
n, m = 6, 3
nn, mn = n * n, m * n


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / (1.0 + ref.abs().max()))


class Smoke:
    def __init__(self, torch, pt, schur, dev):
        self.torch, self.pt, self.schur, self.dev = torch, pt, schur, dev
        self.failures = []
        self.gen = torch.Generator().manual_seed(0)
        self.kernel_stats = {}

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"FAIL: {what}", flush=True)

    # -- inputs --------------------------------------------------------
    def rand(self, *shape, scale=1.0):
        t = self.torch
        return (scale * t.randn(shape, generator=self.gen)).to(self.dev)

    def pos(self, *shape):
        t = self.torch
        return (0.5 + t.rand(shape, generator=self.gen)).to(self.dev)

    # -- timing ----------------------------------------------------------
    def time_call(self, fn, make_args):
        """Median ms of ``fn(*make_args())`` over REPS launches, CUDA
        events around each call; inputs are re-made (untimed) before each
        call since the kernels update them in place."""
        t = self.torch
        times = []
        for _ in range(REPS + 1):
            args = make_args()
            t.cuda.synchronize()
            a = t.cuda.Event(enable_timing=True)
            b = t.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            t.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[1:])

    def compare(self, name, case, fn, args, kwargs):
        """Kernel vs plain on clones of ``args``; record error and times."""
        t = self.torch

        def clones():
            return [
                [x.clone() for x in a] if isinstance(a, (list, tuple))
                else (None if a is None else a.clone())
                for a in args
            ]

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
        print(f"phase2 {name} {case}: max_abs_err={err:.3e} "
              f"rel_diff={err / scale:.3e} (bar {KERNEL_BAR}) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        st = self.kernel_stats.setdefault(
            name, {"max_abs_err": 0.0, "case": case, "ms": ms,
                   "plain_ms": plain_ms}
        )
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
        )
        # B2 at levels 0, 3, 7 (the first, a middle and the top level).
        for level in (0, 3, depth - 1):
            G = N >> (level + 1)
            self.compare(
                "rhs_update_level_em", f"N={N} B={B} level={level}",
                s.rhs_update_level_em,
                [R(nn, N, B), R(nn, N, B), R(mn, N, B), R(n, N, B),
                 R(n, N, B), R(m, N, B), R(G, n, B, scale=0.1)],
                dict(level=level, n=n, m=m),
            )
        # B4 at levels 1 and 5 (the first and last pair of the main path;
        # emission as the main path chooses it).
        for level in (1, depth - 3):
            self.compare(
                "schur_update_pair_em", f"N={N} B={B} level={level}",
                s.schur_update_pair_em, self.pair_args(N, B, level),
                dict(level=level, n=n, m=m),
            )
        # B1 at N=128 levels 1 and 5 (level 5 is on the main path there),
        # and at N=256 level 1 (the level_pairing=False path).
        d_odd = N_ODD.bit_length() - 1
        for NN, level in ((N_ODD, 1), (N_ODD, d_odd - 2), (N_MAIN, 1)):
            self.compare(
                "schur_update_level_em", f"N={NN} B={B} level={level}",
                s.schur_update_level_em, self.level_args(NN, B, level),
                dict(level=level, n=n, m=m),
            )

    def level_args(self, N, B, level):
        R = self.rand
        depth = N.bit_length() - 1
        U = depth - level - 1
        G, G2 = N >> (level + 1), N >> (level + 2)
        emit = self.schur._level_emits(level, N) and level + 2 <= depth
        return [R(nn, N, B), R(nn, N, B), R(mn, N, B),
                [R(nn, N, B) for _ in range(U)],
                [R(nn, N, B) for _ in range(U)],
                [R(mn, N, B) for _ in range(U)],
                [R(G, nn, B, scale=0.1) for _ in range(U)],
                R(G2, nn, B) if emit else None,
                R(G2, n * m, B) if emit else None]

    def pair_args(self, N, B, level):
        R = self.rand
        depth = N.bit_length() - 1
        U = depth - level - 1
        G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
        emit = (self.schur._pair_emits(level, N, B, U, n, m)
                and level + 2 <= depth - 1)
        return [R(nn, N, B), R(nn, N, B), R(mn, N, B),
                [R(nn, N, B) for _ in range(U)],
                [R(nn, N, B) for _ in range(U)],
                [R(mn, N, B) for _ in range(U)],
                [R(G1, nn, B, scale=0.1) for _ in range(U)],
                R(G2, nn, B),
                [R(G2, nn, B, scale=0.1) for _ in range(U - 1)],
                R(G3, nn, B) if emit else None,
                R(G3, n * m, B) if emit else None]

    # -- phase 3 ---------------------------------------------------------
    def batch(self, N, dtype):
        pt = self.pt
        prob = pt.double_integrator_problem(N, dtype=dtype, device=self.dev)
        gen = self.torch.Generator().manual_seed(N)
        return pt.batch_problems(prob, BATCH, gen)

    def slice_checks(self):
        t, pt, s = self.torch, self.pt, self.schur
        off = pt.SolveOptions(kernels="off")
        batches = {N: self.batch(N, t.float32) for N in (N_MAIN, N_ODD)}
        s.reset_launch_counts()
        out = {N_MAIN: pt.solve_kkt(batches[N_MAIN])}
        t.cuda.synchronize()
        c_main = s.launch_counts()
        out[N_ODD] = pt.solve_kkt(batches[N_ODD])
        t.cuda.synchronize()
        counts = s.launch_counts()
        c_odd = {k: counts[k] - c_main[k] for k in counts}
        self.launches = counts
        for k in ("rhs_update_level_em", "leaf_schur_level0_em",
                  "schur_update_pair_em"):
            self.check(c_main[k] > 0, f"{k} not launched at N={N_MAIN}")
        self.check(c_odd["schur_update_level_em"] > 0,
                   f"schur_update_level_em not launched at N={N_ODD}")
        for k, c in counts.items():
            self.check(c > 0, f"{k} launched no time on the main path")
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
        self.main_batch = batches[N_MAIN]

    # -- phase 4 ---------------------------------------------------------
    def time_solves(self, card):
        t, pt = self.torch, self.pt
        b = self.main_batch
        off = pt.SolveOptions(kernels="off")
        for _ in range(2):
            pt.solve_kkt(b)
            pt.solve_kkt(b, options=off)
        t.cuda.synchronize()
        tk, tp = [], []
        for _ in range(REPS):
            for opts, acc in ((None, tk), (off, tp)):
                t.cuda.synchronize()
                t0 = time.perf_counter()
                pt.solve_kkt(b, options=opts)
                t.cuda.synchronize()
                acc.append(1e3 * (time.perf_counter() - t0))
        mk, mp = statistics.median(tk), statistics.median(tp)
        print(f"phase4 N={N_MAIN} B={BATCH} f32 on {card}: kernel path "
              f"{mk:.3f} ms/solve ({BATCH / mk * 1e3:.0f} solves/s), "
              f"kernels=off {mp:.3f} ms/solve ({BATCH / mp * 1e3:.0f} "
              f"solves/s); median of {REPS}, min {min(tk):.3f} / "
              f"{min(tp):.3f} ms", flush=True)


def main() -> int:
    try:
        import torch

        import rslqr_tpu_torch as pt
        from rslqr_tpu_torch.ops import _build, schur
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
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.load()
    print(f"phase1 device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} build_s={build_s:.2f} lib={lib.name}",
          flush=True)

    smoke = Smoke(torch, pt, schur, dev)
    smoke.kernel_cases()
    smoke.slice_checks()
    smoke.time_solves(card)

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed:",
              file=sys.stderr)
        for f in smoke.failures:
            print("  " + f, file=sys.stderr)
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": smoke.launches[name],
         "max_abs_err": st["max_abs_err"], "ms": st["ms"],
         "plain_ms": st["plain_ms"], "case": st["case"]}
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
