"""Chained per-stage timings of the port's solver stages on the card.

    python -m rslqr_tpu_torch.bench_kernels

Counterpart of the JAX package's ``bench_kernels.py``, section by section,
at its defaults (N=256, B=1024, n=6, m=3, K=8, reps=3, levels 0,2,4,6;
planes at N=512, B=32, nx=36):

  update : B1 ``schur_update_level_em`` per level
  leaf   : B3 ``leaf_schur_level0_em``
  rhs    : B2 ``rhs_update_level_em`` per level
  sep    : the compact separator stage as production composes it: group-
           major -> element-major, ``bgemm``, ``bcholesky``, cached
           ``bcho_solve`` of every upper level, element-major -> group-major
  prod   : the inner products at tail levels (``_gk``/``_sel`` + ``bgemm``)
  planes : B5 ``pgemm`` and ``schur_update_planes`` (``lam=True``, level 2)

Env, as the JAX script: KB_SECTIONS ("update,leaf,rhs,sep,prod"; add
"planes"), KB_LEVELS, KB_N, KB_B, KB_K, KB_REPS, KB_PLANES_N, KB_PLANES_B,
KB_PLANES_NX.

A stage's time is :func:`chain_diff`: the K-chained minus the 1-chained
program over K - 1, the least of ``reps`` tries. Each iteration's input
depends on the previous output: in-place slab updates carry through the
chain, the other stages feed a scalar of their output back into the next
input (``* 1e-38``), as the JAX chains do. Both programs are captured in a
CUDA graph and replayed (rows say ``"chain": "cuda_graph"``), so the time is
the card's and not the host's launch cost. Rows carry JAX's keys plus
``device`` (the card's name); ``compile_s`` holds the seconds of the first,
eager call of the 1-chain (the kernel build included when the library is
not built yet). The byte models (``*_traffic``) are JAX's formulas; the
``planes_update`` one counts the separators at full size, as JAX passes
them, where the port reads the compact ones.

The chains (``*_chain``: ``make_run(Kc)`` -> a callable) are built apart
from the clock, so the CPU tests run them with the plain versions. A
measurement needs a card: :func:`chain_diff` raises without one. The same
clock times single calls and chains for ``chip_smoke.py`` and
``tools/time_solve.py`` (:func:`launch_ms`, :func:`chain_ms`).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from . import linalg as la
from .ops import planes, schur
from .rslqr_em import _em_from_gm, _gk, _gm, _sel

n, m = 6, 3
nn, mn, nm = n * n, m * n, n * m
PLANES_LEVEL = 2


# ---------------------------------------------------------------------------
# Byte models (bench_kernels.py's formulas).
# ---------------------------------------------------------------------------


def update_emits(N: int, level: int) -> bool:
    """Whether the level-``level`` update emits the next level's products
    (JAX's ``emit_cfg``: levels 0-2)."""
    span = 1 << (level + 1)
    span2 = 2 * span
    return span2 <= min(max(span, 8) * 2, 16, N) and N >= span2


def update_traffic(N: int, B: int, level: int, U: int, emit: bool) -> int:
    """Bytes of one B1 launch: the level's slabs, U upper slabs read and
    written, the emitted products and the solved separators."""
    span2 = 2 << (level + 1)
    G = N >> (level + 1)
    slab = (2 * nn + mn) * N * B * 4
    ex_bytes = nn * (N // span2) * B * 4 if emit else 0
    return slab + U * (2 * slab + ex_bytes) + U * (G * nn * B * 4)


def leaf_traffic(N: int, B: int) -> int:
    """Bytes of one B3 launch: the problem planes, S0, the separators and
    the level-1 extracts read, every level's slab written."""
    depth = (N - 1).bit_length()
    U = depth - 1
    reads = (nn + nm + n + m) * N * B * 4 + (U + 1) * (N // 2) * nn * B * 4
    reads += (N // 4) * (nn + nm) * B * 4 + U * (N // 4) * nn * B * 4
    writes = depth * (2 * nn + nm) * N * B * 4
    return reads + writes


def rhs_traffic(N: int, B: int, level: int) -> int:
    """Bytes of one B2 launch: the slabs read, z read and written, zbar."""
    G = N >> (level + 1)
    return ((2 * nn + mn) * N * B * 4 + 2 * (2 * n + m) * N * B * 4
            + G * n * B * 4)


def sep_traffic(N: int, B: int, level: int, U: int) -> int:
    """Bytes of the separator stage: each compact array read and written
    about three times (transpose in, stage, transpose out)."""
    compact = (N >> (level + 1)) * nn * B * 4
    return (U + 1) * compact * 4 + U * compact * 2


def prod_traffic(N: int, B: int, level: int, U: int) -> int:
    """Full-slab bytes of the products stage (JAX's ``model_full_GB``: the
    chain's ``+ eps`` re-reads whole slabs, so an upper bound)."""
    return U * (2 * nn + mn) * N * B * 4


def planes_gemm_traffic(nx: int, F: int) -> int:
    """Bytes of one ``pgemm``: A and B read, C written."""
    return 3 * nx * nx * F * 4


def planes_update_traffic(nx: int, F: int) -> int:
    """Bytes of one ``schur_update_planes`` (JAX's: A, the per-knot
    separators, C read and written)."""
    return 4 * nx * nx * F * 4


def planes_flops(nx: int, F: int) -> int:
    return 2 * nx * nx * nx * F


# ---------------------------------------------------------------------------
# Chained programs.
# ---------------------------------------------------------------------------


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randn(gen, device, *shape):
    return torch.randn(shape, generator=gen, device=device)


def update_inputs(N, B, level, device):
    """The B1 chain's operands; the U upper slab trios start equal (JAX
    passes one array U times) but are separate tensors, updated in place."""
    depth = (N - 1).bit_length()
    U = depth - level - 1
    G, G2 = N >> (level + 1), N >> (level + 2)
    g = _gen(level, device)
    R = lambda *s: _randn(g, device, *s)
    FL = [R(nn, N, B), R(nn, N, B), R(mn, N, B)]
    ups = [[x.clone() for _ in range(U)] for x in (R(nn, N, B), R(nn, N, B),
                                                   R(mn, N, B))]
    fsol = [R(G, nn, B)] * U
    emit = update_emits(N, level)
    sep = [R(G2, nn, B), R(G2, nm, B)] if emit else [None, None]
    return dict(FL=FL, Fls=ups[0], Fxs=ups[1], Fus=ups[2], fsol=fsol,
                sep=sep, level=level)


def update_chain(inp):
    """B1 chained through the upper slabs it updates in place."""
    def make_run(Kc):
        def run():
            for _ in range(Kc):
                schur.schur_update_level_em(
                    *inp["FL"], inp["Fls"], inp["Fxs"], inp["Fus"],
                    inp["fsol"], *inp["sep"], level=inp["level"], n=n, m=m)
            return inp["Fls"]
        return run
    return make_run


def leaf_inputs(N, B, device):
    U = (N - 1).bit_length() - 1
    g = _gen(0, device)
    R = lambda *s: _randn(g, device, *s)
    pos = lambda *s: 1.0 + torch.rand(s, generator=g, device=device)
    return dict(A=R(nn, N, B), B=R(nm, N, B), qinv=pos(n, N, B),
                rinv=pos(m, N, B), S0=R(N // 2, nn, B),
                fsol=[R(N // 2, nn, B)] * U, Asep=R(N // 4, nn, B),
                Bsep=R(N // 4, nm, B))


def leaf_chain(inp):
    """B3 chained through ``qinv``: the next call's ``qinv`` adds the sum of
    the first slab's first element times 1e-38."""
    depth = (inp["A"].shape[1] - 1).bit_length()

    def make_run(Kc):
        def run():
            qi, acc = inp["qinv"], 0.0
            for _ in range(Kc):
                Fls, _, _, _ = schur.leaf_schur_level0_em(
                    inp["A"], inp["B"], qi, inp["rinv"], inp["S0"],
                    inp["fsol"], inp["Asep"], inp["Bsep"], depth=depth, n=n,
                    m=m)
                s = Fls[0][0].sum()
                qi = inp["qinv"] + s * 1e-38
                acc = acc + s
            return acc
        return run
    return make_run


def rhs_inputs(N, B, level, device):
    g = _gen(level + 100, device)
    R = lambda *s: _randn(g, device, *s)
    return dict(F=[R(nn, N, B), R(nn, N, B), R(mn, N, B)],
                z=[R(n, N, B), R(n, N, B), R(m, N, B)],
                zb=R(N >> (level + 1), n, B), level=level)


def rhs_chain(inp):
    """B2 chained through the z planes it updates in place."""
    def make_run(Kc):
        def run():
            for _ in range(Kc):
                schur.rhs_update_level_em(*inp["F"], *inp["z"], inp["zb"],
                                          level=inp["level"], n=n, m=m)
            return inp["z"]
        return run
    return make_run


def sep_inputs(N, B, level, device):
    G = N >> (level + 1)
    return _randn(_gen(level + 200, device), device, G, nn, B)


def sep_chain(base, U):
    """The separator stage on U + 1 compact arrays (all ``base``): the
    level's Cholesky of ``S S' + 10 I`` and the solves of the U upper
    levels, chained through ``eps`` added to every input."""
    G, _, B = base.shape

    def make_run(Kc):
        def run():
            eps, acc = 0.0, 0.0
            for _ in range(Kc):
                Sm = [_em_from_gm(base + eps, n, n) for _ in range(U + 1)]
                S0 = la.bgemm(Sm[0], la.transpose_block(Sm[0], 2), 2) \
                    + 10.0 * la.beye(n, Sm[0], 2)
                Lc = la.bcholesky(S0, 2)
                outs = [_gm(la.bcho_solve(Lc, S, 2)) for S in Sm[1:]]
                s = sum(o.sum() for o in outs) + Lc.sum()
                eps, acc = s * 1e-38, acc + s
            return acc
        return run
    return make_run


def prod_inputs(N, B, level, device):
    g = _gen(level + 300, device)
    R = lambda *s: _randn(g, device, *s)
    return dict(A=R(n, n, N, B), B=R(n, m, N, B), Fl=R(n, n, N, B),
                Fx=R(n, n, N, B), Fu=R(m, n, N, B), level=level)


def prod_chain(inp, U):
    """The products ``A_sep Fx[sep] + B_sep Fu[sep] - Fx[sep+1] -
    Fl[sep+1]`` of U upper levels (all the same slabs) from strided slab
    slices, chained through ``eps`` added to the slabs."""
    level = inp["level"]
    span, mid = 1 << (level + 1), (1 << level) - 1

    def make_run(Kc):
        def run():
            A_sep = _sel(_gk(inp["A"], span), mid)
            B_sep = _sel(_gk(inp["B"], span), mid)
            eps, acc = 0.0, 0.0
            for _ in range(Kc):
                s = 0.0
                for _ in range(U):
                    gl = _gk(inp["Fl"] + eps, span)
                    gx = _gk(inp["Fx"] + eps, span)
                    gu = _gk(inp["Fu"] + eps, span)
                    S = (la.bgemm(A_sep, _sel(gx, mid), 2)
                         + la.bgemm(B_sep, _sel(gu, mid), 2)
                         - _sel(gx, mid + 1) - _sel(gl, mid + 1))
                    s = s + S.sum()
                eps, acc = s * 1e-38, acc + s
            return acc
        return run
    return make_run


def planes_inputs(N, B, nx, device):
    g = _gen(7, device)
    R = lambda *s: _randn(g, device, *s)
    return dict(A=R(nx, nx, N, B), B=R(nx, nx, N, B), C=R(nx, nx, N, B),
                fsol=R(nx, nx, N >> (PLANES_LEVEL + 1), B))


def planes_gemm_chain(inp):
    """B5 chained as ``c = pgemm(A, c) * 1e-2`` from ``c = B``."""
    def make_run(Kc):
        def run():
            c = inp["B"]
            for _ in range(Kc):
                c = planes.pgemm(inp["A"], c) * 1e-2
            return c
        return run
    return make_run


def planes_update_chain(inp):
    """``schur_update_planes`` (lambda slab, level 2) in place on ``C``."""
    def make_run(Kc):
        def run():
            for _ in range(Kc):
                planes.schur_update_planes(inp["A"], inp["fsol"], inp["C"],
                                           level=PLANES_LEVEL, lam=True)
            return inp["C"]
        return run
    return make_run


# ---------------------------------------------------------------------------
# The clock.
# ---------------------------------------------------------------------------


def _captured(run):
    """``run`` captured in a CUDA graph: a callable that replays it."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()

    def replay():
        g.replay()
        return out
    return replay


def _timed(fn) -> float:
    """Seconds of one call of ``fn`` on the card (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def chain_diff(make_run, K, reps, device):
    """``(min over reps of (t(K) - t(1)) / (K - 1), first-call seconds)``
    for the chained programs ``make_run(1)`` and ``make_run(K)``: one eager
    warm-up call each (on a side stream, as capture wants), then both
    captured in CUDA graphs; each time is one replay between CUDA events,
    read after synchronizing. Raises without a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"chain_diff times on a CUDA device, got {device} (CUDA "
            f"available: {torch.cuda.is_available()})")
    with torch.cuda.device(device):
        f1, fK = make_run(1), make_run(K)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f1()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            fK()
        torch.cuda.current_stream().wait_stream(side)
        f1, fK = _captured(f1), _captured(fK)
        f1()
        fK()
        ts = []
        for _ in range(reps):
            t1 = _timed(f1)
            tK = _timed(fK)
            ts.append((tK - t1) / (K - 1))
        del f1, fK  # the graphs and their memory pools
    torch.cuda.empty_cache()
    return min(ts), first_s


def chain_spd(M: torch.Tensor) -> torch.Tensor:
    """SPD blocks ``[d, d, *plane]`` for timing B7 (``pcho_solve``, which
    solves ``(L L') X = B`` in place on X) chained, from ``M [*plane, d,
    d]`` of standard normal entries: ``I + M M' / (25 d)``, every
    eigenvalue in about [1, 1.16] (the largest of ``M M'`` is about 4 d).
    The chain carries X through every call of a timing (:func:`chain_diff`'s
    warm-ups and replays: 55 at K=10 and 3 reps), so X never grows and
    shrinks by at most 1.16x a call; ``M M' + d I`` shrinks it d-fold a
    call, into subnormals within ~25 calls, and eigenvalues that straddle 1
    trade that for overflow."""
    d = M.shape[-1]
    S = torch.eye(d, dtype=M.dtype, device=M.device) + (
        M @ M.transpose(-1, -2)) / (25 * d)
    return S.movedim((-2, -1), (0, 1)).contiguous()


def device_name(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them ("cpu" for
    a run on the CPU)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    if out:
        return out.splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def chain_ms(call, device="cuda", K: int = 10, reps: int = 3) -> float:
    """Device ms of one ``call()`` chained: :func:`chain_diff` of ``K``
    back-to-back calls against one, min over ``reps`` (the calls read the
    same inputs; an in-place kernel updates them again)."""
    def make_run(Kc):
        def run():
            out = None
            for _ in range(Kc):
                out = call()
            return out
        return run
    return 1e3 * chain_diff(make_run, K, reps, device)[0]


def launch_ms(fn, make_args, reps: int = 10) -> float:
    """Median ms of ``fn(*make_args())`` over ``reps`` single launches after
    one warm-up, CUDA events around each call with the card synchronized
    before it (so the time holds the wrapper's host time while the card
    idles); inputs are re-made, untimed, before each call."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch_ms times on a CUDA device")
    times = []
    for _ in range(reps + 1):
        args = make_args()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


# ---------------------------------------------------------------------------
# Sections.
# ---------------------------------------------------------------------------


class Bench:
    """The six sections at one set of sizes; each returns its rows."""

    def __init__(self, device, K=8, reps=3):
        self.device, self.K, self.reps = device, K, reps
        self.card = torch.cuda.get_device_name(device)

    def time(self, make_run):
        return chain_diff(make_run, self.K, self.reps, self.device)

    def row(self, stage, per_call, first_s, traffic=None, **extra):
        r = {"stage": stage, **extra,
             "ms_per_call": round(per_call * 1e3, 4)}
        if traffic is not None:
            r["model_GB"] = round(traffic / 1e9, 4)
            r["achieved_GBps"] = round(traffic / per_call / 1e9, 1)
        r.update(compile_s=round(first_s, 2), device=self.card,
                 chain="cuda_graph")
        return r

    def update(self, N, B, levels):
        rows = []
        for level in levels:
            U = (N - 1).bit_length() - level - 1
            if U < 1:
                continue
            inp = update_inputs(N, B, level, self.device)
            per, first = self.time(update_chain(inp))
            rows.append(self.row(
                "update", per, first,
                update_traffic(N, B, level, U, update_emits(N, level)),
                level=level, U=U))
        return rows

    def leaf(self, N, B):
        per, first = self.time(leaf_chain(leaf_inputs(N, B, self.device)))
        return [self.row("leaf", per, first, leaf_traffic(N, B))]

    def rhs(self, N, B, levels):
        rows = []
        for level in levels:
            per, first = self.time(rhs_chain(rhs_inputs(N, B, level,
                                                        self.device)))
            rows.append(self.row("rhs", per, first,
                                 rhs_traffic(N, B, level), level=level))
        return rows

    def sep(self, N, B, levels):
        rows = []
        for level in levels:
            U = (N - 1).bit_length() - level - 1
            if U < 1:
                continue
            per, first = self.time(sep_chain(
                sep_inputs(N, B, level, self.device), U))
            rows.append(self.row("sep", per, first,
                                 sep_traffic(N, B, level, U), level=level,
                                 U=U))
        return rows

    def prod(self, N, B, levels):
        rows = []
        for level in levels:
            U = (N - 1).bit_length() - level
            if U < 1 or (1 << (level + 1)) > N:
                continue
            per, first = self.time(prod_chain(
                prod_inputs(N, B, level, self.device), U))
            rows.append(self.row(
                "prod", per, first, level=level, U=U,
                note="chained adds re-read full slabs; upper bound",
                model_full_GB=round(prod_traffic(N, B, level, U) / 1e9, 4)))
        return rows

    def planes(self, N, B, nx):
        F = N * B
        inp = planes_inputs(N, B, nx, self.device)
        rows = []
        for stage, chain, traffic in (
                ("planes_gemm", planes_gemm_chain,
                 planes_gemm_traffic(nx, F)),
                ("planes_update", planes_update_chain,
                 planes_update_traffic(nx, F))):
            per, first = self.time(chain(inp))
            r = self.row(stage, per, first, n=nx, plane=F,
                         GFLOPs=round(planes_flops(nx, F) / per / 1e9, 1))
            r["achieved_GBps"] = round(traffic / per / 1e9, 1)
            rows.append(r)
        return rows


SECTIONS = ("update", "leaf", "rhs", "sep", "prod", "planes")


def run(sections, device, N=256, B=1024, K=8, reps=3, levels=(0, 2, 4, 6),
        planes_shape=(512, 32, 36)):
    """The rows of ``sections`` (in :data:`SECTIONS` order), JAX's defaults
    for the rest."""
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}")
    b = Bench(device, K, reps)
    calls = {
        "update": lambda: b.update(N, B, levels),
        "leaf": lambda: b.leaf(N, B),
        "rhs": lambda: b.rhs(N, B, levels),
        "sep": lambda: b.sep(N, B, levels),
        "prod": lambda: b.prod(N, B, levels),
        "planes": lambda: b.planes(*planes_shape),
    }
    return [r for s in SECTIONS if s in sections for r in calls[s]()]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    env = os.environ.get
    rows = run(
        env("KB_SECTIONS", "update,leaf,rhs,sep,prod").split(","),
        torch.device("cuda"), N=int(env("KB_N", "256")),
        B=int(env("KB_B", "1024")), K=int(env("KB_K", "8")),
        reps=int(env("KB_REPS", "3")),
        levels=[int(x) for x in env("KB_LEVELS", "0,2,4,6").split(",")],
        planes_shape=(int(env("KB_PLANES_N", "512")),
                      int(env("KB_PLANES_B", "32")),
                      int(env("KB_PLANES_NX", "36"))))
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
