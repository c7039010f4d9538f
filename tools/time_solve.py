#!/usr/bin/env python3
"""Time the port's batched solve (and, optionally, the mid-block plane
kernels) on one GPU, for comparing two versions of the package on one card.

    python3 tools/time_solve.py [--root DIR] [--config small|quad]
                                [--solver rslqr|pscan] [--reps 20]
                                [--kernels [--sets sweep,plane,...]]

Imports ``rslqr_tpu_torch`` from ``DIR`` (default: the checkout this script
lies in), builds its kernels, and prints the card's name and power limit,
then one line: the median and the minimum ms per batched ``solve_kkt``
(``--solver pscan``: ``solve_pscan_kkt``), host clock around each solve with
the device synchronized, on one of chip_smoke.py's configurations (f32, the
kernel path):

* ``small``: double integrator, N=256, B=1024 perturbed instances;
* ``quad``: the quadruped config, ``random_problem`` nx=36, nu=12, N=512,
  B=256 perturbed instances, one batch.

``--kernels`` also prints, single (median ms over 10 launches, CUDA
events) and chained (CUDA-graph replays of 10 back-to-back calls against
one), chip_smoke.py's phase-2 cases of the small-block sweep kernels at
(n, m) = (6, 3) (B1 at N=128 levels 1 and 5 and N=256 level 1, B2, B3,
B4 (levels 1, 3, 5), B11 and B12 at N=256, B=1024), its phase-2b cases
of B5 (``pgemm``, no flags) and B9 (``schur3_update_planes``), B7
(``pcho_solve``, n=36: w=36 at each quadruped level's plane, w=1 at levels
0 and 7; n=w=12 and 16), B6 (``pchol``: n=36 at each quadruped level's
plane, n=12 at level 0 and at the batched-interior plane), B8
(``plu_solve_multi`` at the quadruped pscan's three shapes) and phase-2c
cases of B5's ``lam_level`` (``schur_update_planes``), the scan's nine
flagged B5 products and B10 (``schur_update_level_flat``) at levels 1-6,
beside the
same timings of one PyTorch library call where there is one
(``matmul``/``baddbmm`` on mat-last views; an unmasked ``baddbmm`` over
every slab row for B1, B2, B9, B10, B12 and ``lam_level``). ``--sets``
takes some of the case sets: ``sweep`` (the small-block kernels),
``plane`` (B5, B9, ``lam_level``), ``pcho`` (B7), ``pchol`` (B6), ``plu``
(B8), ``flagged``, ``flat`` (B10) and ``leaf`` (B3 and B11 at
chip_smoke.py's phase-2f blocks, (n, m) = (4, 2), (8, 8), (5, 4), (6, 12)
and (8, 64), N=256, B=1024); B6's and B8's library calls are timed single
only. The clock is the timed tree's
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
# The --kernels case sets (all by default).
SETS = ("sweep", "plane", "pcho", "pchol", "plu", "flagged", "flat", "leaf")
# The other and wide small blocks of chip_smoke.py's phase 2f.
LEAF_BLOCKS = ((4, 2), (8, 8), (5, 4), (6, 12), (8, 64))


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


def _pair(torch, call, fresh):
    """(single ms, chained ms) of ``call(*fresh())``: single launches on
    fresh inputs (the kernels update them in place), chained on one
    working copy."""
    work = fresh()
    return _med(torch, call, fresh), _chained(torch, lambda: call(*work))


def _trio_lib(torch, FL, up, fs, level, n, N, B, gm=False):
    """One unmasked ``baddbmm`` on mat-last views doing the update of every
    upper trio of ``up`` (``[[l_u], [x_u], [u_u]]`` slabs, q columns each)
    by the multipliers ``FL`` and the compact separators ``fs``
    (element-major ``[e, G, B]``, or group-major ``[G, e, B]`` with
    ``gm``): chip_smoke.py's ``trio_library``."""
    span = 2 << level
    G = N >> (level + 1)
    q = up[0][0].shape[0] // n
    FLml = torch.cat([x.reshape(-1, n, N * B) for x in FL]).permute(
        2, 0, 1).contiguous()
    C = torch.cat([torch.cat([x.reshape(-1, q, N * B) for x in trio])
                   for trio in zip(*up)], dim=1).permute(2, 0, 1).contiguous()
    em = [x.transpose(0, 1) if gm else x for x in fs]
    f = torch.cat([x.reshape(n, q, G, 1, B).expand(n, q, G, span, B).reshape(
        n, q, N * B) for x in em], dim=1).permute(2, 0, 1).contiguous()
    return lambda: torch.baddbmm(C, FLml, f, alpha=-1.0)


def sweep_times(torch, schur, flat, R):
    """``{case: (single ms, chained ms)}`` of the small-block sweep kernels
    at (6, 3), B=1024 (chip_smoke.py phase 2 and 2d), and of the library
    calls beside B1, B2 and B12."""
    n, m, B = 6, 3, 1024
    nn, mn = n * n, m * n
    out = {}
    N = 256
    depth = N.bit_length() - 1
    # B3 and B11: the fused leaf at depth 8.
    out.update(_leaf_pair(torch, schur, flat, R, n, m, ""))
    # B2 and B12 at level 0.
    G = N // 2
    FL = [R(nn, N, B), R(nn, N, B), R(mn, N, B)]
    z = [R(n, N, B), R(n, N, B), R(m, N, B)]
    zb = 0.1 * R(G, n, B)
    out["B2 N=256 L0"] = _pair(
        torch, lambda *a: schur.rhs_update_level_em(*a, level=0, n=n, m=m),
        lambda: (*FL, *[x.clone() for x in z], zb))
    lib = _trio_lib(torch, FL, [[x] for x in z], [zb], 0, n, N, B, gm=True)
    out["library B2 N=256 L0"] = (_med(torch, lib, tuple),
                                  _chained(torch, lib))
    f2 = lambda x: x.reshape(x.shape[0], -1, 128)
    zbf = zb.transpose(0, 1).reshape(n, -1, 128).contiguous()
    out["B12 N=256 L0"] = _pair(
        torch, lambda *a: flat.rhs_update_level_flat(*a, level=0, n=n, m=m,
                                                     N=N),
        lambda: (*map(f2, FL), *[f2(x.clone()) for x in z], zbf))
    del FL, z, zb, zbf
    # B4 at levels 1, 3 and 5 (the main path's pairs; emission as it
    # chooses it).
    for level in (1, 3, 5):
        U = depth - level - 1
        G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
        emit = schur._pair_emits(level, N, B, U, n, m)
        args = [R(nn, N, B), R(nn, N, B), R(mn, N, B),
                [R(nn, N, B) for _ in range(U)], [R(nn, N, B) for _ in range(U)],
                [R(mn, N, B) for _ in range(U)],
                [0.1 * R(G1, nn, B) for _ in range(U)], R(G2, nn, B),
                [0.1 * R(G2, nn, B) for _ in range(U - 1)],
                R(G3, nn, B) if emit else None, R(G3, mn, B) if emit else None]
        out[f"B4 N=256 L{level}"] = _pair(
            torch, lambda *a: schur.schur_update_pair_em(
                *a, level=level, n=n, m=m),
            lambda: [[x.clone() for x in a] if isinstance(a, list) else a
                     for a in args])
        del args
    # B1 at N=128 levels 1 and 5 and N=256 level 1.
    for N, level in ((128, 1), (128, 5), (256, 1)):
        depth = N.bit_length() - 1
        U = depth - level - 1
        G, G2 = N >> (level + 1), N >> (level + 2)
        emit = schur._level_emits(level, N) and level + 2 <= depth
        FL = [R(nn, N, B), R(nn, N, B), R(mn, N, B)]
        up = [[R(e, N, B) for _ in range(U)] for e in (nn, nn, mn)]
        fs = [0.1 * R(G, nn, B) for _ in range(U)]
        sep = [R(G2, nn, B), R(G2, mn, B)] if emit else [None, None]
        out[f"B1 N={N} L{level}"] = _pair(
            torch, lambda *u: schur.schur_update_level_em(
                *FL, *u, fs, *sep, level=level, n=n, m=m),
            lambda: [[x.clone() for x in u] for u in up])
        lib = _trio_lib(torch, FL, up, fs, level, n, N, B, gm=True)
        out[f"library B1 N={N} L{level}"] = (_med(torch, lib, tuple),
                                             _chained(torch, lib))
        del FL, up, fs, sep, lib
    return out


def plane_times(torch, planes, R):
    """``{case: (single ms, chained ms)}`` of chip_smoke.py's phase-2b cases
    of B5 (``pgemm``, no flags) and B9 (``schur3_update_planes``) and its
    phase-2c cases of ``schur_update_planes`` (quadruped shapes: G=256 or
    N=512 knots by B=256), and of their library calls."""
    G, Bb, N = 256, 256, 512
    out = {}
    for p, K, q in ((36, 36, 36), (36, 12, 36), (12, 12, 12)):
        A, Bm = R(p, K, G, Bb), R(K, q, G, Bb)
        out[f"pgemm {p}x{K}.{K}x{q}"] = _pair(
            torch, planes.pgemm, lambda: (A, Bm))
        a, b = _ml(A), _ml(Bm)
        lib = lambda: torch.matmul(a, b)
        out[f"library pgemm {p}x{K}.{K}x{q}"] = (_med(torch, lib, tuple),
                                                 _chained(torch, lib))
        del A, Bm, a, b, lib
    for nx, nu, q, level in ((36, 12, 36, 0), (36, 12, 36, 7),
                             (36, 12, 1, 0), (12, 4, 12, 0)):
        Gl = N >> (level + 1)
        FL = [R(nx, nx, N, Bb), R(nx, nx, N, Bb), R(nu, nx, N, Bb)]
        fs = 0.1 * R(nx, q, Gl, Bb)
        C = [R(nx, q, N, Bb), R(nx, q, N, Bb), R(nu, q, N, Bb)]
        out[f"schur3 n={nx} q={q} L{level}"] = _pair(
            torch, lambda *c: planes.schur3_update_planes(
                *FL, fs, *c, level=level),
            lambda: [c.clone() for c in C])
        lib = _trio_lib(torch, [x.reshape(-1, N, Bb) for x in FL],
                        [[x.reshape(-1, N, Bb)] for x in C],
                        [fs.reshape(nx * q, Gl, Bb)], level, nx, N, Bb)
        out[f"library schur3 n={nx} q={q} L{level}"] = (
            _med(torch, lib, tuple), _chained(torch, lib))
        del FL, fs, C, lib
    for lam in (True, False):
        FL, fs, Fin = R(36, 36, N, Bb), 0.1 * R(36, 36, N // 2, Bb), R(
            36, 36, N, Bb)
        out[f"lam_level lam={lam}"] = _pair(
            torch, lambda c: planes.schur_update_planes(
                FL, fs, c, level=0, lam=lam), lambda: (Fin.clone(),))
        lib = _trio_lib(torch, [FL.reshape(-1, N, Bb)],
                        [[Fin.reshape(-1, N, Bb)]],
                        [fs.reshape(-1, N // 2, Bb)], 0, 36, N, Bb)
        out[f"library lam_level lam={lam}"] = (_med(torch, lib, tuple),
                                               _chained(torch, lib))
        del FL, fs, Fin, lib
    return out


def _spd(torch, R, d, *plane):
    """Random SPD blocks ``[d, d, *plane]`` (f32, well conditioned)."""
    M = R(*plane, d, d)
    S = M @ M.transpose(-1, -2) + d * torch.eye(d, device="cuda")
    return S.movedim((-2, -1), (0, 1)).contiguous()


def pcho_times(torch, planes, R):
    """``{case: (single ms, chained ms)}`` of B7 (``pcho_solve``) at the
    quadruped rsLQR's separator solves, n=36: w=36 at every level's plane
    (G = 256 / 2^L groups by B=256), w=1 at levels 0 and 7; and n=w=12, 16
    at level 0 (its library call, ``cholesky_solve``, is chip_smoke.py's
    phase 2b)."""
    G, Bb = 256, 256
    out = {}
    cases = ([(36, 36, level) for level in range(8)]
             + [(36, 1, 0), (36, 1, 7), (12, 12, 0), (16, 16, 0)])
    for d, w, level in cases:
        Gl = G >> level
        Lc = planes.pchol_plain(_spd(torch, R, d, Gl, Bb))
        X = R(d, w, Gl, Bb)
        out[f"pcho n={d} w={w} L{level}"] = _pair(
            torch, lambda x: planes.pcho_solve(Lc, x), lambda: (X.clone(),))
        del Lc, X
    return out


def pchol_times(torch, planes, R):
    """``{case: (single ms, chained ms)}`` of B6 (``pchol``) at the
    quadruped rsLQR's nine Cholesky planes, n=36 at F = (256 >> L) x 256 for
    L = 0..8, and at n=12 on the level-0 plane and the batched-interior
    gains pass's (511 x 256); beside each, ``cholesky_ex`` on mat-last
    views, single only (a batched Cholesky captured in a CUDA graph breaks
    MAGMA's next call)."""
    cases = ([(36, 256 >> level, f"L{level}") for level in range(9)]
             + [(12, 256, "L0"), (12, 511, "interior")])
    out = {}
    for d, G, tag in cases:
        S = _spd(torch, R, d, G, 256)
        out[f"pchol n={d} {tag} F={G}x256"] = _pair(
            torch, planes.pchol, lambda: (S,))
        ml = _ml(S)
        out[f"library pchol n={d} {tag} F={G}x256"] = (
            _med(torch, torch.linalg.cholesky_ex, lambda: (ml,)), None)
        del S, ml
    return out


def plu_times(torch, planes, R):
    """``{case: (single ms, chained ms)}`` of B8 (``plu_solve_multi``) at the
    quadruped pscan's three shapes (chip_smoke.py phase 2c): n=12 w=(12,)
    at 16 x 256 (the Woodbury solve), n=36 w=(36, 1, 36, 1) at 8 x 256 and
    n=36 w=(36, 1) at 7 x 256 (the suffix tree's I + C J solves); beside
    each, ``lu_factor_ex`` + ``lu_solve`` on mat-last views, single only."""
    out = {}
    for n, ws, G in ((12, (12,), 16), (36, (36, 1, 36, 1), 8),
                     (36, (36, 1), 7)):
        M = R(G, 256, n, n) * n ** -0.5
        P = R(G, 256, n, n) * n ** -0.5
        IC = torch.eye(n, device="cuda") + (M @ M.transpose(-1, -2)) @ (
            P @ P.transpose(-1, -2))
        A = IC.movedim((-2, -1), (0, 1)).contiguous()
        Bs = [R(n, w, G, 256) for w in ws]
        label = f"n={n} w={ws} F={G}x256"
        out[f"plu {label}"] = _pair(
            torch, lambda *a: planes.plu_solve_multi(*a), lambda: (A, *Bs))
        Aml = _ml(A)
        Bml = torch.cat([_ml(b) for b in Bs], dim=2)

        def lib(a, b):
            LU, piv, _ = torch.linalg.lu_factor_ex(a)
            return torch.linalg.lu_solve(LU, piv, b)

        out[f"library plu {label}"] = (_med(torch, lib, lambda: (Aml, Bml)),
                                       None)
        del M, P, IC, A, Bs, Aml, Bml
    return out


def _leaf_pair(torch, schur, flat, R, n, m, tag):
    """``{case: (single ms, chained ms)}`` of B3 and B11 on the same data at
    block (n, m), N=256, B=1024, depth 8."""
    N, B = 256, 1024
    depth = N.bit_length() - 1
    xx, ux = n * n, m * n
    pos = lambda *s: 0.5 + torch.rand(s, device="cuda")
    leaf = [R(xx, N, B), 0.2 * R(ux, N, B), pos(n, N, B), pos(m, N, B),
            R(N // 2, xx, B),
            [0.1 * R(N // 2, xx, B) for _ in range(depth - 1)],
            R(N // 4, xx, B), R(N // 4, ux, B)]
    out = {f"B3 {tag}N=256": _pair(
        torch, lambda *a: schur.leaf_schur_level0_em(
            *a, depth=depth, n=n, m=m), lambda: leaf)}
    fl = lambda x: x.reshape(x.shape[0], -1, 128) if x.shape[1] == N else (
        x.transpose(0, 1).reshape(x.shape[1], -1, 128))
    fleaf = [fl(x) if not isinstance(x, list) else [fl(y) for y in x]
             for x in leaf]
    del leaf
    out[f"B11 {tag}N=256"] = _pair(
        torch, lambda *a: flat.leaf_schur_level0_flat(
            *a, depth=depth, n=n, m=m, N=N), lambda: fleaf)
    return out


def leaf_times(torch, schur, flat, R):
    """``{case: (single ms, chained ms)}`` of B3 and B11 at the other and
    wide small blocks."""
    out = {}
    for n, m in LEAF_BLOCKS:
        out.update(_leaf_pair(torch, schur, flat, R, n, m, f"n={n} m={m} "))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--config", choices=sorted(CONFIGS), default="small")
    ap.add_argument("--solver", choices=("rslqr", "pscan"), default="rslqr")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--sets", default=",".join(SETS),
                    help="kernel case sets for --kernels, of "
                    + ", ".join(SETS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import rslqr_tpu_torch as pt
    from rslqr_tpu_torch.ops import _build, flat, planes, schur

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
        gen = torch.Generator(device="cuda").manual_seed(1)
        R = lambda *s: torch.randn(s, generator=gen, device="cuda")
        runs = {"sweep": lambda: sweep_times(torch, schur, flat, R),
                "plane": lambda: plane_times(torch, planes, R),
                "pcho": lambda: pcho_times(torch, planes, R),
                "pchol": lambda: pchol_times(torch, planes, R),
                "plu": lambda: plu_times(torch, planes, R),
                "flagged": lambda: flagged_times(torch, planes, R),
                "flat": lambda: flat_level_times(torch, flat, R),
                "leaf": lambda: leaf_times(torch, schur, flat, R)}
        times = {}
        for name in args.sets.split(","):
            times.update(runs[name]())
        for case, (single, chained) in times.items():
            ch = "none" if chained is None else f"{chained:.4f} ms"
            print(f"time_solve root={root.name} kernel {case}: single "
                  f"{single:.4f} ms, chained {ch}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
