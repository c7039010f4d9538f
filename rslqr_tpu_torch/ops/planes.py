"""Mid-block (8 < n <= 64) linear algebra on element planes, for Hopper.

Counterpart of ``rslqr_tpu/ops/planes_pallas.py``. Arrays are element-plane
blocks ``[p, q, *plane]``: block element ``(i, j)`` is a dense plane that
carries the (knot x batch) or (group x batch) grid, flattened to ``F``
plane elements (element ``(i, j)`` at ``(i*q + j)*F + f``). Each wrapper
keeps the name and the function of its JAX counterpart; the TPU tile
artifacts of the JAX module (the ``(F//128, 128)`` reshape and the row
padding of ``linalg._pv``) are not carried over: the CUDA kernels index any
plane size directly.

Dispatch (``ops/schur.py``'s :func:`kernel_applies`, the one rule of the
port): a wrapper launches its CUDA kernel (``csrc/planes_kernels.cu``;
flagged ``pgemm``: ``csrc/flagged_kernels.cu``; ``plu_solve_multi``:
``csrc/plu_kernels.cu``) for float32 CUDA tensors under
``kernels="auto"``, and runs its plain PyTorch version (``*_plain``)
otherwise (CPU tensors, ``kernels="off"``, other dtypes). A kernel that
applies launches or raises (block dims outside 1..``MAX_BLOCK``,
contiguity, shapes); there is no fallback. Each wrapper counts its
launches in its ``launches`` attribute (:func:`launch_counts`).

``pcho_solve``, ``schur3_update_planes``, ``schur3_update_levels`` and
``schur_update_planes`` update their right-hand side / slab operands IN
PLACE on both routes, as the TPU kernels alias them
(``input_output_aliases``), and return them. ``pgemm``
with ``Cin`` and ``plu_solve_multi`` return new tensors and leave every
operand as it is: their callers (the parallel-scan combines) pass views and
operands they read again, which the TPU kernels' aliasing (an XLA hint
that keeps the semantics) never overwrote.

What bounds the kernels on the card: every one streams its operands once
with a few FLOP per byte (at n=36: pgemm ~6, the Schur update ~3
FLOP/byte), far below the H100's ~20 f32 FLOP/byte balance, so they are
bandwidth-bound. The design (details in the CUDA source): a block owns 32
plane elements, one per lane, so every plane load and store is a
coalesced 128-byte line; the products and the Schur update stage a column
slice of the right-hand operand of those plane elements in shared memory
and give every output row, two per warp, of that slice to the block
(column slices of one plane chunk run together, so the left operand comes
from HBM once and from L2 after); the factor sweep's Schur update takes
every upper level of a level in one launch (``schur3_update_levels``), so
the level's multiplier slabs come from HBM once; the Cholesky solve keeps
the factor in shared memory; the Cholesky and the LU give each thread one
row of one plane element's block, eight elements per block, in registers.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .schur import _launch, _masks, _ptr, kernel_applies

# Largest block dim the kernels take (their register columns hold 64).
MAX_BLOCK = 64
# Right-hand sides per plu_solve_multi launch, and the narrowest state dim
# that takes ``plu_kernel``'s wide instantiations (W = 48, 64: the LU in
# dynamic shared memory past 48 KB).
MAX_RHS = 4
LU_WIDE_MIN = 37
# Upper levels per schur3_update_levels launch (the pointers its C entry
# takes, ``levels::UG`` in csrc/planes_kernels.cu); more take more launches.
UPPER_GROUP = 16


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; CPU tests and kernels="off").
# ---------------------------------------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``[p, q, *plane] -> [p, q, F]``."""
    return x.reshape(x.shape[0], x.shape[1], -1)


def pgemm_plain(A, B, Cin=None, diag=None, kscale=None, *, ta=False,
                tbt=False, sub=True, dconst=0.0, sym=False) -> torch.Tensor:
    """Plain version of :func:`pgemm`: one einsum over the planes (what the
    JAX package's ``_bgemm_mxu`` fallback computes), then the epilogues in
    the TPU kernel's order (``Cin``, then the diagonal; ``sym`` keeps the
    lower triangle and mirrors it)."""
    a, b = _flat(A), _flat(B)
    if ta:
        a = a.transpose(0, 1)
    if tbt:
        b = b.transpose(0, 1)
    if kscale is not None:  # scale the A side per (i, k), as the TPU kernel
        a = a * kscale.reshape(1, a.shape[1], -1)
    p, q = a.shape[0], b.shape[1]
    C = torch.einsum("ikf,kjf->ijf", a, b)
    if Cin is not None:
        C = _flat(Cin) - C if sub else _flat(Cin) + C
    if diag is not None or dconst:
        idx = torch.arange(p, device=C.device)
        dg = C[idx, idx]
        if diag is not None:
            dg = dg + diag.reshape(p, -1)
        if dconst:
            dg = dg + dconst
        C[idx, idx] = dg  # C is a fresh tensor here
    if sym:
        low = torch.ones((p, p), dtype=torch.bool, device=C.device).tril()
        C = torch.where(low[:, :, None], C, C.transpose(0, 1))
    return C.reshape((p, q) + A.shape[2:])


def pchol_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pchol`: the left-looking column algorithm of
    the TPU kernel (``_chol_kernel``), one column at a time over all
    planes."""
    n = A.shape[0]
    L = torch.zeros_like(A)
    for j in range(n):
        acc = A[j:, j]
        if j:
            acc = acc - (L[j:, :j] * L[j, :j][None]).sum(1)
        L[j:, j] = acc * torch.rsqrt(acc[0])[None]
    return L


def pcho_solve_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pcho_solve`: forward then back substitution,
    row by row, in place on ``B``."""
    n = L.shape[0]
    for i in range(n):
        acc = B[i]
        if i:
            acc = acc - (L[i, :i, None] * B[:i]).sum(0)
        B[i] = acc / L[i, i][None]
    for i in reversed(range(n)):
        acc = B[i]
        if i + 1 < n:
            acc = acc - (L[i + 1:, i, None] * B[i + 1:]).sum(0)
        B[i] = acc / L[i, i][None]
    return B


def schur_update_planes_plain(FL, fsol, Fin, *, level, lam):
    """Plain version of :func:`schur_update_planes`, in place on ``Fin``."""
    p, n, N, Bb = FL.shape
    q, G = fsol.shape[1], fsol.shape[2]
    span = N // G
    prod = torch.einsum(
        "ikgsb,kjgb->ijgsb", FL.reshape(p, n, G, span, Bb), fsol
    ).reshape(p, q, N, Bb)
    if not lam:
        return Fin.sub_(prod)
    keep, sep = _masks(level, N, FL.device)
    fs_full = fsol[:p, :, :, None].expand(p, q, G, span, Bb).reshape(
        p, q, N, Bb)
    return Fin.copy_(
        torch.where(sep, fs_full, Fin - torch.where(keep, prod, 0.0)))


def schur3_update_planes_plain(FLl, FLx, FLu, fsol, Cl, Cx, Cu, *, level):
    """Plain version of :func:`schur3_update_planes`."""
    for FL, C, lam in ((FLl, Cl, True), (FLx, Cx, False), (FLu, Cu, False)):
        schur_update_planes_plain(FL, fsol, C, level=level, lam=lam)
    return Cl, Cx, Cu


def schur3_update_levels_plain(FLl, FLx, FLu, fsols, Cls, Cxs, Cus, *,
                               level):
    """Plain version of :func:`schur3_update_levels`: the plain B9 of each
    upper level in turn."""
    for fs, Cl, Cx, Cu in zip(fsols, Cls, Cxs, Cus):
        schur3_update_planes_plain(FLl, FLx, FLu, fs, Cl, Cx, Cu, level=level)
    return Cls, Cxs, Cus


def plu_solve_multi_plain(A: torch.Tensor, *Bs: torch.Tensor):
    """Plain version of :func:`plu_solve_multi`: the TPU kernel's
    (``_lu_solve_kernel``) unpivoted Doolittle LU, one column step at a time
    over all planes, then per right-hand side the unit-lower forward and the
    upper back substitution, row by row. Returns new tensors."""
    n = A.shape[0]
    LU = A.clone()
    for k in range(n - 1):
        f = LU[k + 1:, k] * (1.0 / LU[k, k])[None]
        LU[k + 1:, k] = f
        LU[k + 1:, k + 1:] -= f[:, None] * LU[k, k + 1:][None]
    outs = []
    for B in Bs:
        X = B.clone()
        for i in range(1, n):
            X[i] = X[i] - (LU[i, :i, None] * X[:i]).sum(0)
        for i in reversed(range(n)):
            acc = X[i]
            if i + 1 < n:
                acc = acc - (LU[i, i + 1:, None] * X[i + 1:]).sum(0)
            X[i] = acc * (1.0 / LU[i, i])[None]
        outs.append(X)
    return tuple(outs)


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


# flagged_kernel's output tile: FLAG_TC columns, FLAG_IB rows per warp
# (csrc/flagged_kernels.cu).
FLAG_IB, FLAG_TC = 2, 6


class FlaggedPlan(NamedTuple):
    """Launch geometry of ``flagged_kernel``: ``warps`` warps per block,
    each taking ``FLAG_IB`` rows of a tile of ``FLAG_IB * warps`` rows by
    ``FLAG_TC`` columns; ``tiles`` the tile origins ``(row, column)``, one
    grid row each; ``grid`` ``(plane chunks of 32, tiles)``; ``c_tiles`` the
    origins flattened for the C launcher."""

    warps: int
    tiles: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int]
    c_tiles: object


@functools.lru_cache(maxsize=256)
def _flagged_plan(p: int, q: int, F: int, sym: bool) -> FlaggedPlan:
    """The tiles of a ``p x q`` output over ``F`` plane elements: rows in
    tiles of 12 (6 when ``p <= 6``), columns in tiles of 6; under ``sym``
    only the tiles that hold an entry on or below the diagonal."""
    warps = 3 if p <= 3 * FLAG_IB else 6
    tr, tc = warps * FLAG_IB, FLAG_TC
    tiles = tuple(
        (r0, c0) for r0 in range(0, p, tr) for c0 in range(0, q, tc)
        if not sym or c0 <= min(r0 + tr, p) - 1)
    flat = [v for t in tiles for v in t]
    return FlaggedPlan(warps, tiles, (-(-F // 32), len(tiles)),
                       (ctypes.c_int * len(flat))(*flat))


def _check(name: str, tensors: Sequence[torch.Tensor], shapes, dims):
    """The kernels' contract: f32, contiguous, on one device, the expected
    shapes, block dims in 1..MAX_BLOCK and a nonempty plane."""
    device = tensors[0].device
    for d in dims:
        if not 1 <= d <= MAX_BLOCK:
            raise ValueError(
                f"{name}: CUDA kernels take block dims 1..{MAX_BLOCK}, got "
                f"{tuple(dims)}"
            )
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(
                f"{name}: kernel takes float32 tensors on {device}, got "
                f"{t.dtype} on {t.device}"
            )
        if t.shape != shape:
            raise ValueError(
                f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    F = math.prod(tensors[0].shape[2:])
    if not 0 < F < 2**31:
        raise ValueError(f"{name}: plane size {F} out of range")
    return F


def pgemm(
    A: torch.Tensor,                       # [p, K, *plane] ([K, p, ..] if ta)
    B: torch.Tensor,                       # [K, q, *plane] ([q, K, ..] if tbt)
    Cin: Optional[torch.Tensor] = None,    # [p, q, *plane]
    diag: Optional[torch.Tensor] = None,   # [p, *plane] added on the diagonal
    kscale: Optional[torch.Tensor] = None,  # [K, *plane] contraction scale
    *,
    ta: bool = False,
    tbt: bool = False,
    sub: bool = True,
    dconst: float = 0.0,
    sym: bool = False,
    kernels: str = "auto",
):
    """Planewise block matmul with the TPU kernel's flags:
    ``C = Cin -/+ op(A) diag(kscale) op(B)``, plus ``diag`` and ``dconst``
    on the diagonal; ``sym``: the output is symmetric (``Cin`` must be), only
    its lower triangle is computed. ``C`` is a new tensor: ``Cin`` is read,
    never overwritten (the TPU kernel aliases it to the output; here the
    caller may still hold it, for example as a view).

    Replaces ``rslqr_tpu/ops/planes_pallas.py:_pgemm_call`` (its
    ``lam_level`` mode is :func:`schur_update_planes`). Kernel:
    ``rows_kernel`` (``csrc/planes_kernels.cu``); when any flag is set,
    ``flagged_kernel`` (``csrc/flagged_kernels.cu``) on the launch geometry
    of :func:`_flagged_plan`.
    """
    p, K = (A.shape[1], A.shape[0]) if ta else (A.shape[0], A.shape[1])
    q = B.shape[0] if tbt else B.shape[1]
    if (diag is not None or dconst or sym) and p != q:
        raise ValueError(f"diag/sym need a square output, got {p}x{q}")
    if not kernel_applies(kernels, A.device, A.dtype):
        return pgemm_plain(A, B, Cin, diag, kscale, ta=ta, tbt=tbt, sub=sub,
                           dconst=dconst, sym=sym)
    plane = tuple(A.shape[2:])
    opt = [(t, s) for t, s in ((Cin, (p, q)), (diag, (p,)), (kscale, (K,)))
           if t is not None]
    F = _check(
        "pgemm", [A, B] + [t for t, _ in opt],
        [((K, p) if ta else (p, K)) + plane,
         ((q, K) if tbt else (K, q)) + plane] + [s + plane for _, s in opt],
        (p, K, q),
    )
    C = torch.empty((p, q) + plane, device=A.device)
    if opt or ta or tbt or sym or dconst:
        plan = _flagged_plan(p, q, F, sym)
        _launch("rslqr_pgemm_flagged", A.device, _ptr(A), _ptr(B), _ptr(Cin),
                _ptr(diag), _ptr(kscale), _ptr(C), p, K, q, F, int(ta),
                int(tbt), int(sub), int(sym), dconst, plan.warps,
                len(plan.tiles), plan.c_tiles)
        pgemm.flagged_launches += 1
    else:
        _launch("rslqr_pgemm", A.device, _ptr(A), _ptr(B), _ptr(C), p, K, q,
                F)
    pgemm.launches += 1
    return C


def pgemm_acc(A, B, Cin, *, sub=True, ta=False, tbt=False,
              kernels: str = "auto"):
    """``C = Cin -/+ op(A) @ op(B)`` in one pass (a new tensor; ``Cin`` is
    left as it is). Replaces ``planes_pallas.py:pgemm_acc``."""
    return pgemm(A, B, Cin, ta=ta, tbt=tbt, sub=sub, kernels=kernels)


def pchol(A: torch.Tensor, *, kernels: str = "auto"):
    """Cholesky of SPD blocks ``[n, n, *plane]`` -> lower ``L`` (a new
    tensor, strict upper triangle zero).

    Replaces ``rslqr_tpu/ops/planes_pallas.py:pchol``. Kernel:
    ``pchol_kernel``.
    """
    n = A.shape[0]
    if not kernel_applies(kernels, A.device, A.dtype):
        return pchol_plain(A)
    F = _check("pchol", (A,), ((n, n) + tuple(A.shape[2:]),), (n,))
    L = torch.empty_like(A)
    _launch("rslqr_pchol", A.device, _ptr(A), _ptr(L), n, F)
    pchol.launches += 1
    return L


def pcho_solve(L: torch.Tensor, B: torch.Tensor, *, kernels: str = "auto"):
    """Solve ``(L L') X = B`` for ``L [n, n, *plane]`` and ``B [n, w,
    *plane]``, in place on ``B``; returns it.

    Replaces ``rslqr_tpu/ops/planes_pallas.py:pcho_solve``. Kernel:
    ``pcho_solve_kernel``.
    """
    n, w = B.shape[:2]
    if not kernel_applies(kernels, L.device, L.dtype):
        return pcho_solve_plain(L, B)
    plane = tuple(L.shape[2:])
    F = _check("pcho_solve", (L, B), ((n, n) + plane, (n, w) + plane), (n, w))
    _launch("rslqr_pcho_solve", L.device, _ptr(L), _ptr(B), n, w, F)
    pcho_solve.launches += 1
    return B


def schur3_update_planes(
    FLl: torch.Tensor,   # [n, n, N, B] level-L lambda multiplier slab
    FLx: torch.Tensor,   # [n, n, N, B]
    FLu: torch.Tensor,   # [m, n, N, B]
    fsol: torch.Tensor,  # [n, q, G, B] solved separators, G = N / 2^(L+1)
    Cl: torch.Tensor,    # [n, q, N, B] upper-level slabs (updated in place)
    Cx: torch.Tensor,    # [n, q, N, B]
    Cu: torch.Tensor,    # [m, q, N, B]
    *,
    level: int,
    kernels: str = "auto",
):
    """One fused Schur update of an upper level's lambda/state/input slabs
    (ndlqr_UpdateShurFactor + ShouldCalcLambda + the separator write-back,
    nested_dissection.c:154-177):

      l' = where(sep, fs, l - where(keep, FLl @ fs, 0))
      x' = x - FLx @ fs;   u' = u - FLu @ fs

    with ``fs`` the solved separator of knot k's group ``k >> (L+1)``,
    ``keep = (k mod 2^L != 0) or k = 0`` and ``sep = (k mod 2^(L+1) =
    2^L)``. ``q = n`` in the factor sweep, ``q = 1`` for the RHS sweep's
    vectors. Updates ``Cl, Cx, Cu`` in place and returns them.

    Replaces ``rslqr_tpu/ops/planes_pallas.py:schur3_update_planes``, which
    takes ``fs`` broadcast over each group's knots; this wrapper takes the
    compact ``fsol`` and the kernel reads it at the knot's group.
    Kernel: ``rows_kernel`` (the three slabs' rows, lambda rows masked).
    """
    n, _, N, Bb = FLl.shape
    m = FLu.shape[0]
    q = fsol.shape[1]
    if not kernel_applies(kernels, FLl.device, FLl.dtype):
        return schur3_update_planes_plain(
            FLl, FLx, FLu, fsol, Cl, Cx, Cu, level=level
        )
    G = N >> (level + 1)
    if G < 1 or N % (2 << level):
        raise ValueError(f"schur3_update_planes: level {level} for N={N}")
    _check(
        "schur3_update_planes", (FLl, FLx, FLu, fsol, Cl, Cx, Cu),
        ((n, n, N, Bb), (n, n, N, Bb), (m, n, N, Bb), (n, q, G, Bb),
         (n, q, N, Bb), (n, q, N, Bb), (m, q, N, Bb)), (n, m, q),
    )
    _launch(
        "rslqr_schur3_update_planes", FLl.device,
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptr(fsol), _ptr(Cl), _ptr(Cx),
        _ptr(Cu), n, m, q, N, Bb, level,
    )
    schur3_update_planes.launches += 1
    return Cl, Cx, Cu


def schur3_update_levels(
    FLl: torch.Tensor,             # [n, n, N, B] level-L lambda multipliers
    FLx: torch.Tensor,             # [n, n, N, B]
    FLu: torch.Tensor,             # [m, n, N, B]
    fsols: Sequence[torch.Tensor],  # U x [n, q, G, B], G = N / 2^(L+1)
    Cls: Sequence[torch.Tensor],   # U x [n, q, N, B] (updated in place)
    Cxs: Sequence[torch.Tensor],   # U x [n, q, N, B]
    Cus: Sequence[torch.Tensor],   # U x [m, q, N, B]
    *,
    level: int,
    kernels: str = "auto",
):
    """:func:`schur3_update_planes` of every upper level of level ``L`` at
    once: for each ``u``, ``(Cls[u], Cxs[u], Cus[u])`` updated in place
    with ``fsols[u]`` and this level's multiplier slabs. Returns the three
    lists.

    Replaces ``rslqr_tpu/ops/planes_pallas.py:schur3_update_planes`` as the
    factor sweep calls it, once per upper level (JAX rslqr_em.py's level
    update). Kernel: ``levels::rows_kernel`` (``csrc/planes_kernels.cu``),
    one launch per ``UPPER_GROUP`` upper levels, so the level's multiplier
    slabs come from device memory once; each output is ``rows_kernel``'s
    bit for bit. ``launches`` counts its launches,
    ``upper_updates`` the (level, upper level) pairs they covered.
    """
    U = len(fsols)
    if not U == len(Cls) == len(Cxs) == len(Cus):
        raise ValueError(f"schur3_update_levels: {U} fsols for "
                         f"{len(Cls)}/{len(Cxs)}/{len(Cus)} slabs")
    if not kernel_applies(kernels, FLl.device, FLl.dtype):
        return schur3_update_levels_plain(FLl, FLx, FLu, fsols, Cls, Cxs,
                                          Cus, level=level)
    n, _, N, Bb = FLl.shape
    m = FLu.shape[0]
    q = fsols[0].shape[1] if U else n
    G = N >> (level + 1)
    if G < 1 or N % (2 << level):
        raise ValueError(f"schur3_update_levels: level {level} for N={N}")
    _check(
        "schur3_update_levels", (FLl, FLx, FLu, *fsols, *Cls, *Cxs, *Cus),
        ((n, n, N, Bb), (n, n, N, Bb), (m, n, N, Bb))
        + ((n, q, G, Bb),) * U + ((n, q, N, Bb),) * (2 * U)
        + ((m, q, N, Bb),) * U, (n, m, q),
    )
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(
        *(t.data_ptr() for t in ts))
    for s in range(0, U, UPPER_GROUP):
        sl = slice(s, s + UPPER_GROUP)
        _launch(
            "rslqr_schur3_update_levels", FLl.device,
            _ptr(FLl), _ptr(FLx), _ptr(FLu), ptrs(fsols[sl]), ptrs(Cls[sl]),
            ptrs(Cxs[sl]), ptrs(Cus[sl]), len(fsols[sl]), n, m, q, N, Bb,
            level,
        )
        schur3_update_levels.launches += 1
    schur3_update_levels.upper_updates += U
    return Cls, Cxs, Cus


def schur_update_planes(
    FL: torch.Tensor,    # [p, n, N, B] level-L multiplier slab
    fsol: torch.Tensor,  # [n, q, G, B] solved separators, G = N / 2^(L+1)
    Fin: torch.Tensor,   # [p, q, N, B] upper-level slab (updated in place)
    *,
    level: int,
    lam: bool,
    kernels: str = "auto",
):
    """Mid-block Schur update of one upper-level slab, in place on ``Fin``:

      out = Fin - FL @ fs                               (x / u slab, lam=False)
      out = where(sep, fs, Fin - where(keep, FL @ fs, 0))  (lambda, lam=True)

    with ``fs`` the solved separator of knot k's group and ``keep``/``sep``
    the masks of :func:`schur3_update_planes` (which runs three such slabs
    in one pass). ``lam=True`` needs ``p <= n``.

    Replaces ``rslqr_tpu/ops/planes_pallas.py:schur_update_planes``
    (``_pgemm_call`` with ``lam_level``), which takes ``fs`` broadcast over
    each group's knots and the flattened plane's ``logb``; this wrapper
    takes the compact ``fsol`` and the plane's ``[N, B]`` shape, as B9's
    does. No module of either package calls it. Kernel: ``rows_kernel`` in
    its Schur mode, with one slab.
    """
    p, n, N, Bb = FL.shape
    q = fsol.shape[1]
    if lam and p > n:
        raise ValueError(f"schur_update_planes: lam needs p <= n, got {p}, {n}")
    if not kernel_applies(kernels, FL.device, FL.dtype):
        return schur_update_planes_plain(FL, fsol, Fin, level=level, lam=lam)
    G = N >> (level + 1)
    if G < 1 or N % (2 << level):
        raise ValueError(f"schur_update_planes: level {level} for N={N}")
    _check("schur_update_planes", (FL, fsol, Fin),
           ((p, n, N, Bb), (n, q, G, Bb), (p, q, N, Bb)), (p, n, q))
    _launch("rslqr_schur_update_planes", FL.device, _ptr(FL), _ptr(fsol),
            _ptr(Fin), p, n, q, N, Bb, level, int(lam))
    schur_update_planes.launches += 1
    return Fin


def plu_solve_multi(A: torch.Tensor, *Bs: torch.Tensor, kernels: str = "auto"):
    """Solve ``A X_r = B_r`` for 1-4 right-hand sides with ONE unpivoted
    LU: ``A [n, n, *plane]``, ``B_r [n, w_r, *plane]``; returns the tuple of
    ``X_r``, new tensors (the ``B_r`` are left as they are; the TPU kernel
    aliases them to its outputs). No pivoting: for well-conditioned blocks
    such as the parallel scan's ``I + C J``.

    Replaces ``rslqr_tpu/ops/planes_pallas.py:plu_solve_multi``. Kernel:
    ``plu_kernel`` (``csrc/plu_kernels.cu``: 8 plane elements a block, A's
    rows in registers factored into a column-major LU in shared memory,
    then the right-hand columns one a thread; at the register width 12, 36,
    48 or 64 that holds n). ``shape_launches`` counts the launches by
    (n, widths, plane); :func:`wide_launches` those at n >= ``LU_WIDE_MIN``.
    """
    if not 1 <= len(Bs) <= MAX_RHS:
        raise ValueError(f"plu_solve_multi takes 1..{MAX_RHS} right-hand "
                         f"sides, got {len(Bs)}")
    n = A.shape[0]
    ws = [b.shape[1] for b in Bs]
    if not kernel_applies(kernels, A.device, A.dtype):
        return plu_solve_multi_plain(A, *Bs)
    plane = tuple(A.shape[2:])
    F = _check("plu_solve_multi", (A,) + Bs,
               ((n, n) + plane,) + tuple((n, w) + plane for w in ws),
               (n, *ws))
    Xs = tuple(torch.empty((n, w) + plane, device=A.device) for w in ws)
    ptrs = lambda ts: (ctypes.c_void_p * MAX_RHS)(
        *(t.data_ptr() for t in ts))
    _launch("rslqr_plu_solve_multi", A.device, _ptr(A), ptrs(Bs), ptrs(Xs),
            (ctypes.c_int * MAX_RHS)(*ws), len(Bs), n, F)
    plu_solve_multi.launches += 1
    plu_solve_multi.shape_launches[(n, tuple(ws), plane)] += 1
    return Xs


def plu_solve(A: torch.Tensor, B: torch.Tensor, *, kernels: str = "auto"):
    """Single right-hand side :func:`plu_solve_multi` (replaces
    ``planes_pallas.py:plu_solve``)."""
    return plu_solve_multi(A, B, kernels=kernels)[0]


KERNEL_WRAPPERS = (pgemm, pchol, pcho_solve, schur3_update_planes,
                   schur3_update_levels, schur_update_planes,
                   plu_solve_multi)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset: ``pgemm`` counts
    both its kernels, ``pgemm_flagged`` those of ``flagged_kernel``
    alone; beside them ``schur3_update_levels_pairs``, the (level, upper
    level) pairs that ``schur3_update_levels``' launches covered."""
    return {**{w.__name__: w.launches for w in KERNEL_WRAPPERS},
            "pgemm_flagged": pgemm.flagged_launches,
            "schur3_update_levels_pairs": schur3_update_levels.upper_updates}


def wide_launches() -> int:
    """``plu_solve_multi``'s launches at n >= ``LU_WIDE_MIN`` (its W = 48
    and 64 instantiations) since the last reset."""
    return sum(v for (n, *_), v in plu_solve_multi.shape_launches.items()
               if n >= LU_WIDE_MIN)


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    pgemm.flagged_launches = 0
    schur3_update_levels.upper_updates = 0
    # plu_solve_multi's launches by (n, widths of the right-hand sides,
    # plane).
    plu_solve_multi.shape_launches = collections.Counter()


reset_launch_counts()
