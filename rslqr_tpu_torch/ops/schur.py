"""The four sweep kernels of the element-major rsLQR path, for Hopper.

Each wrapper keeps the signature, layouts and return contract of its
counterpart in ``rslqr_tpu/ops/schur_pallas.py``:

* factor slabs are element-major ``[nn, N, B]`` / ``[mn, N, B]`` planes
  (``nn = n*n``, ``mn = m*n``; element ``e`` of knot ``k``, batch column
  ``b`` at ``e*N*B + k*B + b``);
* solved separator blocks and emitted products are group-major
  ``[G, nn, B]``;
* the next-level products ``S_next`` are returned exactly when the JAX
  kernel returns them (:func:`_level_emits`, :func:`_pair_emits` carry its
  tiling-based choice over), with the next level's own Sbar folded into its
  slab.

Dispatch (:func:`kernel_applies`, the one rule of every kernel family of
the port): a wrapper launches its CUDA kernel (``csrc/schur_kernels.cu``)
for float32 CUDA tensors under ``kernels="auto"``, and runs its plain
PyTorch version (``*_plain``) otherwise: CPU tensors, ``kernels="off"`` and
other dtypes (the reference sends them to XLA stages). The dtype that
routes is the compute dtype (separators, z vectors, problem data): the
factor slabs may be stored in bfloat16 (``SolveOptions.factor_dtype``),
and then both routes load them into f32, compute in f32 and round each
slab element once at its store, at the JAX kernels' points
(schur_pallas.py:214-216, 255-257, 563-565): the products emitted from the
unrounded values, the separator fold before the rounding, one rounding
per level in B1 and per pair of levels in B4, whose level-(L+1)
multiplier is slab L+1 as stored. Emission follows the storage dtype's
tiles (:func:`_level_emits`: levels 0-3 for bf16, 0-2 for f32). The rule
is static and decided before any launch: a kernel that applies launches or raises
(a state dim outside 1..``MAX_STATE`` or an input dim outside
1..``MAX_INPUT``, shapes, contiguity, a CUDA error); there is no fallback.
The kernels are instantiated for every block size the small-block path
takes (``csrc/small_blocks.cuh``: the reference's small-block Schur
kernels are gated on the state dim alone, so the input dim runs up to the
mid-block limit). The solver sends a block here only when its state dim
is at most ``min(mxu_block_threshold, MAX_STATE)``
(``rslqr_em._mid_block``); a state dim of 9..threshold under a raised
threshold takes the plane kernels (``ops/planes.py``) instead, so no
solve reaches the limit below. Each wrapper counts
its kernel launches in its ``launches`` attribute (see
:func:`launch_counts`).

Both routes update the input slabs (or z vectors) IN PLACE, as the TPU
kernels alias them (``input_output_aliases``), and return them. Callers that
need the inputs afterwards clone them first.

What bounds the kernels on the card: every kernel streams its slabs once.
Per knot and batch column and per upper level it reads and writes about
36+36+18 floats of slab and reads 36 floats of separator block (shared by
the whole group, so cached), against ~6 FMAs per slab element: about
0.4 FLOP per byte, far below the H100's ~20 FLOP/byte f32 balance, so they
are bandwidth-bound. The design does three things about it: batch columns
contiguous in a warp, so every slab load and store is a coalesced 128-byte
line; the level-L multiplier blocks are loaded into registers once and
reused for every upper level (the TPU kernels' VMEM reuse); and the
next-level products are emitted from the values just computed, so the
products stage re-reads no slab. B2 runs one thread per (knot, batch
column); B1, B3 and B4 split each knot's slab rows into groups of three,
one thread each (:func:`_level_plan`, ``csrc/row_groups.cuh``,
``csrc/leaf_rows.cuh``); with bf16 slabs, B1, B3 and B4 give each thread
two batch columns and stage their product emission in shared memory
(``csrc/bf16_rows.cuh``, ``csrc/bf16_kernels.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import storage_dtype

# Maximum number of upper slabs one launch takes (the kernels receive the
# slab pointers by value); tree depth <= 25.
MAXU = 24
# The largest state dim n and input dim m the CUDA kernels take
# (csrc/small_blocks.cuh: the exact (6, 3), the (4, 4) and (8, 8)
# capacities, and the wide tag for 8 < m <= 64, the mid-block limit).
MAX_STATE = 8
MAX_INPUT = 64


# ---------------------------------------------------------------------------
# Emission policy of the JAX kernels (schur_pallas._tiles / _tiles_pair).
# ---------------------------------------------------------------------------


def _min_tk(dtype) -> int:
    """The JAX kernels' least knot tile for slabs stored in ``dtype``: 16
    rows for bf16 (a packed (16, 128) tile), else 8."""
    return 16 if dtype == torch.bfloat16 else 8


def _level_emits(level: int, N: int, dtype=torch.float32) -> bool:
    """Whether ``schur_update_level_em`` emits the next level's products:
    the JAX kernel does when its knot tile (``_tiles``) covers whole
    next-level groups, i.e. at levels 0-2 for f32 slabs and 0-3 for bf16
    (``dtype``: the slabs' storage dtype)."""
    span = 1 << (level + 1)
    tk = min(max(2 * span, _min_tk(dtype)), 2 * _min_tk(dtype), N)
    return 2 * span <= tk and N >= 2 * span


def _pair_emits(level: int, N: int, B: int, U: int, n: int, m: int,
                dtype=torch.float32) -> bool:
    """Whether ``schur_update_pair_em`` emits the level-(L+2) products:
    the JAX kernel does when a knot tile covering whole L+2 groups fits its
    VMEM budget (``_tiles_pair``, 128-lane batch tiles, the slabs' storage
    ``dtype``)."""
    span2 = 2 << (level + 1)
    tk = max(2 * span2, _min_tk(dtype))
    tb = min(128, B)
    size = 2 if dtype == torch.bfloat16 else 4
    est = (1 + U) * (2 * n * n + m * n) * tk * tb * size * 2
    return U >= 2 and tk <= N and est <= 60 * 1024 * 1024


# ---------------------------------------------------------------------------
# Launch geometry of the row-group kernels (csrc/row_groups.cuh,
# csrc/leaf_rows.cuh): B1, B3 and B4 here, B10 and B11 in ops/flat.py.
# ---------------------------------------------------------------------------

# A block: LEVEL_TB lanes of batch columns by up to LEVEL_SLOTS row groups
# of LEVEL_RPT slab rows by LEVEL_KB knots (at most 1,024 threads); the
# pair kernel (B4) takes at most PAIR_WIDE_SLOTS at the wide inputs (m > 8).
# With bf16 slabs, B1, B3 and B4 give each lane PAIR_COLS adjacent batch
# columns (csrc/bf16_rows.cuh).
LEVEL_TB, LEVEL_KB, LEVEL_RPT, LEVEL_SLOTS = 32, 2, 3, 16
PAIR_WIDE_SLOTS = 8
PAIR_COLS = 2


class LevelPlan(NamedTuple):
    """Launch geometry of the row-group level kernels: grid row ``y``
    covers knots ``y * LEVEL_KB - shift`` .. ``+ LEVEL_KB - 1`` (those in
    ``[0, N)``), grid column ``x`` batch columns ``x * LEVEL_TB * cols``
    .. ``+ LEVEL_TB * cols - 1`` (those below ``B``; lane ``t`` takes the
    ``cols`` columns from ``(x * LEVEL_TB + t) * cols``); ``groups`` the
    row groups of the lambda, x and u slabs (row group ``z`` of a knot, in
    that order, takes slab rows ``LEVEL_RPT * (z - first group of its
    slab)`` .. ``+ LEVEL_RPT - 1``, those below the slab's row count);
    ``slots`` the block's threads per knot and lane, which take row groups
    ``slot, slot + slots, ...``. The bf16 level, pair and leaf kernels
    (``cols == 2``) move a lane's two columns as one 4-byte bf16 pair where
    ``vec`` (B even; a wrapper also needs its tensors aligned), and stage
    an emitting launch's products in ``smem`` bytes of shared memory a
    block (:func:`_pair2_smem`)."""

    shift: int
    grid: Tuple[int, int]
    groups: Tuple[int, int, int]
    slots: int
    cols: int = 1
    vec: bool = False
    smem: int = 0


def _row_groups(rows: int) -> int:
    """Row groups of a slab of ``rows`` rows (the last one partly masked
    where ``rows`` is not a multiple of ``LEVEL_RPT``)."""
    return -(-rows // LEVEL_RPT)


# The dynamic shared memory a block may take on sm_90.
SMEM_MAX = 227 * 1024


def _pair2_smem(n: int, m: int, slots: int, pair: bool, emit: bool) -> int:
    """Shared memory of a bf16 B4 (``pair``), or B1 or B3, block of
    ``slots`` row group slots (``csrc/bf16_rows.cuh``: ``smem2``). Below
    the wide inputs (m <= ``MAX_STATE``): B4's double buffer of each
    thread's rows of an upper slab (2 x ``LEVEL_RPT`` x n words a thread,
    filled a slab ahead) and its level-L multiplier rows (``LEVEL_RPT`` x
    n words), and, in an emitting launch, the products' stage (the f32 x
    and u rows of the
    separator knot r and the x rows of r + 1, ``2nn + mn`` values a batch
    column) and, where the block can hold them, A_sep and B_sep of its
    group; two stages where that keeps the blocks an SM that the register
    cap aims at (640 threads' worth). At the wide inputs one stage only."""
    hold = m <= MAX_STATE
    threads = LEVEL_TB * LEVEL_KB * slots
    blocks = max(1, 640 // threads)
    budget = min(SMEM_MAX, 233472 // blocks - 1024)
    cols = LEVEL_TB * PAIR_COLS
    vbuf = 3 * LEVEL_RPT * n * threads if pair and hold else 0
    stage = (2 * n * n + m * n) * cols if emit else 0
    sep = (n * n + n * m) * cols if emit and hold else 0
    if 4 * (vbuf + stage + sep) > SMEM_MAX:
        sep = 0  # (8, 8) B4: A_sep and B_sep from device memory
    one = 4 * (vbuf + stage + sep)
    nstage = 0 if not emit else (
        2 if hold and one + 4 * stage <= budget else 1)
    return 4 * (vbuf + nstage * stage + sep)


def _level_plan(N: int, B: int, emit: bool, n: int, m: int,
                pair: bool = False, bf16: bool = False,
                leaf: bool = False) -> LevelPlan:
    """Knot pairs shifted by one when the level emits products, so that
    each next-level group's separator row r (odd) and r + 1 share a
    block; unshifted otherwise. Row groups: ``ceil(n / 3)`` for each of the
    lambda and x slabs, ``ceil(m / 3)`` for u, in at most ``LEVEL_SLOTS``
    slots (``pair``: the pair kernel's, at most ``PAIR_WIDE_SLOTS`` at the
    wide inputs, m > ``MAX_STATE``). ``bf16`` slabs (B1, B4 with ``pair``,
    or B3 with ``pair`` and ``leaf``): ``PAIR_COLS`` batch columns a lane
    and :func:`_pair2_smem`."""
    shift = int(emit)
    groups = (_row_groups(n), _row_groups(n), _row_groups(m))
    cap = PAIR_WIDE_SLOTS if pair and m > MAX_STATE else LEVEL_SLOTS
    slots = min(sum(groups), cap)
    cols = PAIR_COLS if bf16 else 1
    return LevelPlan(
        shift, (-(-B // (LEVEL_TB * cols)), -(-(N + shift) // LEVEL_KB)),
        groups, slots, cols, cols > 1 and B % 2 == 0,
        _pair2_smem(n, m, slots, pair and not leaf, emit) if cols > 1 else 0)


def _check_pair2(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """The bf16 level, pair and leaf kernels index with 32-bit offsets:
    every tensor below 2^31 elements."""
    big = [tuple(t.shape) for t in tensors if t.numel() >= 2**31]
    if big:
        raise ValueError(f"{name}: bf16 kernels take tensors below 2^31 "
                         f"elements, got {big}")


def _vec(plan: LevelPlan, tensors: Sequence[torch.Tensor]) -> int:
    """Whether a bf16 level, pair or leaf launch moves column pairs as one
    access: the plan's ``vec``, and every tensor aligned to its pair (4
    bytes for bf16, 8 for f32)."""
    return int(plan.vec and all(
        t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; CPU tests and kernels="off").
# ---------------------------------------------------------------------------


def _masks(level: int, N: int, device):
    """calc_lambda mask (nested_dissection.c:173-177: knots that are
    multiples of 2^level skip the lambda update, except knot 0) and the
    separator write positions (knot % span == 2^level), as ``[N, 1]``."""
    half = 1 << level
    k = torch.arange(N, device=device)
    keep = ((k & (half - 1)) != 0) | (k == 0)
    sep = (k & (2 * half - 1)) == half
    return keep[:, None], sep[:, None]


def _bcast(fs: torch.Tensor, span: int) -> torch.Tensor:
    """Group-major ``[G, e, B]`` -> per-knot ``[e, G*span, B]``."""
    return fs.transpose(0, 1).repeat_interleave(span, dim=1)


def _mm(F: torch.Tensor, f: torch.Tensor, p: int, n: int) -> torch.Tensor:
    """Per-knot block product ``F @ f``: ``[p*n, N, B] x [n*q, N, B]``."""
    N, B = F.shape[1:]
    q = f.shape[0] // n
    out = torch.einsum(
        "ijkb,jlkb->ilkb", F.reshape(p, n, N, B), f.reshape(n, q, N, B)
    )
    return out.reshape(p * q, N, B)


def _emit_S(vl, vx, vu, Asep, Bsep, n: int, m: int, span: int):
    """Next-level products ``S = A_sep Fx[sep] + B_sep Fu[sep] - Fx[sep+1]
    - Fl[sep+1]`` (ndlqr_FactorInnerProduct, nested_dissection.c:114-134)
    with next-level separators at rows ``g*2*span + span - 1``; returns
    ``[G2, nn, B]``."""
    nn, N, B = vl.shape
    G2 = N // (2 * span)
    row = lambda v, r: v.reshape(v.shape[0], G2, 2 * span, B)[:, :, r]
    A = Asep.transpose(0, 1).reshape(n, n, G2, B)
    Bm = Bsep.transpose(0, 1).reshape(n, m, G2, B)
    S = (
        torch.einsum("ijgb,jkgb->ikgb", A, row(vx, span - 1).reshape(
            n, n, G2, B))
        + torch.einsum("ijgb,jkgb->ikgb", Bm, row(vu, span - 1).reshape(
            m, n, G2, B))
    ).reshape(nn, G2, B)
    S = S - row(vx, span) - row(vl, span)
    return S.transpose(0, 1).contiguous()


def _fold_rows(v: torch.Tensor, S: torch.Tensor, span: int) -> torch.Tensor:
    """Overwrite rows ``knot % (2*span) == span`` of ``v`` with the group's
    ``S`` (the next level's separator write-back, solve.c:92-97)."""
    e, N, B = v.shape
    out = v.clone()
    out.view(e, N // (2 * span), 2 * span, B)[:, :, span] = S.transpose(0, 1)
    return out


def _up(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in the compute dtype: bf16 slabs are upcast on load, as the
    kernels load them (f32 math, one rounding at each store)."""
    return x if x.dtype == dtype else x.to(dtype)


def _update_trio(vl, vx, vu, ML, MX, MU, f, keep, sep, n, m):
    """One level's update of one slab trio (ndlqr_UpdateShurFactor,
    nested_dissection.c:154-171): lambda rows masked by calc_lambda and
    overwritten by the solved separator at sep+1 rows. Every operand is
    taken in ``f``'s dtype (bf16 slabs upcast)."""
    dt = f.dtype
    vl, vx, vu, ML, MX, MU = (_up(x, dt) for x in (vl, vx, vu, ML, MX, MU))
    vl = torch.where(sep, f, vl - torch.where(keep, _mm(ML, f, n, n), 0.0))
    return vl, vx - _mm(MX, f, n, n), vu - _mm(MU, f, m, n)


def rhs_update_level_em_plain(Fl, Fx, Fu, zy, zx, zu, zbar, *, level, n, m):
    """Plain version of :func:`rhs_update_level_em` (bf16 slabs upcast)."""
    N = Fl.shape[1]
    keep, sep = _masks(level, N, Fl.device)
    zb = _bcast(zbar, 2 << level)  # [n, N, B]
    mv = lambda F, p: (_up(F, zb.dtype).reshape(p, n, N, -1)
                       * zb[None]).sum(1)
    vy = torch.where(sep, zb, zy - torch.where(keep, mv(Fl, n), 0.0))
    vx = zx - mv(Fx, n)
    vu = zu - mv(Fu, m)
    zy.copy_(vy)
    zx.copy_(vx)
    zu.copy_(vu)
    return zy, zx, zu


def schur_update_level_em_plain(
    FLl, FLx, FLu, Fls, Fxs, Fus, fsol, Asep=None, Bsep=None, *, level, n, m
):
    """Plain version of :func:`schur_update_level_em`. bf16 slabs are
    upcast on load and each updated slab rounded once at its store; the
    products come from the unrounded values, with the fold before the
    rounding (schur_pallas.py:214-257)."""
    N = FLl.shape[1]
    span = 2 << level
    keep, sep = _masks(level, N, FLl.device)
    emit = Asep is not None and _level_emits(level, N, FLl.dtype)
    S_next = [] if emit else None
    for u in range(len(Fls)):
        f = _bcast(fsol[u], span)
        vl, vx, vu = _update_trio(
            Fls[u], Fxs[u], Fus[u], FLl, FLx, FLu, f, keep, sep, n, m
        )
        if emit:
            S = _emit_S(vl, vx, vu, Asep, Bsep, n, m, span)
            S_next.append(S)
            if u == 0:
                vl = _fold_rows(vl, S, span)
        Fls[u].copy_(vl)
        Fxs[u].copy_(vx)
        Fus[u].copy_(vu)
    return tuple(Fls), tuple(Fxs), tuple(Fus), S_next


def schur_update_pair_em_plain(
    FLl, FLx, FLu, Fls, Fxs, Fus, fsol1, Sbar2, fsol2, Asep3=None,
    Bsep3=None, *, level, n, m,
):
    """Plain version of :func:`schur_update_pair_em`. bf16 slabs: as
    :func:`schur_update_level_em_plain`, one rounding per slab for both
    levels; the level-(L+1) multiplier is slab L+1 as stored (rounded), as
    the JAX kernel reads it back from its output block
    (schur_pallas.py:535-537)."""
    nn, N, B = FLl.shape
    U = len(Fls)
    span = 2 << level
    span2 = 2 * span
    keep1, sep1 = _masks(level, N, FLl.device)
    keep2, sep2 = _masks(level + 1, N, FLl.device)
    emit = Asep3 is not None and _pair_emits(level, N, B, U, n, m, FLl.dtype)
    S_next = [] if emit else None
    for uu in range(U):
        vl, vx, vu = _update_trio(
            Fls[uu], Fxs[uu], Fus[uu], FLl, FLx, FLu,
            _bcast(fsol1[uu], span), keep1, sep1, n, m,
        )
        if uu == 0:
            # Slab L+1: fold its Sbar, then it is the level-(L+1) multiplier.
            vl = _fold_rows(vl, Sbar2, span)
        else:
            vl, vx, vu = _update_trio(
                vl, vx, vu, Fls[0], Fxs[0], Fus[0],
                _bcast(fsol2[uu - 1], span2), keep2, sep2, n, m,
            )
            if emit:
                S = _emit_S(vl, vx, vu, Asep3, Bsep3, n, m, span2)
                S_next.append(S)
                if uu == 1:
                    vl = _fold_rows(vl, S, span2)
        Fls[uu].copy_(vl)
        Fxs[uu].copy_(vx)
        Fus[uu].copy_(vu)
    return tuple(Fls), tuple(Fxs), tuple(Fus), S_next


def _leaf_values(A, Bm, qinv, rinv, L: int, n: int, m: int):
    """Level-``L`` leaf factor values (ndlqr_SolveLeaf,
    nested_dissection.c:10-105) from the problem planes: ``Q^-1 A'`` at the
    knots whose own dynamics block lives at level L (level(k) =
    trailing zeros of k+1, binary_tree.c:65-73), ``-Q^-1`` at the knot after
    a level-L separator, and ``R^-1 B'`` (also at knot 0 for L = 0)."""
    N, B = A.shape[1:]
    k = torch.arange(N, device=A.device)[:, None]
    own = (((k + 1) & ((2 << L) - 1)) == (1 << L)) & (k >= 1) & (k < N - 1)
    prev = (k & ((2 << L) - 1)) == (1 << L)
    ownu = own | (k == 0) if L == 0 else own
    At = A.reshape(n, n, N, B).transpose(0, 1)
    Bt = Bm.reshape(n, m, N, B).transpose(0, 1)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).reshape(n, n, 1, 1)
    fx = torch.where(own, At * qinv[:, None], 0.0) - torch.where(
        prev, eye * qinv[None], 0.0
    )
    fu = torch.where(ownu, Bt * rinv[:, None], 0.0)
    return fx.reshape(n * n, N, B), fu.reshape(m * n, N, B)


def leaf_schur_level0_em_plain(
    A, B, qinv, rinv, S0, fsol, Asep, Bsep, *, depth, n, m, factor_dtype=""
):
    """Plain version of :func:`leaf_schur_level0_em`: every value in the
    problem dtype (the level-0 multipliers unrounded), each slab rounded to
    ``factor_dtype`` once at the end, after the products and the fold."""
    nn, N, Bb = A.shape
    k = torch.arange(N, device=A.device)[:, None]
    keep, sep = _masks(0, N, A.device)
    fl0 = torch.where(
        k == 0, -A.reshape(n, n, N, Bb).transpose(0, 1), 0.0
    ).reshape(nn, N, Bb)
    fx0, fu0 = _leaf_values(A, B, qinv, rinv, 0, n, m)
    Fls = [torch.where(sep, _bcast(S0, 2), fl0)]
    Fxs = [fx0]
    Fus = [fu0]
    S_next = []
    for u in range(1, depth):
        fxu, fuu = _leaf_values(A, B, qinv, rinv, u, n, m)
        vl, vx, vu = _update_trio(
            torch.zeros_like(fl0), fxu, fuu, fl0, fx0, fu0,
            _bcast(fsol[u - 1], 2), keep, sep, n, m,
        )
        S = _emit_S(vl, vx, vu, Asep, Bsep, n, m, 2)
        S_next.append(S)
        if u == 1:
            vl = _fold_rows(vl, S, 2)
        Fls.append(vl)
        Fxs.append(vx)
        Fus.append(vu)
    fdt = storage_dtype(factor_dtype, A.dtype)
    Fls, Fxs, Fus = ([x.to(fdt) for x in F] for F in (Fls, Fxs, Fus))
    return tuple(Fls), tuple(Fxs), tuple(Fus), S_next


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


# The slab storages the sweep kernels take (f32 math either way).
KERNEL_SLABS = (torch.float32, torch.bfloat16)


def kernel_applies(kernels: str, device: torch.device, dtype: torch.dtype,
                   slabs: Optional[torch.dtype] = None) -> bool:
    """The routing rule of every kernel wrapper of the port: its CUDA
    kernel runs for float32 tensors on a CUDA device under
    ``kernels="auto"``; CPU tensors, ``kernels="off"`` and other dtypes run
    the plain version. ``dtype`` is the compute dtype; ``slabs`` the
    factor slabs' storage, where the wrapper takes slabs: the kernels take
    f32 and bf16 slabs (``KERNEL_SLABS``), so any other storage
    (``SolveOptions.factor_dtype`` f16, or f64 on an f32 problem) runs the
    plain version on every device. An unknown mode, or a device that is
    neither CPU nor CUDA, raises. Block sizes do not route here: the solver
    picks the path by state dim before any launch (``rslqr_em._mid_block``:
    above ``min(mxu_block_threshold, MAX_STATE)`` the plane kernels), so a
    kernel that applies takes every block size its path gives it, and
    raises on any other (a wrapper called directly past its limits)."""
    if kernels not in ("auto", "off"):
        raise ValueError(f"unknown kernel mode {kernels!r}")
    if kernels == "off" or device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for device {device}")
    return dtype == torch.float32 and (slabs is None
                                       or slabs in KERNEL_SLABS)


def _check(name: str, tensors: Sequence[torch.Tensor], shapes, n: int,
           m: int, device, slabs: int = 0):
    """The kernels' limits: block dims, devices, dtypes, shapes and
    contiguity. The first ``slabs`` tensors are factor slabs, stored in
    float32 or bfloat16 (one dtype for all of them); the others float32."""
    if not (1 <= n <= MAX_STATE and 1 <= m <= MAX_INPUT):
        raise ValueError(
            f"{name}: CUDA kernels take state dims n in 1..{MAX_STATE} and "
            f"input dims m in 1..{MAX_INPUT}, got (n, m) = {(n, m)}"
        )
    sdt = tensors[0].dtype if slabs else torch.float32
    if sdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: kernel takes float32 or bfloat16 slabs, "
                         f"got {sdt}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        want = sdt if i < slabs else torch.float32
        if t.device != device or t.dtype != want:
            raise ValueError(
                f"{name}: kernel takes {want} tensors on {device}, got "
                f"{t.dtype} on {t.device}"
            )
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")


def _ptr(t: Optional[torch.Tensor]) -> int:
    """A tensor's device address (0 for none); every C entry point declares
    its pointer arguments, so ctypes converts the int."""
    return 0 if t is None else t.data_ptr()


def _ptrs(ts: Sequence[torch.Tensor]):
    if len(ts) > MAXU:
        raise ValueError(f"at most {MAXU} upper slabs per launch")
    return (ctypes.c_void_p * MAXU)(*(t.data_ptr() for t in ts))


def _stacked(device, *shapes, dtype=torch.float32):
    """One allocation per shape ``(count, *slab)``, each returned as the
    tuple of its ``count`` contiguous slabs: the fused leaf's outputs, in
    four allocations instead of one per slab."""
    return tuple(torch.empty(s, device=device, dtype=dtype).unbind(0)
                 for s in shapes)


def _launch(fn_name: str, device, *args):
    """Call one C launcher on the device's current stream; raise on any
    CUDA error it reports (cudaGetLastError right after the launch)."""
    from ._build import load

    lib = load()
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn_name)(
                *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.rslqr_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({msg})")


def rhs_update_level_em(
    Fl: torch.Tensor,    # [nn, N, B] factor slab of this level
    Fx: torch.Tensor,    # [nn, N, B]
    Fu: torch.Tensor,    # [mn, N, B]
    zy: torch.Tensor,    # [n, N, B] RHS planes (updated in place)
    zx: torch.Tensor,    # [n, N, B]
    zu: torch.Tensor,    # [m, N, B]
    zbar: torch.Tensor,  # [G, n, B] solved separator RHS, group-major
    *,
    level: int,
    n: int,
    m: int,
    kernels: str = "auto",
):
    """One level of the RHS sweep's slab application (ref solve.c:137-182):
    ``z{y,x,u} -= F{l,x,u} @ zbar[group]`` with the calc_lambda mask and the
    solved separator written at sep+1 rows. Updates ``zy, zx, zu`` in place
    and returns them.

    Replaces ``rslqr_tpu/ops/schur_pallas.py:rhs_update_level_em``. Kernel:
    ``rhs_kernel`` (one thread per knot and batch column; reads 90 floats of
    slab and 15 of z, writes 15).
    """
    if not kernel_applies(kernels, zy.device, zy.dtype, Fl.dtype):
        return rhs_update_level_em_plain(
            Fl, Fx, Fu, zy, zx, zu, zbar, level=level, n=n, m=m
        )
    nn, N, B = Fl.shape
    G = N >> (level + 1)
    _check(
        "rhs_update_level_em", (Fl, Fx, Fu, zy, zx, zu, zbar),
        ((nn, N, B), (nn, N, B), (m * n, N, B), (n, N, B), (n, N, B),
         (m, N, B), (G, n, B)), n, m, zy.device, slabs=3,
    )
    _launch(
        "rslqr_rhs_update_level", zy.device,
        _ptr(Fl), _ptr(Fx), _ptr(Fu), _ptr(zy), _ptr(zx), _ptr(zu),
        _ptr(zbar), N, B, level, n, m, int(Fl.dtype == torch.bfloat16),
    )
    rhs_update_level_em.launches += 1
    return zy, zx, zu


def schur_update_level_em(
    FLl: torch.Tensor,            # [nn, N, B] level-L lambda multiplier slab
    FLx: torch.Tensor,            # [nn, N, B]
    FLu: torch.Tensor,            # [mn, N, B]
    Fls: Sequence[torch.Tensor],  # U upper-level slabs [nn, N, B] (in place)
    Fxs: Sequence[torch.Tensor],  # U x [nn, N, B]
    Fus: Sequence[torch.Tensor],  # U x [mn, N, B]
    fsol: Sequence[torch.Tensor],  # U solved separators [G, nn, B]
    Asep: Optional[torch.Tensor] = None,  # [G2, nn, B] A at next-level seps
    Bsep: Optional[torch.Tensor] = None,  # [G2, nm, B]
    *,
    level: int,
    n: int,
    m: int,
    kernels: str = "auto",
):
    """Apply the level-``level`` Schur updates and separator write-back to
    every upper slab: ``F*[u,k] -= F*[L,k] @ fsol_u[group(k)]``.

    Returns ``(Fls, Fxs, Fus, S_next)``; the slabs are updated in place.
    ``S_next`` is the per-upper-level list of next-level products
    ``[G2, nn, B]`` (``S_next[0]`` is the next level's Sbar, already folded
    into that slab) when ``Asep``/``Bsep`` are given and the JAX kernel
    would emit (:func:`_level_emits`); otherwise ``None``.

    Replaces ``rslqr_tpu/ops/schur_pallas.py:schur_update_level_em``.
    Kernel: ``row_level_kernel`` (``csrc/row_groups.cuh``: up to three slab
    rows per thread, on the geometry of :func:`_level_plan`). bf16 slabs:
    ``row_level2_kernel`` (``csrc/bf16_rows.cuh``): two batch columns a
    thread, the emission's unrounded f32 rows staged in shared memory.
    """
    cdt = fsol[0].dtype if len(fsol) else FLl.dtype
    if not kernel_applies(kernels, FLl.device, cdt, FLl.dtype):
        return schur_update_level_em_plain(
            FLl, FLx, FLu, list(Fls), list(Fxs), list(Fus), fsol, Asep, Bsep,
            level=level, n=n, m=m,
        )
    nn, N, B = FLl.shape
    mn = m * n
    U = len(Fls)
    G = N >> (level + 1)
    bf16 = FLl.dtype == torch.bfloat16
    emit = Asep is not None and _level_emits(level, N, FLl.dtype)
    G2 = N >> (level + 2)
    ts = [FLl, FLx, FLu, *Fls, *Fxs, *Fus, *fsol]
    shapes = ([(nn, N, B)] * 2 + [(mn, N, B)] + [(nn, N, B)] * (2 * U)
              + [(mn, N, B)] * U + [(G, nn, B)] * U)
    if emit:
        ts += [Asep, Bsep]
        shapes += [(G2, nn, B), (G2, n * m, B)]
    _check("schur_update_level_em", ts, shapes, n, m, FLl.device,
           slabs=3 + 3 * U)
    S = [torch.empty((G2, nn, B), device=FLl.device) for _ in range(U)] \
        if emit else []
    plan = _level_plan(N, B, emit, n, m, bf16=bf16)
    args = (
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus),
        _ptrs(fsol), _ptr(Asep if emit else None),
        _ptr(Bsep if emit else None), _ptrs(S), U, N, B, level, int(emit),
        n, m, plan.shift, plan.grid[1], sum(plan.groups),
    )
    if bf16:
        _check_pair2("schur_update_level_em", ts)
        _launch("rslqr_schur_update_level_bf16", FLl.device, *args,
                _vec(plan, ts + S), plan.smem)
    else:
        _launch("rslqr_schur_update_level", FLl.device, *args)
    schur_update_level_em.launches += 1
    return tuple(Fls), tuple(Fxs), tuple(Fus), (S if emit else None)


def schur_update_pair_em(
    FLl: torch.Tensor,             # [nn, N, B] level-L lambda multiplier slab
    FLx: torch.Tensor,
    FLu: torch.Tensor,             # [mn, N, B]
    Fls: Sequence[torch.Tensor],   # U upper slabs, u = L+1..depth-1
    Fxs: Sequence[torch.Tensor],
    Fus: Sequence[torch.Tensor],
    fsol1: Sequence[torch.Tensor],  # U solved level-L separators [G1, nn, B]
    Sbar2: torch.Tensor,            # [G2, nn, B] level-(L+1) Sbar (pre-pass)
    fsol2: Sequence[torch.Tensor],  # U-1 solved level-(L+1) seps [G2, nn, B]
    Asep3: Optional[torch.Tensor] = None,  # [G3, nn, B] A at L+2 separators
    Bsep3: Optional[torch.Tensor] = None,
    *,
    level: int,
    n: int,
    m: int,
    kernels: str = "auto",
):
    """Apply the Schur updates of levels ``level`` and ``level + 1`` to every
    upper slab in one pass, with both separator write-backs and (when the
    JAX kernel would, :func:`_pair_emits`) the level-(L+2) products.

    The level-(L+1) multiplier is slab ``u = L+1`` after its level-L update
    and Sbar fold, which this pass itself writes first. Returns
    ``(Fls, Fxs, Fus, S_next)`` with the slabs updated in place; ``S_next``
    has ``U-1`` entries or is ``None``.

    Replaces ``rslqr_tpu/ops/schur_pallas.py:schur_update_pair_em``.
    Kernel: ``row_pair_kernel`` (``csrc/row_groups.cuh``, on the geometry of
    :func:`_level_plan` with ``pair=True``): a thread's rows of slab L+1,
    which it writes first, are the level-(L+1) multiplier rows its upper
    slab rows need, so no value crosses threads except the product
    emission's separator rows. bf16 slabs: ``row_pair2_kernel``
    (``csrc/bf16_rows.cuh``): two batch columns a thread, the multiplier
    rows held packed, the emission's f32 rows staged in shared memory.
    """
    if not kernel_applies(kernels, FLl.device, Sbar2.dtype, FLl.dtype):
        return schur_update_pair_em_plain(
            FLl, FLx, FLu, list(Fls), list(Fxs), list(Fus), fsol1, Sbar2,
            fsol2, Asep3, Bsep3, level=level, n=n, m=m,
        )
    nn, N, B = FLl.shape
    mn = m * n
    U = len(Fls)
    G1 = N >> (level + 1)
    G2 = N >> (level + 2)
    G3 = N >> (level + 3)
    bf16 = FLl.dtype == torch.bfloat16
    emit = Asep3 is not None and _pair_emits(level, N, B, U, n, m, FLl.dtype)
    ts = [FLl, FLx, FLu, *Fls, *Fxs, *Fus, *fsol1, Sbar2, *fsol2]
    shapes = ([(nn, N, B)] * 2 + [(mn, N, B)] + [(nn, N, B)] * (2 * U)
              + [(mn, N, B)] * U + [(G1, nn, B)] * U + [(G2, nn, B)] * U)
    if emit:
        ts += [Asep3, Bsep3]
        shapes += [(G3, nn, B), (G3, n * m, B)]
    _check("schur_update_pair_em", ts, shapes, n, m, FLl.device,
           slabs=3 + 3 * U)
    S = [torch.empty((G3, nn, B), device=FLl.device)
         for _ in range(U - 1)] if emit else []
    plan = _level_plan(N, B, emit, n, m, pair=True, bf16=bf16)
    args = (
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus),
        _ptrs(fsol1), _ptr(Sbar2), _ptrs(fsol2),
        _ptr(Asep3 if emit else None), _ptr(Bsep3 if emit else None),
        _ptrs(S), U, N, B, level, int(emit), n, m, plan.shift, plan.grid[1],
        sum(plan.groups),
    )
    if bf16:
        _check_pair2("schur_update_pair_em", ts)
        _launch("rslqr_schur_update_pair_bf16", FLl.device, *args,
                _vec(plan, ts + S), plan.smem)
    else:
        _launch("rslqr_schur_update_pair", FLl.device, *args)
    schur_update_pair_em.launches += 1
    return tuple(Fls), tuple(Fxs), tuple(Fus), (S if emit else None)


def leaf_schur_level0_em(
    A: torch.Tensor,      # [nn, N, B] element-major dynamics
    B: torch.Tensor,      # [nm, N, B]
    qinv: torch.Tensor,   # [n, N, B] 1/Qdiag
    rinv: torch.Tensor,   # [m, N, B] 1/Rdiag
    S0: torch.Tensor,     # [G0, nn, B] level-0 Sbar
    fsol: Sequence[torch.Tensor],  # depth-1 solved level-0 separators
    Asep: torch.Tensor,   # [G1, nn, B] A at level-1 separator knots
    Bsep: torch.Tensor,   # [G1, nm, B]
    *,
    depth: int,
    n: int,
    m: int,
    kernels: str = "auto",
    factor_dtype: str = "",
):
    """Fused leaf construction + level-0 Schur update: builds every level's
    leaf factor values from the problem data, applies level 0, writes each
    slab once, and emits the level-1 products (with level 1's Sbar folded
    into its slab).

    Returns ``(Fls, Fxs, Fus, S_next)``: per-level tuples of length
    ``depth`` (new tensors; on the kernel route, views of one allocation
    per kind), stored in ``factor_dtype`` ("" = the problem dtype, else
    the dtype it names: every value formed in the problem dtype, each
    element rounded once at its store, the products from the unrounded
    values; the kernel takes f32 and bf16 slabs), and the list of
    ``depth-1`` level-1 products in the problem dtype.

    Replaces ``rslqr_tpu/ops/schur_pallas.py:leaf_schur_level0_em``.
    Kernel: ``leaf_row_kernel`` (``csrc/leaf_rows.cuh``, on the pair
    kernel's emitting plan, :func:`_level_plan` with ``pair``: reads 63
    floats of problem data per knot and batch column at (6, 3), writes each
    element of the ``depth`` slab trios once). bf16 slabs:
    ``leaf_row2_kernel`` (``csrc/bf16_rows.cuh``): two batch columns a
    thread, the emission's f32 rows staged in shared memory.
    """
    if depth < 2:
        raise ValueError("the fused leaf needs a tree of depth >= 2")
    fdt = storage_dtype(factor_dtype, A.dtype)
    if not kernel_applies(kernels, A.device, A.dtype, fdt):
        return leaf_schur_level0_em_plain(
            A, B, qinv, rinv, S0, fsol, Asep, Bsep, depth=depth, n=n, m=m,
            factor_dtype=factor_dtype,
        )
    nn, N, Bb = A.shape
    mn = m * n
    U = depth - 1
    G0, G1 = N // 2, N // 4
    _check(
        "leaf_schur_level0_em", [A, B, qinv, rinv, S0, *fsol, Asep, Bsep],
        [(nn, N, Bb), (mn, N, Bb), (n, N, Bb), (m, N, Bb), (G0, nn, Bb)]
        + [(G0, nn, Bb)] * U + [(G1, nn, Bb), (G1, mn, Bb)],
        n, m, A.device,
    )
    bf16 = fdt == torch.bfloat16
    Fls, Fxs, Fus = _stacked(A.device, (depth, nn, N, Bb),
                             (depth, nn, N, Bb), (depth, mn, N, Bb),
                             dtype=fdt)
    S, = _stacked(A.device, (U, G1, nn, Bb))
    plan = _level_plan(N, Bb, True, n, m, pair=True, bf16=bf16, leaf=True)
    args = (
        _ptr(A), _ptr(B), _ptr(qinv), _ptr(rinv), _ptr(S0), _ptrs(fsol),
        _ptr(Asep), _ptr(Bsep), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus), _ptrs(S),
        depth, N, Bb, n, m, plan.shift, plan.grid[1], sum(plan.groups),
    )
    if bf16:
        ts = [A, B, qinv, rinv, S0, *fsol, Asep, Bsep, *Fls, *Fxs, *Fus, *S]
        _check_pair2("leaf_schur_level0_em", ts)
        _launch("rslqr_leaf_schur_level0_bf16", A.device, *args,
                _vec(plan, ts), plan.smem)
    else:
        _launch("rslqr_leaf_schur_level0", A.device, *args)
    leaf_schur_level0_em.launches += 1
    return Fls, Fxs, Fus, list(S)


KERNEL_WRAPPERS = (
    schur_update_level_em,
    rhs_update_level_em,
    leaf_schur_level0_em,
    schur_update_pair_em,
)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
