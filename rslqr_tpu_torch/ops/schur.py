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
other dtypes (the reference sends them to XLA stages). The rule is static
and decided before any launch: a kernel that applies launches or raises
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
``csrc/leaf_rows.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

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


def _level_emits(level: int, N: int) -> bool:
    """Whether ``schur_update_level_em`` emits the next level's products:
    the JAX kernel does when its f32 knot tile (``_tiles``) covers whole
    next-level groups, i.e. at levels 0-2."""
    span = 1 << (level + 1)
    tk = min(max(2 * span, 8), 16, N)
    return 2 * span <= tk and N >= 2 * span


def _pair_emits(level: int, N: int, B: int, U: int, n: int, m: int) -> bool:
    """Whether ``schur_update_pair_em`` emits the level-(L+2) products:
    the JAX kernel does when a knot tile covering whole L+2 groups fits its
    VMEM budget (``_tiles_pair``, f32, 128-lane batch tiles)."""
    span2 = 2 << (level + 1)
    tk = max(2 * span2, 8)
    tb = min(128, B)
    est = (1 + U) * (2 * n * n + m * n) * tk * tb * 4 * 2
    return U >= 2 and tk <= N and est <= 60 * 1024 * 1024


# ---------------------------------------------------------------------------
# Launch geometry of the row-group kernels (csrc/row_groups.cuh,
# csrc/leaf_rows.cuh): B1, B3 and B4 here, B10 and B11 in ops/flat.py.
# ---------------------------------------------------------------------------

# A block: LEVEL_TB batch columns by up to LEVEL_SLOTS row groups of
# LEVEL_RPT slab rows by LEVEL_KB knots (at most 1,024 threads); the pair
# kernel (B4) takes at most PAIR_WIDE_SLOTS at the wide inputs (m > 8).
LEVEL_TB, LEVEL_KB, LEVEL_RPT, LEVEL_SLOTS = 32, 2, 3, 16
PAIR_WIDE_SLOTS = 8


class LevelPlan(NamedTuple):
    """Launch geometry of the row-group level kernels: grid row ``y``
    covers knots ``y * LEVEL_KB - shift`` .. ``+ LEVEL_KB - 1`` (those in
    ``[0, N)``), grid column ``x`` batch columns ``x * LEVEL_TB`` ..
    ``+ LEVEL_TB - 1`` (those below ``B``); ``groups`` the row groups of
    the lambda, x and u slabs (row group ``z`` of a knot, in that order,
    takes slab rows ``LEVEL_RPT * (z - first group of its slab)`` ..
    ``+ LEVEL_RPT - 1``, those below the slab's row count); ``slots`` the
    block's threads per knot and batch column, which take row groups
    ``slot, slot + slots, ...``."""

    shift: int
    grid: Tuple[int, int]
    groups: Tuple[int, int, int]
    slots: int


def _row_groups(rows: int) -> int:
    """Row groups of a slab of ``rows`` rows (the last one partly masked
    where ``rows`` is not a multiple of ``LEVEL_RPT``)."""
    return -(-rows // LEVEL_RPT)


def _level_plan(N: int, B: int, emit: bool, n: int, m: int,
                pair: bool = False) -> LevelPlan:
    """Knot pairs shifted by one when the level emits products, so that
    each next-level group's separator row r (odd) and r + 1 share a
    block; unshifted otherwise. Row groups: ``ceil(n / 3)`` for each of the
    lambda and x slabs, ``ceil(m / 3)`` for u, in at most ``LEVEL_SLOTS``
    slots (``pair``: the pair kernel's, at most ``PAIR_WIDE_SLOTS`` at the
    wide inputs, m > ``MAX_STATE``)."""
    shift = int(emit)
    groups = (_row_groups(n), _row_groups(n), _row_groups(m))
    cap = PAIR_WIDE_SLOTS if pair and m > MAX_STATE else LEVEL_SLOTS
    return LevelPlan(shift, (-(-B // LEVEL_TB), -(-(N + shift) // LEVEL_KB)),
                     groups, min(sum(groups), cap))


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


def _update_trio(vl, vx, vu, ML, MX, MU, f, keep, sep, n, m):
    """One level's update of one slab trio (ndlqr_UpdateShurFactor,
    nested_dissection.c:154-171): lambda rows masked by calc_lambda and
    overwritten by the solved separator at sep+1 rows."""
    vl = torch.where(sep, f, vl - torch.where(keep, _mm(ML, f, n, n), 0.0))
    return vl, vx - _mm(MX, f, n, n), vu - _mm(MU, f, m, n)


def rhs_update_level_em_plain(Fl, Fx, Fu, zy, zx, zu, zbar, *, level, n, m):
    """Plain version of :func:`rhs_update_level_em`."""
    N = Fl.shape[1]
    keep, sep = _masks(level, N, Fl.device)
    zb = _bcast(zbar, 2 << level)  # [n, N, B]
    mv = lambda F, p: (F.reshape(p, n, N, -1) * zb[None]).sum(1)
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
    """Plain version of :func:`schur_update_level_em`."""
    N = FLl.shape[1]
    span = 2 << level
    keep, sep = _masks(level, N, FLl.device)
    emit = Asep is not None and _level_emits(level, N)
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
    """Plain version of :func:`schur_update_pair_em`."""
    nn, N, B = FLl.shape
    U = len(Fls)
    span = 2 << level
    span2 = 2 * span
    keep1, sep1 = _masks(level, N, FLl.device)
    keep2, sep2 = _masks(level + 1, N, FLl.device)
    emit = Asep3 is not None and _pair_emits(level, N, B, U, n, m)
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
    A, B, qinv, rinv, S0, fsol, Asep, Bsep, *, depth, n, m
):
    """Plain version of :func:`leaf_schur_level0_em`."""
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
    return tuple(Fls), tuple(Fxs), tuple(Fus), S_next


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


def kernel_applies(kernels: str, device: torch.device,
                   dtype: torch.dtype) -> bool:
    """The routing rule of every kernel wrapper of the port: its CUDA
    kernel runs for float32 tensors on a CUDA device under
    ``kernels="auto"``; CPU tensors, ``kernels="off"`` and other dtypes run
    the plain version. An unknown mode, or a device that is neither CPU nor
    CUDA, raises. Block sizes do not route here: the solver picks the path
    by state dim before any launch (``rslqr_em._mid_block``: above
    ``min(mxu_block_threshold, MAX_STATE)`` the plane kernels), so a kernel
    that applies takes every block size its path gives it, and raises on
    any other (a wrapper called directly past its limits)."""
    if kernels not in ("auto", "off"):
        raise ValueError(f"unknown kernel mode {kernels!r}")
    if kernels == "off" or device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for device {device}")
    return dtype == torch.float32


def _check(name: str, tensors: Sequence[torch.Tensor], shapes, n: int,
           m: int, device):
    if not (1 <= n <= MAX_STATE and 1 <= m <= MAX_INPUT):
        raise ValueError(
            f"{name}: CUDA kernels take state dims n in 1..{MAX_STATE} and "
            f"input dims m in 1..{MAX_INPUT}, got (n, m) = {(n, m)}"
        )
    for t, shape in zip(tensors, shapes):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(
                f"{name}: kernel takes float32 tensors on {device}, got "
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


def _stacked(device, *shapes):
    """One f32 allocation per shape ``(count, *slab)``, each returned as the
    tuple of its ``count`` contiguous slabs: the fused leaf's outputs, in
    four allocations instead of one per slab."""
    return tuple(torch.empty(s, device=device).unbind(0) for s in shapes)


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
    if not kernel_applies(kernels, Fl.device, Fl.dtype):
        return rhs_update_level_em_plain(
            Fl, Fx, Fu, zy, zx, zu, zbar, level=level, n=n, m=m
        )
    nn, N, B = Fl.shape
    G = N >> (level + 1)
    _check(
        "rhs_update_level_em", (Fl, Fx, Fu, zy, zx, zu, zbar),
        ((nn, N, B), (nn, N, B), (m * n, N, B), (n, N, B), (n, N, B),
         (m, N, B), (G, n, B)), n, m, Fl.device,
    )
    _launch(
        "rslqr_rhs_update_level", Fl.device,
        _ptr(Fl), _ptr(Fx), _ptr(Fu), _ptr(zy), _ptr(zx), _ptr(zu),
        _ptr(zbar), N, B, level, n, m,
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
    rows per thread, on the geometry of :func:`_level_plan`).
    """
    if not kernel_applies(kernels, FLl.device, FLl.dtype):
        return schur_update_level_em_plain(
            FLl, FLx, FLu, list(Fls), list(Fxs), list(Fus), fsol, Asep, Bsep,
            level=level, n=n, m=m,
        )
    nn, N, B = FLl.shape
    mn = m * n
    U = len(Fls)
    G = N >> (level + 1)
    emit = Asep is not None and _level_emits(level, N)
    G2 = N >> (level + 2)
    ts = [FLl, FLx, FLu, *Fls, *Fxs, *Fus, *fsol]
    shapes = ([(nn, N, B)] * 2 + [(mn, N, B)] + [(nn, N, B)] * (2 * U)
              + [(mn, N, B)] * U + [(G, nn, B)] * U)
    if emit:
        ts += [Asep, Bsep]
        shapes += [(G2, nn, B), (G2, n * m, B)]
    _check("schur_update_level_em", ts, shapes, n, m, FLl.device)
    S = [torch.empty((G2, nn, B), device=FLl.device) for _ in range(U)] \
        if emit else []
    plan = _level_plan(N, B, emit, n, m)
    _launch(
        "rslqr_schur_update_level", FLl.device,
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus),
        _ptrs(fsol), _ptr(Asep if emit else None),
        _ptr(Bsep if emit else None), _ptrs(S), U, N, B, level, int(emit),
        n, m, plan.shift, plan.grid[1], sum(plan.groups),
    )
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
    emission's separator rows.
    """
    if not kernel_applies(kernels, FLl.device, FLl.dtype):
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
    emit = Asep3 is not None and _pair_emits(level, N, B, U, n, m)
    ts = [FLl, FLx, FLu, *Fls, *Fxs, *Fus, *fsol1, Sbar2, *fsol2]
    shapes = ([(nn, N, B)] * 2 + [(mn, N, B)] + [(nn, N, B)] * (2 * U)
              + [(mn, N, B)] * U + [(G1, nn, B)] * U + [(G2, nn, B)] * U)
    if emit:
        ts += [Asep3, Bsep3]
        shapes += [(G3, nn, B), (G3, n * m, B)]
    _check("schur_update_pair_em", ts, shapes, n, m, FLl.device)
    S = [torch.empty((G3, nn, B), device=FLl.device)
         for _ in range(U - 1)] if emit else []
    plan = _level_plan(N, B, emit, n, m, pair=True)
    _launch(
        "rslqr_schur_update_pair", FLl.device,
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus),
        _ptrs(fsol1), _ptr(Sbar2), _ptrs(fsol2),
        _ptr(Asep3 if emit else None), _ptr(Bsep3 if emit else None),
        _ptrs(S), U, N, B, level, int(emit), n, m, plan.shift, plan.grid[1],
        sum(plan.groups),
    )
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
):
    """Fused leaf construction + level-0 Schur update: builds every level's
    leaf factor values from the problem data, applies level 0, writes each
    slab once, and emits the level-1 products (with level 1's Sbar folded
    into its slab).

    Returns ``(Fls, Fxs, Fus, S_next)``: per-level tuples of length
    ``depth`` (new tensors; on the kernel route, views of one allocation
    per kind) and the list of ``depth-1`` level-1 products.

    Replaces ``rslqr_tpu/ops/schur_pallas.py:leaf_schur_level0_em``.
    Kernel: ``leaf_row_kernel`` (``csrc/leaf_rows.cuh``, on the pair
    kernel's emitting plan, :func:`_level_plan` with ``pair``: reads 63
    floats of problem data per knot and batch column at (6, 3), writes each
    element of the ``depth`` slab trios once).
    """
    if depth < 2:
        raise ValueError("the fused leaf needs a tree of depth >= 2")
    if not kernel_applies(kernels, A.device, A.dtype):
        return leaf_schur_level0_em_plain(
            A, B, qinv, rinv, S0, fsol, Asep, Bsep, depth=depth, n=n, m=m
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
    Fls, Fxs, Fus, S = _stacked(A.device, (depth, nn, N, Bb),
                                (depth, nn, N, Bb), (depth, mn, N, Bb),
                                (U, G1, nn, Bb))
    plan = _level_plan(N, Bb, True, n, m, pair=True)
    _launch(
        "rslqr_leaf_schur_level0", A.device,
        _ptr(A), _ptr(B), _ptr(qinv), _ptr(rinv), _ptr(S0), _ptrs(fsol),
        _ptr(Asep), _ptr(Bsep), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus), _ptrs(S),
        depth, N, Bb, n, m, plan.shift, plan.grid[1], sum(plan.groups),
    )
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
