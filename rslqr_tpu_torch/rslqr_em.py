"""Element-major rsLQR solve: the production path for small blocks.

Counterpart of ``rslqr_tpu.rslqr_em``. Same algorithm (recursive Schur
complement over the knot-point tree, ref solve.c:38-190), with the factor
slabs element-major ``[p, q, N, B]``: block dims leading, the (knot x batch)
plane minor. The batch is always ONE trailing axis here (the front door
flattens leading batch axes; a single problem runs as ``B = 1``).

On every device this module runs the structure of the JAX package's kernel
path. Small blocks (n at most ``SolveOptions.mxu_block_threshold`` and at
most ``ops.schur.MAX_STATE`` = 8):

1. level-0 products from compact gathers of the problem data, a small
   Cholesky and stacked separator solves, then ONE fused leaf + level-0
   pass (``leaf_schur_level0_em``);
2. per level, either the paired sweep (``schur_update_pair_em`` after the
   compact ``_pair_prepass``) or the single sweep (``schur_update_level_em``);
3. the RHS sweep: per level a compact separator solve in plain ops, then
   one pass over the level's slabs (``rhs_update_level_em``).

Mid blocks (n above ``min(mxu_block_threshold, ops.schur.MAX_STATE)``, at
most 64: the quadruped regime, and state dims 9..threshold under a raised
threshold; :func:`_mid_block`), as the JAX module runs them when its
Pallas Schur kernels do not apply (rslqr_em.py:202-242,
388-421, 751-774, 935-963): the plain leaf (``_leaf_em``), then single
levels only, each with its products (``planes.pgemm`` through
``linalg.bgemm``), Cholesky (``planes.pchol``), one separator solve per
upper level (``planes.pcho_solve``) and one fused Schur update of every
upper level (``planes.schur3_update_levels``; JAX: one
``schur3_update_planes`` per upper level); the RHS sweep solves its
separators with ``pcho_solve`` (one column) and applies them with
``schur3_update_planes`` (one column).

With ``SolveOptions.flat_planes`` (small blocks, f32, ``B % 1024 == 0``,
N >= 8; :func:`_flat_path_ok`), the flat-plane schedule of the JAX module
(rslqr_em.py:507-577, 716-734, 890-952): the fused leaf
``leaf_schur_level0_flat``, single levels only (``schur_update_level_flat``,
products emitted at levels 0-1), and ``rhs_update_level_flat`` in the RHS
sweep, with element-major compact separators and products
(``ops/flat.py``). Its kernels take the JAX kernels' flat planes
``[pq, N*B/128, 128]`` (:func:`_flat`), the same bytes as the ``[pq, N, B]``
slab views (:func:`_slab`) the other small-block kernels take.

Only the kernel calls (``ops/schur.py``, ``ops/flat.py``, ``ops/planes.py``)
differ between devices: the plain PyTorch versions on CPU tensors (or under
``kernels="off"``), the CUDA kernels on CUDA tensors. Everything else is
plain PyTorch on compact ``[.., G, B]`` data.

The slabs are updated in place by the kernels, as the TPU kernels alias
them.

``SolveOptions(factor_dtype=...)`` stores the slabs in the dtype it names
(rslqr_em.py:162-168 of the JAX package: bf16, f16, f32 or f64); the
Cholesky factors, separator products and solves and the right-hand sides
stay in the problem dtype. The schedule is decided on the storage dtype
(:func:`_kernel_schedule`: f32, and bf16 on a knot axis of sixteens, take
the kernel path's; any other storage the plain leaf and single levels),
slab rows are taken into the problem dtype before any product, and the
plain stages round each updated slab once (``copy_``, round to nearest
even, as ``astype``). The flat schedule takes f32 slabs of an f32 problem
only, and mid blocks with slabs stored apart from the problem dtype take
the plain update (no plane kernel takes them, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import linalg as la
from .config import SolveOptions, resolve_options, storage_dtype
from .ops import flat, planes, schur
from .problem import LQRProblem, pack_solution
from .rslqr import RsLqrSolution, _bf, _to_batch_last
from .spans import host_copy, span
from .tree import TreeTables, build_tree_tables

NB = 1  # trailing batch axes of every element-major array


@dataclasses.dataclass(frozen=True)
class EmFactorization:
    """Element-major factorization state (NdLqrCholeskyFactors analogue,
    cholesky_factors.h:30-35, plus the final factor slabs).

    ``Fls``/``Fxs``/``Fus``: tuple over levels of ``[{n,n,m}, n, N, B]``
    post-sweep factor slabs, consumed by the RHS sweep.
    ``chols``: tuple over levels of ``[n, n, G_level, B]`` Cholesky factors.
    """

    Fls: Tuple
    Fxs: Tuple
    Fus: Tuple
    chols: Tuple


def _em(x: torch.Tensor) -> torch.Tensor:
    """Batch-last blocks ``[N, p, q, B]`` -> element-major ``[p, q, N, B]``."""
    return x.movedim(0, 2)


def _emv(x: torch.Tensor) -> torch.Tensor:
    """Batch-last vectors ``[N, p, B]`` -> element-major ``[p, N, B]``."""
    return x.movedim(0, 1)


def _emv_bl(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, 0)


def _gk(x: torch.Tensor, span: int) -> torch.Tensor:
    """Group the knot axis: ``[..., N, B] -> [..., G, span, B]``."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] // span, span, x.shape[-1]))


def _sel(x: torch.Tensor, idx: int) -> torch.Tensor:
    """Select one span position: ``[..., G, span, B] -> [..., G, B]``."""
    return x[..., idx, :]


def _kmask(sel: np.ndarray, lead: int, device) -> torch.Tensor:
    """Static bool over knots -> broadcastable with ``lead`` leading block
    axes and the trailing batch axis."""
    return host_copy(sel.reshape((1,) * lead + sel.shape + (1,)), device)


def _leaf_masks(levels: np.ndarray, N: int, depth: int):
    """Static per-level leaf-ownership masks over knots (ref
    nested_dissection.c:10-105 index logic via the tree tables)."""
    ks = np.arange(N)
    own = [
        (levels[np.minimum(ks, N - 2)] == L) & (ks >= 1) & (ks < N - 1)
        for L in range(depth)
    ]
    prev = [np.concatenate([[False], levels == L]) for L in range(depth)]
    return own, prev


def _leaf_em(pbl: LQRProblem, levels: np.ndarray, depth: int, fdt=None):
    """Leaf solves (ref nested_dissection.c:10-105): each level's factor
    slabs, contiguous ``[p, n, N, B]`` in the storage dtype ``fdt`` (None:
    the problem dtype; bf16 slabs take the values rounded once, as JAX's
    ``astype``, rslqr_em.py:162-167), zero except at the knots the level
    owns (``Q^-1 A'``, ``R^-1 B'``; ``-Q^-1`` after its separators; ``-A'``
    and ``R^-1 B'`` at knot 0 for level 0). The values are those of the JAX
    module's static-mask ``where``s (a knot is never both owned and after a
    separator), written only at those knots. Used for mid-size blocks and
    where the fused leaf kernel does not run (:func:`_kernel_schedule`)."""
    N, n = pbl.A.shape[0], pbl.A.shape[1]
    m, Bb = pbl.B.shape[2], pbl.A.shape[3]
    dev, dtype = pbl.A.device, pbl.A.dtype
    fdt = fdt or dtype
    A, B = _em(pbl.A), _em(pbl.B)
    At, Bt = A.transpose(0, 1), B.transpose(0, 1)
    qinv, rinv = 1.0 / _emv(pbl.Qdiag), 1.0 / _emv(pbl.Rdiag)
    knot0 = np.arange(N) == 0
    own, prev = _leaf_masks(levels, N, depth)
    eye = torch.eye(n, dtype=dtype, device=dev).reshape(n, n, 1, 1)

    def slab(p, parts):
        """Zeros ``[p, n, N, B]`` with ``(knot mask, values)`` parts set;
        ``values(idx)`` gives the blocks at knots ``idx``."""
        out = torch.zeros((p, n, N, Bb), dtype=fdt, device=dev)
        for mask, values in parts:
            idx = host_copy(np.nonzero(mask)[0], dev)
            if len(idx):
                out[:, :, idx] = values(idx).to(fdt)
        return out

    qiat = lambda idx: At[:, :, idx] * qinv[:, idx][:, None]
    ribt = lambda idx: Bt[:, :, idx] * rinv[:, idx][:, None]
    mqinv = lambda idx: -(eye * qinv[:, idx][None])
    Fls: List[torch.Tensor] = []
    Fxs: List[torch.Tensor] = []
    Fus: List[torch.Tensor] = []
    for L in range(depth):
        Fxs.append(slab(n, [(own[L], qiat), (prev[L], mqinv)]))
        if L == 0:
            Fus.append(slab(m, [(own[L] | knot0, ribt)]))
            Fls.append(slab(n, [(knot0, lambda idx: -At[:, :, idx])]))
        else:
            Fus.append(slab(m, [(own[L], ribt)]))
            Fls.append(slab(n, []))
    zy, zx, zu = _leaf_z(pbl)
    return Fls, Fxs, Fus, A, B, zy, zx, zu


def _leaf_z(pbl: LQRProblem):
    """Negated, leaf-transformed RHS planes (ref solver.c:187-190 +
    nested_dissection.c:42-90)."""
    N = pbl.A.shape[0]
    dev = pbl.A.device
    q_, r_, f_ = _emv(pbl.q), _emv(pbl.r), _emv(pbl.f)
    Qd, Rd = _emv(pbl.Qdiag), _emv(pbl.Rdiag)
    ks = np.arange(N)
    m0 = _kmask(ks == 0, 1, dev)
    mlast = _kmask(ks == N - 1, 1, dev)
    zy0 = torch.cat([-pbl.x0[:, None], -f_[:, :-1]], dim=1)
    zy = torch.where(m0, -Qd[:, :1] * zy0 + q_, zy0)
    zx = torch.where(m0, -zy0, -q_ * (1.0 / Qd))
    zu = torch.where(mlast, -r_, -r_ * (1.0 / Rd))
    return zy, zx, zu


def _em_from_gm(x: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Group-major kernel extract ``[G, p*q, B]`` -> ``[p, q, G, B]``."""
    G, _, B = x.shape
    return x.transpose(0, 1).reshape(p, q, G, B)


def _gm(x: torch.Tensor) -> torch.Tensor:
    """Element-major ``[p, q, G, B] -> [G, pq, B]`` group-major."""
    p, q, G, B = x.shape
    return x.reshape(p * q, G, B).transpose(0, 1).contiguous()


def _sep_gm(M: torch.Tensor, level: int) -> torch.Tensor:
    """Group-major gather of a dynamics array at level-``level`` separator
    knots: ``[p, q, N, B] -> [G, pq, B]`` with ``G = N / 2^{level+1}``."""
    p, q, N, B = M.shape
    span = 1 << (level + 1)
    sep = M.reshape(p * q, N // span, span, B)[:, :, span // 2 - 1, :]
    return sep.transpose(0, 1).contiguous()


def _slab(x: torch.Tensor) -> torch.Tensor:
    """Kernel view of an element-major slab: ``[p, q, N, B] -> [pq, N, B]``
    (a view of the contiguous slab, so in-place updates land in it)."""
    return x.view(x.shape[0] * x.shape[1], x.shape[2], x.shape[3])


def _flat(x: torch.Tensor) -> torch.Tensor:
    """Flat-plane kernel view of an element-major block array (JAX's
    ``_flat``): ``[p, q, N, B] -> [pq, N*B/128, 128]``, the same bytes as
    :func:`_slab`'s view (a view, so in-place updates land in it)."""
    p, q, N, B = x.shape
    return x.view(p * q, N * B // 128, 128)


def _flatv(x: torch.Tensor) -> torch.Tensor:
    """Flat-plane view of element-major vectors: ``[p, N, B] ->
    [p, N*B/128, 128]``."""
    p, N, B = x.shape
    return x.view(p, N * B // 128, 128)


def _sep_flat(M: torch.Tensor, level: int) -> torch.Tensor:
    """Dynamics at level-``level`` separator knots as compact flat planes:
    ``[p, q, N, B] -> [pq, G*B/128, 128]`` with ``G = N / 2^{level+1}``."""
    p, q, N, B = M.shape
    span = 1 << (level + 1)
    G = N // span
    sep = M.reshape(p * q, G, span, B)[:, :, span // 2 - 1, :]
    return sep.reshape(p * q, G * B // 128, 128)


def _level_products_em(A, B, level, depth, Fls, Fxs, Fus, ex, n, opts):
    """Inner products for every upper level (ndlqr_FactorInnerProduct,
    nested_dissection.c:114-134): either the compact arrays emitted by the
    previous kernel or computed from slab slices."""
    if ex is not None:
        # Group-major [G, nn, B] from ops/schur.py's kernels, already
        # element-major [n, n, G, B] from the flat path.
        return [S if S.dim() == 4 else _em_from_gm(S, n, n) for S in ex]
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    # Compact copies, made once per level (the products' kernels take
    # contiguous planes); rows of bf16 slabs upcast to the problem dtype.
    A_sep = _sel(_gk(A, span), mid).contiguous()
    B_sep = _sel(_gk(B, span), mid).contiguous()
    row = lambda F, pos: schur._up(_sel(_gk(F, span), pos), A.dtype)
    Ss = []
    for u in range(level, depth):
        Ss.append(
            la.bgemm(A_sep, row(Fxs[u], mid), NB + 1, opts)
            + la.bgemm(B_sep, row(Fus[u], mid), NB + 1, opts)
            - row(Fxs[u], mid + 1)
            - row(Fls[u], mid + 1)
        )
    return Ss


def _level_writeback_em(Fls, level, S):
    """Separator write-back of this level's Sbar into its lambda slab
    (ref solve.c:92-97 placement), in place (a bf16 slab takes S rounded,
    as JAX's ``astype``). The kernels fold this into the upstream store
    when they emitted the products."""
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    _gk(Fls[level], span)[..., mid + 1, :] = S


def _level_cholsolve_em(Lc, Ss, level, opts):
    """Cached-Cholesky solves of the upper-level products
    (ndlqr_SolveCholeskyFactor, nested_dissection.c:136-152)."""
    sols = _cholsolve_stacked(Lc, Ss[1:], opts)
    return {level + 1 + i: s for i, s in enumerate(sols)}


def _kernel_schedule(fdt, N: int, n: int, opts: SolveOptions,
                     dtype=None) -> bool:
    """Whether small-block slabs stored in ``fdt`` (on a problem of dtype
    ``dtype``; None: ``fdt``) take the schedule of the JAX package's kernel
    path (fused leaf, level pairs, products emitted by the sweep kernels),
    decided as its ``_pallas_schur_mode`` decides it on the storage dtype
    (rslqr_em.py:440-453, 876), before any launch: on every device for f32
    slabs and for f64 slabs on an f64 problem (the port runs that schedule
    everywhere), and for bf16 slabs where the knot axis tiles by 16
    (N >= 16, N % 16 == 0). Any other storage (f16; f64 on an f32
    problem; bf16 on another knot axis), as JAX's ``ok_dtype`` sends it to
    its XLA stages (rslqr_em.py:317-361), takes the plain leaf and single
    levels without emission, each level's updated slabs rounded once."""
    if _mid_block(n, opts):
        return False
    if fdt == torch.bfloat16:
        return N >= 16 and N % 16 == 0
    return fdt == torch.float32 or fdt == torch.float64 == (dtype or fdt)


def _mid_block(n: int, opts: SolveOptions) -> bool:
    """Whether the slabs take the mid-block planes route: one static rule,
    decided before any launch, the same on every device. Above the
    threshold (JAX: its Pallas Schur kernels' mode is None there), and also
    for a state dim past the small-block kernels' ``schur.MAX_STATE`` under
    a raised threshold (n in 9..threshold): there the plane kernels (B7,
    B9) run the separator solves and Schur updates, where the reference
    runs its small-block kernels; both give the same KKT solution."""
    return n > min(opts.mxu_block_threshold, schur.MAX_STATE)


def _plane_options(n: int, m: int, opts: SolveOptions) -> SolveOptions:
    """The options the sweep runs a block on: blocks past the plane
    kernels' ``planes.MAX_BLOCK`` (``max(n, m) > 64``) take the mid-block
    route through the plain versions of B5-B9 (``kernels="off"``) on every
    device, as the JAX package's plane kernels stand aside there
    (rslqr_tpu/linalg.py:172-193); smaller blocks keep ``opts``. One static
    rule, decided before any launch, beside :func:`_mid_block`."""
    if max(n, m) > planes.MAX_BLOCK:
        return dataclasses.replace(opts, kernels="off")
    return opts


def _pcho_solve(Lc, S, opts):
    """Mid-block separator solve, in place on ``S`` (a level's compact
    product or RHS, used no more after it; JAX donates it the same way)."""
    return planes.pcho_solve(Lc.contiguous(), S.contiguous(),
                             kernels=opts.kernels)


def _cholsolve_stacked(Lc, Ss, opts):
    """Solve equal-shape block RHS against one cached factor. Small blocks:
    one stacked substitution (width n*len(Ss)), split after. Mid blocks:
    one ``pcho_solve`` per RHS, in place on it, as the JAX package runs
    them (rslqr_em.py:299-314); stacking there would save the factor's
    re-reads but pay a concatenated copy of every RHS."""
    if _mid_block(Lc.shape[0], opts):
        return [_pcho_solve(Lc, S, opts) for S in Ss]
    if len(Ss) <= 1:
        return [la.bcho_solve(Lc, S, NB + 1, opts) for S in Ss]
    n = Ss[0].shape[1]
    sol = la.bcho_solve(Lc, torch.cat(Ss, dim=1), NB + 1, opts)
    return [sol[:, i * n:(i + 1) * n] for i in range(len(Ss))]


def _schur_kernel(A, B_dyn, level, depth, Fls, Fxs, Fus, fsols, n, m, opts,
                  emit=True):
    """The single-level Schur stage through ``schur_update_level_em``
    (counterpart of ``rslqr_em._schur_pallas``); updates the slabs in
    place and returns the next level's products list (or None; always
    None without ``emit``)."""
    N, B = Fls[level].shape[2], Fls[level].shape[3]
    us = list(range(level + 1, depth))
    Asep = Bsep = None
    if (emit and schur._level_emits(level, N, Fls[level].dtype)
            and level + 2 <= depth):
        Asep = _sep_gm(A, level + 1)
        Bsep = _sep_gm(B_dyn, level + 1)
    *_, S_next = schur.schur_update_level_em(
        _slab(Fls[level]), _slab(Fxs[level]), _slab(Fus[level]),
        [_slab(Fls[u]) for u in us],
        [_slab(Fxs[u]) for u in us],
        [_slab(Fus[u]) for u in us],
        [_gm(fsols[u]) for u in us],
        Asep, Bsep, level=level, n=n, m=m, kernels=opts.kernels,
    )
    return S_next


def _flat_path_ok(dtype, nb: int, N: int, b_shape, n: int,
                  opts: Optional[SolveOptions] = None, cdt=None) -> bool:
    """Whether the flat-plane schedule (``ops/flat.py``) runs: JAX's
    ``_flat_path_ok`` (``flat_planes``, one batch axis, ``flat.flat_ok``:
    f32 and ``B % 1024 == 0``) and the conditions under which its Pallas
    Schur kernels run at all (``_pallas_schur_mode``: small blocks, N >= 8,
    N % 8 == 0). ``dtype`` is the slabs' storage, ``cdt`` the problem's
    (None: the same): the flat kernels and their plain versions take f32
    slabs of an f32 problem only."""
    opts = resolve_options(opts)
    return (
        opts.flat_planes
        and (cdt is None or cdt == dtype)
        and not _mid_block(n, opts)
        and nb == 1
        and N >= 8
        and N % 8 == 0
        and flat.flat_ok(N, b_shape[0], dtype)
    )


def _schur_flat(A, B_dyn, level, depth, Fls, Fxs, Fus, fsols, n, m, opts):
    """The single-level Schur stage through ``schur_update_level_flat``
    (counterpart of ``rslqr_em._schur_flat``); updates the slabs in place
    and returns the next level's products as element-major
    ``[n, n, G2, B]`` views (or None)."""
    N, B = Fls[level].shape[2], Fls[level].shape[3]
    us = list(range(level + 1, depth))
    Asep = Bsep = None
    if flat._flat_emits(level, N) and level + 2 <= depth:
        Asep = _sep_flat(A, level + 1)
        Bsep = _sep_flat(B_dyn, level + 1)
    *_, S_next = flat.schur_update_level_flat(
        _flat(Fls[level]), _flat(Fxs[level]), _flat(Fus[level]),
        [_flat(Fls[u]) for u in us],
        [_flat(Fxs[u]) for u in us],
        [_flat(Fus[u]) for u in us],
        [_flat(fsols[u].contiguous()) for u in us],
        Asep, Bsep, level=level, n=n, m=m, N=N, kernels=opts.kernels,
    )
    if S_next is None:
        return None
    return [S.view(n, n, N >> (level + 2), B) for S in S_next]


def _level_update_planes_em(level, depth, Fls, Fxs, Fus, fsols, opts):
    """Mid-block Schur update stage (ndlqr_UpdateShurFactor,
    nested_dissection.c:154-171): one ``schur3_update_levels`` call for
    every upper level (JAX: one ``schur3_update_planes`` pass per upper
    level), which reads the compact solved separators at each knot's
    group; updates the slabs in place. Slabs stored in another dtype than
    the problem's (``factor_dtype``) take the plain update
    (:func:`_level_update_plain_em`), as JAX sends non-f32 slabs past its
    plane kernels (rslqr_em.py:383)."""
    if Fls[level].dtype != fsols[level + 1].dtype:
        _level_update_plain_em(level, depth, Fls, Fxs, Fus, fsols)
        return
    us = range(level + 1, depth)
    planes.schur3_update_levels(
        Fls[level], Fxs[level], Fus[level], [fsols[u] for u in us],
        [Fls[u] for u in us], [Fxs[u] for u in us], [Fus[u] for u in us],
        level=level, kernels=opts.kernels,
    )


def _level_update_plain_em(level, depth, Fls, Fxs, Fus, fsols):
    """The plain Schur update of mid-block slabs stored in another dtype
    than the problem's (JAX's ``_level_update_xla_em``,
    rslqr_em.py:317-361): each upper slab trio updated in the problem
    dtype on converted copies, then rounded back once by ``copy_`` (round
    to nearest even, as ``astype``)."""
    cdt = fsols[level + 1].dtype
    FL = [schur._up(x, cdt) for x in (Fls[level], Fxs[level], Fus[level])]
    for u in range(level + 1, depth):
        dst = (Fls[u], Fxs[u], Fus[u])
        C = [schur._up(x, cdt) for x in dst]
        planes.schur3_update_planes_plain(*FL, fsols[u], *C, level=level)
        for d, c in zip(dst, C):
            d.copy_(c)


def _sweep_level_em(A, B, level, depth, Fls, Fxs, Fus, n, m, ex, opts):
    """One level of the factorization sweep (ref solve.c:68-134); updates
    the slabs in place, returns the level's Cholesky factors
    ``[n, n, G, B]`` and the next level's products (or None). Each
    reference phase runs in its span, tagged with ``level``."""
    with span("products", level):
        Ss = _level_products_em(A, B, level, depth, Fls, Fxs, Fus, ex, n,
                                opts)
    with span("cholesky", level):
        Lc = la.bcholesky(Ss[0], NB + 1, opts)
    if ex is None:
        with span("shur", level):
            _level_writeback_em(Fls, level, Ss[0])
    with span("cholsolve", level):
        fsols = _level_cholsolve_em(Lc, Ss, level, opts)
    if level + 1 >= depth:
        return Lc, None
    with span("shur", level):
        if _mid_block(n, opts):
            _level_update_planes_em(level, depth, Fls, Fxs, Fus, fsols,
                                    opts)
            return Lc, None
        fdt = Fls[level].dtype
        if _flat_path_ok(fdt, NB, A.shape[2], A.shape[3:], n, opts,
                         A.dtype):
            return Lc, _schur_flat(A, B, level, depth, Fls, Fxs, Fus, fsols,
                                   n, m, opts)
        return Lc, _schur_kernel(
            A, B, level, depth, Fls, Fxs, Fus, fsols, n, m, opts,
            emit=_kernel_schedule(fdt, A.shape[2], n, opts, A.dtype))


def _pair_prepass(A, B, level, depth, Fls, Fxs, Fus, fsols1, opts):
    """Level-(L+1) inner products computed from the PRE-update slabs and
    this level's solved separators (only the level-(L+1) separator rows
    are gathered), so the paired kernel needs no separate level-(L+1) pass.
    See ``rslqr_tpu.rslqr_em._pair_prepass`` for the row algebra."""
    span1 = 1 << (level + 1)
    span2 = 2 * span1
    nk = NB + 1
    # Rows of bf16 slabs upcast to the problem dtype.
    sel2 = lambda x, pos: schur._up(_sel(_gk(x, span2), pos), A.dtype)
    A_sep2 = sel2(A, span1 - 1)
    B_sep2 = sel2(B, span1 - 1)
    FxL_r2 = sel2(Fxs[level], span1 - 1)
    FuL_r2 = sel2(Fus[level], span1 - 1)
    FxL_r2p = sel2(Fxs[level], span1)
    Ss = []
    for u in range(level + 1, depth):
        f = fsols1[u]  # [n, n, G1, B]
        f_e = _sel(_gk(f, 2), 0)  # even level-L groups (row r2)
        f_o = _sel(_gk(f, 2), 1)  # odd groups (row r2 + 1)
        Fx_r2 = sel2(Fxs[u], span1 - 1) - la.bgemm(FxL_r2, f_e, nk, opts)
        Fu_r2 = sel2(Fus[u], span1 - 1) - la.bgemm(FuL_r2, f_e, nk, opts)
        Fx_r2p = sel2(Fxs[u], span1) - la.bgemm(FxL_r2p, f_o, nk, opts)
        Fl_r2p = sel2(Fls[u], span1)
        Ss.append(
            la.bgemm(A_sep2, Fx_r2, nk, opts)
            + la.bgemm(B_sep2, Fu_r2, nk, opts)
            - Fx_r2p
            - Fl_r2p
        )
    return Ss


def _schur_kernel_pair(
    A, B_dyn, level, depth, Fls, Fxs, Fus, fsols1, Sbar2, fsols2, n, m, opts
):
    """The two-level Schur stage through ``schur_update_pair_em``
    (counterpart of ``rslqr_em._schur_pallas_pair``); updates the slabs in
    place and returns the level-(L+2) products list (or None)."""
    N, B = Fls[level].shape[2], Fls[level].shape[3]
    us = list(range(level + 1, depth))
    Asep = Bsep = None
    if (
        schur._pair_emits(level, N, B, len(us), n, m, Fls[level].dtype)
        and level + 2 <= depth - 1
    ):
        Asep = _sep_gm(A, level + 2)
        Bsep = _sep_gm(B_dyn, level + 2)
    *_, S_next = schur.schur_update_pair_em(
        _slab(Fls[level]), _slab(Fxs[level]), _slab(Fus[level]),
        [_slab(Fls[u]) for u in us],
        [_slab(Fxs[u]) for u in us],
        [_slab(Fus[u]) for u in us],
        [_gm(fsols1[u]) for u in us],
        _gm(Sbar2),
        [_gm(fsols2[u]) for u in us[1:]],
        Asep, Bsep, level=level, n=n, m=m, kernels=opts.kernels,
    )
    return S_next


def _sweep_pair_em(A, B, level, depth, Fls, Fxs, Fus, n, m, ex, opts):
    """TWO levels of the factorization sweep (ref solve.c:68-134, two
    iterations) with a single slab pass: compact stages for both levels'
    Cholesky factors and separator solves, then the paired kernel.
    Returns ``(Lc1, Lc2, ex_next)``. Each compact stage's span is tagged
    with the level it computes, the paired kernel's ``shur`` with
    ``level``."""
    with span("products", level):
        Ss = _level_products_em(A, B, level, depth, Fls, Fxs, Fus, ex, n,
                                opts)
    with span("cholesky", level):
        Lc1 = la.bcholesky(Ss[0], NB + 1, opts)
    if ex is None:
        with span("shur", level):
            _level_writeback_em(Fls, level, Ss[0])
    with span("cholsolve", level):
        fsols1 = _level_cholsolve_em(Lc1, Ss, level, opts)
    with span("products", level + 1):
        S2 = _pair_prepass(A, B, level, depth, Fls, Fxs, Fus, fsols1, opts)
    with span("cholesky", level + 1):
        Lc2 = la.bcholesky(S2[0], NB + 1, opts)
    with span("cholsolve", level + 1):
        fsols2 = {
            level + 2 + i: s
            for i, s in enumerate(_cholsolve_stacked(Lc2, S2[1:], opts))
        }
    with span("shur", level):
        ex_next = _schur_kernel_pair(
            A, B, level, depth, Fls, Fxs, Fus, fsols1, S2[0], fsols2, n, m,
            opts
        )
    return Lc1, Lc2, ex_next


def _rhs_level_em(A, B, level, Fl, Fx, Fu, Lc, zy, zx, zu, opts):
    """One level of the RHS sweep (ref solve.c:137-182): the compact
    separator solve (plain ops; ``pcho_solve`` for mid blocks), then one
    kernel pass over the level's slabs (``rhs_update_level_em``, or
    ``rhs_update_level_flat`` on the flat path; for mid blocks
    ``schur3_update_planes`` with one column, JAX rslqr_em.py:751-774).
    Vectors are contiguous ``[n|m, N, B]``; returns the updated
    ``(zy, zx, zu)`` (updated in place)."""
    span = 1 << (level + 1)
    mid = (1 << level) - 1
    nk = NB + 1
    A_sep = _sel(_gk(A, span), mid)
    B_sep = _sel(_gk(B, span), mid)
    gy, gx, gu = _gk(zy, span), _gk(zx, span), _gk(zu, span)
    znew = (
        la.bgemv(A_sep, _sel(gx, mid), nk)
        + la.bgemv(B_sep, _sel(gu, mid), nk)
        - _sel(gx, mid + 1)
        - _sel(gy, mid + 1)
    )
    n, m = zy.shape[0], zu.shape[0]
    if _mid_block(n, opts):
        zbar = _pcho_solve(Lc, znew.unsqueeze(1), opts)  # [n, 1, G, B]
        zs = (zy.unsqueeze(1), zx.unsqueeze(1), zu.unsqueeze(1))
        if Fl.dtype != zy.dtype:
            # No plane kernel takes slabs stored apart from the problem
            # dtype (JAX's XLA stage, rslqr_em.py:750-790): the plain
            # update on converted copies.
            planes.schur3_update_planes_plain(
                *(schur._up(F, zy.dtype) for F in (Fl, Fx, Fu)), zbar, *zs,
                level=level)
        else:
            planes.schur3_update_planes(Fl, Fx, Fu, zbar, *zs, level=level,
                                        kernels=opts.kernels)
        return zy, zx, zu
    zbar = la.bcho_solve_vec(Lc, znew, nk, opts)  # [n, G, B]
    N, B_ = zy.shape[1], zy.shape[2]
    if _flat_path_ok(Fl.dtype, NB, N, (B_,), n, opts, zy.dtype):
        flat.rhs_update_level_flat(
            _flat(Fl), _flat(Fx), _flat(Fu), _flatv(zy), _flatv(zx),
            _flatv(zu), _flatv(zbar.contiguous()),  # element-major [n, G, B]
            level=level, n=n, m=m, N=N, kernels=opts.kernels,
        )
        return zy, zx, zu
    return schur.rhs_update_level_em(
        _slab(Fl), _slab(Fx), _slab(Fu), zy, zx, zu,
        zbar.transpose(0, 1).contiguous(),
        level=level, n=n, m=m, kernels=opts.kernels,
    )


def _leaf_products0(pbl: LQRProblem, t: TreeTables, n: int, m: int, opts):
    """Level-0 inner products from compact even/odd-knot gathers of the
    problem data: ``S_{0,u} = A_sep Fx_u[even] + B_sep Fu_u[even] -
    Fx_u[odd]`` (the lambda term vanishes: the only nonzero leaf lambda
    block sits at knot 0, an even knot). Returns ``(A, B, qinv, rinv,
    [S_u])`` in element-major layout."""
    N, depth = pbl.A.shape[0], t.depth
    dev = pbl.A.device
    nk = NB + 1
    A, Bd = _em(pbl.A), _em(pbl.B)
    At, Bt = A.transpose(0, 1), Bd.transpose(0, 1)
    qinv = 1.0 / _emv(pbl.Qdiag)
    rinv = 1.0 / _emv(pbl.Rdiag)
    QiAt = At * qinv[:, None]
    RiBt = Bt * rinv[:, None]
    own, prev = _leaf_masks(t.levels, N, depth)
    knot0 = np.arange(N) == 0

    par = lambda x, p: _sel(_gk(x, 2), p)  # even (0) / odd (1) knots
    eye = torch.eye(n, dtype=A.dtype, device=dev).reshape(n, n, 1, 1)
    qinv_e, qinv_o = par(qinv, 0), par(qinv, 1)
    A_sep, B_sep = par(A, 0), par(Bd, 0)
    QiAt_e, QiAt_o = par(QiAt, 0), par(QiAt, 1)
    RiBt_e = par(RiBt, 0)

    def fx(u, parity, QiAt_p, qinv_p):
        mo = _kmask(own[u][parity::2], 2, dev)
        mp = _kmask(prev[u][parity::2], 2, dev)
        return torch.where(mo, QiAt_p, 0.0) - torch.where(
            mp, eye * qinv_p[None], 0.0
        )

    Ss = []
    for u in range(depth):
        ownu = own[u] | knot0 if u == 0 else own[u]
        Fue = torch.where(_kmask(ownu[0::2], 2, dev), RiBt_e, 0.0)
        Ss.append(
            la.bgemm(A_sep, fx(u, 0, QiAt_e, qinv_e), nk, opts)
            + la.bgemm(B_sep, Fue, nk, opts)
            - fx(u, 1, QiAt_o, qinv_o)
        )
    return A, Bd, qinv, rinv, Ss


def factorize_em(
    prob: LQRProblem, tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
):
    """Leaf solves + level sweep (ref solve.c:50-134), in the ``factor``
    span. ``prob`` carries ONE leading batch axis. Returns the
    factorization and the leaf-solved element-major RHS ``(zy, zx, zu)``.
    The fused leaf kernel runs in the ``leaves`` span, the level-0 compact
    stages from which it starts in level 0's."""
    pbl = _to_batch_last(prob, 1)
    t = tables or build_tree_tables(pbl.A.shape[0])
    n, m = pbl.A.shape[1], pbl.B.shape[2]
    opts = _plane_options(n, m, resolve_options(options))
    N, Bb = pbl.A.shape[0], pbl.A.shape[3]

    mid = _mid_block(n, opts)
    fdt = storage_dtype(opts.factor_dtype, pbl.A.dtype)
    sched = _kernel_schedule(fdt, N, n, opts, pbl.A.dtype)
    use_flat = _flat_path_ok(fdt, NB, N, (Bb,), n, opts, pbl.A.dtype)
    with span("factor"):
        if t.depth >= 2 and sched:
            # Fused leaf + level 0: level-0 products from compact gathers, then
            # ONE kernel writes every slab in its post-level-0 state and emits
            # the level-1 products.
            with span("products", 0):
                A, B, qinv, rinv, Ss = _leaf_products0(pbl, t, n, m, opts)
            with span("cholesky", 0):
                Lc0 = la.bcholesky(Ss[0], NB + 1, opts)
            with span("cholsolve", 0):
                fsols0 = _cholsolve_stacked(Lc0, Ss[1:], opts)
            with span("leaves"):
                A = A.contiguous()
                B = B.contiguous()
                if use_flat:
                    Fls, Fxs, Fus, ex = flat.leaf_schur_level0_flat(
                        _flat(A), _flat(B), _flatv(qinv.contiguous()),
                        _flatv(rinv.contiguous()), _flat(Ss[0].contiguous()),
                        [_flat(f.contiguous()) for f in fsols0],
                        _sep_flat(A, 1), _sep_flat(B, 1),
                        depth=t.depth, n=n, m=m, N=N, kernels=opts.kernels,
                    )
                    ex = [S.view(n, n, N // 4, Bb) for S in ex]
                else:
                    Fls, Fxs, Fus, ex = schur.leaf_schur_level0_em(
                        A.view(n * n, N, Bb), B.view(n * m, N, Bb),
                        qinv.contiguous(), rinv.contiguous(),
                        _gm(Ss[0]), [_gm(f) for f in fsols0],
                        _sep_gm(A, 1), _sep_gm(B, 1),
                        depth=t.depth, n=n, m=m, kernels=opts.kernels,
                        factor_dtype=opts.factor_dtype,
                    )
                Fls = [x.view(n, n, N, Bb) for x in Fls]
                Fxs = [x.view(n, n, N, Bb) for x in Fxs]
                Fus = [x.view(m, n, N, Bb) for x in Fus]
                zy, zx, zu = _leaf_z(pbl)
            chols = [Lc0]
            level = 1
        else:
            # Plain leaf slabs: the tree is too shallow for the fused leaf
            # kernel, the blocks are mid-size (no fused leaf there in JAX), or
            # the storage takes JAX's XLA stages (_kernel_schedule).
            with span("leaves"):
                Fls, Fxs, Fus, A, B, zy, zx, zu = _leaf_em(pbl, t.levels,
                                                           t.depth, fdt)
            chols = []
            ex = None
            level = 0
        while level < t.depth:
            # Level pairing: two sweep levels per slab pass, whenever level+1
            # still has upper levels to update (small blocks only: the pair
            # kernel is a small-block kernel; the flat path never pairs, as in
            # JAX, rslqr_em.py:943-952).
            if (level <= t.depth - 3 and opts.level_pairing and sched
                    and not use_flat):
                Lc1, Lc2, ex = _sweep_pair_em(
                    A, B, level, t.depth, Fls, Fxs, Fus, n, m, ex, opts
                )
                chols.extend([Lc1, Lc2])
                level += 2
            else:
                Lc, ex = _sweep_level_em(
                    A, B, level, t.depth, Fls, Fxs, Fus, n, m, ex, opts
                )
                chols.append(Lc)
                level += 1
    fact = EmFactorization(
        Fls=tuple(Fls), Fxs=tuple(Fxs), Fus=tuple(Fus), chols=tuple(chols)
    )
    return fact, (zy, zx, zu)


def solve_rhs_em(
    prob: LQRProblem,
    fact: EmFactorization,
    rhs: Tuple,
    tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """Cached-factorization RHS solve (ref solve.c:137-182). ``rhs`` is the
    leaf-solved element-major RHS from :func:`factorize_em` or
    :func:`leaf_rhs_em`; its planes are updated in place. ``tables`` is
    taken for the JAX signature: the sweep's depth is the factorization's."""
    opts = resolve_options(options)
    pbl = _to_batch_last(prob, 1)
    zy, zx, zu = rhs_sweep_em(_em(pbl.A), _em(pbl.B), fact, rhs, opts)
    Y, X, U = _emv_bl(zy), _emv_bl(zx), _emv_bl(zu)
    return RsLqrSolution(
        Y=_bf(Y, 1), X=_bf(X, 1), U=_bf(U[:-1], 1), fact=fact
    )


def rhs_sweep_em(A, B, fact: EmFactorization, rhs: Tuple,
                 opts: SolveOptions) -> Tuple:
    """Every level of the RHS sweep over ``fact`` (ref solve.c:137-182),
    with element-major dynamics ``A``/``B``; ``rhs`` is an element-major
    leaf-solved RHS (made contiguous, then updated in place). Returns
    ``(zy, zx, zu)``."""
    opts = _plane_options(A.shape[0], B.shape[1], opts)
    with span("sweep"):
        zy, zx, zu = (z.contiguous() for z in rhs)
        for level in range(len(fact.chols)):
            with span("rhs", level):
                zy, zx, zu = _rhs_level_em(
                    A, B, level, fact.Fls[level], fact.Fxs[level],
                    fact.Fus[level], fact.chols[level], zy, zx, zu, opts,
                )
    return zy, zx, zu


def leaf_rhs_em(prob: LQRProblem) -> Tuple:
    """Leaf-solve a fresh RHS into element-major planes (multi-RHS mode;
    the z-vector half of ndlqr_SolveLeaf, nested_dissection.c:42-90)."""
    return _leaf_z(_to_batch_last(prob, 1))


def em_rhs_from_bl(rhs: Tuple) -> Tuple:
    """A batch-last leaf-solved RHS ``[N, n|m, B]`` as element-major
    ``[n|m, N, B]`` planes."""
    return tuple(_emv(z) for z in rhs)


def solve_em(
    prob: LQRProblem, tables: Optional[TreeTables] = None,
    options: Optional[SolveOptions] = None,
) -> RsLqrSolution:
    """Full rsLQR solve, element-major (ref ndlqr_Solve, solve.c:38-190),
    of a problem with ONE leading batch axis."""
    t = tables or build_tree_tables(prob.A.shape[-3])
    fact, rhs = factorize_em(prob, t, options=options)
    return solve_rhs_em(prob, fact, rhs, t, options=options)


def solve_kkt_em(prob: LQRProblem, options=None) -> torch.Tensor:
    """Solve and return the flat KKT vectors ``[B, nvars]``."""
    sol = solve_em(prob, options=options)
    return pack_solution(sol.Y, sol.X, sol.U)
