"""The three flat-plane sweep kernels of the small-block rsLQR path (Hopper).

Each wrapper keeps the signature, layouts and return contract of its
counterpart in ``rslqr_tpu/ops/schur_planes.py``:

* factor slabs and z vectors are flat planes ``[e, N*B/128, 128]``, the same
  bytes as the element-major ``[e, N, B]`` planes of ``ops/schur.py``
  (element ``e`` of knot ``k``, batch column ``b`` at ``e*N*B + k*B + b``);
* compact solved separators and emitted products are element-major too,
  ``[e, G*B/128, 128]`` (``ops/schur.py``: group-major ``[G, e, B]``);
* the next-level products are emitted at levels 0-1 only
  (:func:`_flat_emits` carries the JAX tiling's choice over), with the next
  level's own Sbar folded into its slab.

Dispatch, launch counts and in-place updates are those of ``ops/schur.py``
(:func:`~rslqr_tpu_torch.ops.schur.kernel_applies`): the CUDA kernel
(``csrc/flat_kernels.cu``, instantiated for every block size of the small
path, 1 <= n <= 8 and 1 <= m <= 64) for float32 CUDA tensors under
``kernels="auto"``,
launch or raise; the plain version (``*_plain``) otherwise.
The plain versions run ``ops/schur.py``'s plain versions on views of the same
data (the math is the same; only the compact layouts and the emission levels
differ).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import schur
from .schur import _check, _launch, _level_plan, _ptr, _ptrs, kernel_applies


# ---------------------------------------------------------------------------
# Geometry of the JAX kernels (schur_planes._kpt_for / _flat_geometry /
# flat_ok), carried over exactly.
# ---------------------------------------------------------------------------


def _kpt_for(level: int, N: int) -> int:
    """Knots per tile: whole next-level groups (2 * 2^{level+1} knots) at
    the shallow levels, at least 4 and at most 8 knots."""
    span = 1 << (level + 1)
    return min(max(2 * span, 4), 8, N)


def _flat_geometry(level: int, N: int, B: int):
    """Tile geometry ``(rb, kpt, t1, span, gd, gd2)`` of the JAX kernels:
    ``rb = B / 128`` rows per knot, ``kpt`` knots per tile, ``gd`` groups
    and ``gd2`` next-level groups per tile (0: no product emission)."""
    rb = B // 128
    span = 1 << (level + 1)
    kpt = _kpt_for(level, N)
    t1 = kpt * rb
    gd = max(kpt // span, 1)
    gd2 = kpt // (2 * span) if 2 * span <= kpt and N >= 2 * span else 0
    return rb, kpt, t1, span, gd, gd2


def flat_ok(N: int, B: int, dtype) -> bool:
    """Whether the flat-plane kernels apply: f32 storage, whole (8, 128)
    tiles per knot, and at least one tile of knots."""
    return (
        dtype == torch.float32
        and B % 1024 == 0
        and N >= 4
        and N % _kpt_for(0, N) == 0
    )


# flat_level_kernel's block and launch plan are the row-group level
# update's (ops/schur.py:_level_plan): B10 runs its own kernel of that
# design at n, m <= 8 (one slot per row group) and csrc/row_groups.cuh's at
# the wide blocks.


def _flat_emits(level: int, N: int) -> bool:
    """Whether ``schur_update_level_flat`` emits the next level's products:
    the JAX kernel does when its knot tile covers a whole next-level group,
    i.e. at levels 0 and 1 (level 1 only for N >= 8)."""
    return _flat_geometry(level, N, 128)[5] > 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; CPU tests and kernels="off").
# ---------------------------------------------------------------------------


def _slab(x: torch.Tensor, N: int) -> torch.Tensor:
    """Flat planes ``[e, N*B/128, 128]`` as the ``[e, N, B]`` slab view of
    ``ops/schur.py`` (a view)."""
    return x.view(x.shape[0], N, -1)


def _gm(x: torch.Tensor, G: int) -> torch.Tensor:
    """Compact element-major ``[e, G*B/128, 128]`` as group-major
    ``[G, e, B]`` (a strided view)."""
    return x.view(x.shape[0], G, -1).transpose(0, 1)


def _from_gm(S: torch.Tensor) -> torch.Tensor:
    """Group-major ``[G, e, B]`` -> compact flat ``[e, G*B/128, 128]``."""
    G, e, B = S.shape
    return S.transpose(0, 1).reshape(e, G * B // 128, 128)


def schur_update_level_flat_plain(
    FLl, FLx, FLu, Fls, Fxs, Fus, fsol, Asep=None, Bsep=None, *, level, n,
    m, N,
):
    """Plain version of :func:`schur_update_level_flat`."""
    G, G2 = N >> (level + 1), N >> (level + 2)
    emit = Asep is not None and _flat_emits(level, N)
    *_, S = schur.schur_update_level_em_plain(
        _slab(FLl, N), _slab(FLx, N), _slab(FLu, N),
        [_slab(x, N) for x in Fls], [_slab(x, N) for x in Fxs],
        [_slab(x, N) for x in Fus], [_gm(f, G) for f in fsol],
        _gm(Asep, G2) if emit else None, _gm(Bsep, G2) if emit else None,
        level=level, n=n, m=m,
    )
    S_next = None if S is None else [_from_gm(x) for x in S]
    return tuple(Fls), tuple(Fxs), tuple(Fus), S_next


def leaf_schur_level0_flat_plain(
    A, B, qinv, rinv, S0, fsol, Asep, Bsep, *, depth, n, m, N
):
    """Plain version of :func:`leaf_schur_level0_flat`."""
    Fls, Fxs, Fus, S = schur.leaf_schur_level0_em_plain(
        _slab(A, N), _slab(B, N), _slab(qinv, N), _slab(rinv, N),
        _gm(S0, N // 2), [_gm(f, N // 2) for f in fsol], _gm(Asep, N // 4),
        _gm(Bsep, N // 4),
        depth=depth, n=n, m=m,
    )
    flat = lambda xs: tuple(x.reshape(x.shape[0], -1, 128) for x in xs)
    return flat(Fls), flat(Fxs), flat(Fus), [_from_gm(x) for x in S]


def rhs_update_level_flat_plain(Fl, Fx, Fu, zy, zx, zu, zbar, *, level, n, m,
                                N):
    """Plain version of :func:`rhs_update_level_flat`."""
    schur.rhs_update_level_em_plain(
        _slab(Fl, N), _slab(Fx, N), _slab(Fu, N), _slab(zy, N), _slab(zx, N),
        _slab(zu, N), _gm(zbar, N >> (level + 1)), level=level, n=n, m=m,
    )
    return zy, zx, zu


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


def _batch(name: str, R: int, N: int) -> int:
    """Batch width ``B`` of flat planes of ``R`` rows over ``N`` knots."""
    if (R * 128) % N:
        raise ValueError(f"{name}: {R} rows of 128 do not split into "
                         f"{N} knots")
    return R * 128 // N


def schur_update_level_flat(
    FLl: torch.Tensor,            # [nn, R, 128] level-L lambda multiplier
    FLx: torch.Tensor,            # [nn, R, 128]
    FLu: torch.Tensor,            # [mn, R, 128]
    Fls: Sequence[torch.Tensor],  # U upper slabs [nn, R, 128] (in place)
    Fxs: Sequence[torch.Tensor],  # U x [nn, R, 128]
    Fus: Sequence[torch.Tensor],  # U x [mn, R, 128]
    fsol: Sequence[torch.Tensor],  # U solved separators [nn, G*B/128, 128]
    Asep: Optional[torch.Tensor] = None,  # [nn, G2*B/128, 128] A at L+1 seps
    Bsep: Optional[torch.Tensor] = None,  # [nm, G2*B/128, 128]
    *,
    level: int,
    n: int,
    m: int,
    N: int,
    kernels: str = "auto",
):
    """Apply the level-``level`` Schur updates and separator write-back to
    every upper slab: ``F*[u,k] -= F*[L,k] @ fsol_u[group(k)]``, with the
    calc_lambda mask and the solved separator written at sep+1 knots.

    Returns ``(Fls, Fxs, Fus, S_next)``; the slabs are updated in place.
    ``S_next`` is the per-upper-level list of next-level products
    ``[nn, G2*B/128, 128]`` (``S_next[0]`` is the next level's Sbar, already
    folded into that slab) when ``Asep``/``Bsep`` are given and the JAX
    kernel would emit (:func:`_flat_emits`); otherwise ``None``.

    Replaces ``rslqr_tpu/ops/schur_planes.py:schur_update_level_flat``.
    Kernel: ``flat_level_kernel`` (up to three slab rows per thread, on the
    geometry of :func:`_level_plan`; at the wide blocks, 8 < m,
    ``csrc/row_groups.cuh``'s ``row_level_kernel``).
    """
    emit = Asep is not None and _flat_emits(level, N)
    if not kernel_applies(kernels, FLl.device, FLl.dtype):
        return schur_update_level_flat_plain(
            FLl, FLx, FLu, list(Fls), list(Fxs), list(Fus), fsol, Asep, Bsep,
            level=level, n=n, m=m, N=N,
        )
    nn, R, _ = FLl.shape
    mn = m * n
    U = len(Fls)
    B = _batch("schur_update_level_flat", R, N)
    rg = lambda G: G * B // 128
    G, G2 = N >> (level + 1), N >> (level + 2)
    ts = [FLl, FLx, FLu, *Fls, *Fxs, *Fus, *fsol]
    shapes = ([(nn, R, 128)] * 2 + [(mn, R, 128)] + [(nn, R, 128)] * (2 * U)
              + [(mn, R, 128)] * U + [(nn, rg(G), 128)] * U)
    if emit:
        ts += [Asep, Bsep]
        shapes += [(nn, rg(G2), 128), (n * m, rg(G2), 128)]
    _check("schur_update_level_flat", ts, shapes, n, m, FLl.device)
    S = [torch.empty((nn, rg(G2), 128), device=FLl.device)
         for _ in range(U)] if emit else []
    plan = _level_plan(N, B, emit, n, m)
    _launch(
        "rslqr_flat_schur_update_level", FLl.device,
        _ptr(FLl), _ptr(FLx), _ptr(FLu), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus),
        _ptrs(fsol), _ptr(Asep if emit else None),
        _ptr(Bsep if emit else None), _ptrs(S), U, N, B, level, int(emit),
        n, m, plan.shift, plan.grid[1], sum(plan.groups),
    )
    schur_update_level_flat.launches += 1
    return tuple(Fls), tuple(Fxs), tuple(Fus), (S if emit else None)


def leaf_schur_level0_flat(
    A: torch.Tensor,      # [nn, R, 128] element-major dynamics
    B: torch.Tensor,      # [nm, R, 128]
    qinv: torch.Tensor,   # [n, R, 128] 1/Qdiag
    rinv: torch.Tensor,   # [m, R, 128] 1/Rdiag
    S0: torch.Tensor,     # [nn, G0*B/128, 128] level-0 Sbar
    fsol: Sequence[torch.Tensor],  # depth-1 solved level-0 separators
    Asep: torch.Tensor,   # [nn, G1*B/128, 128] A at level-1 separator knots
    Bsep: torch.Tensor,   # [nm, G1*B/128, 128]
    *,
    depth: int,
    n: int,
    m: int,
    N: int,
    kernels: str = "auto",
):
    """Fused leaf construction + level-0 Schur update: builds every level's
    leaf factor values from the problem data, applies level 0, writes each
    slab once, and emits the level-1 products (with level 1's Sbar folded
    into its slab).

    Returns ``(Fls, Fxs, Fus, S_next)``: per-level tuples of length
    ``depth`` (new tensors) and the list of ``depth-1`` level-1 products.

    Replaces ``rslqr_tpu/ops/schur_planes.py:leaf_schur_level0_flat``.
    Kernel: ``flat_leaf_kernel``.
    """
    if depth < 2:
        raise ValueError("the fused leaf needs a tree of depth >= 2")
    if not kernel_applies(kernels, A.device, A.dtype):
        return leaf_schur_level0_flat_plain(
            A, B, qinv, rinv, S0, fsol, Asep, Bsep, depth=depth, n=n, m=m,
            N=N,
        )
    nn, R, _ = A.shape
    mn = m * n
    U = depth - 1
    Bb = _batch("leaf_schur_level0_flat", R, N)
    r0, r1 = (N // 2) * Bb // 128, (N // 4) * Bb // 128
    _check(
        "leaf_schur_level0_flat", [A, B, qinv, rinv, S0, *fsol, Asep, Bsep],
        [(nn, R, 128), (mn, R, 128), (n, R, 128), (m, R, 128), (nn, r0, 128)]
        + [(nn, r0, 128)] * U + [(nn, r1, 128), (mn, r1, 128)],
        n, m, A.device,
    )
    new = lambda *s: torch.empty(s, device=A.device)
    Fls = [new(nn, R, 128) for _ in range(depth)]
    Fxs = [new(nn, R, 128) for _ in range(depth)]
    Fus = [new(mn, R, 128) for _ in range(depth)]
    S = [new(nn, r1, 128) for _ in range(U)]
    _launch(
        "rslqr_flat_leaf_schur_level0", A.device,
        _ptr(A), _ptr(B), _ptr(qinv), _ptr(rinv), _ptr(S0), _ptrs(fsol),
        _ptr(Asep), _ptr(Bsep), _ptrs(Fls), _ptrs(Fxs), _ptrs(Fus), _ptrs(S),
        depth, N, Bb, n, m,
    )
    leaf_schur_level0_flat.launches += 1
    return tuple(Fls), tuple(Fxs), tuple(Fus), S


def rhs_update_level_flat(
    Fl: torch.Tensor,    # [nn, R, 128] factor slab of this level
    Fx: torch.Tensor,    # [nn, R, 128]
    Fu: torch.Tensor,    # [mn, R, 128]
    zy: torch.Tensor,    # [n, R, 128] RHS planes (updated in place)
    zx: torch.Tensor,    # [n, R, 128]
    zu: torch.Tensor,    # [m, R, 128]
    zbar: torch.Tensor,  # [n, G*B/128, 128] solved separator RHS, compact
    *,
    level: int,
    n: int,
    m: int,
    N: int,
    kernels: str = "auto",
):
    """One level of the RHS sweep's slab application (ref solve.c:137-182):
    ``z{y,x,u} -= F{l,x,u} @ zbar[group]`` with the calc_lambda mask and the
    solved separator written at sep+1 knots. Updates ``zy, zx, zu`` in place
    and returns them.

    Replaces ``rslqr_tpu/ops/schur_planes.py:rhs_update_level_flat``.
    Kernel: ``flat_rhs_kernel``.
    """
    if not kernel_applies(kernels, Fl.device, Fl.dtype):
        return rhs_update_level_flat_plain(
            Fl, Fx, Fu, zy, zx, zu, zbar, level=level, n=n, m=m, N=N
        )
    nn, R, _ = Fl.shape
    B = _batch("rhs_update_level_flat", R, N)
    rG = (N >> (level + 1)) * B // 128
    _check(
        "rhs_update_level_flat", (Fl, Fx, Fu, zy, zx, zu, zbar),
        ((nn, R, 128), (nn, R, 128), (m * n, R, 128), (n, R, 128),
         (n, R, 128), (m, R, 128), (n, rG, 128)), n, m, Fl.device,
    )
    _launch(
        "rslqr_flat_rhs_update_level", Fl.device,
        _ptr(Fl), _ptr(Fx), _ptr(Fu), _ptr(zy), _ptr(zx), _ptr(zu),
        _ptr(zbar), N, B, level, n, m,
    )
    rhs_update_level_flat.launches += 1
    return zy, zx, zu


KERNEL_WRAPPERS = (
    schur_update_level_flat,
    leaf_schur_level0_flat,
    rhs_update_level_flat,
)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
