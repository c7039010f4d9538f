"""Mid-block (8 < n <= 64) linear algebra on element planes, for Hopper.

Counterpart of ``rslqr_tpu/ops/planes_pallas.py``. Arrays are element-plane
blocks ``[p, q, *plane]``: block element ``(i, j)`` is a dense plane that
carries the (knot x batch) or (group x batch) grid, flattened to ``F``
plane elements (element ``(i, j)`` at ``(i*q + j)*F + f``). Each wrapper
keeps the name and the function of its JAX counterpart; the TPU tile
artifacts of the JAX module (the ``(F//128, 128)`` reshape and the row
padding of ``linalg._pv``) are not carried over: the CUDA kernels index any
plane size directly.

Dispatch, as in ``ops/schur.py``: a wrapper runs its plain PyTorch version
(``*_plain``) for CPU tensors or under ``kernels="off"``, and launches its
CUDA kernel (``csrc/planes_kernels.cu``) for CUDA tensors: f32, contiguous,
block dims at most 64. On CUDA it launches or raises; there is no fallback.
Each wrapper counts its launches in its ``launches`` attribute
(:func:`launch_counts`).

``pcho_solve`` and ``schur3_update_planes`` update their right-hand side /
slab operands IN PLACE on both routes, as the TPU kernels alias them
(``input_output_aliases``), and return them.

What bounds the kernels on the card: every one streams its operands once
with a few FLOP per byte (at n=36: pgemm ~6, the Schur update ~3
FLOP/byte), far below the H100's ~20 f32 FLOP/byte balance, so they are
bandwidth-bound. The design (details in the CUDA source): a block owns 32
plane elements, one per lane, so every plane load and store is a
coalesced 128-byte line; the products and the Schur update stage the
right-hand operand of those plane elements in shared memory and give
whole rows of the left operand to the block's warps, and the Cholesky
solve stages the factor, so each operand is read from device memory once.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .schur import _launch, _masks, _ptr, _use_kernel

# Largest block dim the kernels take (their register columns hold 64).
MAX_BLOCK = 64


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; CPU tests and kernels="off").
# ---------------------------------------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``[p, q, *plane] -> [p, q, F]``."""
    return x.reshape(x.shape[0], x.shape[1], -1)


def pgemm_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pgemm`: one einsum over the planes (what the
    JAX package's ``_bgemm_mxu`` fallback computes)."""
    p, q = A.shape[0], B.shape[1]
    C = torch.einsum("ikf,kjf->ijf", _flat(A), _flat(B))
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


def schur3_update_planes_plain(FLl, FLx, FLu, fsol, Cl, Cx, Cu, *, level):
    """Plain version of :func:`schur3_update_planes`."""
    n, N, Bb = FLl.shape[1:]
    q, G = fsol.shape[1], fsol.shape[2]
    span = N // G

    def prod(F):
        p = F.shape[0]
        out = torch.einsum(
            "ikgsb,kjgb->ijgsb", F.reshape(p, n, G, span, Bb), fsol
        )
        return out.reshape(p, q, N, Bb)

    keep, sep = _masks(level, N, FLl.device)
    fs_full = fsol[:, :, :, None].expand(n, q, G, span, Bb).reshape(n, q, N, Bb)
    Cl.copy_(torch.where(sep, fs_full, Cl - torch.where(keep, prod(FLl), 0.0)))
    Cx.sub_(prod(FLx))
    Cu.sub_(prod(FLu))
    return Cl, Cx, Cu


# ---------------------------------------------------------------------------
# Kernel launches.
# ---------------------------------------------------------------------------


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
    F = math.prod(tensors[0].shape[2:])
    if not 0 < F < 2**31:
        raise ValueError(f"{name}: plane size {F} out of range")
    return F


def pgemm(A: torch.Tensor, B: torch.Tensor, *, kernels: str = "auto"):
    """Planewise block matmul ``C = A @ B``: ``A [p, K, *plane]``,
    ``B [K, q, *plane]`` -> ``C [p, q, *plane]`` (a new tensor).

    Replaces ``rslqr_tpu/ops/planes_pallas.py:pgemm`` (``_pgemm_call``
    without its transpose and epilogue flags). Kernel: ``rows_kernel``.
    """
    if not _use_kernel(kernels, A):
        return pgemm_plain(A, B)
    p, K = A.shape[:2]
    q = B.shape[1]
    plane = tuple(A.shape[2:])
    F = _check("pgemm", (A, B), ((p, K) + plane, (K, q) + plane), (p, K, q))
    C = torch.empty((p, q) + plane, device=A.device)
    _launch("rslqr_pgemm", A.device, _ptr(A), _ptr(B), _ptr(C), p, K, q, F)
    pgemm.launches += 1
    return C


def pchol(A: torch.Tensor, *, kernels: str = "auto"):
    """Cholesky of SPD blocks ``[n, n, *plane]`` -> lower ``L`` (a new
    tensor, strict upper triangle zero).

    Replaces ``rslqr_tpu/ops/planes_pallas.py:pchol``. Kernel:
    ``pchol_kernel``.
    """
    if not _use_kernel(kernels, A):
        return pchol_plain(A)
    n = A.shape[0]
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
    if not _use_kernel(kernels, L):
        return pcho_solve_plain(L, B)
    n, w = B.shape[:2]
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
    if not _use_kernel(kernels, FLl):
        return schur3_update_planes_plain(
            FLl, FLx, FLu, fsol, Cl, Cx, Cu, level=level
        )
    n, _, N, Bb = FLl.shape
    m = FLu.shape[0]
    q = fsol.shape[1]
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


KERNEL_WRAPPERS = (pgemm, pchol, pcho_solve, schur3_update_planes)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
