"""The two kernel-measurement probes of ``probes/probe_pgemm.py``, for Hopper.

* :func:`pgemm_ib`: ``C = A @ B`` over element planes with ``ib`` rows of
  ``A`` per pass over ``B`` (the register-blocking question for B5's
  ``rows_kernel``);
* :func:`fma_peak`: ``reps`` dependent FMAs per element (the card's f32
  FMA rate).

Neither lies on a solver path; ``python -m rslqr_tpu_torch.probe_pgemm``
times them. Dispatch by ``ops/schur.py``'s rule: a wrapper launches its
CUDA kernel (``csrc/probe_kernels.cu``) for float32 CUDA tensors under
``kernels="auto"``, and runs its plain PyTorch version (``*_plain``)
otherwise; a kernel that applies launches or raises (``pgemm_ib``: block
dims outside 1..64), there is no fallback. Each
wrapper counts its launches in its ``launches`` attribute
(:func:`launch_counts`). Both return new tensors.
"""

from __future__ import annotations

import math

import torch

from .planes import _check, _flat
from .schur import _launch, _ptr, kernel_applies

# Rows of A per pass (the probe's ``ib``) and warps per block (the
# counterpart of its ``t1``, the TPU plane tile's 8 or 16 sublanes).
IBS = (1, 2, 4)
T1S = (8, 16)


def pgemm_ib_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pgemm_ib`: one einsum over the planes (``ib``
    and ``t1`` change no result)."""
    C = torch.einsum("ikf,kjf->ijf", _flat(A), _flat(B))
    return C.reshape((A.shape[0], B.shape[1]) + tuple(A.shape[2:]))


def fma_peak_plain(A: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of :func:`fma_peak`: the probe's loop, one ``addcmul``
    (``acc * x + x``) per step."""
    acc = A.clone()
    for _ in range(reps):
        acc = torch.addcmul(A, acc, A)
    return acc


def pgemm_ib(A: torch.Tensor, B: torch.Tensor, *, ib: int = 1, t1: int = 8,
             kernels: str = "auto") -> torch.Tensor:
    """``C[i, j] = sum_k A[i, k] * B[k, j]`` planewise: ``A [p, K, *plane]``,
    ``B [K, q, *plane]`` -> ``C [p, q, *plane]``, a new tensor. ``ib``
    (1, 2 or 4): rows of ``A`` each warp takes per pass over the staged
    ``B``; ``t1`` (8 or 16): warps per block.

    Replaces ``probes/probe_pgemm.py:pgemm_ib`` (its ``[p, K, P1, P2]``
    planes are the same bytes as ``[p, K, P1*P2]``; any plane shape is
    taken). Kernel: ``pgemm_ib_kernel``.
    """
    if ib not in IBS or t1 not in T1S:
        raise ValueError(f"pgemm_ib: ib in {IBS} and t1 in {T1S}, got "
                         f"ib={ib}, t1={t1}")
    p, K = A.shape[:2]
    q = B.shape[1]
    if not kernel_applies(kernels, A.device, A.dtype):
        return pgemm_ib_plain(A, B)
    plane = tuple(A.shape[2:])
    F = _check("pgemm_ib", (A, B), ((p, K) + plane, (K, q) + plane),
               (p, K, q))
    C = torch.empty((p, q) + plane, device=A.device)
    _launch("rslqr_pgemm_ib", A.device, _ptr(A), _ptr(B), _ptr(C), p, K, q,
            F, ib, t1)
    pgemm_ib.launches += 1
    return C


def fma_peak(A: torch.Tensor, *, reps: int,
             kernels: str = "auto") -> torch.Tensor:
    """``reps`` steps of ``acc = acc * x + x`` from ``acc = x`` for every
    element ``x`` of ``A`` (any shape; the probe's ``[1, P1, P2]``); a new
    tensor of ``A``'s shape.

    Replaces ``probes/probe_pgemm.py:fma_peak``. Kernel:
    ``fma_peak_kernel`` (one fmaf per step).
    """
    if reps < 0:
        raise ValueError(f"fma_peak: reps >= 0, got {reps}")
    if not kernel_applies(kernels, A.device, A.dtype):
        return fma_peak_plain(A, reps)
    F = math.prod(A.shape)
    if A.dtype != torch.float32 or not A.is_contiguous() or not 0 < F < 2**31:
        raise ValueError(f"fma_peak: kernel takes a contiguous nonempty "
                         f"float32 tensor, got {A.dtype} {tuple(A.shape)}")
    out = torch.empty_like(A)
    _launch("rslqr_fma_peak", A.device, _ptr(A), _ptr(out), F, reps)
    fma_peak.launches += 1
    return out


KERNEL_WRAPPERS = (pgemm_ib, fma_peak)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
