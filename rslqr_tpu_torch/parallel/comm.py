"""Collectives over one mesh axis's process group: the counterparts of
``lax.all_gather`` and ``lax.ppermute`` (JAX parallel/seq.py,
parallel/pscan_seq.py), with a recorder for the collective audit.

The transport is picked from the group's backend and the tensor's device
before any call (:func:`transport`):

* ``"native"``: NCCL with CUDA tensors, gloo with CPU tensors. The
  backend's own ``all_gather``; ``ppermute`` as point-to-point sends and
  receives.
* ``"all_reduce"``: gloo with CUDA tensors, where gloo has only
  ``broadcast`` and ``all_reduce`` (PyTorch's backend table): both
  collectives become one ``all_reduce`` of a zero-filled ``[D, ...]``
  buffer with the rank's own slot written, which is exact (every other
  slot adds zeros). This is how several ranks share one card: NCCL refuses
  two ranks on one GPU.

Any other pairing raises. No transport is ever swapped for another on an
exception.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

# The collectives of the solvers (audited); ``"assemble"`` labels the one
# all_gather that hands every rank the full solution vector.
SOLVE_COLLECTIVES = ("all_gather", "ppermute")


class Recorder:
    """The collectives of a block: ``calls`` is a list of ``(name, output
    shape)``, ``transports`` the set of transports they used."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple]] = []
        self.transports: set = set()


_ACTIVE: Optional[Recorder] = None


@contextlib.contextmanager
def recording():
    """Record every collective made inside the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, Recorder()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def _record(name: str, shape, how: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.calls.append((name, tuple(shape)))
        _ACTIVE.transports.add(how)


def transport(group, x: torch.Tensor) -> str:
    """The transport of ``x`` over ``group``'s backend (module docstring)."""
    backend = dist.get_backend(group)
    if (backend == "nccl" and x.is_cuda) or (backend == "gloo"
                                             and not x.is_cuda):
        return "native"
    if backend == "gloo" and x.is_cuda:
        return "all_reduce"
    raise RuntimeError(f"no transport for backend {backend!r} with "
                       f"{x.device.type} tensors")


def _slotted(x: torch.Tensor, group, me: int) -> torch.Tensor:
    """All ranks' ``x`` as ``[D, ...]`` by one all_reduce of zero-filled
    buffers, each with its own slot written."""
    buf = x.new_zeros((dist.get_world_size(group),) + x.shape)
    buf[me] = x
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(x: torch.Tensor, group, label: str = "all_gather"):
    """``lax.all_gather``: ``[D, *x.shape]``, rank ``i``'s ``x`` in slot
    ``i`` of the group."""
    x = x.contiguous()
    D, me = dist.get_world_size(group), dist.get_rank(group)
    how = transport(group, x)
    if D == 1:
        out = x[None].clone()
    elif how == "native":
        out = x.new_empty((D,) + x.shape)
        dist.all_gather(list(out.unbind(0)), x, group=group)
    else:
        out = _slotted(x, group, me)
    _record(label, out.shape, how)
    return out


def ppermute(x: torch.Tensor, group, perm: Iterable[Tuple[int, int]]):
    """``lax.ppermute``: each ``(src, dst)`` pair of group ranks sends
    ``src``'s ``x`` to ``dst``; a rank that receives nothing gets zeros."""
    x = x.contiguous()
    perm = list(perm)
    D, me = dist.get_world_size(group), dist.get_rank(group)
    how = transport(group, x)
    src = {dst: s for s, dst in perm}.get(me)
    if D == 1 or not perm:
        out = torch.zeros_like(x)
    elif how == "native":
        out = torch.zeros_like(x)
        glob = lambda r: dist.get_global_rank(group, r)
        ops = [dist.P2POp(dist.isend, x, glob(dst), group)
               for s, dst in perm if s == me]
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, glob(src), group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    else:
        buf = _slotted(x, group, me)
        out = buf[src] if src is not None else torch.zeros_like(x)
    _record("ppermute", out.shape, how)
    return out
