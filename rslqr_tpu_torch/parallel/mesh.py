"""Device meshes and batch sharding on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``: whole problem
instances are sharded over a ``"dp"`` mesh axis, and (:mod:`.seq`,
:mod:`.pscan_seq`) knot points over an ``"sp"`` axis. Batch sharding
needs no communication: every stage of the solver is independent across
instances, so each rank solves its contiguous slice of the batch (JAX's
``P("dp")``) and no collective runs.

The SPMD contract of this package: one process a rank
(:func:`.launch.run_ranks`, or ``torchrun``), the process group
initialised by the caller, every rank passing the same global problem.
The horizon-sharded solvers hand every rank the full solution vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import SolveOptions
from ..problem import LQRProblem, pack_solution
from ..rslqr import RsLqrSolution, _bf, solve
from . import comm


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp",),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the process group (default: 1-D data
    parallel), row-major: global rank ``r`` sits at the mesh position
    ``r`` counts to."""
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh {shape} does not cover the {world} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def axis(mesh: DeviceMesh, name: str):
    """``(size, this rank's index, process group)`` of a mesh axis."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def _batch_slice(B: int, mesh: DeviceMesh, name: Optional[str]) -> slice:
    if name is None:
        return slice(None)
    D, i, _ = axis(mesh, name)
    if B % D:
        raise ValueError(f"batch {B} is not divisible by {name}={D}")
    return slice(i * (B // D), (i + 1) * (B // D))


def shard_problem_batch(prob: LQRProblem, mesh: DeviceMesh,
                        axis: str = "dp") -> LQRProblem:
    """This rank's contiguous slice of the leading batch axis (views)."""
    sl = _batch_slice(prob.batch_shape[0], mesh, axis)
    return prob.map(lambda x: x[sl])


def solve_batch_sharded(prob: LQRProblem, mesh: DeviceMesh,
                        axis: str = "dp",
                        options: Optional[SolveOptions] = None
                        ) -> RsLqrSolution:
    """Solve this rank's shard of a batch (``mesh[axis]``): the local solve
    on the route ``solve`` picks (the em kernel path on the card), with no
    collective. Every rank passes the global batch; each gets its shard's
    solution."""
    return solve(shard_problem_batch(prob, mesh, axis), options=options)


@dataclasses.dataclass(frozen=True)
class HorizonShard:
    """This rank's part of a horizon-sharded solve of a problem with ONE
    leading batch axis: ``D`` chunks of ``C`` knots over ``mesh[sp]``,
    chunk ``d`` here, the batch slice ``bsl`` of ``mesh[dp]`` (all of it
    without a dp axis)."""

    mesh: DeviceMesh
    sp: str
    dp: Optional[str]
    D: int
    d: int
    group: object
    N: int
    C: int
    bsl: slice


def horizon_shard(prob: LQRProblem, mesh: DeviceMesh, sp_axis: str,
                  dp_axis: Optional[str]) -> HorizonShard:
    N = prob.nhorizon
    D, d, group = axis(mesh, sp_axis)
    C = N // D
    if C * D != N or C < 2:
        raise ValueError(
            f"need N ({N}) divisible by devices ({D}) with chunk >= 2")
    return HorizonShard(mesh, sp_axis, dp_axis, D, d, group, N, C,
                        _batch_slice(prob.batch_shape[0], mesh, dp_axis))


def local_chunk(pbl: LQRProblem, hs: HorizonShard) -> LQRProblem:
    """This rank's knots and batch slice of a batch-last problem (``x0``
    has no knot axis)."""
    ks = slice(hs.d * hs.C, (hs.d + 1) * hs.C)
    cut = lambda x: x[ks][..., hs.bsl]
    return dataclasses.replace(pbl.map(cut), x0=pbl.x0[..., hs.bsl])


def gather_solution(hs: HorizonShard, zy, zx, zu) -> torch.Tensor:
    """The full KKT vectors ``[B, nvars]`` on every rank from each rank's
    batch-last ``(zy, zx, zu)`` (``[C, n|m, b]``, ``zu`` with the
    scratch row), by ONE all_gather labelled ``"assemble"``: over the sp
    group, or over every rank when the batch is sharded too."""
    n = zy.shape[1]
    local = torch.cat([zy, zx, zu], dim=1)  # [C, V, b]
    if hs.dp is None:
        full = comm.all_gather(local, hs.group, label="assemble")
    else:
        g = comm.all_gather(local, dist.group.WORLD, label="assemble")
        names = hs.mesh.mesh_dim_names
        grid = g[hs.mesh.mesh.flatten()].view(
            tuple(hs.mesh.mesh.shape) + local.shape)
        grid = grid[tuple(slice(None) if nm in (hs.sp, hs.dp) else 0
                          for nm in names)]
        rest = [nm for nm in names if nm in (hs.sp, hs.dp)]
        if rest[0] != hs.sp:
            grid = grid.transpose(0, 1)  # [SP, DP, C, V, b]
        full = grid.permute(0, 2, 3, 1, 4)  # [SP, C, V, DP, b]
    full = full.reshape(hs.N, local.shape[1], -1)  # [N, V, B]
    Y, X, U = (_bf(x, 1) for x in full.split([n, n, zu.shape[1]], dim=1))
    return pack_solution(Y, X, U[:, :-1])
