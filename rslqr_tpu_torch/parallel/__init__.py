"""Multi-rank parallelism on ``torch.distributed``: meshes and the sharded
solvers (counterpart of the JAX package's ``parallel/``)."""

from .mesh import (
    make_mesh,
    shard_problem_batch,
    solve_batch_sharded,
)
from .seq import solve_seq_sharded
from .pscan_seq import solve_pscan_sharded
