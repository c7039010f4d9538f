"""rslqr_tpu_torch: the rsLQR solver in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100.

A port of ``rslqr_tpu`` (which stays the reference): the batched rsLQR
solve on the element-major path (with the flat-plane schedule under
``SolveOptions(flat_planes=True)``) and on the knot-major grid path
(``layout="grid"``, and every block above 64: the large-block route), the
multi-RHS front door (``factorize`` / ``solve_rhs`` / ``leaf_solve_rhs``),
mixed-precision refinement (``refine``: f32 factorization, f64 accuracy),
the parallel-scan solver (``solve_pscan``) at any block size, the Riccati
oracle, JSON problem I/O (``io``, ``native``), diagnostics
(``diagnostics``), the per-phase profiler (``profile``) on the solve's stage
spans (``spans``, which ``torch.profiler`` shows too) and the problem
helpers (which build on the card unless asked for ``device="cpu"``). The
hand-written kernels (``ops/schur.py`` with ``csrc/schur_kernels.cu`` and
``ops/flat.py`` with ``csrc/flat_kernels.cu`` for small blocks,
``ops/planes.py`` with ``csrc/planes_kernels.cu`` and ``csrc/plu_kernels.cu``
for mid blocks) run on CUDA tensors; their plain PyTorch versions run on
CPU tensors. The grid path and the large-block route run no hand kernel,
as the JAX package runs no Pallas kernel there. Per-call ``SolveOptions``
take the place of the JAX package's global ``config``, ``set_layout``,
``set_pallas`` and ``linear_algebra_backend``, which are not ported.
"""

from .config import SolveOptions
from .io import (
    read_lqr_data_json,
    read_lqr_problem_json,
    read_named_matrix,
    write_lqr_problem_json,
)
from .problem import (
    LQRProblem,
    batch_problems,
    double_integrator_problem,
    kkt_residual,
    objective,
    pack_solution,
    perturb_problem,
    problem_from_arrays,
    problem_from_numpy,
    random_problem,
    unpack_solution,
)
from . import refine
from .pscan import solve_pscan, solve_pscan_kkt
from .refine import (
    kkt_apply,
    kkt_rhs,
    refined_kkt_device,
    solve_refined,
    solve_refined_device,
    solve_refined_host,
)
from .profile import (
    RiccatiProfile,
    SolveProfile,
    print_solve_summary,
    profile_riccati,
    profile_solve,
)
from .riccati import RiccatiSolution, backward_pass, forward_pass, solve_riccati
from .rslqr import (
    RsLqrFactorization,
    RsLqrSolution,
    factorize,
    leaf_solve_rhs,
    solve,
    solve_kkt,
    solve_rhs,
)
from .rslqr_em import (
    EmFactorization,
    em_rhs_from_bl,
    factorize_em,
    leaf_rhs_em,
    solve_em,
    solve_kkt_em,
    solve_rhs_em,
)
from .tree import TreeTables, build_tree_tables

__version__ = "0.1.0"
