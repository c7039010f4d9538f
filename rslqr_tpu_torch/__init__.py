"""rslqr_tpu_torch: the rsLQR solver in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100.

A port of ``rslqr_tpu`` (which stays the reference): the batched
element-major rsLQR solve (with the flat-plane schedule under
``SolveOptions(flat_planes=True)``), mixed-precision refinement
(``refine``: f32 factorization, f64 accuracy) and the parallel-scan solver
(``solve_pscan``) for small and mid-size blocks (n, m <= 64), the Riccati
oracle, and the problem helpers (which build on the card unless asked for
``device="cpu"``). The hand-written kernels (``ops/schur.py`` with
``csrc/schur_kernels.cu`` and ``ops/flat.py`` with ``csrc/flat_kernels.cu``
for small blocks, ``ops/planes.py`` with ``csrc/planes_kernels.cu`` and
``csrc/plu_kernels.cu`` for mid blocks) run on CUDA tensors; their plain
PyTorch versions run on CPU tensors.
"""

from .config import SolveOptions
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
from .riccati import RiccatiSolution, solve_riccati
from .rslqr import RsLqrSolution, solve, solve_kkt
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
