"""Per-call solver options (counterpart of ``rslqr_tpu.config.SolveOptions``).

PyTorch runs eagerly, so there is no trace-time global config to snapshot:
every entry point takes an explicit :class:`SolveOptions` (``None`` means
the defaults). The JAX package's global ``config``, ``set_layout``,
``set_pallas`` and ``linear_algebra_backend`` are left out by design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_LAYOUTS = ("auto", "em", "grid")
_KERNEL_MODES = ("auto", "off")
# ``factor_dtype`` names and the slab storage each names ("" = the problem
# dtype): the floating dtypes ``jnp.dtype`` takes by these names.
FACTOR_DTYPES = {
    "": None,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Solver options.

    ``kernels`` replaces the JAX package's ``pallas`` switch:

    * ``"auto"``: each kernel wrapper (``ops/schur.py``, ``ops/planes.py``)
      launches its hand-written CUDA kernel on CUDA tensors and runs its
      plain PyTorch version on CPU tensors. There is no silent fallback on
      CUDA: a kernel that cannot run raises.
    * ``"off"``: the plain PyTorch versions on every device (the reference
      path that ``chip_smoke.py`` times and compares the kernels against).

    ``layout`` (JAX config.py:35, 175-177):

    * ``"auto"``: the element-major path for ``max(n, m) <= 64`` on every
      device, the knot-major grid path (the large-block route, torch.matmul
      and torch.linalg on mat-last views) above 64. This departs on purpose
      from the JAX package's CPU dispatch (rslqr.py:498-533), which sends
      mid blocks to its grid path where no Pallas kernel engages: the
      port's plain element-major path is exact on the CPU, so one rule
      serves every device.
    * ``"em"``: the element-major path at every block size, as in the JAX
      package; blocks above 64 take its mid-block route through the plain
      versions of the plane kernels (``rslqr_em._plane_options``: the
      kernels take block dims up to 64, and JAX's stand aside there too).
    * ``"grid"``: the knot-major grid path (``rslqr.factorize``), which
      launches no hand kernel, as in the JAX package; for ``solve_pscan``
      the batch-last scan.

    ``factor_dtype`` (JAX config.py:73-79, 137; rslqr_em.py:162-168,
    875): the storage of the element-major path's factor slabs
    ``Fls``/``Fxs``/``Fus``. ``""`` stores them in the problem dtype, as
    does the problem dtype's own name (``"float32"`` on an f32 problem is
    the default solve, bit for bit); ``"bfloat16"``, ``"float16"``,
    ``"float32"`` and ``"float64"`` (:data:`FACTOR_DTYPES`) store them in
    that dtype; ``"bfloat16"`` halves the sweep's slab traffic. The
    Cholesky factors, separator products and solves and the right-hand
    sides stay in the problem dtype: every slab element is taken into the
    problem dtype on load, the math runs there, and each store rounds
    once. (JAX promotes instead, so f64 slabs on an f32 problem compute
    and return f64 there; the port keeps the problem dtype.) The kernels
    take f32 and bf16 slabs (bf16: f32 math, one rounding a store); any
    other storage runs the plain stages, with the single-level schedule
    of JAX's XLA stages (``rslqr_em._kernel_schedule``). Accuracy contract
    (as the JAX package's): the raw bf16-slab solve loses digits with tree
    depth; pair it with ``refine.solve_refined``. The grid path and the
    parallel scan ignore it. A name that is no floating dtype raises.
    """

    layout: str = "auto"
    kernels: str = "auto"
    factor_dtype: str = ""
    # Block dim above which linalg and the sweep take the mid-block planes
    # route (up to 64); the sweep also takes it for a state dim past 8, the
    # small-block kernels' limit (rslqr_em._mid_block).
    mxu_block_threshold: int = 8
    # Two sweep levels per slab pass (rslqr_em._sweep_pair_em); False = one
    # level per pass.
    level_pairing: bool = True
    # The flat-plane schedule of the small-block sweep (ops/flat.py; JAX's
    # ops/schur_planes.py) for f32 batches with B % 1024 == 0: element-major
    # compact separators and products, products emitted at levels 0-1 only,
    # no level pairing. Off by default, as in the JAX package.
    flat_planes: bool = False
    # Chunk size of the mid-block parallel scan (pscan._auto_chunk): 0 =
    # auto (the largest of 32, 16, 8, 4 that divides N, for N >= 64), 1 =
    # the unchunked leaf-pair scan, >= 2 = explicit (must divide N with at
    # least two chunks).
    pscan_chunk: int = 0
    # Chunked pscan: recover the interior cost-to-gos and rollout states in
    # one full-width reduced combine / gemv from the emitted within-chunk
    # composites, instead of s - 1 serial steps.
    pscan_batched_interior: bool = False

    def __post_init__(self):
        if self.layout not in _LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r} (want one of {_LAYOUTS})"
            )
        if self.kernels not in _KERNEL_MODES:
            raise ValueError(
                f"unknown kernel mode {self.kernels!r} "
                f"(want one of {_KERNEL_MODES})"
            )
        if self.factor_dtype not in FACTOR_DTYPES:
            raise ValueError(
                f"unknown factor_dtype {self.factor_dtype!r} "
                f"(want one of {tuple(FACTOR_DTYPES)})"
            )


def resolve_options(options: Optional[SolveOptions]) -> SolveOptions:
    """``options`` if given, else the defaults."""
    return options if options is not None else SolveOptions()


def storage_dtype(factor_dtype: str, dtype: torch.dtype) -> torch.dtype:
    """The slabs' storage dtype: what ``factor_dtype`` names, or the
    problem dtype ``dtype`` for ``""``."""
    return FACTOR_DTYPES[factor_dtype] or dtype
