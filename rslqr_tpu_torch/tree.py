"""Static binary-tree index tables for the nested-dissection solve.

Counterpart of ``rslqr_tpu.tree`` (and of the reference's
``src/binary_tree.{h,c}``). The tree over the ``N-1`` dynamics separators
is closed-form bit arithmetic, evaluated once on the host with NumPy.

Index math (all 0-based):
  * Nodes are the separators ``0 .. N-2``; knot ``N-1`` is not a node.
  * A node at tree level ``L`` has index ``2^L * (2*leaf + 1) - 1``
    (ref ``binary_tree.c:65-69``), i.e. ``level(idx) = trailing_zeros(idx+1)``.
  * The node at level ``L`` whose knot range contains ``k`` is
    ``(k >> (L+1)) << (L+1) + 2^L - 1`` (ref ``binary_tree.c:75-106``).
  * A node's left range starts at ``idx - 2^L + 1``; its right range starts at
    ``idx + 1`` and stops at ``idx + 2^L`` (ref ``binary_tree.c:20-31``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .utils import is_power_of_two, log2_int


def index_level(index: int) -> int:
    """Tree level of separator node ``index`` (ref binary_tree.c:71-73)."""
    if index < 0:
        raise ValueError(f"negative node index {index}")
    return int(((index + 1) & -(index + 1)).bit_length() - 1)


def index_from_leaf(leaf: int, level: int) -> int:
    """Node index of the ``leaf``-th level-``level`` node (binary_tree.c:65-69)."""
    return (1 << level) * (2 * leaf + 1) - 1


def index_at_level(index: int, level: int, nhorizon: int) -> int:
    """Index of the level-``level`` node whose knot range contains knot
    ``index``, with the reference's clamp of the terminal knot onto the last
    separator (binary_tree.c:89-106)."""
    if index == nhorizon - 1:
        index = nhorizon - 2
    return ((index >> (level + 1)) << (level + 1)) + (1 << level) - 1


@dataclasses.dataclass(frozen=True)
class TreeTables:
    """All solve-time index tables for a horizon of ``nhorizon`` knots.

    Attributes:
      nhorizon: number of knot points N (power of two).
      depth: log2(N) tree levels.
      levels: ``[N-1]`` int array, tree level of each separator node.
      leaf_index: ``leaf_index[L]`` is the ``[2^(depth-L-1)]`` array of node
        indices at level ``L``, in leaf order.
      sep_index: ``[N, depth]``, ``sep_index[k, L]`` = separator node at level
        ``L`` containing knot ``k``.
      calc_lambda: ``[N, depth]`` bool, whether the Schur update at level ``L``
        touches knot ``k``'s lambda block (ref nested_dissection.c:173-177).
    """

    nhorizon: int
    depth: int
    levels: np.ndarray
    leaf_index: tuple
    sep_index: np.ndarray
    calc_lambda: np.ndarray


def build_tree_tables(nhorizon: int) -> TreeTables:
    """Build all static index tables for horizon ``nhorizon`` (a power of 2)."""
    if not is_power_of_two(nhorizon):
        raise ValueError(f"nhorizon must be a power of two, got {nhorizon}")
    if nhorizon < 2:
        raise ValueError("nhorizon must be >= 2")
    depth = log2_int(nhorizon)

    # level(idx) = count of trailing zeros of idx+1
    low_bit = np.arange(1, nhorizon) & -np.arange(1, nhorizon)
    levels = np.array([int(b).bit_length() - 1 for b in low_bit], np.int32)

    leaf_index = tuple(
        index_from_leaf(np.arange(1 << (depth - L - 1)), L).astype(np.int32)
        for L in range(depth)
    )

    knots = np.arange(nhorizon)
    clamped = np.minimum(knots, nhorizon - 2)
    sep_index = np.empty((nhorizon, depth), dtype=np.int32)
    calc_lambda = np.empty((nhorizon, depth), dtype=bool)
    for L in range(depth):
        idx = ((clamped >> (L + 1)) << (L + 1)) + (1 << L) - 1
        sep_index[:, L] = idx
        is_start = (knots == idx - (1 << L) + 1) | (knots == idx + 1)
        calc_lambda[:, L] = (~is_start) | (knots == 0)

    return TreeTables(
        nhorizon=nhorizon,
        depth=depth,
        levels=levels,
        leaf_index=leaf_index,
        sep_index=sep_index,
        calc_lambda=calc_lambda,
    )
