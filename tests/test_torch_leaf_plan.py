"""Port tests: the launch plan of the fused leaf kernel (B3 and B11).

``csrc/leaf_rows.cuh``'s ``leaf_row_kernel`` runs on the pair kernel's
emitting plan (``ops/schur.py:_level_plan(N, B, True, n, m, pair=True)``:
B1's knots and row groups, at most 8 slots at the wide inputs). Walked here
the way the kernel walks it:

* every knot and every batch column is taken by exactly one block
  (N in {4, 8, 256}, B in {1, 33, 1024}), and the C launcher's own check of
  the plan (``leaf_plan_ok``) holds;
* each level-1 group's separator row r = 4g + 1 and the row r + 1 after it
  share a block, whose second knot is r + 1: the block that emits the
  group's products;
* every slab row (lambda, x, u) of a knot is taken by one thread (row
  groups of three in the block's slots, looping where a knot has more row
  groups than slots), at every n, m in 1..8 and at four wide blocks, in
  at most 512 threads a block at the wide ones;
* the emission's (row group, upper slab) items of an emitting knot are
  each taken by one thread of its block.
"""

import numpy as np
import pytest

from rslqr_tpu_torch.ops import schur

KB, TB, RPT = schur.LEVEL_KB, schur.LEVEL_TB, schur.LEVEL_RPT


def _knot_blocks(plan, N):
    """Block row of every knot, and how many blocks take it."""
    taken = np.zeros(N, dtype=int)
    block = np.full(N, -1)
    for y in range(plan.grid[1]):
        for z in range(KB):
            k = y * KB - plan.shift + z
            if 0 <= k < N:
                taken[k] += 1
                block[k] = y
    return taken, block


@pytest.mark.parametrize("B", [1, 33, 1024])
@pytest.mark.parametrize("N", [4, 8, 256])
def test_leaf_plan_covers_knots_and_columns_once(N, B):
    plan = schur._level_plan(N, B, True, 6, 3, pair=True)
    taken, block = _knot_blocks(plan, N)
    assert (taken == 1).all()
    cols = np.zeros(plan.grid[0] * TB, dtype=int)
    for x in range(plan.grid[0]):
        cols[x * TB:(x + 1) * TB] += 1
    assert (cols[:B] == 1).all() and len(cols) - B < TB
    # leaf_plan_ok: shift 1, every knot covered, one level-1 group at least.
    assert plan.shift == 1 and plan.grid[1] * KB - plan.shift >= N
    assert N >> 2 >= 1
    for g in range(N // 4):
        r = 4 * g + 1
        assert block[r] == block[r + 1]
        assert block[r + 1] * KB == r + 1  # the block's second knot


@pytest.mark.parametrize("nm", [(n, m) for n in range(1, 9)
                                for m in range(1, 9)]
                         + [(6, 12), (1, 9), (5, 33), (8, 64)])
def test_leaf_plan_takes_every_slab_row_and_item_once(nm):
    n, m = nm
    N, B, depth = 8, 1, 3
    plan = schur._level_plan(N, B, True, n, m, pair=True)
    nl = plan.groups[0]
    rgs = sum(plan.groups)
    assert plan.groups == (-(-n // RPT), -(-n // RPT), -(-m // RPT))
    wide = m > schur.MAX_STATE
    cap = schur.PAIR_WIDE_SLOTS if wide else schur.LEVEL_SLOTS
    assert plan.slots == min(rgs, cap)
    assert TB * plan.slots * KB <= (512 if wide else 1024)
    rows = (n, n, m)
    for k in range(N):
        count = [np.zeros(r, dtype=int) for r in rows]
        for slot in range(plan.slots):
            for rg in range(slot, rgs, plan.slots):
                slab = 0 if rg < nl else (1 if rg < 2 * nl else 2)
                i0 = (rg - slab * nl) * RPT
                live = [i for i in range(i0, i0 + RPT) if i < rows[slab]]
                assert live, f"row group {rg} takes no row"
                count[slab][live] += 1
        assert all((c == 1).all() for c in count)
    # Emission: the block's threads (slot y of knot z: item z * slots + y,
    # stepping by 2 * slots) take each (lambda row group, upper slab) once.
    items = np.zeros((nl, depth - 1), dtype=int)
    for z in range(KB):
        for y in range(plan.slots):
            for it in range(z * plan.slots + y, nl * (depth - 1),
                            KB * plan.slots):
                items[it % nl, it // nl] += 1
    assert (items == 1).all()
