"""Port tests: the launch plan of B1's, B3's and B4's bf16-slab kernels.

``csrc/bf16_rows.cuh``'s ``row_pair2_kernel`` (B4) and ``leaf_row2_kernel``
(B3) run on the pair kernel's plan (``ops/schur.py:_level_plan(...,
pair=True, bf16=True)``), ``row_level2_kernel`` (B1) on the level
kernel's (``bf16=True``), with two batch columns a lane. Walked here the
way the kernels walk it, on the CPU:

* every batch column is taken by one lane of one block, a lane's pair
  moved as one access only where B is even (``vec``), the odd tail masked;
* the shared memory of a block (``_pair2_smem``) fits the card's 227 KB
  at every block the kernels take: below the wide inputs B4's double
  buffer of its threads' slab rows, and in an emitting launch A_sep and
  B_sep of the block's group and the products' stage (``2nn + mn`` f32
  values a column, 23,040 bytes at (6, 3)), twice where it fits; one stage
  at the wide inputs; the products' elements are each taken by one
  thread of the block;
* the f32 plans are as they were (one column a lane, no stage);
* a bf16 B1, B3 or B4 launch goes to its own C entry with the plan's
  ``vec`` and ``smem`` (no f32 shadow of the products' rows through device
  memory), and passes as many arguments as the entry declares
  (``_build.SIGNATURES``).
"""

import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)

from rslqr_tpu_torch.ops import _build, schur

KB, TB, RPT = schur.LEVEL_KB, schur.LEVEL_TB, schur.LEVEL_RPT


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("B", [1, 2, 33, 40, 1024])
def test_bf16_plan_takes_every_column_once(B, emit):
    plan = schur._level_plan(256, B, emit, 6, 3, pair=True, bf16=True)
    f32 = schur._level_plan(256, B, emit, 6, 3, pair=True)
    assert plan.cols == schur.PAIR_COLS == 2 and f32.cols == 1
    assert plan.vec == (B % 2 == 0) and not f32.vec
    # (6, 3), 320 threads: the slab rows' double buffer and the level-L
    # multiplier rows (69,120 bytes), then one stage and A_sep, B_sep where
    # the launch emits (two stages would leave one block an SM).
    assert plan.smem == 69120 + (23040 + 13824 if emit else 0)
    leaf = schur._level_plan(256, B, True, 6, 3, pair=True, bf16=True,
                             leaf=True)
    assert leaf.smem == 2 * 23040 + 13824
    assert f32.smem == 0
    # Knots, row groups and slots as the f32 kernel's.
    assert (plan.shift, plan.grid[1], plan.groups, plan.slots) == (
        f32.shift, f32.grid[1], f32.groups, f32.slots)
    taken = np.zeros(B, dtype=int)
    for x in range(plan.grid[0]):
        for t in range(TB):
            b = (x * TB + t) * 2  # the lane's pair; live where b < B
            if b < B:
                taken[b] += 1
                if b + 1 < B:  # else the masked tail (odd B)
                    taken[b + 1] += 1
    assert (taken == 1).all()
    assert plan.grid[0] * TB * 2 - B < TB * 2


@pytest.mark.parametrize("nm", [(n, m) for n in range(1, 9)
                                for m in range(1, 9)]
                         + [(6, 12), (1, 9), (5, 33), (8, 64)])
def test_shared_memory_fits_and_emission_items_once(nm):
    n, m = nm
    plan = schur._level_plan(16, 64, True, n, m, pair=True, bf16=True)
    threads = TB * KB * plan.slots
    stage = (2 * n * n + m * n) * 64 * 4
    for pair in (True, False):
        for emit in (True, False):
            got = schur._pair2_smem(n, m, plan.slots, pair, emit)
            assert got <= schur.SMEM_MAX
            if m > schur.MAX_STATE:  # wide: one stage, nothing else
                assert got == (stage if emit else 0)
                continue
            vbuf = 3 * RPT * n * threads * 4 if pair else 0
            sep = (n * n + n * m) * 64 * 4
            if vbuf + stage + sep > schur.SMEM_MAX:
                sep = 0  # only B4 at (8, 7) and (8, 8)
                assert pair and n == 8 and m >= 7
            assert got in ((vbuf + 2 * stage + sep, vbuf + stage + sep)
                           if emit else (vbuf,))
            # Two stages wherever they keep the blocks an SM that 640
            # threads' registers allow (228 KB an SM, 1 KB a block kept).
            blocks = max(1, 640 // threads)
            budget = min(schur.SMEM_MAX, 233472 // blocks - 1024)
            assert (got == vbuf + stage + sep) == (
                emit and vbuf + 2 * stage + sep > budget)
    nl = plan.groups[0]
    # emit2: element z * slots + y stepping by 2 * slots, (el // n, el % n).
    items = np.zeros((n, n), dtype=int)
    for z in range(KB):
        for y in range(plan.slots):
            for el in range(z * plan.slots + y, n * n, KB * plan.slots):
                items[el // n, el % n] += 1
    assert (items == 1).all()
    # Every stage row a product reads is written by one row group: x and
    # u rows of r, x rows of r + 1.
    written = np.zeros(2 * n * n + m * n, dtype=int)
    for rg in range(sum(plan.groups)):
        slab = 0 if rg < nl else (1 if rg < 2 * nl else 2)
        if slab == 0:
            continue
        i0, rows = (rg - slab * nl) * RPT, (n if slab == 1 else m)
        for i in range(i0, min(i0 + RPT, rows)):
            for c in range(n):
                e = i * n + c
                written[(0 if slab == 1 else n * n) + e] += 1  # knot r
                if slab == 1:
                    written[n * n + m * n + e] += 1  # knot r + 1
    assert (written == 1).all()


def test_vec_needs_even_batch_and_aligned_tensors():
    plan = schur._level_plan(16, 40, True, 6, 3, pair=True, bf16=True)
    slab = torch.zeros(36 * 16 * 40 + 1, dtype=torch.bfloat16)
    f = torch.zeros(8 * 36 * 40 + 1)
    assert schur._vec(plan, [slab[:-1], f[:-1]]) == 1
    assert schur._vec(plan, [slab[1:], f[:-1]]) == 0
    assert schur._vec(plan, [slab[:-1], f[1:]]) == 0
    odd = schur._level_plan(16, 33, True, 6, 3, pair=True, bf16=True)
    assert schur._vec(odd, [slab[:-1]]) == 0


def _record_launches(monkeypatch):
    """Run the wrappers' launch path on CPU tensors: the kernel applies,
    each C call is recorded. No wrapper keeps an f32 shadow of the bf16
    slabs (``schur._shadow`` is gone)."""
    calls = []
    monkeypatch.setattr(schur, "kernel_applies", lambda *a: True)
    monkeypatch.setattr(schur, "_launch",
                        lambda name, dev, *args: calls.append((name, args)))
    assert not hasattr(schur, "_shadow")
    return calls


def _pair_args(N, B, level, n, m, slab_dtype):
    g = torch.Generator().manual_seed(N + B)
    R = lambda *s: torch.randn(s, generator=g)
    S = lambda *s: R(*s).to(slab_dtype)
    depth = N.bit_length() - 1
    U = depth - level - 1
    G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
    xx, ux = n * n, m * n
    return [S(xx, N, B), S(xx, N, B), S(ux, N, B),
            [S(xx, N, B) for _ in range(U)], [S(xx, N, B) for _ in range(U)],
            [S(ux, N, B) for _ in range(U)], [R(G1, xx, B) for _ in range(U)],
            R(G2, xx, B), [R(G2, xx, B) for _ in range(U - 1)],
            R(G3, xx, B), R(G3, ux, B)]


def _leaf_args(N, B, n, m):
    g = torch.Generator().manual_seed(N + B + 1)
    R = lambda *s: torch.randn(s, generator=g)
    depth = N.bit_length() - 1
    xx, ux = n * n, m * n
    return [R(xx, N, B), R(ux, N, B), R(n, N, B), R(m, N, B),
            R(N // 2, xx, B), [R(N // 2, xx, B) for _ in range(depth - 1)],
            R(N // 4, xx, B), R(N // 4, ux, B)], depth


@pytest.mark.parametrize("B", [33, 40])
@pytest.mark.parametrize("bf16", [False, True])
def test_pair_and_leaf_launches(monkeypatch, bf16, B):
    calls = _record_launches(monkeypatch)
    n, m, N = 6, 3, 64
    dt = torch.bfloat16 if bf16 else torch.float32
    schur.schur_update_pair_em(*_pair_args(N, B, 0, n, m, dt), level=0,
                               n=n, m=m)
    args, depth = _leaf_args(N, B, n, m)
    schur.leaf_schur_level0_em(*args, depth=depth, n=n, m=m,
                               factor_dtype="bfloat16" if bf16 else "")
    suffix = "_bf16" if bf16 else ""
    assert [c[0] for c in calls] == [f"rslqr_schur_update_pair{suffix}",
                                     f"rslqr_leaf_schur_level0{suffix}"]
    for name, a in calls:
        # The declared arguments, less the stream that _launch appends.
        assert len(a) == len(_build.SIGNATURES[name]) - 1
        if bf16:
            assert a[-2] == int(B % 2 == 0)  # vec
            assert a[-1] == schur._pair2_smem(  # smem: both emit
                n, m, 5, name.startswith("rslqr_schur"), True)


@pytest.mark.parametrize("B", [33, 40])
@pytest.mark.parametrize("bf16", [False, True])
def test_bf16_level_launch_keeps_its_shadow(monkeypatch, bf16, B):
    """B1 with bf16 slabs (its own kernel stages its products' f32 rows in
    shared memory, with no shadow of them in device memory): an emitting
    launch goes to ``rslqr_schur_update_level_bf16``
    with the level kernel's bf16 plan, allocates nothing beside its
    products, and passes the declared arguments; f32 slabs keep their
    entry and plan."""
    calls = _record_launches(monkeypatch)
    n, m, N, level = 6, 3, 32, 1
    g = torch.Generator().manual_seed(5)
    dt = torch.bfloat16 if bf16 else torch.float32
    S = lambda *s: torch.randn(s, generator=g).to(dt)
    R = lambda *s: torch.randn(s, generator=g)
    U = N.bit_length() - 1 - level - 1
    G, G2 = N >> (level + 1), N >> (level + 2)
    *_, out = schur.schur_update_level_em(
        S(36, N, B), S(36, N, B), S(18, N, B), [S(36, N, B)] * U,
        [S(36, N, B)] * U, [S(18, N, B)] * U, [R(G, 36, B)] * U,
        R(G2, 36, B), R(G2, 18, B), level=level, n=n, m=m)
    assert len(out) == U
    name, a = calls[0]
    assert name == ("rslqr_schur_update_level_bf16" if bf16
                    else "rslqr_schur_update_level")
    assert len(a) == len(_build.SIGNATURES[name]) - 1
    plan = schur._level_plan(N, B, True, n, m, bf16=bf16)
    assert (plan.cols, plan.slots) == ((2, 5) if bf16 else (1, 5))
    if bf16:
        assert a[-2] == int(B % 2 == 0)
        # One stage and A_sep, B_sep below the wide inputs, two stages
        # where 640 threads' worth of blocks keep them (as B3's).
        assert a[-1] == plan.smem == schur._pair2_smem(n, m, 5, False, True)
        assert plan.smem == 2 * 23040 + 13824


@pytest.mark.parametrize("nm", [(6, 3), (4, 4), (2, 1), (8, 8), (5, 7),
                                (6, 12), (1, 9), (8, 64)])
def test_level2_plan_fits_every_block(nm):
    """B1's bf16 plan: the level kernel's slots (16 at most, also at the
    wide inputs), two columns a lane, and shared memory for the products'
    stage (``2nn + mn`` f32 values a column) and, below the wide inputs,
    A_sep and B_sep, twice the stage where 640 threads' worth of blocks
    keep it; nothing where the launch does not emit."""
    n, m = nm
    for emit in (False, True):
        plan = schur._level_plan(64, 40, emit, n, m, bf16=True)
        f32 = schur._level_plan(64, 40, emit, n, m)
        assert plan.cols == 2 and plan.vec and f32.cols == 1
        assert (plan.slots, plan.groups, plan.shift, plan.grid[1]) == (
            f32.slots, f32.groups, f32.shift, f32.grid[1])
        assert plan.grid[0] == 1 and f32.grid[0] == 2
        assert plan.smem == schur._pair2_smem(n, m, plan.slots, False, emit)
        assert plan.smem <= schur.SMEM_MAX
        stage = (2 * n * n + m * n) * 64 * 4
        if not emit:
            assert plan.smem == 0
        elif m > schur.MAX_STATE:
            assert plan.smem == stage
        else:
            sep = (n * n + n * m) * 64 * 4
            assert plan.smem in (stage + sep, 2 * stage + sep)
