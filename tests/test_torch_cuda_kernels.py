"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture). This file imports no JAX, so it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: tests/conftest.py configures JAX.)

Inputs are random f32, cloned for each route, at small shapes that reach
every branch: odd batch widths (ragged last block of batch columns), B=1,
the shortest horizons, emission on and off, and emission groups larger than
one block of knots. The small-block kernels (B1-B4, B10-B12) also run at
the block sizes of their generic instantiations, (n, m) = (4, 2), (3, 2),
(4, 1), (1, 1), (8, 8), (5, 4) and (7, 5), B1 and B10 with their last row
groups masked, and at wide inputs (n <= 8 < m <= 64: (6, 12), (1, 9),
(5, 33), (8, 64)), where B1 and B10 loop over more row groups than a
block has slots. The fused leaf (B3 and B11, one row-group kernel) also
runs at depth 2 and 8, at one batch column and ragged strips, with masked
last row groups and wide blocks, on outputs the allocator last held as NaN
(every element written). Default-option solves (``solve_kkt``,
``solve_pscan_kkt``) in f64 at nx=6 and 36 launch no kernel (f64 runs the
plain stages), in f32 at (n, m) = (4, 2), (8, 8) and (6, 12) they launch
the small-block kernels (em and flat schedule), and all equal
``kernels="off"``. The mid-block plane kernels run at n=12 and 36
(and the limit, 64), with one right-hand column (w=1, q=1), ragged planes,
and Schur updates at level 0 and the top level; B7 at n = 9, 12, 16, 36,
64 and w = 1, 2, 12, 36 on planes below one block, on grids smaller than
the card and with several column tiles per block; an f32 solve with
nx=12 under ``mxu_block_threshold=16`` launches B7 and B9 and no
small-block kernel (ROADMAP C6). B6 runs at n = 9, 12, 16, 36, 64 on
planes of 5, 256, 640 and 4,096 elements and at n = 36 on the quadruped's
level-0 plane (65,536), one launch per call. The flat-plane kernels run
at the main path's shapes (N=256, B=1024), B10 at every level 0-6 with one
upper slab and the most the tree allows, emitting and not. The parallel
scan's kernels:
``pgemm`` with each of its flags alone and in every combination the scan
calls, at the quadruped scan's planes (16, 8 and 7 by 256), on wide planes
(F >= 65,536) and on ragged planes (F = 1, 33, 2049) at block dims 1, 5,
12, 36, 40 and 64 (all flags at once on a square output, exactly symmetric
under ``sym``), ``schur_update_planes`` masked and not,
``plu_solve_multi`` at widths 12, 20, 36 and 64 with 1-4 right-hand sides
(also at the quadruped scan's three shapes and planes), and
the pscan slice at small sizes. The probe kernels (``ops/probe.py``):
``pgemm_ib`` at every ``ib`` and ``t1``, with rows left over past a
multiple of ``ib``, two column chunks and the 12-column chunk that a long
contraction forces, and ``fma_peak`` with a ragged tail. Bar: ``max|kernel - plain| <= 1e-4 * (1 + max|plain|)``
(summation order only; the f32 atol of tests/test_pallas_ops.py:110-118).
"""

import pytest
import torch

from rslqr_tpu_torch.ops import flat, planes, probe, schur

pytestmark = pytest.mark.cuda

n, m = 6, 3
nn, mn = n * n, m * n


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, dev, *shape):
    return torch.randn(shape, generator=gen).to(dev)


def _both(fn, args, kwargs):
    """Run the kernel and the plain version on clones of ``args``; return
    both outputs flattened to tensor lists."""
    def clone(a):
        if isinstance(a, (list, tuple)):
            return [x.clone() for x in a]
        return None if a is None else a.clone()

    def tensors(out):
        res = []
        for o in out:
            if isinstance(o, (list, tuple)):
                res.extend(o)
            elif o is not None:
                res.append(o)
        return res

    k = fn(*[clone(a) for a in args], **kwargs)
    torch.cuda.synchronize()
    p = fn(*[clone(a) for a in args], kernels="off", **kwargs)
    return tensors(k), tensors(p), k, p


def _assert_match(ks, ps):
    assert len(ks) == len(ps)
    for a, b in zip(ks, ps):
        scale = 1.0 + b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize(
    "N,B,level", [(4, 1, 0), (64, 40, 0), (64, 40, 3), (64, 40, 5),
                  (256, 33, 7)],
)
def test_rhs_kernel(dev, N, B, level):
    g = torch.Generator().manual_seed(level)
    G = N >> (level + 1)
    args = [_rand(g, dev, *s) for s in (
        (nn, N, B), (nn, N, B), (mn, N, B), (n, N, B), (n, N, B), (m, N, B),
        (G, n, B))]
    before = schur.rhs_update_level_em.launches
    ks, ps, *_ = _both(schur.rhs_update_level_em, args,
                       dict(level=level, n=n, m=m))
    assert schur.rhs_update_level_em.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize(
    "N,B,level,with_sep",
    [(8, 1, 1, True), (16, 40, 0, True), (16, 40, 0, False),
     (16, 40, 2, True), (32, 40, 3, True), (128, 40, 1, True)],
)
def test_level_kernel(dev, N, B, level, with_sep):
    g = torch.Generator().manual_seed(100 + level)
    depth = N.bit_length() - 1
    U = depth - level - 1
    G, G2 = N >> (level + 1), N >> (level + 2)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(nn, N, B), R(nn, N, B), R(mn, N, B),
            [R(nn, N, B) for _ in range(U)], [R(nn, N, B) for _ in range(U)],
            [R(mn, N, B) for _ in range(U)], [R(G, nn, B) for _ in range(U)],
            R(G2, nn, B) if with_sep else None,
            R(G2, n * m, B) if with_sep else None]
    ks, ps, k, p = _both(schur.schur_update_level_em, args,
                         dict(level=level, n=n, m=m))
    emits = with_sep and schur._level_emits(level, N)
    assert (k[3] is not None) == (p[3] is not None) == emits
    _assert_match(ks, ps)


@pytest.mark.parametrize("N,B", [(4, 1), (16, 40), (256, 33)])
def test_leaf_kernel(dev, N, B):
    g = torch.Generator().manual_seed(N)
    depth = N.bit_length() - 1
    R = lambda *s: _rand(g, dev, *s)
    pos = lambda *s: (0.5 + torch.rand(s, generator=g)).to(dev)
    args = [R(nn, N, B), R(n * m, N, B), pos(n, N, B), pos(m, N, B),
            R(N // 2, nn, B), [R(N // 2, nn, B) for _ in range(depth - 1)],
            R(N // 4, nn, B), R(N // 4, n * m, B)]
    ks, ps, *_ = _both(schur.leaf_schur_level0_em, args,
                       dict(depth=depth, n=n, m=m))
    _assert_match(ks, ps)


def _tensors(out):
    res = []
    for o in out:
        res.extend(o if isinstance(o, (list, tuple)) else [o])
    return res


def _leaf_args(g, dev, N, B, bn, bm, kind):
    """Random arguments of B3 (``kind`` "em": group-major compacts) or B11
    ("flat": flat planes, element-major compacts) at block (bn, bm)."""
    xx, ux = bn * bn, bm * bn
    depth = N.bit_length() - 1
    R = lambda *s: _rand(g, dev, *s)
    pos = lambda *s: (0.5 + torch.rand(s, generator=g)).to(dev)
    args = [R(xx, N, B), R(ux, N, B), pos(bn, N, B), pos(bm, N, B),
            R(N // 2, xx, B), [R(N // 2, xx, B) for _ in range(depth - 1)],
            R(N // 4, xx, B), R(N // 4, ux, B)]
    if kind == "em":
        return schur.leaf_schur_level0_em, args, dict(depth=depth)
    plane = lambda x: x.reshape(x.shape[0], -1, 128)
    compact = lambda x: x.transpose(0, 1).contiguous().reshape(
        x.shape[1], -1, 128)
    return flat.leaf_schur_level0_flat, (
        [plane(x) for x in args[:4]] + [compact(args[4]),
                                        [compact(x) for x in args[5]],
                                        compact(args[6]), compact(args[7])]
    ), dict(depth=depth, N=N)


# The fused leaf's shapes: depth 2 (N=4) and 8 (N=256), one batch column
# and a ragged strip of them (em: B = 1, 33; flat, whose compacts need
# N/4 * B to be a multiple of 128: B = 128 at N=4, 2 and 34 at N=256);
# blocks with the last row group masked ((7, 5), (5, 4)) and wide blocks
# with more row groups than slots ((5, 33): 15 in 8; (8, 64): 28 in 8).
LEAF_SHAPES = [("em", 4, 1), ("em", 4, 33), ("em", 256, 1), ("em", 256, 33),
               ("flat", 4, 128), ("flat", 256, 2), ("flat", 256, 34)]
LEAF_BLOCKS = [(6, 3), (1, 1), (7, 5), (5, 4), (5, 33), (8, 64)]


@pytest.mark.parametrize("bn,bm", LEAF_BLOCKS)
@pytest.mark.parametrize("kind,N,B", LEAF_SHAPES)
def test_leaf_kernels_write_every_element(dev, kind, N, B, bn, bm):
    """B3 and B11 (one shared row-group kernel) write every output element
    once: the caching allocator hands them memory it last held as NaN (the
    outputs' own allocations, filled and freed just before the call), and
    no NaN is left; each element equals the plain twin's; one launch."""
    g = torch.Generator().manual_seed(1300 + 10 * bn + bm + N + B)
    fn, args, kw = _leaf_args(g, dev, N, B, bn, bm, kind)
    kw = dict(kw, n=bn, m=bm)
    clone = lambda: [[x.clone() for x in a] if isinstance(a, list)
                     else a.clone() for a in args]
    kargs, pargs = clone(), clone()
    first = fn(*clone(), **kw)
    shapes = [s for o in first for s in
              [(len(o), *o[0].shape)] + [x.shape for x in o]]
    del first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nan = [torch.full(s, float("nan"), device=dev) for s in shapes]
    del nan
    before = fn.launches
    ks = _tensors(fn(*kargs, **kw))
    assert fn.launches == before + 1
    torch.cuda.synchronize()
    assert not any(bool(torch.isnan(k).any()) for k in ks)
    ps = _tensors(fn(*pargs, kernels="off", **kw))
    _assert_match(ks, ps)


@pytest.mark.parametrize(
    "N,B,level", [(8, 1, 0), (16, 40, 1), (64, 40, 1), (64, 40, 3),
                  (256, 8, 5), (256, 33, 5)],
)
def test_pair_kernel(dev, N, B, level):
    g = torch.Generator().manual_seed(200 + level)
    depth = N.bit_length() - 1
    U = depth - level - 1
    G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
    R = lambda *s: _rand(g, dev, *s)
    with_sep = G3 >= 1
    args = [R(nn, N, B), R(nn, N, B), R(mn, N, B),
            [R(nn, N, B) for _ in range(U)], [R(nn, N, B) for _ in range(U)],
            [R(mn, N, B) for _ in range(U)], [R(G1, nn, B) for _ in range(U)],
            R(G2, nn, B), [R(G2, nn, B) for _ in range(U - 1)],
            R(G3, nn, B) if with_sep else None,
            R(G3, n * m, B) if with_sep else None]
    ks, ps, k, p = _both(schur.schur_update_pair_em, args,
                         dict(level=level, n=n, m=m))
    emits = with_sep and schur._pair_emits(level, N, B, U, n, m)
    assert (k[3] is not None) == (p[3] is not None) == emits
    _assert_match(ks, ps)


def test_solve_kernel_path_matches_plain(dev):
    """The whole slice at a small size: kernels vs ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.double_integrator_problem(32, dtype=torch.float32, device=dev)
    batch = pt.batch_problems(prob, 40, torch.Generator().manual_seed(0))
    schur.reset_launch_counts()
    got = pt.solve_kkt(batch)
    counts = schur.launch_counts()
    ref = pt.solve_kkt(batch, options=pt.SolveOptions(kernels="off"))
    assert all(c > 0 for c in counts.values()), counts
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


# The block sizes of the small-block kernels' generic instantiations
# (csrc/small_blocks.cuh): the (4, 4) capacity and the (8, 8) one; then the
# wide tag's (n <= 8 < m <= 64), whose u rows come in chunks of 8.
OTHER_BLOCKS = [(4, 2), (3, 2), (4, 1), (1, 1), (8, 8), (5, 4), (7, 5)]
WIDE_BLOCKS = [(6, 12), (1, 9), (5, 33), (8, 64)]


def _sweep_args(g, dev, N, B, level, bn, bm, kind):
    """Random arguments of one small-block sweep kernel at block (bn, bm):
    ``kind`` is "rhs", "level" (with the separator dynamics), "pair" or
    "leaf"."""
    R = lambda *s: _rand(g, dev, *s)
    xx, ux = bn * bn, bm * bn
    depth = N.bit_length() - 1
    U = depth - level - 1
    G1, G2, G3 = N >> (level + 1), N >> (level + 2), N >> (level + 3)
    trio = lambda: [R(xx, N, B), R(xx, N, B), R(ux, N, B)]
    ups = lambda: [[R(e, N, B) for _ in range(U)] for e in (xx, xx, ux)]
    if kind == "rhs":
        return [*trio(), R(bn, N, B), R(bn, N, B), R(bm, N, B),
                R(G1, bn, B)], dict(level=level)
    if kind == "level":
        return [*trio(), *ups(), [R(G1, xx, B) for _ in range(U)],
                R(G2, xx, B), R(G2, ux, B)], dict(level=level)
    if kind == "pair":
        return [*trio(), *ups(), [R(G1, xx, B) for _ in range(U)],
                R(G2, xx, B), [R(G2, xx, B) for _ in range(U - 1)],
                R(G3, xx, B) if G3 else None,
                R(G3, ux, B) if G3 else None], dict(level=level)
    pos = lambda *s: (0.5 + torch.rand(s, generator=g)).to(dev)
    return [R(xx, N, B), R(ux, N, B), pos(bn, N, B), pos(bm, N, B),
            R(N // 2, xx, B), [R(N // 2, xx, B) for _ in range(depth - 1)],
            R(N // 4, xx, B), R(N // 4, ux, B)], dict(depth=depth)


SWEEP_KERNELS = {"rhs": "rhs_update_level_em",
                 "level": "schur_update_level_em",
                 "pair": "schur_update_pair_em",
                 "leaf": "leaf_schur_level0_em"}


@pytest.mark.parametrize("kind,N,B,level",
                         [("rhs", 64, 40, 0), ("rhs", 64, 40, 4),
                          ("level", 16, 40, 0), ("level", 32, 40, 2),
                          ("level", 64, 33, 3), ("pair", 16, 40, 1),
                          ("pair", 64, 33, 1), ("pair", 64, 40, 3),
                          ("leaf", 16, 40, 0), ("leaf", 64, 33, 0)])
@pytest.mark.parametrize("bn,bm", OTHER_BLOCKS + WIDE_BLOCKS)
def test_sweep_kernels_other_blocks(dev, bn, bm, kind, N, B, level):
    """B1-B4 at the generic instantiations' block sizes, emission included
    where the level gives it."""
    g = torch.Generator().manual_seed(1000 + 10 * bn + bm)
    args, kw = _sweep_args(g, dev, N, B, level, bn, bm, kind)
    fn = getattr(schur, SWEEP_KERNELS[kind])
    before = fn.launches
    ks, ps, *_ = _both(fn, args, dict(kw, n=bn, m=bm))
    assert fn.launches == before + 1
    _assert_match(ks, ps)


def test_sweep_kernels_reject_blocks_past_eight(dev):
    """A float32 CUDA call at a block past the instantiations (a state dim
    past 8, an input dim past 64) raises (no plain run on the card)."""
    g = torch.Generator().manual_seed(5)
    for bn, bm in ((9, 2), (2, 65)):
        args, kw = _sweep_args(g, dev, 16, 8, 0, bn, bm, "rhs")
        with pytest.raises(ValueError, match="n in 1..8 and input dims m "
                                             "in 1..64"):
            schur.rhs_update_level_em(*args, n=bn, m=bm, **kw)


# ---------------------------------------------------------------------------
# Flat-plane kernels (ops/flat.py, csrc/flat_kernels.cu), at the main path's
# shapes: N=256, B=1024 as [e, N*B/128, 128] flat planes.
# ---------------------------------------------------------------------------

FN, FB = 256, 1024
FR = FN * FB // 128


def _frows(G):
    return G * FB // 128


@pytest.mark.parametrize("U_max", [False, True])
@pytest.mark.parametrize("with_sep", [False, True])
@pytest.mark.parametrize("level", range(7))
def test_flat_level_kernel_every_level(dev, level, with_sep, U_max):
    """B10 at N=256, B=1024 at every level, with one upper slab and with
    the most the tree allows, emitting (levels 0-1 with the separator
    dynamics given) and not."""
    g = torch.Generator().manual_seed(900 + 4 * level + 2 * with_sep + U_max)
    U = FN.bit_length() - 1 - level - 1 if U_max else 1
    G, G2 = FN >> (level + 1), FN >> (level + 2)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(nn, FR, 128), R(nn, FR, 128), R(mn, FR, 128),
            [R(nn, FR, 128) for _ in range(U)],
            [R(nn, FR, 128) for _ in range(U)],
            [R(mn, FR, 128) for _ in range(U)],
            [0.1 * R(nn, _frows(G), 128) for _ in range(U)],
            R(nn, _frows(G2), 128) if with_sep else None,
            R(n * m, _frows(G2), 128) if with_sep else None]
    before = flat.schur_update_level_flat.launches
    ks, ps, k, p = _both(flat.schur_update_level_flat, args,
                         dict(level=level, n=n, m=m, N=FN))
    assert flat.schur_update_level_flat.launches == before + 1
    emits = with_sep and level < 2
    assert (k[3] is not None) == (p[3] is not None) == emits
    _assert_match(ks, ps)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_flat_level_kernel(dev, level):
    """B10 with the next-level separator dynamics given: emits (and folds)
    at levels 0 and 1, not at 2."""
    g = torch.Generator().manual_seed(600 + level)
    U = FN.bit_length() - 1 - level - 1
    G, G2 = FN >> (level + 1), FN >> (level + 2)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(nn, FR, 128), R(nn, FR, 128), R(mn, FR, 128),
            [R(nn, FR, 128) for _ in range(U)],
            [R(nn, FR, 128) for _ in range(U)],
            [R(mn, FR, 128) for _ in range(U)],
            [0.1 * R(nn, _frows(G), 128) for _ in range(U)],
            R(nn, _frows(G2), 128), R(n * m, _frows(G2), 128)]
    before = flat.schur_update_level_flat.launches
    ks, ps, k, p = _both(flat.schur_update_level_flat, args,
                         dict(level=level, n=n, m=m, N=FN))
    assert flat.schur_update_level_flat.launches == before + 1
    assert (k[3] is not None) == (p[3] is not None) == (level < 2)
    _assert_match(ks, ps)


def test_flat_leaf_kernel(dev):
    """B11 at depth 8."""
    g = torch.Generator().manual_seed(700)
    depth = FN.bit_length() - 1
    R = lambda *s: _rand(g, dev, *s)
    pos = lambda *s: (0.5 + torch.rand(s, generator=g)).to(dev)
    args = [R(nn, FR, 128), R(n * m, FR, 128), pos(n, FR, 128),
            pos(m, FR, 128), R(nn, _frows(FN // 2), 128),
            [0.1 * R(nn, _frows(FN // 2), 128) for _ in range(depth - 1)],
            R(nn, _frows(FN // 4), 128), R(n * m, _frows(FN // 4), 128)]
    before = flat.leaf_schur_level0_flat.launches
    ks, ps, *_ = _both(flat.leaf_schur_level0_flat, args,
                       dict(depth=depth, n=n, m=m, N=FN))
    assert flat.leaf_schur_level0_flat.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize("level", [0, 5])
def test_flat_rhs_kernel(dev, level):
    """B12 at level 0 and level 5."""
    g = torch.Generator().manual_seed(800 + level)
    G = FN >> (level + 1)
    args = [_rand(g, dev, *s) for s in (
        (nn, FR, 128), (nn, FR, 128), (mn, FR, 128), (n, FR, 128),
        (n, FR, 128), (m, FR, 128), (n, _frows(G), 128))]
    before = flat.rhs_update_level_flat.launches
    ks, ps, *_ = _both(flat.rhs_update_level_flat, args,
                       dict(level=level, n=n, m=m, N=FN))
    assert flat.rhs_update_level_flat.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize("level,with_sep", [(0, True), (1, True), (1, False),
                                            (2, False), (6, False)])
@pytest.mark.parametrize("bn,bm", OTHER_BLOCKS + WIDE_BLOCKS)
def test_flat_level_kernel_other_blocks(dev, bn, bm, level, with_sep):
    """B10 at the generic block sizes (row groups of three with the last
    one masked where n or m is not a multiple of three), N=256, B=1024, the
    most upper slabs the tree allows, emitting and not."""
    g = torch.Generator().manual_seed(1100 + 10 * bn + bm + level)
    xx, ux = bn * bn, bm * bn
    U = FN.bit_length() - 1 - level - 1
    G, G2 = FN >> (level + 1), FN >> (level + 2)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(xx, FR, 128), R(xx, FR, 128), R(ux, FR, 128),
            [R(xx, FR, 128) for _ in range(U)],
            [R(xx, FR, 128) for _ in range(U)],
            [R(ux, FR, 128) for _ in range(U)],
            [0.1 * R(xx, _frows(G), 128) for _ in range(U)],
            R(xx, _frows(G2), 128) if with_sep else None,
            R(ux, _frows(G2), 128) if with_sep else None]
    before = flat.schur_update_level_flat.launches
    ks, ps, k, p = _both(flat.schur_update_level_flat, args,
                         dict(level=level, n=bn, m=bm, N=FN))
    assert flat.schur_update_level_flat.launches == before + 1
    assert (k[3] is not None) == (p[3] is not None) == (with_sep
                                                        and level < 2)
    _assert_match(ks, ps)


@pytest.mark.parametrize("bn,bm", OTHER_BLOCKS + WIDE_BLOCKS)
def test_flat_leaf_and_rhs_kernels_other_blocks(dev, bn, bm):
    """B11 at depth 5 and B12 at levels 0 and 3 (N=32, B=1024) at the
    generic block sizes."""
    N = 32
    rows = lambda G: G * FB // 128
    g = torch.Generator().manual_seed(1200 + 10 * bn + bm)
    xx, ux = bn * bn, bm * bn
    depth = N.bit_length() - 1
    R = lambda *s: _rand(g, dev, *s)
    pos = lambda *s: (0.5 + torch.rand(s, generator=g)).to(dev)
    args = [R(xx, rows(N), 128), R(ux, rows(N), 128), pos(bn, rows(N), 128),
            pos(bm, rows(N), 128), R(xx, rows(N // 2), 128),
            [0.1 * R(xx, rows(N // 2), 128) for _ in range(depth - 1)],
            R(xx, rows(N // 4), 128), R(ux, rows(N // 4), 128)]
    ks, ps, *_ = _both(flat.leaf_schur_level0_flat, args,
                       dict(depth=depth, n=bn, m=bm, N=N))
    _assert_match(ks, ps)
    for level in (0, 3):
        args = [R(*s) for s in (
            (xx, rows(N), 128), (xx, rows(N), 128), (ux, rows(N), 128),
            (bn, rows(N), 128), (bn, rows(N), 128), (bm, rows(N), 128),
            (bn, rows(N >> (level + 1)), 128))]
        before = flat.rhs_update_level_flat.launches
        ks, ps, *_ = _both(flat.rhs_update_level_flat, args,
                           dict(level=level, n=bn, m=bm, N=N))
        assert flat.rhs_update_level_flat.launches == before + 1
        _assert_match(ks, ps)


@pytest.mark.parametrize("flat_planes", [False, True])
def test_wide_input_solve_launches_kernels(dev, flat_planes):
    """A default-option f32 solve at (n, m) = (6, 12), N=32, B=1024: the em
    schedule launches B3, B4, B1 and B2, the flat one B11, B10 and B12
    (no B1-B4); both equal ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.random_problem(torch.Generator().manual_seed(6), 32, 6, 12,
                             device=dev)
    batch = pt.batch_problems(prob, FB, torch.Generator().manual_seed(12))
    flat.reset_launch_counts()
    schur.reset_launch_counts()
    opts = pt.SolveOptions(flat_planes=flat_planes)
    got = pt.solve_kkt(batch, options=opts)
    torch.cuda.synchronize()
    ran, idle = ((flat.launch_counts(), schur.launch_counts()) if flat_planes
                 else (schur.launch_counts(), flat.launch_counts()))
    assert all(c > 0 for c in ran.values()), ran
    assert sum(idle.values()) == 0, idle
    ref = pt.solve_kkt(batch, options=pt.SolveOptions(
        flat_planes=flat_planes, kernels="off"))
    scale = 1.0 + ref.abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= 1e-4 * scale


def test_flat_solve_kernel_path_matches_plain(dev):
    """The flat schedule at N=32, B=1024: B11 once, B10 at levels 1-3, B12
    at every level, no B1-B4; the kernel path agrees with
    ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.double_integrator_problem(32, dtype=torch.float32, device=dev)
    batch = pt.batch_problems(prob, FB, torch.Generator().manual_seed(0))
    flat.reset_launch_counts()
    schur.reset_launch_counts()
    got = pt.solve_kkt(batch, options=pt.SolveOptions(flat_planes=True))
    assert flat.launch_counts() == {"schur_update_level_flat": 3,
                                    "leaf_schur_level0_flat": 1,
                                    "rhs_update_level_flat": 5}
    assert sum(schur.launch_counts().values()) == 0
    ref = pt.solve_kkt(batch, options=pt.SolveOptions(flat_planes=True,
                                                      kernels="off"))
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# Mid-block plane kernels (ops/planes.py, csrc/planes_kernels.cu).
# ---------------------------------------------------------------------------


def _spd(gen, dev, d, *plane):
    """Random SPD blocks ``[d, d, *plane]`` (f32, well conditioned)."""
    M = torch.randn(plane + (d, d), generator=gen, dtype=torch.float64)
    S = M @ M.transpose(-1, -2) + d * torch.eye(d, dtype=torch.float64)
    return S.movedim((-2, -1), (0, 1)).contiguous().float().to(dev)


@pytest.mark.parametrize(
    "p,K,q,plane", [(12, 12, 12, (5, 33)), (12, 4, 12, (3, 7)),
                    (36, 36, 36, (16, 40)), (36, 12, 36, (9, 33)),
                    (64, 64, 64, (2, 33)), (3, 36, 1, (1, 1))],
)
def test_pgemm_kernel(dev, p, K, q, plane):
    g = torch.Generator().manual_seed(p * K + q)
    args = [_rand(g, dev, p, K, *plane), _rand(g, dev, K, q, *plane)]
    before = planes.pgemm.launches
    ks, ps, *_ = _both(lambda *a, **k: (planes.pgemm(*a, **k),), args, {})
    assert planes.pgemm.launches == before + 1
    _assert_match(ks, ps)


# B6 at every register width (n = 9, 12, 16, 36, 64) on a plane below one
# block (F = 5), the quadruped rsLQR's top-level plane (F = 256: 32 blocks
# of 8 elements), a plane of 80 blocks (F = 640) and one of 512 (F =
# 4,096); and n = 36 at the level-0 plane (F = 65,536).
PCHOL_CASES = [(12, (7, 33)), (36, (16, 40)), (64, (2, 5)), (9, (1, 1))]
PCHOL_CASES += sorted(
    {(d, plane) for d in (9, 12, 16, 36, 64)
     for plane in ((1, 5), (1, 256), (16, 40), (16, 256))}
    - set(PCHOL_CASES)) + [(36, (256, 256))]


@pytest.mark.parametrize("n,plane", PCHOL_CASES)
def test_pchol_kernel(dev, n, plane):
    g = torch.Generator().manual_seed(n)
    A = _spd(g, dev, n, *plane)
    before = planes.pchol.launches
    ks, ps, *_ = _both(lambda *a, **k: (planes.pchol(*a, **k),), [A], {})
    assert planes.pchol.launches == before + 1
    _assert_match(ks, ps)
    assert not torch.triu(ks[0].movedim((0, 1), (-2, -1)), 1).any()


# B7 at every register width (n = 9, 12, 16, 36, 64: the raised-threshold
# dims, the quadruped's and the limit) and column count (one column, a
# partial tile, whole tiles): on a plane below one block (F = 5), on a grid
# smaller than the card (F = 640: one warp per block), and on planes where
# blocks take several column tiles (F = 4,096).
PCHO_CASES = sorted(
    {(d, w, plane) for d in (9, 12, 16, 36, 64) for w in (1, 2, 12, 36)
     for plane in ((1, 5), (16, 40))}
    | {(12, 12, (7, 33)), (12, 1, (7, 33)), (36, 36, (16, 40)),
       (36, 1, (9, 40)), (64, 3, (2, 5)), (36, 36, (64, 64)),
       (16, 36, (64, 64)), (64, 36, (64, 64)), (36, 12, (64, 64))})


@pytest.mark.parametrize("n,w,plane", PCHO_CASES)
def test_pcho_solve_kernel(dev, n, w, plane):
    g = torch.Generator().manual_seed(n + w)
    L = planes.pchol_plain(_spd(g, dev, n, *plane))
    args = [L, _rand(g, dev, n, w, *plane)]
    before = planes.pcho_solve.launches
    ks, ps, k, _ = _both(lambda *a, **kw: (planes.pcho_solve(*a, **kw),),
                         args, {})
    assert planes.pcho_solve.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize(
    "n,m,q,N,B,level",
    [(12, 4, 12, 16, 40, 0), (12, 4, 12, 16, 33, 3), (12, 4, 1, 16, 33, 0),
     (12, 4, 1, 16, 1, 3), (36, 12, 36, 32, 40, 0), (36, 12, 36, 32, 40, 4),
     (36, 12, 1, 32, 33, 2)],
)
def test_schur3_update_planes_kernel(dev, n, m, q, N, B, level):
    g = torch.Generator().manual_seed(300 + level + q)
    G = N >> (level + 1)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(n, n, N, B), R(n, n, N, B), R(m, n, N, B), R(n, q, G, B),
            R(n, q, N, B), R(n, q, N, B), R(m, q, N, B)]
    before = planes.schur3_update_planes.launches
    ks, ps, *_ = _both(planes.schur3_update_planes, args, dict(level=level))
    assert planes.schur3_update_planes.launches == before + 1
    _assert_match(ks, ps)


# The plane kernels of the mid-block rsLQR path (the scan's own kernels,
# schur_update_planes and plu_solve_multi, do not run there).
RSLQR_MID_KERNELS = ("pgemm", "pchol", "pcho_solve", "schur3_update_planes")


def test_midblock_solve_kernel_path_matches_plain(dev):
    """The mid-block slice at a small size (nx=12, nu=4, N=16, B=40):
    every plane kernel launches, and the kernel path agrees with
    ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.random_problem(torch.Generator().manual_seed(0), 16, 12, 4,
                             device=dev)
    batch = pt.batch_problems(prob, 40, torch.Generator().manual_seed(1))
    planes.reset_launch_counts()
    got = pt.solve_kkt(batch)
    counts = planes.launch_counts()
    ref = pt.solve_kkt(batch, options=pt.SolveOptions(kernels="off"))
    assert all(counts[k] > 0 for k in RSLQR_MID_KERNELS), counts
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


def test_raised_threshold_solve_takes_plane_kernels(dev):
    """An f32 solve at ``mxu_block_threshold=16``, nx=12, nu=4 (N=32,
    B=40): the state dim past 8 takes the planes route (ROADMAP C6), so B7
    and B9 launch and no small-block kernel does; it equals
    ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.random_problem(torch.Generator().manual_seed(12), 32, 12, 4,
                             device=dev)
    batch = pt.batch_problems(prob, 40, torch.Generator().manual_seed(1))
    opts = pt.SolveOptions(mxu_block_threshold=16)
    for mod in (schur, flat, planes):
        mod.reset_launch_counts()
    got = pt.solve_kkt(batch, options=opts)
    torch.cuda.synchronize()
    counts = planes.launch_counts()
    assert counts["pcho_solve"] > 0 and counts["schur3_update_planes"] > 0
    assert sum(schur.launch_counts().values()) == 0
    assert sum(flat.launch_counts().values()) == 0
    ref = pt.solve_kkt(batch, options=pt.SolveOptions(
        mxu_block_threshold=16, kernels="off"))
    assert bool(torch.isfinite(got).all())
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# The parallel scan's kernels: B5's flags, schur_update_planes, B8.
# ---------------------------------------------------------------------------

# (p, K, q, plane, flags): each flag alone, then every combination the
# pscan combines call (pscan.py), at n=36 / m=12 and at the limits.
PGEMM_FLAG_CASES = [
    (12, 36, 12, (3, 33), dict(ta=True)),
    (12, 36, 36, (3, 33), dict(tbt=True)),
    (36, 12, 36, (2, 40), dict(cin=True)),
    (36, 12, 36, (2, 40), dict(cin=True, sub=False)),
    (12, 12, 12, (5, 7), dict(diag=True)),
    (12, 36, 12, (4, 33), dict(dconst=1.0)),
    (36, 36, 36, (2, 33), dict(sym=True)),
    (36, 36, 36, (2, 33), dict(ks=True)),
    (36, 36, 36, (16, 40), dict(dconst=1.0)),
    (36, 36, 36, (16, 40), dict(ta=True, sym=True, diag=True)),
    (36, 36, 36, (16, 40), dict(ta=True, sym=True, diag=True, ks=True)),
    (36, 12, 36, (16, 40), dict(sym=True, cin=True, sub=False)),
    (36, 36, 36, (8, 33), dict(sym=True, cin=True, sub=False)),
    (36, 36, 36, (8, 33), dict(tbt=True, sym=True, cin=True, sub=False)),
    (12, 36, 12, (31, 9), dict(sym=True, diag=True)),
    (64, 64, 64, (1, 45), dict(ta=True, tbt=True, cin=True, diag=True,
                               dconst=2.0, sym=True, ks=True)),
    (40, 64, 40, (1, 45), dict(tbt=True, cin=True, ks=True)),
    (5, 20, 1, (1, 1), dict(ta=True, cin=True, ks=True)),
]


# The pscan's own flag combinations (chip_smoke.py phase 2c: Sm, Vt, C_leaf,
# J_leaf, J_pair, IC, C_comb, J_comb, Quu) at the quadruped scan's planes:
# 16 chunks, 8 composites and 7 of them, by B=256.
PSCAN_FLAGS = [
    (12, 36, 12, dict(dconst=1.0)),
    (12, 36, 36, dict(tbt=True)),
    (36, 12, 36, dict(cin=True, sub=False, sym=True)),
    (36, 36, 36, dict(ta=True, diag=True, sym=True)),
    (36, 36, 36, dict(ta=True, ks=True, diag=True, sym=True)),
    (36, 36, 36, dict(dconst=1.0)),
    (36, 36, 36, dict(tbt=True, cin=True, sub=False, sym=True)),
    (36, 36, 36, dict(cin=True, sub=False, sym=True)),
    (12, 36, 12, dict(diag=True, sym=True)),
]
PGEMM_FLAG_CASES += [(p, K, q, plane, fl) for p, K, q, fl in PSCAN_FLAGS
                     for plane in ((16, 256), (8, 256), (7, 256))]
# Wide planes (F >= 65,536), the batched interior's Quu among them.
PGEMM_FLAG_CASES += [
    (12, 36, 12, (511, 256), dict(diag=True, sym=True)),
    (36, 36, 36, (257, 256), dict(ta=True, ks=True, diag=True, sym=True)),
    (40, 64, 40, (65569,), dict(tbt=True, cin=True, ks=True)),
    (5, 7, 5, (65537,), dict(ta=True, cin=True, sub=False, dconst=1.0,
                             sym=True)),
]
# Ragged planes (F = 1, 33, 2049) at every block dim of interest: all flags
# on a square output, and the non-symmetric flags on a rectangular one.
PGEMM_FLAG_CASES += [
    case for F in (1, 33, 2049) for d, e in ((1, 5), (5, 12), (12, 36),
                                             (36, 40), (40, 64), (64, 1))
    for case in (
        (d, e, d, (F,), dict(ta=True, tbt=True, cin=True, diag=True,
                             dconst=0.5, sym=True, ks=True)),
        (d, d, e, (F,), dict(tbt=True, cin=True, sub=False, ks=True)))]


@pytest.mark.parametrize("p,K,q,plane,flags", PGEMM_FLAG_CASES)
def test_pgemm_flagged_kernel(dev, p, K, q, plane, flags):
    g = torch.Generator().manual_seed(p + 7 * K + q)
    R = lambda *s: _rand(g, dev, *s)
    A = R(*((K, p) if flags.get("ta") else (p, K)), *plane)
    Bm = R(*((q, K) if flags.get("tbt") else (K, q)), *plane)
    cin = R(p, q, *plane) if flags.get("cin") else None
    diag = R(p, *plane) if flags.get("diag") else None
    ks = R(K, *plane) if flags.get("ks") else None
    kw = dict(ta=flags.get("ta", False), tbt=flags.get("tbt", False),
              sub=flags.get("sub", True), dconst=flags.get("dconst", 0.0),
              sym=flags.get("sym", False))
    before = planes.pgemm.launches
    ks_, ps, *_ = _both(
        lambda a, b, c, d, s, **k: (planes.pgemm(a, b, c, d, s, **k),),
        [A, Bm, cin, diag, ks], kw)
    assert planes.pgemm.launches == before + 1
    _assert_match(ks_, ps)
    if kw["sym"]:
        out = ks_[0]
        assert torch.equal(out, out.transpose(0, 1))


# Default-option solves: f64 runs the plain stages on the card (no launch
# of any kernel); f32 at small blocks other than (6, 3) launches the
# small-block kernels' generic instantiations. Both equal kernels="off".
C5_CASES = [(torch.float64, 6, 3, 32, 40), (torch.float64, 36, 12, 32, 9),
            (torch.float32, 4, 2, 32, 40), (torch.float32, 8, 8, 32, 40)]


@pytest.mark.parametrize("solver", ["solve_kkt", "solve_pscan_kkt"])
@pytest.mark.parametrize("dtype,nx,nu,N,B", C5_CASES)
def test_default_options_route_by_applicability(dev, dtype, nx, nu, N, B,
                                                solver):
    import rslqr_tpu_torch as pt

    prob = pt.random_problem(torch.Generator().manual_seed(nx), N, nx, nu,
                             dtype=dtype, device=dev)
    batch = pt.batch_problems(prob, B, torch.Generator().manual_seed(1))
    solve = getattr(pt, solver)
    for mod in (schur, flat, planes):
        mod.reset_launch_counts()
    got = solve(batch)
    torch.cuda.synchronize()
    launched = {k: v for mod in (schur, flat, planes)
                for k, v in mod.launch_counts().items() if v}
    if dtype == torch.float32 and solver == "solve_kkt":
        # N=32: the fused leaf, one pair (levels 1-2), B1 at levels 3-4.
        assert launched == schur.launch_counts() and all(
            c > 0 for c in launched.values()) and len(launched) == 4, launched
    else:  # f64, or the small-block pscan (batch-last, no kernel)
        assert not launched, launched
    ref = solve(batch, pt.SolveOptions(kernels="off"))
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize(
    "p,n,q,N,B,level,lam",
    [(36, 36, 36, 32, 40, 0, True), (36, 36, 36, 32, 40, 0, False),
     (12, 12, 12, 16, 33, 3, True), (12, 12, 1, 16, 33, 2, False),
     (4, 12, 12, 16, 40, 1, True)],
)
def test_schur_update_planes_kernel(dev, p, n, q, N, B, level, lam):
    g = torch.Generator().manual_seed(400 + level + q + p)
    G = N >> (level + 1)
    R = lambda *s: _rand(g, dev, *s)
    args = [R(p, n, N, B), R(n, q, G, B), R(p, q, N, B)]
    before = planes.schur_update_planes.launches
    ks, ps, k, _ = _both(
        lambda *a, **kw: (planes.schur_update_planes(*a, **kw),), args,
        dict(level=level, lam=lam))
    assert planes.schur_update_planes.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize(
    "n,ws,plane",
    [(12, (12,), (16, 33)), (12, (12, 1, 12, 1), (3, 7)),
     (36, (36, 1, 36, 1), (8, 40)), (36, (36, 1), (5, 33)),
     (36, (1,), (1, 1)), (64, (64, 1, 3), (2, 33)), (20, (5, 5), (1, 45)),
     (12, (12,), (16, 256)), (36, (36, 1, 36, 1), (8, 256)),
     (36, (36, 1), (7, 256)), (36, (36, 1, 36, 1), (32, 256))],
)
def test_plu_solve_multi_kernel(dev, n, ws, plane):
    """Well-conditioned ``I + C J`` blocks (C, J PSD), 1-4 right-hand sides,
    ragged planes, and the quadruped pscan's three shapes at their planes
    (the Woodbury solve at 16 x 256, the suffix tree's at 8 and 7 x 256),
    and a plane wide enough (32 x 256) that one block takes all 74 columns,
    up to three a slot; the operands are left as they are."""
    g = torch.Generator().manual_seed(500 + n + len(ws))
    M = torch.randn(plane + (n, n), generator=g, dtype=torch.float64)
    P = torch.randn(plane + (n, n), generator=g, dtype=torch.float64)
    C = M @ M.transpose(-1, -2) / n
    J = P @ P.transpose(-1, -2) / n
    IC = torch.eye(n, dtype=torch.float64) + C @ J
    A = IC.movedim((-2, -1), (0, 1)).contiguous().float().to(dev)
    Bs = [_rand(g, dev, n, w, *plane) for w in ws]
    A0, B0 = A.clone(), [b.clone() for b in Bs]
    before = planes.plu_solve_multi.launches
    shape = planes.plu_solve_multi.shape_launches[(n, ws)]
    ks = planes.plu_solve_multi(A, *Bs)
    torch.cuda.synchronize()
    assert planes.plu_solve_multi.launches == before + 1
    assert planes.plu_solve_multi.shape_launches[(n, ws)] == shape + 1
    assert torch.equal(A, A0) and all(torch.equal(b, c) for b, c in zip(Bs, B0))
    ps = planes.plu_solve_multi(A, *Bs, kernels="off")
    _assert_match(list(ks), list(ps))


@pytest.mark.parametrize("n,m,N,B,chunk,batched",
                         [(12, 4, 16, 40, 4, False), (12, 4, 16, 40, 1, False),
                          (36, 12, 64, 9, 0, False), (36, 12, 64, 9, 8, True)])
def test_pscan_kernel_path_matches_plain(dev, n, m, N, B, chunk, batched):
    """The mid-block pscan slice at a small size: pgemm and plu_solve_multi
    launch (pchol and pcho_solve too where the gains pass runs on m > 8),
    and the kernel path agrees with ``kernels="off"``."""
    import rslqr_tpu_torch as pt

    prob = pt.random_problem(torch.Generator().manual_seed(2), N, n, m,
                             device=dev)
    batch = pt.batch_problems(prob, B, torch.Generator().manual_seed(3))
    opts = pt.SolveOptions(pscan_chunk=chunk, pscan_batched_interior=batched)
    planes.reset_launch_counts()
    got = pt.solve_pscan_kkt(batch, opts)
    counts = planes.launch_counts()
    ref = pt.solve_pscan_kkt(batch, pt.SolveOptions(
        kernels="off", pscan_chunk=chunk, pscan_batched_interior=batched))
    assert counts["pgemm"] > 0 and counts["plu_solve_multi"] > 0, counts
    if (chunk == 1 or batched) and m > 8:  # the gains pass's m x m Quu
        assert counts["pchol"] > 0 and counts["pcho_solve"] > 0, counts
    scale = 1.0 + ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("ib", probe.IBS)
@pytest.mark.parametrize("t1", probe.T1S)
@pytest.mark.parametrize(
    "p,K,q,plane", [(36, 36, 36, (16, 40)), (13, 12, 12, (5, 33)),
                    (7, 64, 64, (2, 33)), (3, 5, 1, (1, 1))],
)
def test_pgemm_ib_kernel(dev, ib, t1, p, K, q, plane):
    g = torch.Generator().manual_seed(p * K + q)
    args = [_rand(g, dev, p, K, *plane), _rand(g, dev, K, q, *plane)]
    before = probe.pgemm_ib.launches
    ks, ps, *_ = _both(lambda *a, **k: (probe.pgemm_ib(*a, **k),), args,
                       dict(ib=ib, t1=t1))
    assert probe.pgemm_ib.launches == before + 1
    _assert_match(ks, ps)


@pytest.mark.parametrize("F,reps", [(1, 0), (1000, 37), (65536, 64)])
def test_fma_peak_kernel(dev, F, reps):
    g = torch.Generator().manual_seed(F)
    X = (-0.5 + 0.4 * torch.rand((1, F), generator=g)).to(dev)
    before = probe.fma_peak.launches
    ks, ps, *_ = _both(lambda *a, **k: (probe.fma_peak(*a, **k),), [X],
                       dict(reps=reps))
    assert probe.fma_peak.launches == before + 1
    _assert_match(ks, ps)
