"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture). This file imports no JAX, so it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: tests/conftest.py configures JAX.)

Inputs are random f32, cloned for each route, at small shapes that reach
every branch: odd batch widths (ragged last block of batch columns), B=1,
the shortest horizons, emission on and off, and emission groups larger than
one block of knots. The mid-block plane kernels run at n=12 and 36 (and the
limit, 64), with one right-hand column (w=1, q=1), ragged planes, and
Schur updates at level 0 and the top level. The flat-plane kernels run at
the main path's shapes (N=256, B=1024), B10 emitting and not. The parallel
scan's kernels:
``pgemm`` with each of its flags alone and in every combination the scan
calls (and all at once at width 64), ``schur_update_planes`` masked and not,
``plu_solve_multi`` at widths 12, 36 and 64 with 1-4 right-hand sides, and
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


# ---------------------------------------------------------------------------
# Flat-plane kernels (ops/flat.py, csrc/flat_kernels.cu), at the main path's
# shapes: N=256, B=1024 as [e, N*B/128, 128] flat planes.
# ---------------------------------------------------------------------------

FN, FB = 256, 1024
FR = FN * FB // 128


def _frows(G):
    return G * FB // 128


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


@pytest.mark.parametrize("n,plane", [(12, (7, 33)), (36, (16, 40)),
                                     (64, (2, 5)), (9, (1, 1))])
def test_pchol_kernel(dev, n, plane):
    g = torch.Generator().manual_seed(n)
    A = _spd(g, dev, n, *plane)
    ks, ps, *_ = _both(lambda *a, **k: (planes.pchol(*a, **k),), [A], {})
    _assert_match(ks, ps)
    assert not torch.triu(ks[0].movedim((0, 1), (-2, -1)), 1).any()


@pytest.mark.parametrize("n,w,plane", [(12, 12, (7, 33)), (12, 1, (7, 33)),
                                       (36, 36, (16, 40)), (36, 1, (9, 40)),
                                       (64, 3, (2, 5))])
def test_pcho_solve_kernel(dev, n, w, plane):
    g = torch.Generator().manual_seed(n + w)
    L = planes.pchol_plain(_spd(g, dev, n, *plane))
    args = [L, _rand(g, dev, n, w, *plane)]
    ks, ps, k, _ = _both(lambda *a, **kw: (planes.pcho_solve(*a, **kw),),
                         args, {})
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
     (36, (1,), (1, 1)), (64, (64, 1, 3), (2, 33)), (20, (5, 5), (1, 45))],
)
def test_plu_solve_multi_kernel(dev, n, ws, plane):
    """Well-conditioned ``I + C J`` blocks (C, J PSD), 1-4 right-hand sides,
    ragged planes; the operands are left as they are."""
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
    ks = planes.plu_solve_multi(A, *Bs)
    torch.cuda.synchronize()
    assert planes.plu_solve_multi.launches == before + 1
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
