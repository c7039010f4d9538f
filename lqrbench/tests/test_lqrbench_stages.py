"""The stage counts against counts made by hand: a literal at the
smallest tree, the rsLQR closed forms against a knot-by-knot enumeration
of the algorithm, and the scan's combine counts against odd-even scans
run on numbers."""

import importlib.util
import types

import pytest

from lqrbench import run

_spec = lambda fam: importlib.util.spec_from_file_location(
    f"stages_{fam}", run.HERE / "stages" / f"{fam}.py")


def _load(fam):
    spec = _spec(fam)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rslqr, pscan = _load("rslqr"), _load("pscan")


def _cfg(N, n, m):
    return {"nhorizon": N, "nstates": n, "ninputs": m, "dtype": "float32"}


def _totals(stages):
    return (sum(f for _, f, _ in stages), sum(b for _, _, b in stages))


def test_rslqr_smallest_tree_by_hand():
    # N=2, n=m=1, B=1. leaf: 2 flops (the diagonal -Q^-1 of knot 1, knot
    # 0's R^-1 B'), 11 elements; right side leaf: 6 flops, 17 elements;
    # level 0 (one separator, no upper level): products 6 flops and 7
    # elements, Cholesky 1/3 and 2, right side 18 and 18.
    f, b = _totals(rslqr.count(_cfg(2, 1, 1), {"batch": 1}))
    assert f == pytest.approx(2 + 6 + 6 + 1 / 3 + 18)
    assert b == 4 * (11 + 17 + 7 + 2 + 18)


def _enumerate_schur(N, n, m):
    """Knot by knot: FLOPs and elements of every level's Schur update."""
    D = N.bit_length() - 1
    lvl = lambda k: (k ^ (k + 1)).bit_length() - 1  # trailing ones
    written = set()  # (level, knot, part) the leaf stage wrote
    for k in range(N):
        if 1 <= k < N - 1:
            written |= {(lvl(k), k, "x"), (lvl(k), k, "u")}
        if k >= 1:
            written.add((lvl(k - 1), k, "x"))
    out = {}
    for l in range(D - 1):
        span, G = 2 << l, N >> (l + 1)
        flops = elems = 0
        for k in range(N):
            pos = k % span
            keep = k == 0 or pos not in (0, span // 2)
            rows = {"l": n * keep, "x": n, "u": m}
            elems += sum(rows.values()) * n  # F_l read once
            for u in range(l + 1, D):
                for part, r in rows.items():
                    flops += r * (2 * n * n + n)
                    elems += r * n  # written
                    if l > 0 or (u, k, part) in written:
                        elems += r * n  # read: not still zero
        elems += (D - l - 1) * G * n * n  # the solved separators
        out[f"schur.L{l}"] = (flops, elems)
    return out


@pytest.mark.parametrize("N,n,m", [(4, 1, 1), (8, 2, 1), (16, 3, 2),
                                   (32, 6, 3)])
def test_rslqr_schur_matches_enumeration(N, n, m):
    got = {name: (f, b / 4) for name, f, b in
           rslqr.count(_cfg(N, n, m), {"batch": 1})
           if name.startswith("schur")}
    assert got == pytest.approx(_enumerate_schur(N, n, m))


def test_counts_scale_with_batch():
    cfg = _cfg(64, 6, 3)
    for mod, traffic in ((rslqr, {}), (pscan, {"stage_params": {"chunk": 1}}),
                         (pscan, {"stage_params": {"chunk": 8}})):
        one = _totals(mod.count(cfg, {**traffic, "batch": 1}))
        many = _totals(mod.count(cfg, {**traffic, "batch": 7}))
        assert many == pytest.approx((7 * one[0], 7 * one[1]))


def _suffix_scan(xs, counts):
    """Odd-even suffix sums of ``xs`` (the program's up-sweep of full
    pair combines, down-sweep of reduced ones), counting each kind."""
    L = len(xs)
    if L == 1:
        return list(xs)
    if L % 2:
        rest = _suffix_scan(xs[1:], counts)
        counts["reduced"] += 1
        return [xs[0] + rest[0]] + rest
    pairs = [xs[2 * i] + xs[2 * i + 1] for i in range(L // 2)]
    counts["full"] += L // 2
    sp = _suffix_scan(pairs, counts)
    odd = [xs[2 * i + 1] + sp[i + 1] for i in range(L // 2 - 1)]
    counts["reduced"] += len(odd)
    odd.append(xs[-1])
    return [v for pair in zip(sp, odd) for v in pair]


@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 16, 17, 64])
def test_suffix_counts_match_a_scan(L):
    xs = [3 ** i % 101 for i in range(L)]
    counts = {"full": 0, "reduced": 0}
    assert _suffix_scan(xs, counts) == [sum(xs[i:]) for i in range(L)]
    assert pscan._suffix_counts(L) == (counts["full"], counts["reduced"])


def _prefix_scan(xs, x0, counts):
    """Odd-even prefix of affine maps ``x -> a x + b`` applied to x0."""
    L = len(xs)
    if L == 1:
        counts["vec"] += 1
        a, b = xs[0]
        return [a * x0 + b]
    if L % 2:
        head = _prefix_scan(xs[:-1], x0, counts)
        counts["vec"] += 1
        a, b = xs[-1]
        return head + [a * head[-1] + b]
    ev, od = xs[0::2], xs[1::2]
    comp = [(o[0] * e[0], o[0] * e[1] + o[1]) for e, o in zip(ev, od)]
    counts["mat"] += L // 2
    counts["vec"] += L // 2
    pair = _prefix_scan(comp, x0, counts)
    even = [ev[0][0] * x0 + ev[0][1]]
    even += [ev[i][0] * pair[i - 1] + ev[i][1] for i in range(1, L // 2)]
    counts["vec"] += 1 + (L // 2 - 1)
    return [v for p in zip(even, pair) for v in p]


@pytest.mark.parametrize("L", [1, 2, 3, 6, 15, 16, 31])
def test_prefix_counts_match_a_scan(L):
    xs = [(i % 3 + 1, i) for i in range(L)]
    counts = {"mat": 0, "vec": 0}
    got = _prefix_scan(xs, 2, counts)
    want, x = [], 2
    for a, b in xs:
        x = a * x + b
        want.append(x)
    assert got == want
    assert pscan._prefix_counts(L) == (counts["mat"], counts["vec"])


def test_least_time_reader():
    read = run.metric_reader("kernels.roofline_share")
    peaks = {"float32_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    r = types.SimpleNamespace(summary={"busy_us": 4000.0, "calls": 2}, peaks=peaks,
                stages=[("a", 1e9, 1e6), ("b", 0.0, 1e6)])
    # least = max(1e9 / 1e12, 2e6 / 1e9) = 2 ms; busy 2 ms a call.
    assert read(r) == pytest.approx(100.0)
