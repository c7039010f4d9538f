"""Operations and bytes of one batched parallel-scan LQR solve, stage by
stage, from the algorithm (Särkkä and García-Fernández, IEEE TAC 2021:
the Riccati recursion as an associative suffix scan over conditional
value-function elements ``(F, c, C, eta, J)``, the rollout as a prefix
scan over affine maps) at the cell's shapes, whatever kernels implement
it.

The traffic's ``stage_params.chunk`` names the scan:

* ``chunk = s >= 2`` (the chunked hybrid): per chunk of ``s`` knots a
  serial fold of leaf elements into one composite (one leaf-pair combine,
  ``s - 2`` leaf-full combines), an odd-even suffix scan over the
  ``N / s`` composites, then a down-sweep of one reduced leaf combine with
  the gains at every knot; the rollout composes each chunk's maps, runs
  the odd-even prefix over the composites and steps the interior states.
* ``chunk = 1``: the odd-even suffix scan over all N full elements, the
  gains of every step from the next cost-to-go, and the odd-even prefix
  scan of the closed-loop maps.

A leaf element is ``(A, B R^-1, B', c, -q, Qdiag)``: ``C = B R^-1 B'`` has
rank m, so every ``I + C J`` solve of a leaf combine is an m x m Woodbury
solve. Each stage counts its inputs read once and its outputs written
once (the symmetric ``C``, ``J`` and ``P`` as triangles); the FLOPs are
those of its math (a product ``a x k`` by ``k x b`` is ``2abk``, half of it
for a symmetric result; an LU ``2k^3 / 3``, a Cholesky ``k^3 / 3``, a solve
with ``w`` right-hand columns ``2 k^2 w``).
"""


def _mm(a, k, b):
    return 2 * a * k * b


def _sym(n, k):
    """A symmetric n x n product over an inner dim k: the triangle."""
    return n * (n + 1) * k


def _full(n, m):
    """Generic full combine, one factorization of ``I + C1 J2``."""
    return (_mm(n, n, n) + 3 * _mm(n, n, 1)            # IC, w, b_c, b_w
            + 2 * n ** 3 / 3 + 2 * n * n * (2 * n + 2)  # LU, 2n + 2 columns
            + _mm(n, n, n) + _mm(n, n, 1)              # F, c
            + 2 * (_mm(n, n, n) + _sym(n, n))          # C, J
            + 2 * _mm(n, n, 1))                        # eta


def _reduced(n, m):
    """Reduced combine: ``(eta, J)`` of the combination only."""
    return (_mm(n, n, n) + 2 * _mm(n, n, 1)
            + 2 * n ** 3 / 3 + 2 * n * n * (n + 1)
            + _mm(n, n, n) + _sym(n, n) + 2 * _mm(n, n, 1))


def _woodbury(n, m):
    """The rank-m core shared by the leaf combines: ``Sm = I + V J U``
    (given ``T = V J``), its inverse, ``M1 U``, ``T A1`` and ``M1 A1``."""
    return (_mm(m, n, m) + 2 * m ** 3 / 3 + 2 * m ** 3
            + _mm(n, m, m) + _mm(m, n, n) + _mm(n, m, n))


def _leaf_pair(n, m):
    return (m * n + _woodbury(n, m)                     # T = V1 diag(Qd2)
            + _mm(n, n, n) + _mm(n, n, m) + _mm(m, n, n)  # F, W, Vt
            + _mm(n, m, n) + _sym(n, m)                 # C2, C
            + _sym(n, n) + n * n                        # J
            + 8 * _mm(n, m, 1) + 2 * _mm(n, n, 1))      # c, eta


def _leaf_full(n, m):
    return (_mm(m, n, n) + _woodbury(n, m)              # T = V1 J2
            + _mm(n, n, n) + _mm(n, n, m) + _mm(m, n, n)  # F, W, Vt
            + _sym(n, m)                                # C
            + _mm(n, n, n) + _sym(n, n)                 # J
            + 8 * _mm(n, m, 1) + 4 * _mm(n, n, 1))      # c, w, eta


def _reduced_leaf_gains(n, m):
    return (_mm(m, n, n) + _woodbury(n, m)
            + _mm(n, n, n) + _sym(n, n)                 # J2 M1 A1, J
            + 4 * _mm(n, n, 1) + 2 * _mm(n, m, 1)       # w, eta, Vw, MCw
            + _mm(m, m, n) + _mm(m, m, 1))              # K, d


def _suffix_counts(L):
    """(full, reduced) combines of the odd-even suffix scan over L."""
    if L == 1:
        return 0, 0
    if L % 2:
        f, r = _suffix_counts(L - 1)
        return f, r + 1
    f, r = _suffix_counts(L // 2)
    return f + L // 2, r + (L // 2 - 1 if L > 2 else 0)


def _prefix_counts(L):
    """(map products, map-vector products) of the odd-even prefix scan
    over L affine maps applied to x0."""
    if L == 1:
        return 0, 1
    if L % 2:
        g, v = _prefix_counts(L - 1)
        return g, v + 1
    g, v = _prefix_counts(L // 2)
    return g + L // 2, v + L // 2 + 1 + (L // 2 - 1)


def count(config: dict, traffic: dict, batch: int = None) -> list:
    """``[(stage, flops, bytes)]`` of one batched solve."""
    n, m, N = config["nstates"], config["ninputs"], config["nhorizon"]
    B = batch or traffic["batch"]
    w = {"float32": 4, "float64": 8}[config["dtype"]]
    s = traffic.get("stage_params", {}).get("chunk", 1)
    tri = n * (n + 1) // 2
    prob = n * n + n * m + 2 * n + 2 * m + n  # A, B, f, q, r, Qdiag, Rdiag
    full_elem = n * n + 2 * tri + 2 * n        # F, C, J, c, eta
    out = []

    def add(name, flops, elems):
        out.append((name, float(flops) * B, float(elems) * w * B))

    if s >= 2:
        C = N // s
        # Leaves: B R^-1 and c = f - B R^-1 r from A, B, f, r, Rdiag.
        add("leaves", N * (n * m + _mm(n, m, 1) + n),
            N * (n * m + n + 2 * m) + N * (n * m + n))
        leaf_elem = n * n + 2 * n * m + 3 * n      # A, B R^-1, B', c, q, Qd
        add("fold", C * (_leaf_pair(n, m) + (s - 2) * _leaf_full(n, m)),
            N * leaf_elem + C * full_elem)
        f, r = _suffix_counts(C)
        add("tree", f * _full(n, m) + r * _reduced(n, m),
            C * full_elem + C * (n + tri))
        add("downsweep", N * _reduced_leaf_gains(n, m),
            N * (leaf_elem + 2 * m) + C * (n + tri)
            + N * (tri + n + m * n + m))
        g, v = _prefix_counts(C)
        add("rollout",
            (N - 1) * (_mm(n, m, n) + n * n + _mm(n, m, 1) + n)  # Phi, t
            + C * (s - 1) * (_mm(n, n, n) + _mm(n, n, 1) + n)    # compose
            + g * (_mm(n, n, n) + _mm(n, n, 1) + n)
            + v * (_mm(n, n, 1) + n)
            + N * (_mm(n, n, 1) + n),                             # interior
            N * (n * n + n * m + m * n + m + n) + n + N * n)
    else:
        add("elements", N * (_mm(n, m, n) / 2 + n * m + _mm(n, m, 1) + n),
            N * prob + N * (tri + n))
        f, r = _suffix_counts(N)
        add("scan", f * _full(n, m) + r * _reduced(n, m),
            N * (n * n + n + tri + 2 * n) + N * (tri + n))
        add("gains", N * (_mm(m, n, n) + _sym(m, n) + _mm(m, n, n)
                          + 2 * _mm(n, n, 1) + _mm(m, n, 1)
                          + m ** 3 / 3 + 2 * m * m * (n + 1)),
            N * prob + N * (tri + n) + N * (m * n + m))
        g, v = _prefix_counts(N - 1)
        add("rollout",
            (N - 1) * (_mm(n, m, n) + n * n + _mm(n, m, 1) + n)
            + g * (_mm(n, n, n) + _mm(n, n, 1) + n) + v * (_mm(n, n, 1) + n),
            N * (n * n + n * m + m * n + m + n) + n + N * n)
    # The solution: u = K x + d, y = P x + p, written as the KKT vector.
    add("outputs", N * (_mm(m, n, 1) + m + _mm(n, n, 1) + n),
        N * (m * n + m + tri + n + n) + N * (2 * n + m))
    return out
