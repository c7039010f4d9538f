"""Operations and bytes of one batched rsLQR solve, stage by stage, from
the algorithm (upstream ``solve.c`` and ``nested_dissection.c``) at the
cell's shapes, whatever kernels implement it.

N knots (a power of two), depth ``D = log2 N``; level ``l`` has
``G = N / 2^(l+1)`` separators. The factor slabs hold, per knot and
level, ``F_lambda`` (n x n), ``F_x`` (n x n) and ``F_u`` (m x n). Stages:

* ``leaf``: every knot's diagonal leaf solve (``Q^-1 A'``, ``R^-1 B'``,
  ``-Q^-1``; knot 0's blocks): reads A, B, Qdiag, Rdiag, writes those
  blocks.
* per level ``l``: ``products`` (each separator's inner products with its
  own and every upper level's factors: ``A F_x + B F_u - F_x - F_lambda``),
  ``cholesky`` (of the level's n x n separator blocks), ``cholsolve`` (the
  factor solved against every upper level's block), ``schur`` (every knot's
  upper-level slabs less ``F_l f_u``, the lambda rows of the positions that
  ``calc_lambda`` masks left out).
* per level ``l``: ``rhs`` (the separator's inner product with the right
  side, its solve with the cached factor, every knot's right side less
  ``F_l zbar``), after the leaf transform of the right side (``rhs_leaf``).

Each stage counts its inputs read once and its outputs written once;
the FLOPs are those of its math (a product ``a x k`` by ``k x b`` is
``2abk``; a Cholesky ``n^3 / 3``). Structural zeros are left out where the
algorithm fixes them: the level-0 ``schur`` reads only the upper-level
blocks that the leaf stage wrote (every other one is still zero), and the
masked lambda rows are neither read nor written.
"""


def _level(k: int) -> int:
    """The tree level of separator knot ``k``: its trailing one bits."""
    lv = 0
    while k & 1:
        k >>= 1
        lv += 1
    return lv


def count(config: dict, traffic: dict, batch: int = None) -> list:
    """``[(stage, flops, bytes)]`` of one batched solve."""
    n, m, N = config["nstates"], config["ninputs"], config["nhorizon"]
    B = batch or traffic["batch"]
    w = {"float32": 4, "float64": 8}[config["dtype"]]
    D = N.bit_length() - 1
    if 1 << D != N:
        raise ValueError(f"N={N} is not a power of two")
    tri = n * (n + 1) // 2
    out = []

    def add(name, flops, elems):
        out.append((name, float(flops) * B, float(elems) * w * B))

    # Leaf solves: reads A, B, Qdiag, Rdiag; writes F_x (Q^-1 A') and F_u
    # (R^-1 B') of knots 1..N-2, the diagonal -Q^-1 of knots 1..N-1, knot 0's
    # F_lambda (-A_0') and F_u.
    inner = max(N - 2, 0)
    add("leaf", inner * (n * n + n * m) + (N - 1) * n + n * m,
        N * (n * n + n * m + n + m)
        + inner * (n * n + n * m) + (N - 1) * n + n * n + n * m)
    # Right side leaf transform: reads x0, f, q, r, Qdiag, Rdiag, writes z.
    add("rhs_leaf", N * (n + m) + 2 * n,
        n + N * (2 * n + m) + N * (n + m) + N * (2 * n + m))

    for l in range(D):
        G = N >> (l + 1)
        U = D - l - 1  # upper levels
        kept = N - 2 * G + 1  # lambda rows calc_lambda keeps
        rows = kept * n + N * (n + m)  # rows of F_l (and of each F_u)
        add(f"products.L{l}", (U + 1) * G * (2 * n ** 3 + 2 * n * n * m
                                             + 2 * n * n),
            G * (n * n + n * m) + (U + 1) * G * (4 * n * n + m * n))
        add(f"cholesky.L{l}", G * n ** 3 / 3, 2 * G * tri)
        if U:
            add(f"cholsolve.L{l}", U * G * 2 * n ** 3,
                G * tri + 2 * U * G * n * n)
            if l == 0:
                # Upper-level blocks the leaf stage wrote, read before the
                # update; every other upper block is written only.
                reads = 0
                for k in range(N):
                    if 1 <= k < N - 1 and _level(k) >= 1:
                        reads += n * n + m * n
                    if k >= 1 and _level(k - 1) >= 1:
                        reads += n * n
                upper = reads + U * rows * n
            else:
                upper = 2 * U * rows * n
            add(f"schur.L{l}", U * rows * (2 * n * n + n),
                rows * n + U * G * n * n + upper)
        # Right side: inner product and solve per separator, then every
        # knot's rows less F_l zbar.
        add(f"rhs.L{l}",
            G * (2 * n * n + 2 * n * m + 2 * n + 2 * n * n)
            + (kept + N) * 2 * n * n + N * m * 2 * n,
            rows * n + G * (tri + n * n + n * m)
            + 2 * (kept * n + N * (n + m)))
    return out
