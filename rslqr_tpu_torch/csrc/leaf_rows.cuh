// The fused leaf of the small-block sweep on row groups: every tree level's
// leaf factor values, the level-0 Schur update of every upper slab and the
// level-1 products, in one pass.
//
//   leaf_row_kernel <- rslqr_tpu/ops/schur_pallas.py:leaf_schur_level0_em
//                      (B3, schur_kernels.cu, Lay = GroupMajor) and
//                      rslqr_tpu/ops/schur_planes.py:leaf_schur_level0_flat
//                      (B11, flat_kernels.cu, Lay = ElementMajor)
//
// Per knot k (element-major [e, N, B] slab planes; ndlqr_SolveLeaf,
// nested_dissection.c:10-105; level(k) = trailing zeros of k + 1,
// binary_tree.c:65-73), the level-L leaf values are
//   fx_L = (own_L ? Q^-1 A' : 0) - (prev_L ? Q^-1 : 0),
//   fu_L = ownu_L ? R^-1 B' : 0,   fl_0 = k == 0 ? -A' : 0.
// Slab 0 is (fl_0, fx_0, fu_0), with level 0's own Sbar S0 at the level-0
// sep+1 rows (odd k). Each upper slab u = 1 .. depth - 1 starts at
// (0, fx_u, fu_u) and takes the level-0 update by the solved separator f of
// k's group, f = fsol[u - 1]:
//   l = odd ? f : (k == 0 ? -(fl_0 @ f) : 0);  x = fx_u - fx_0 @ f;
//   u = fu_u - fu_0 @ f.
// The level-1 products S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] - l[r+1]
// (ndlqr_FactorInnerProduct, nested_dissection.c:114-134) are emitted at
// r = 4g + 1 for every upper slab and folded into slab 1's lambda rows of
// r + 1 (l[r+1] is zero on every upper slab: r + 1 is even and not 0).
//
// What bounds it: bytes. It writes depth slab trios (2n + m rows of n per
// knot and batch column; ~72% of the bytes at (6, 3)) against ~n FMAs per
// element, and reads the problem data and each slab's solved separators
// once. Mapping: B1's row groups (row_groups.cuh) on the pair kernel's
// plan (ops/schur.py:_level_plan with emit and pair: shift 1, so each pair
// (r, r + 1) shares a block; at the wide tag 8 slots). A thread owns RPT = 3
// rows of one slab (lambda, x or u) at one (knot, batch column). Row i's
// leaf values need only column i of A (x rows) or of B (u rows) and entry
// i of Q^-1 or R^-1, so the thread loads those 3n values once; they are the
// level-0 multiplier rows where the knot owns level 0, and a knot owns at
// most one other level, whose values the column loop reads again. The
// columns run at run time, so that the thread holds its 3n values and one
// column of f and nothing more. After a level-0 separator (odd k) the
// x rows' multiplier is -Q^-1 on the diagonal: one element of f per row,
// and the u rows' is zero: no f. Every output element is computed in
// registers and stored once (TB = 32 batch columns per warp: coalesced
// 128-byte lines); f is read by all the column's threads through L1.
//
// Emission: after one __syncthreads() every thread of a block whose second
// knot is r + 1 takes (row group, slab) items of r + 1's products, reading
// x[r], u[r] and x[r + 1] back from L1/L2, with its A_sep rows (and B_sep's
// where they are few) held as values. Without the emission the pass takes
// 0.40 of its 0.56 ms at (6, 3) on an H100 at 700 W (PERF.md §6).
//
// Registers: capped as B1's, about 30 warps per SM at (6, 3) (64); 80 at
// the (4, 4) capacity, 96 at (8, 8); one block of 512 threads at the wide
// tag, whose rows spill under the 64 registers of 1,024 threads (a cap
// that ran 1.4x faster with 64 bytes of stack). No instantiation spills.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "row_groups.cuh"
#include "small_blocks.cuh"

namespace small_blocks {

// Which leaf values knot k has at level L.
struct LeafMask {
  bool own, prev, ownu;
};

__device__ __forceinline__ LeafMask leaf_mask(int L, int k, int N) {
  const int mask = (2 << L) - 1;
  LeafMask lm;
  lm.own = ((k + 1) & mask) == (1 << L) && k >= 1 && k < N - 1;
  lm.prev = (k & mask) == (1 << L);
  lm.ownu = lm.own || (L == 0 && k == 0);
  return lm;
}

// The x (``xrows``) or u rows i0 .. of every slab at this knot. ``src`` is
// A (n x n) or B (n x m), ``cols`` its column count (the slab's rows),
// ``scale`` Q^-1 or R^-1: w[q][j] = src[j][i] * scale[i] holds row i of the
// level-0 multiplier where the knot owns level 0; the level-L value of a
// knot that owns level L > 0 reads its column c of src again (one level a
// knot), so that the column loop runs at run time and holds no more.
template <int NP, class Lay>
__device__ __forceinline__ void leaf_value_rows(
    const float* __restrict__ src, const float* __restrict__ scale,
    bool xrows, const Ptrs& out, const CPtrs& fsol, int depth, int i0,
    const bool (&row_ok)[RPT], int cols, int n, int k, int N, int g, int G,
    int B, const RowSite& s) {
  float w[RPT][NP], sc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    sc[q] = row_ok[q] ? scale[(i0 + q) * s.plane + s.idx] : 0.0f;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      w[q][j] = row_ok[q] && j < n
                    ? src[(j * cols + i0 + q) * s.plane + s.idx] * sc[q]
                    : 0.0f;
  // The level-0 multiplier rows (fx_0 or fu_0): w itself where the knot
  // owns level 0 (even knots; u rows also at knot 0), -Q^-1 on the
  // diagonal after a level-0 separator (odd knots, x rows), else zero.
  const LeafMask l0 = leaf_mask(0, k, N);
  const bool own0 = xrows ? l0.own : l0.ownu, prev0 = xrows && l0.prev;
  for (int u = 0; u < depth; ++u) {
    const LeafMask lu = leaf_mask(u, k, N);
    const bool own = xrows ? lu.own : lu.ownu, prev = xrows && lu.prev;
    float* o = out.p[u];
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      // (M_0 @ f)[i, c], summed in order (a diagonal M_0 adds exact zeros
      // to its one product, so that product alone is the sum).
      float acc[RPT] = {};
      if (u > 0 && own0) {
        float fc[NP];
        load_fcol<NP, Lay>(fc, fsol.p[u - 1], c, n, g, G, B, s.b);
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] = row_dot<NP>(w, q, fc);
      } else if (u > 0 && prev0) {
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          if (row_ok[q])
            acc[q] = -sc[q] * fsol.p[u - 1][Lay::at((i0 + q) * n + c, g,
                                                    n * n, G, B, s.b)];
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (!row_ok[q]) continue;
        const int i = i0 + q;
        // fx_L or fu_L at (i, c): own ? src[c][i] * scale[i] : 0, less
        // Q^-1 on the diagonal where prev.
        float v = own ? src[(c * cols + i) * s.plane + s.idx] * sc[q] : 0.0f;
        if (c == i) v -= prev ? sc[q] : 0.0f;
        o[(i * n + c) * s.plane + s.idx] = u > 0 ? v - acc[q] : v;
      }
    }
  }
}

// The lambda rows i0 .. of every slab at this knot: S0's rows (slab 0) or
// f's (upper slabs) at odd knots; -A' and -(-A' @ f) at knot 0; zero at
// the other even knots, except slab 1 at r + 1 (k = 4g + 2), which the
// product emission writes.
template <int NP, class Lay>
__device__ __forceinline__ void leaf_lambda_rows(
    const float* __restrict__ A, const float* __restrict__ S0,
    const Ptrs& Fls, const CPtrs& fsol, int depth, int i0,
    const bool (&row_ok)[RPT], int n, int k, int g, int G, int B,
    const RowSite& s) {
  for (int u = 0; u < depth; ++u) {
    float* o = Fls.p[u];
    if (k & 1) {
      put_rows<NP, Lay>(o, u == 0 ? S0 : fsol.p[u - 1], i0, row_ok, n, g, G,
                        B, s);
      continue;
    }
    if (u == 1 && (k & 3) == 2) continue;
    if (k != 0) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
#pragma unroll
        for (int c = 0; c < NP; ++c)
          if (row_ok[q] && c < n)
            o[((i0 + q) * n + c) * s.plane + s.idx] = 0.0f;
      continue;
    }
    // Knot 0: fl_0 = -A' (slab 0), -(fl_0 @ f) (upper slabs).
    float w[RPT][NP];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        w[q][j] = row_ok[q] && j < n
                      ? -A[(j * n + i0 + q) * s.plane + s.idx]
                      : 0.0f;
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      float fc[NP];
      if (u > 0) load_fcol<NP, Lay>(fc, fsol.p[u - 1], c, n, g, G, B, s.b);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (!row_ok[q]) continue;
        const float v = u > 0 ? 0.0f - row_dot<NP>(w, q, fc)
                              : -A[(c * n + i0 + q) * s.plane + s.idx];
        o[((i0 + q) * n + c) * s.plane + s.idx] = v;
      }
    }
  }
}

// Rows i0 .. of the products of upper slab u at the emitting knot r + 1
// (site e): S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] (l[r+1] is zero),
// into Sout and, on slab 1, into the lambda rows. The rows of A_sep (and
// of B_sep below the wide tag) are held as values, not addresses.
template <class K, class Lay, bool WHOLE>
__device__ __forceinline__ void leaf_emit(
    int i0, const float* xs, const float* us, float* ls, float* so,
    bool fold, const float* __restrict__ Asep,
    const float* __restrict__ Bsep, int g2, int G2, int B, int n, int m,
    const RowSite& e) {
  // B_sep's rows are held as values where they are few (NP <= 6); at the
  // (8, 8) capacity and the wide tag they are read per use.
  constexpr bool HOLD_B = !K::WIDE && K::NP <= 6;
  constexpr int NP = K::NP, MP = HOLD_B ? K::MP : 1;
  const int nn = n * n;
  const size_t ir = e.idx - B;  // knot r
  bool row_ok[RPT];
  float a[RPT][NP], bm[RPT][MP];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    row_ok[q] = WHOLE || i0 + q < n;
    const int i = row_ok[q] ? i0 + q : 0;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      a[q][j] = j < n ? Asep[Lay::at(i * n + j, g2, nn, G2, B, e.b)] : 0.0f;
#pragma unroll
    for (int j = 0; j < MP; ++j)
      bm[q][j] = HOLD_B && j < m
                     ? Bsep[Lay::at(i * m + j, g2, n * m, G2, B, e.b)]
                     : 0.0f;
  }
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    float xr[NP], acc[RPT];
#pragma unroll
    for (int j = 0; j < NP; ++j)
      xr[j] = j < n ? xs[(j * n + c) * e.plane + ir] : 0.0f;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      acc[q] = a[q][0] * xr[0];
#pragma unroll
      for (int j = 1; j < NP; ++j)
        if (j < n) acc[q] = fmaf(a[q][j], xr[j], acc[q]);
    }
    if constexpr (!HOLD_B) {
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float uj = us[(j * n + c) * e.plane + ir];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int i = row_ok[q] ? i0 + q : 0;
          acc[q] = fmaf(Bsep[Lay::at(i * m + j, g2, n * m, G2, B, e.b)], uj,
                        acc[q]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        if (j >= m) continue;
        const float uj = us[(j * n + c) * e.plane + ir];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] = fmaf(bm[q][j], uj, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (!row_ok[q]) continue;
      const int el = (i0 + q) * n + c;
      const float v = acc[q] - xs[el * e.plane + e.idx];
      so[Lay::at(el, g2, nn, G2, B, e.b)] = v;
      if (fold) ls[el * e.plane + e.idx] = v;
    }
  }
}

template <class K, class Lay>
__global__ void __launch_bounds__(row_pair_threads<K>(),
                                  row_level_min_blocks<K>())
    leaf_row_kernel(const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ qinv,
                    const float* __restrict__ rinv,
                    const float* __restrict__ S0, CPtrs fsol,
                    const float* __restrict__ Asep,
                    const float* __restrict__ Bsep, Ptrs Fls, Ptrs Fxs,
                    Ptrs Fus, Ptrs Sout, int depth, int N, int B, int n_,
                    int m_) {
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  const int NL = groups_of(n);
  const int rgs = 2 * NL + groups_of(m);
  const RowSite s = row_site(N, B, 1);
  const int k = s.k, g = k >> 1, G = N >> 1;
  for (int rg = threadIdx.y; s.live && rg < rgs; rg += blockDim.y) {
    const int slab = rg < NL ? 0 : (rg < 2 * NL ? 1 : 2);
    const int i0 = (rg - slab * NL) * RPT;
    const int rows = slab == 2 ? m : n;
    bool row_ok[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < rows;
    if (slab == 0)
      leaf_lambda_rows<NP, Lay>(A, S0, Fls, fsol, depth, i0, row_ok, n, k, g,
                                G, B, s);
    else if (slab == 1)
      leaf_value_rows<NP, Lay>(A, qinv, true, Fxs, fsol, depth, i0, row_ok,
                               n, n, k, N, g, G, B, s);
    else
      leaf_value_rows<NP, Lay>(Bm, rinv, false, Fus, fsol, depth, i0,
                               row_ok, m, n, k, N, g, G, B, s);
  }
  // The block's second knot is r + 1 of a level-1 group: its products.
  const int k1 = (int)blockIdx.y * LKB;
  if ((k1 & 3) != 2 || k1 >= N) return;  // the same for the whole block
  __syncthreads();
  RowSite e = s;
  e.k = k1;
  e.live = s.b < B;
  e.idx = e.live ? (size_t)k1 * B + s.b : 0;
  if (!e.live) return;
  const int items = NL * (depth - 1);
  const int step = blockDim.y * blockDim.z;
  for (int it = threadIdx.z * blockDim.y + threadIdx.y; it < items;
       it += step) {
    const int rg = it % NL, u = 1 + it / NL;
    leaf_emit<K, Lay, WHOLE>(rg * RPT, Fxs.p[u], Fus.p[u], Fls.p[u],
                             Sout.p[u - 1], u == 1, Asep, Bsep, k1 >> 2,
                             N >> 2, B, n, m, e);
  }
}

// The plan's checks: the emitting plan at level 0 (ops/schur.py:
// _level_plan with emit), depth slabs, at least one level-1 group.
inline bool leaf_plan_ok(int depth, int N, int n, int m, int shift, int gy,
                         int rgs) {
  return depth >= 2 && (N >> 2) >= 1 &&
         row_plan_ok(depth, N, 0, 1, n, m, shift, gy, rgs);
}

// Launch leaf_row_kernel on the plan (gy rows of LKB knots from knot -1;
// the pair kernel's slots).
template <class K, class Lay>
int launch_leaf_rows(const float* A, const float* Bm, const float* qinv,
                     const float* rinv, const float* S0, void* const* fsol,
                     const float* Asep, const float* Bsep, void* const* Fls,
                     void* const* Fxs, void* const* Fus, void* const* S,
                     int depth, int N, int B, int n, int m, int gy,
                     cudaStream_t st) {
  const dim3 grid((B + TB - 1) / TB, gy),
      block(TB, pair_slots_of(n, m, K::WIDE), LKB);
  leaf_row_kernel<K, Lay><<<grid, block, 0, st>>>(
      A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep, ptrs(Fls), ptrs(Fxs),
      ptrs(Fus), ptrs(S), depth, N, B, n, m);
  return 0;
}

}  // namespace small_blocks
