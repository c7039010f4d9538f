// The Schur updates of the small-block sweep on row groups: one tree level
// of every upper slab, or two levels in one pass.
//
//   row_level_kernel <- rslqr_tpu/ops/schur_pallas.py:schur_update_level_em
//                       (B1, schur_kernels.cu, every block size; bf16
//                       slabs: bf16_rows.cuh) and
//                       rslqr_tpu/ops/schur_planes.py:schur_update_level_flat
//                       (B10, flat_kernels.cu, the wide blocks)
//   row_pair_kernel  <- rslqr_tpu/ops/schur_pallas.py:schur_update_pair_em
//                       (B4, schur_kernels.cu, every block size)
//
// Per upper slab u and knot k (element-major [e, N, B] slab planes):
//   l = sep ? f : (keep ? l - ML @ f : l);  x -= MX @ f;  u -= MU @ f
// with f the solved separator of k's group, and at an emitting level the
// next level's products
//   S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] - l[r+1]
// (ndlqr_FactorInnerProduct, nested_dissection.c:114-134) at each
// next-level group's separator row r and the row r + 1 after it, folded into
// the lambda rows of r + 1 on the next level's own slab (u = 0; the level
// leaves those rows unchanged). The layout ``Lay`` indexes the compacts
// (solved separators, A_sep, B_sep, S): group-major [G, e, B] for B1 and B4,
// element-major [e, G, B] for B10.
//
// What bounds it: bytes (~0.4 FLOP per byte: every upper slab is read and
// written once against ~n FMAs per element). Mapping: a thread owns RPT = 3
// rows of one slab (lambda, x or u) at one (knot, batch column), and holds
// only those rows of the level-L multiplier (3n floats) for every upper
// slab; a thread that held all 2n + m rows needed 221-255 registers at (6, 3)
// and left 8 warps per SM. A slab of r rows has ceil(r / 3) row groups;
// rows past r in its last group are masked (none at (6, 3)). A block is
// TB = 32 batch columns (one warp per row group and knot: coalesced
// 128-byte lines) by up to SLOTS = 16 row groups (8 for the pair kernel's
// wide tag) by LKB = 2 knots, so at most 1,024 threads; a knot with more row
// groups (n <= 8 < m) loops over them. Registers are capped so that about
// 30 warps fit an SM at (6, 3) (24 for the pair kernel). The products are
// summed before they are subtracted, as the reference and the plain version
// sum them.
//
// The pair kernel (levels L and L+1): a row group first updates its rows of
// slab L+1 at level L (and folds the level-(L+1) Sbar into its lambda rows
// at level-(L+1) separators) and keeps the new rows in registers: they are
// the level-(L+1) multiplier's rows. An upper slab's row i at level L+1 reads
// only row i of slab L+1 at its own knot ((M2 @ f2)[i, c] = sum_j M2[i, j]
// f2[j, c]), and the same thread just wrote it, so no value crosses threads
// between the two levels and no barrier is needed there; each upper slab is
// then read and written once for both levels.
//
// Emission: knot tiles are shifted by one (the plan's ``shift``), so a
// block holds the pair (r, r + 1), r odd. After every row group's update of
// every upper slab, one __syncthreads() makes the new x and u rows of r and
// the x rows of r + 1 visible to the block, and the lambda row groups of
// r + 1 form their rows of S for each upper slab from device memory
// (L1/L2); u[r] is read one row at a time, so m adds no registers.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "small_blocks.cuh"

namespace small_blocks {

constexpr int RPT = 3;     // slab rows per thread
constexpr int LKB = 2;     // knots per block (ops/schur.py:_level_plan)
constexpr int SLOTS = 16;  // row-group slots per knot and block

// Row groups of a slab of ``rows`` rows (ops/schur.py:_row_groups).
__host__ __device__ constexpr int groups_of(int rows) {
  return (rows + RPT - 1) / RPT;
}

// Row-group slots of a block: one per row group, at most SLOTS.
__host__ __device__ constexpr int slots_of(int n, int m) {
  return 2 * groups_of(n) + groups_of(m) < SLOTS
             ? 2 * groups_of(n) + groups_of(m)
             : SLOTS;
}

template <class K>
__host__ __device__ constexpr int row_level_threads() {
  return TB * LKB * slots_of(K::NP, K::WIDE ? MAX_INPUT_DIM : K::MP);
}

// Blocks per SM the register cap aims at: 30 warps at (6, 3).
template <class K>
__host__ __device__ constexpr int row_level_min_blocks() {
  return 960 / row_level_threads<K>() > 1 ? 960 / row_level_threads<K>()
                                          : 1;
}

// The pair kernel's slots: as the level kernel's, but 8 at the wide tag, so
// that its second set of multiplier rows fits the register cap of 512
// threads (1,024 would leave 64 registers).
constexpr int PAIR_WIDE_SLOTS = 8;

__host__ __device__ constexpr int pair_slots_of(int n, int m, bool wide) {
  return wide && slots_of(n, m) > PAIR_WIDE_SLOTS ? PAIR_WIDE_SLOTS
                                                  : slots_of(n, m);
}

template <class K>
__host__ __device__ constexpr int row_pair_threads() {
  return TB * LKB *
         pair_slots_of(K::NP, K::WIDE ? MAX_INPUT_DIM : K::MP, K::WIDE);
}

// 24 warps per SM at (6, 3): two sets of multiplier rows.
template <class K>
__host__ __device__ constexpr int row_pair_min_blocks() {
  return 768 / row_pair_threads<K>() > 1 ? 768 / row_pair_threads<K>() : 1;
}

// Element e of group g of a compact array of E elements per group, G groups.
struct GroupMajor {  // [G, E, B]
  __device__ static size_t at(int e, int g, int E, int G, int B, int b) {
    return ((size_t)g * E + e) * B + b;
  }
};
struct ElementMajor {  // [E, G, B]
  __device__ static size_t at(int e, int g, int E, int G, int B, int b) {
    return ((size_t)e * G + g) * B + b;
  }
};

// The site of a row-group thread: batch column b, knot k (the block's knot
// pair starts at knot blockIdx.y * LKB - shift), and its offset in a plane.
struct RowSite {
  int b, k;
  bool live;
  size_t plane, idx;
};

__device__ __forceinline__ RowSite row_site(int N, int B, int shift) {
  RowSite s;
  s.b = blockIdx.x * TB + threadIdx.x;
  s.k = blockIdx.y * LKB - shift + (int)threadIdx.z;
  s.live = s.b < B && s.k >= 0 && s.k < N;
  s.plane = (size_t)N * B;
  s.idx = s.live ? (size_t)s.k * B + s.b : 0;
  return s;
}

// Rows i0 .. i0 + RPT - 1 of a slab M (n columns) at this knot, zero past
// the slab's rows (row_ok) and past n.
template <int NP>
__device__ __forceinline__ void load_rows(float (&r)[RPT][NP], const float* M,
                                          int i0, const bool (&row_ok)[RPT],
                                          int n, const RowSite& s) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      r[q][j] = row_ok[q] && j < n
                    ? M[((i0 + q) * n + j) * s.plane + s.idx]
                    : 0.0f;
}

// Where the products of one slab read the f32 rows of knots r and r + 1
// (``e`` the site of r + 1; f32 slabs, which hold them as computed; the
// bf16 kernels stage them, bf16_rows.cuh): element 0 of x and u at r and
// of x at r + 1, ``es`` apart.
struct EmitRows {
  const float *xr, *ur, *x1;
  size_t es;
};

__device__ __forceinline__ EmitRows emit_src(const float* xs, const float* us,
                                             int B, const RowSite& e) {
  EmitRows r;
  r.es = e.plane;
  r.xr = xs + e.idx - B;
  r.ur = us + e.idx - B;
  r.x1 = xs + e.idx;
  return r;
}

// Column c of the solved separator f (n x n) of group g, zero past n.
template <int NP, class Lay>
__device__ __forceinline__ void load_fcol(float (&fc)[NP], const float* f,
                                          int c, int n, int g, int G, int B,
                                          int b) {
#pragma unroll
  for (int j = 0; j < NP; ++j)
    fc[j] = j < n ? f[Lay::at(j * n + c, g, n * n, G, B, b)] : 0.0f;
}

// (rows @ fc)[q] for the thread's rows, summed in order.
template <int NP>
__device__ __forceinline__ float row_dot(const float (&r)[RPT][NP], int q,
                                         const float (&fc)[NP]) {
  float acc = r[q][0] * fc[0];
#pragma unroll
  for (int j = 1; j < NP; ++j) acc = fmaf(r[q][j], fc[j], acc);
  return acc;
}

// Rows i0 .. of the solved separator f (group g) written to ``out``.
template <int NP, class Lay>
__device__ __forceinline__ void put_rows(float* out, const float* f, int i0,
                                         const bool (&row_ok)[RPT], int n,
                                         int g, int G, int B,
                                         const RowSite& s) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (!row_ok[q] || c >= n) continue;
      const int e = (i0 + q) * n + c;
      out[e * s.plane + s.idx] = f[Lay::at(e, g, n * n, G, B, s.b)];
    }
}

// The products of one emitting knot r + 1 (this thread's site), for the
// lambda row groups (rows i0 ..) of slabs u0 .. U - 1: S_u -> Sout[u - u0]
// at group g2 of G2, folded into slab u0's lambda rows. Called after a
// barrier that made every row of knots r and r + 1 visible.
template <int NP, class Lay, bool WHOLE>
__device__ __forceinline__ void emit_rows(
    int rg0, int rgstep, int NL, const Ptrs& Fls, const Ptrs& Fxs,
    const Ptrs& Fus, const Ptrs& Sout, int u0, int U,
    const float* __restrict__ Asep, const float* __restrict__ Bsep, int g2,
    int G2, int B, int n, int m, const RowSite& s) {
  const int nn = n * n;
  for (int rg = rg0; rg < NL; rg += rgstep) {
    const int i0 = rg * RPT;
    bool row_ok[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < n;
    for (int u = u0; u < U; ++u) {
      const EmitRows src = emit_src(Fxs.p[u], Fus.p[u], B, s);
      float* ls = Fls.p[u];
      float* so = Sout.p[u - u0];
#pragma unroll 1
      for (int c = 0; c < n; ++c) {
        float xr[NP], acc[RPT];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          xr[j] = j < n ? src.xr[(j * n + c) * src.es] : 0.0f;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = row_ok[r] ? i0 + r : 0;
          acc[r] = Asep[Lay::at(i * n, g2, nn, G2, B, s.b)] * xr[0];
#pragma unroll
          for (int j = 1; j < NP; ++j)
            if (j < n)
              acc[r] = fmaf(Asep[Lay::at(i * n + j, g2, nn, G2, B, s.b)],
                            xr[j], acc[r]);
        }
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const float uj = src.ur[(j * n + c) * src.es];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const int i = row_ok[r] ? i0 + r : 0;
            acc[r] = fmaf(Bsep[Lay::at(i * m + j, g2, n * m, G2, B, s.b)],
                          uj, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (!row_ok[r]) continue;
          const int e = (i0 + r) * n + c;
          const float v =
              acc[r] - src.x1[e * src.es] - ls[e * s.plane + s.idx];
          so[Lay::at(e, g2, nn, G2, B, s.b)] = v;
          if (u == u0) ls[e * s.plane + s.idx] = v;
        }
      }
    }
  }
}

template <class K, bool EMIT, class Lay>
__global__ void __launch_bounds__(row_level_threads<K>(),
                                  row_level_min_blocks<K>())
    row_level_kernel(const float* __restrict__ FLl,
                     const float* __restrict__ FLx,
                     const float* __restrict__ FLu, Ptrs Fls, Ptrs Fxs,
                     Ptrs Fus, CPtrs fsol, const float* __restrict__ Asep,
                     const float* __restrict__ Bsep, Ptrs Sout, int U, int N,
                     int B, int level, int shift, int n_, int m_) {
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  // Every row group whole: nothing to mask.
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  const int NL = groups_of(n);  // lambda (and x) row groups
  const int rgs = 2 * NL + groups_of(m);
  const RowSite s = row_site(N, B, shift);
  const int k = s.k;
  const int half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  const int g = k >> (level + 1), G = N >> (level + 1);
  const int span = 2 << level;  // next-level groups are 2 span knots
  const int g2 = k >> (level + 2), G2 = N >> (level + 2);
  for (int rg = threadIdx.y; rg < rgs; rg += blockDim.y) {
    // This thread's slab (0 lambda, 1 x, 2 u), its first row there, and
    // which of its RPT rows the slab has.
    const int slab = rg < NL ? 0 : (rg < 2 * NL ? 1 : 2);
    const int i0 = (rg - slab * NL) * RPT;
    const int rows = slab == 2 ? m : n;
    bool row_ok[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < rows;
    const bool lam = slab == 0;
    const bool upd = s.live && !(lam && (sep || !keep));  // reads M's rows
    const bool put = s.live && lam && sep;                // writes f's rows
    float mrow[RPT][NP];
    if (upd)
      load_rows<NP>(mrow, slab == 0 ? FLl : (slab == 1 ? FLx : FLu), i0,
                    row_ok, n, s);
    for (int u = 0; u < U; ++u) {
      const float* fu = fsol.p[u];
      float* out = slab == 0 ? Fls.p[u] : (slab == 1 ? Fxs.p[u] : Fus.p[u]);
      if (upd) {
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          if (c >= n) continue;
          float fc[NP], v[RPT];
          load_fcol<NP, Lay>(fc, fu, c, n, g, G, B, s.b);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            v[r] = row_ok[r] ? out[((i0 + r) * n + c) * s.plane + s.idx]
                             : 0.0f;
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float acc = row_dot<NP>(mrow, r, fc);
            if (!row_ok[r]) continue;
            const int e = (i0 + r) * n + c;
            out[e * s.plane + s.idx] = v[r] - acc;
          }
        }
      } else if (put) {
        put_rows<NP, Lay>(out, fu, i0, row_ok, n, g, G, B, s);
      }
    }
  }
  if constexpr (EMIT) {
    __syncthreads();
    if (!s.live || (k & (2 * span - 1)) != span) return;  // knot r + 1 only
    emit_rows<NP, Lay, WHOLE>(threadIdx.y, blockDim.y, NL, Fls, Fxs, Fus,
                              Sout, 0, U, Asep, Bsep, g2, G2, B, n, m, s);
  }
}

// Levels L and L+1 in one pass (see the header). Slab 0 (u = L+1) takes the
// level-L update and, at level-(L+1) separators (sep2), its Sbar2 rows;
// slabs 1 .. U-1 take both levels, the second with slab 0's new rows (held
// in m2) as multiplier; at an emitting level the level-(L+2) products of
// slabs 1 .. U-1 go to Sout[u - 1], folded into slab 1.
template <class K, bool EMIT, class Lay>
__global__ void __launch_bounds__(row_pair_threads<K>(),
                                  row_pair_min_blocks<K>())
    row_pair_kernel(const float* __restrict__ FLl,
                    const float* __restrict__ FLx,
                    const float* __restrict__ FLu, Ptrs Fls, Ptrs Fxs,
                    Ptrs Fus, CPtrs fsol1, const float* __restrict__ Sbar2,
                    CPtrs fsol2, const float* __restrict__ Asep3,
                    const float* __restrict__ Bsep3, Ptrs Sout, int U, int N,
                    int B, int level, int shift, int n_, int m_) {
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  const int NL = groups_of(n);
  const int rgs = 2 * NL + groups_of(m);
  const RowSite s = row_site(N, B, shift);
  const int k = s.k;
  const int half = 1 << level, span = 2 * half, span2 = 2 * span;
  const bool keep1 = (k & (half - 1)) != 0 || k == 0;
  const bool sep1 = (k & (span - 1)) == half;
  const bool keep2 = (k & (span - 1)) != 0 || k == 0;
  const bool sep2 = (k & (span2 - 1)) == span;  // excludes sep1 and keep1
  const int g1 = k >> (level + 1), G1 = N >> (level + 1);
  const int g2 = k >> (level + 2), G2 = N >> (level + 2);
  const int g3 = k >> (level + 3), G3 = N >> (level + 3);
  for (int rg = threadIdx.y; rg < rgs; rg += blockDim.y) {
    if (!s.live) break;
    const int slab = rg < NL ? 0 : (rg < 2 * NL ? 1 : 2);
    const int i0 = (rg - slab * NL) * RPT;
    const int rows = slab == 2 ? m : n;
    bool row_ok[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < rows;
    const bool lam = slab == 0;
    // Level L moves the rows (reads the multiplier's) except lambda rows
    // that calc_lambda skips or the separator overwrites.
    const bool upd1 = !lam || (keep1 && !sep1);
    // Level L+1 reads slab 0's rows as its multiplier's.
    const bool need2 = U > 1 && (!lam || (keep2 && !sep2));
    float mrow[RPT][NP], m2[RPT][NP];
    if (upd1)
      load_rows<NP>(mrow, slab == 0 ? FLl : (slab == 1 ? FLx : FLu), i0,
                    row_ok, n, s);
    // Slab 0 (u = L+1): level L, then Sbar2 at sep2. Its new rows are the
    // level-(L+1) multiplier's as stored.
    float* o0 = slab == 0 ? Fls.p[0] : (slab == 1 ? Fxs.p[0] : Fus.p[0]);
    if (lam && sep2) {
      put_rows<NP, Lay>(o0, Sbar2, i0, row_ok, n, g2, G2, B, s);
    } else if (lam && sep1) {
      put_rows<NP, Lay>(o0, fsol1.p[0], i0, row_ok, n, g1, G1, B, s);
      if (need2) load_rows<NP>(m2, o0, i0, row_ok, n, s);
    } else if (upd1) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (c >= n) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) m2[r][c] = 0.0f;
          continue;
        }
        float fc[NP], v[RPT];
        load_fcol<NP, Lay>(fc, fsol1.p[0], c, n, g1, G1, B, s.b);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          v[r] = row_ok[r] ? o0[((i0 + r) * n + c) * s.plane + s.idx]
                           : 0.0f;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float nv = v[r] - row_dot<NP>(mrow, r, fc);
          m2[r][c] = row_ok[r] ? nv : 0.0f;
          if (row_ok[r]) o0[((i0 + r) * n + c) * s.plane + s.idx] = nv;
        }
      }
    } else if (need2) {  // lambda rows level L leaves as they are
      load_rows<NP>(m2, o0, i0, row_ok, n, s);
    }
    // Upper slabs: level L (multiplier rows mrow, f1), then level L+1
    // (multiplier rows m2, f2).
    for (int u = 1; u < U; ++u) {
      const float* f1 = fsol1.p[u];
      const float* f2 = fsol2.p[u - 1];
      float* out = slab == 0 ? Fls.p[u] : (slab == 1 ? Fxs.p[u] : Fus.p[u]);
      if (lam && sep2) {
        put_rows<NP, Lay>(out, f2, i0, row_ok, n, g2, G2, B, s);
      } else if (!lam || keep2) {
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          if (c >= n) continue;
          float fc1[NP], fc2[NP], v[RPT];
          load_fcol<NP, Lay>(fc2, f2, c, n, g2, G2, B, s.b);
          if (lam && sep1) {
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              v[r] = row_ok[r] ? f1[Lay::at((i0 + r) * n + c, g1, n * n, G1,
                                            B, s.b)]
                               : 0.0f;
          } else {
            load_fcol<NP, Lay>(fc1, f1, c, n, g1, G1, B, s.b);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              v[r] = row_ok[r] ? out[((i0 + r) * n + c) * s.plane + s.idx]
                               : 0.0f;
#pragma unroll
            for (int r = 0; r < RPT; ++r) v[r] -= row_dot<NP>(mrow, r, fc1);
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float acc2 = row_dot<NP>(m2, r, fc2);
            if (!row_ok[r]) continue;
            const int e = (i0 + r) * n + c;
            out[e * s.plane + s.idx] = v[r] - acc2;
          }
        }
      }
      // Lambda rows at the other knots (k a nonzero multiple of 2^(L+1)):
      // neither level moves them (keep1, sep1, keep2 and sep2 all false).
    }
  }
  if constexpr (EMIT) {
    __syncthreads();
    if (!s.live || (k & (2 * span2 - 1)) != span2) return;  // knot r + 1
    emit_rows<NP, Lay, WHOLE>(threadIdx.y, blockDim.y, NL, Fls, Fxs, Fus,
                              Sout, 1, U, Asep3, Bsep3, g3, G3, B, n, m, s);
  }
}

// Launch row_level_kernel on the plan's geometry (ops/schur.py:_level_plan):
// gy rows of LKB knots starting at knot -shift cover every knot; emission
// needs each (odd r, r + 1) pair in one block, so a shift of one; rgs row
// groups cover the 2n + m rows, in slots_of(n, m) slots. f32 slabs; bf16
// slabs run row_level2_kernel (bf16_rows.cuh).
template <class K, class Lay>
int launch_row_level(const void* FLl, const void* FLx, const void* FLu,
                     void* const* Fls, void* const* Fxs, void* const* Fus,
                     void* const* fsol, const float* Asep, const float* Bsep,
                     void* const* S, int U, int N, int B, int level, int emit,
                     int n, int m, int shift, int gy, cudaStream_t st) {
  const dim3 grid((B + TB - 1) / TB, gy), block(TB, slots_of(n, m), LKB);
  const auto ml = static_cast<const float*>(FLl);
  const auto mx = static_cast<const float*>(FLx);
  const auto mu = static_cast<const float*>(FLu);
  if (emit)
    row_level_kernel<K, true, Lay><<<grid, block, 0, st>>>(
        ml, mx, mu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep, Bsep,
        ptrs(S), U, N, B, level, shift, n, m);
  else
    row_level_kernel<K, false, Lay><<<grid, block, 0, st>>>(
        ml, mx, mu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep, Bsep,
        ptrs(S), U, N, B, level, shift, n, m);
  return 0;
}

// Launch row_pair_kernel on the same plan (the pair's slots:
// pair_slots_of). f32 slabs; bf16 slabs run row_pair2_kernel
// (bf16_rows.cuh).
template <class K, class Lay>
int launch_row_pair(const void* FLl, const void* FLx, const void* FLu,
                    void* const* Fls, void* const* Fxs, void* const* Fus,
                    void* const* fsol1, const float* Sbar2,
                    void* const* fsol2, const float* Asep3,
                    const float* Bsep3, void* const* S, int U, int N, int B,
                    int level, int emit, int n, int m, int shift, int gy,
                    cudaStream_t st) {
  const dim3 grid((B + TB - 1) / TB, gy),
      block(TB, pair_slots_of(n, m, K::WIDE), LKB);
  const auto ml = static_cast<const float*>(FLl);
  const auto mx = static_cast<const float*>(FLx);
  const auto mu = static_cast<const float*>(FLu);
  if (emit)
    row_pair_kernel<K, true, Lay><<<grid, block, 0, st>>>(
        ml, mx, mu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol1),
        Sbar2, cptrs(fsol2), Asep3, Bsep3, ptrs(S), U, N, B, level, shift, n,
        m);
  else
    row_pair_kernel<K, false, Lay><<<grid, block, 0, st>>>(
        ml, mx, mu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol1),
        Sbar2, cptrs(fsol2), Asep3, Bsep3, ptrs(S), U, N, B, level, shift, n,
        m);
  return 0;
}

// The plan's checks (the wrapper computes it; a wrong plan is refused).
inline bool row_plan_ok(int U, int N, int level, int emit, int n, int m,
                        int shift, int gy, int rgs) {
  return U >= 0 && U <= MAXU && level >= 0 && (N >> (level + 1)) >= 1 &&
         shift >= 0 && shift < LKB && (long long)gy * LKB - shift >= N &&
         (!emit || shift == 1) && rgs == 2 * groups_of(n) + groups_of(m);
}

// The pair's checks: whole level-(L+1) groups, at least one upper slab,
// whole level-(L+2) groups where it emits.
inline bool pair_plan_ok(int U, int N, int level, int emit, int n, int m,
                         int shift, int gy, int rgs) {
  return U >= 1 && row_plan_ok(U, N, level, emit, n, m, shift, gy, rgs) &&
         (N >> (level + 2)) >= 1 && (!emit || (N >> (level + 3)) >= 1);
}

}  // namespace small_blocks
