// One tree level's Schur update of every upper slab, on row groups.
//
//   row_level_kernel <- rslqr_tpu/ops/schur_pallas.py:schur_update_level_em
//                       (B1, schur_kernels.cu, every block size) and
//                       rslqr_tpu/ops/schur_planes.py:schur_update_level_flat
//                       (B10, flat_kernels.cu, the wide blocks)
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
// (solved separators, A_sep, B_sep, S): group-major [G, e, B] for B1,
// element-major [e, G, B] for B10.
//
// What bounds it: bytes (~0.4 FLOP per byte: every upper slab is read and
// written once against ~n FMAs per element). Mapping: a thread owns RPT = 3
// rows of one slab (lambda, x or u) at one (knot, batch column), and holds
// only those rows of the level-L multiplier (3n floats) for every upper
// slab; a thread that held all 2n + m rows needed 221 registers at (6, 3)
// and left 8 warps per SM. A slab of r rows has ceil(r / 3) row groups;
// rows past r in its last group are masked (none at (6, 3)). A block is
// TB = 32 batch columns (one warp per row group and knot: coalesced
// 128-byte lines) by up to SLOTS = 16 row groups by LKB = 2 knots, so at
// most 1,024 threads; a knot with more row groups (n <= 8 < m) loops over
// them. Registers are capped so that about 30 warps fit an SM at (6, 3).
// The products are summed before they are subtracted, as the reference and
// the plain version sum them.
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
  return 960 / row_level_threads<K>() > 1 ? 960 / row_level_threads<K>() : 1;
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
  const int nn = n * n;
  const int NL = groups_of(n);  // lambda (and x) row groups
  const int rgs = 2 * NL + groups_of(m);
  const int b = blockIdx.x * TB + threadIdx.x;
  const int k = blockIdx.y * LKB - shift + (int)threadIdx.z;
  const bool live = b < B && k >= 0 && k < N;
  const size_t plane = (size_t)N * B;
  const size_t idx = live ? (size_t)k * B + b : 0;
  const int half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  const int g = k >> (level + 1), G = N >> (level + 1);
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
    const bool upd = live && !(lam && (sep || !keep));  // reads M, its rows
    const bool put = live && lam && sep;                // writes f's rows
    float mrow[RPT][NP];
    if (upd) {
      const float* M = slab == 0 ? FLl : (slab == 1 ? FLx : FLu);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < NP; ++j)
          mrow[r][j] = row_ok[r] && j < n
                           ? M[((i0 + r) * n + j) * plane + idx]
                           : 0.0f;
    }
    for (int u = 0; u < U; ++u) {
      const float* fu = fsol.p[u];
      float* out = slab == 0 ? Fls.p[u] : (slab == 1 ? Fxs.p[u] : Fus.p[u]);
      if (upd) {
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          if (c >= n) continue;
          float fc[NP], v[RPT];
#pragma unroll
          for (int j = 0; j < NP; ++j)
            fc[j] = j < n ? fu[Lay::at(j * n + c, g, nn, G, B, b)] : 0.0f;
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            v[r] = row_ok[r] ? out[((i0 + r) * n + c) * plane + idx] : 0.0f;
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            float acc = mrow[r][0] * fc[0];
#pragma unroll
            for (int j = 1; j < NP; ++j) acc = fmaf(mrow[r][j], fc[j], acc);
            if (row_ok[r]) out[((i0 + r) * n + c) * plane + idx] = v[r] - acc;
          }
        }
      } else if (put) {
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < NP; ++c) {
            if (!row_ok[r] || c >= n) continue;
            const int e = (i0 + r) * n + c;
            out[e * plane + idx] = fu[Lay::at(e, g, nn, G, B, b)];
          }
      }
    }
  }
  if constexpr (EMIT) {
    __syncthreads();
    const int span = 2 << level;
    if (!live || (k & (2 * span - 1)) != span) return;  // knot r + 1 only
    const size_t ir = idx - B;  // knot r = k - 1
    const int g2 = k >> (level + 2), G2 = N >> (level + 2);
    for (int rg = threadIdx.y; rg < NL; rg += blockDim.y) {
      const int i0 = rg * RPT;
      bool row_ok[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < n;
      for (int u = 0; u < U; ++u) {
        const float* xs = Fxs.p[u];
        const float* us = Fus.p[u];
        float* ls = Fls.p[u];
        float* so = Sout.p[u];
#pragma unroll 1
        for (int c = 0; c < n; ++c) {
          float xr[NP], acc[RPT];
#pragma unroll
          for (int j = 0; j < NP; ++j)
            xr[j] = j < n ? xs[(j * n + c) * plane + ir] : 0.0f;
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const int i = row_ok[r] ? i0 + r : 0;
            acc[r] = Asep[Lay::at(i * n, g2, nn, G2, B, b)] * xr[0];
#pragma unroll
            for (int j = 1; j < NP; ++j)
              if (j < n)
                acc[r] = fmaf(Asep[Lay::at(i * n + j, g2, nn, G2, B, b)],
                              xr[j], acc[r]);
          }
#pragma unroll 4
          for (int j = 0; j < m; ++j) {
            const float uj = us[(j * n + c) * plane + ir];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const int i = row_ok[r] ? i0 + r : 0;
              acc[r] = fmaf(Bsep[Lay::at(i * m + j, g2, n * m, G2, B, b)],
                            uj, acc[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            if (!row_ok[r]) continue;
            const int e = (i0 + r) * n + c;
            const float s = acc[r] - xs[e * plane + idx] - ls[e * plane + idx];
            so[Lay::at(e, g2, nn, G2, B, b)] = s;
            if (u == 0) ls[e * plane + idx] = s;
          }
        }
      }
    }
  }
}

// Launch row_level_kernel on the plan's geometry (ops/schur.py:_level_plan):
// gy rows of LKB knots starting at knot -shift cover every knot; emission
// needs each (odd r, r + 1) pair in one block, so a shift of one; rgs row
// groups cover the 2n + m rows, in slots_of(n, m) slots.
template <class K, class Lay>
int launch_row_level(const float* FLl, const float* FLx, const float* FLu,
                     void* const* Fls, void* const* Fxs, void* const* Fus,
                     void* const* fsol, const float* Asep, const float* Bsep,
                     void* const* S, int U, int N, int B, int level, int emit,
                     int n, int m, int shift, int gy, cudaStream_t st) {
  const dim3 grid((B + TB - 1) / TB, gy), block(TB, slots_of(n, m), LKB);
  if (emit)
    row_level_kernel<K, true, Lay><<<grid, block, 0, st>>>(
        FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep,
        Bsep, ptrs(S), U, N, B, level, shift, n, m);
  else
    row_level_kernel<K, false, Lay><<<grid, block, 0, st>>>(
        FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep,
        Bsep, ptrs(S), U, N, B, level, shift, n, m);
  return 0;
}

// The plan's checks (the wrapper computes it; a wrong plan is refused).
inline bool row_plan_ok(int U, int N, int level, int emit, int n, int m,
                        int shift, int gy, int rgs) {
  return U >= 0 && U <= MAXU && level >= 0 && (N >> (level + 1)) >= 1 &&
         shift >= 0 && shift < LKB && (long long)gy * LKB - shift >= N &&
         (!emit || shift == 1) && rgs == 2 * groups_of(n) + groups_of(m);
}

}  // namespace small_blocks
