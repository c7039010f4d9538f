// Hand-written Hopper kernels for the flat-plane rsLQR sweep.
//
// Three kernels, one per TPU kernel of rslqr_tpu/ops/schur_planes.py:
//   flat_level_kernel <- schur_update_level_flat (one tree level, every upper
//                        slab)
//   flat_leaf_kernel  <- leaf_schur_level0_flat  (leaf factors + level 0)
//   flat_rhs_kernel   <- rhs_update_level_flat   (one level of the RHS sweep)
//
// Layout: the JAX kernels' flat planes [e, N*B/128, 128] are the bytes of
// element-major [e, N, B] planes (element e of knot k, batch column b at
// e*N*B + k*B + b), which is how these kernels index them. What differs from
// schur_kernels.cu (the [nn, N, B] suite, B1-B4) is the schedule: compact
// solved separators and emitted products are element-major [e, G, B] (there
// group-major [G, e, B]), products are emitted at levels 0 and 1 only, and
// there is no level pairing. float32 only. Block sizes: every 1 <= n <= 8,
// 1 <= m <= 64, through the instantiations of small_blocks.cuh (the exact
// (6, 3), the (4, 4) and (8, 8) capacities with n, m at run time, and the
// wide tag, whose u rows the leaf and RHS kernels take in chunks of 8 and
// whose level update is row_groups.cuh's row_level_kernel: B10's own block
// of one thread per row group would pass 1,024 threads there).
//
// Mapping of the leaf and RHS kernels: one thread per (knot, batch column).
// A block is TB=32 batch columns (one warp, so every slab load and store is
// a coalesced 128-byte line) by KPT knots, KPT = the JAX tile's knots per
// tile (_kpt_for: 4 at level 0, 8 above, at most N). Blocks start at
// multiples of KPT, so at an emitting level (2 * span == KPT) a block holds
// exactly one next-level group, its separator row r = span - 1 and the row
// r + 1 after it. The level kernel splits each knot's rows over several
// threads instead (see its note below).
//
// Every slab element is written once. In the leaf kernel the row-r thread
// stages its new x/u blocks in shared memory; the row-(r+1) thread stages
// its new lambda/x blocks and holds back its lambda store. After a
// __syncthreads() the row-(r+1) thread forms S = A_sep @ x[r] + B_sep @ u[r]
// - x[r+1] - l[r+1] (ndlqr_FactorInnerProduct, nested_dissection.c:114-134),
// writes S and stores its lambda row: S on the next level's own slab (the
// Sbar fold, ref solve.c:92-97), else the staged value. At the wide tag the
// u rows of r are not staged: the emission reads them back from device
// memory, one row at a time.
//
// Bound: bandwidth. Per knot and batch column and upper level a kernel reads
// and writes about 90 floats of slab against ~6 FMAs per slab element (about
// 0.4 FLOP per byte, far below the H100's ~20 FLOP/byte f32 balance). The
// design streams each slab once with coalesced lines, keeps the level-L
// multiplier blocks in registers for every upper level, and emits the
// products from the values just computed. Each launcher returns
// cudaGetLastError() right after the launch. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (rslqr_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cstddef>

#include "row_groups.cuh"
#include "small_blocks.cuh"

namespace {

using small_blocks::chunk_rows;
using small_blocks::chunks;
using small_blocks::CPtrs;
using small_blocks::cptrs;
using small_blocks::dot_row;
using small_blocks::groups_of;
using small_blocks::LKB;
using small_blocks::load_blk;
using small_blocks::MAXU;
using small_blocks::Ptrs;
using small_blocks::ptrs;
using small_blocks::RPT;
using small_blocks::TB;
using small_blocks::with_block;

struct Site {
  int b, k;
  bool live;
  size_t idx, plane;
};

// Block (x: strip of TB batch columns, y: tile of blockDim.y knots).
__device__ __forceinline__ Site site(int N, int B) {
  Site s;
  s.b = blockIdx.x * TB + threadIdx.x;
  s.k = blockIdx.y * blockDim.y + threadIdx.y;
  s.live = s.b < B && s.k < N;
  s.plane = (size_t)N * B;
  s.idx = s.live ? (size_t)s.k * B + s.b : 0;
  return s;
}

// Element e of group g of an element-major compact [E, G, B] array.
__device__ __forceinline__ size_t cidx(int e, int g, int G, int B, int b) {
  return ((size_t)e * G + g) * B + b;
}

// A rows x cols block of this thread's knot from element-major planes.
template <int R, int C>
__device__ __forceinline__ void load_planes(float (&r)[R * C],
                                            const float* src, int rows,
                                            int cols, const Site& s) {
  load_blk<R, C>(r, rows, cols,
                 [&](int e) { return src[e * s.plane + s.idx]; });
}

// A rows x cols block of group g of an element-major compact array.
template <int R, int C>
__device__ __forceinline__ void load_compact(float (&r)[R * C],
                                             const float* src, int rows,
                                             int cols, int g, int G, int B,
                                             int b) {
  load_blk<R, C>(r, rows, cols,
                 [&](int e) { return src[cidx(e, g, G, B, b)]; });
}

// Shared-memory staging of one next-level group's rows r (x, u) and r+1
// (lambda, x), per batch column of the block.
template <class K>
struct Stage {
  float xr[K::NP * K::NP][TB];
  float ur[K::WIDE ? 1 : K::MP * K::NP][TB];
  float lr1[K::NP * K::NP][TB];
  float xr1[K::NP * K::NP][TB];
};

enum Role { kPlain = 0, kSepRow = 1, kAfterSep = 2 };

// One level's update of one upper slab trio at this thread's knot, from the
// trio's current values (in_l/in_x/in_u: block row, column -> value),
// written once:
//   l = sep ? f : (keep ? l - ML@f : l);  x -= MX@f;  u -= MU@f.
// kSepRow stages its new x/u (x only at the wide tag); kAfterSep stages its
// new lambda/x and leaves its lambda store to emit_products. ``mu`` holds the
// u rows' multiplier (at the wide tag: a callable giving chunk i0's);
// ``in_u`` takes the slab row.
template <class K, class InL, class InX, class InU, class Mu>
__device__ __forceinline__ void update_trio(
    const float* ml, const float* mx, const Mu& mu, const float* f,
    bool keep, bool sep, InL in_l, InX in_x, InU in_u, float* ol, float* ox,
    float* ou, Stage<K>& st, int role, const Site& s, int n, int m) {
  constexpr int NP = K::NP, MP = K::MP;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (i >= n || c >= n) continue;
      const int e = i * n + c;
      const float l = in_l(i, c);
      const float v =
          sep ? f[i * NP + c] : (keep ? l - dot_row<NP>(ml, i, f, c) : l);
      if (role == kAfterSep)
        st.lr1[e][t] = v;
      else
        ol[e * s.plane + s.idx] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (i >= n || c >= n) continue;
      const int e = i * n + c;
      const float v = in_x(i, c) - dot_row<NP>(mx, i, f, c);
      ox[e * s.plane + s.idx] = v;
      if (role == kSepRow) st.xr[e][t] = v;
      if (role == kAfterSep) st.xr1[e][t] = v;
    }
  }
  for (int ch = 0, i0 = 0; ch < chunks<K>(m); ++ch, i0 += MP) {
    const int mc = chunk_rows<K>(m, i0);
    float mw[MP * NP];
    const float* mu_c;
    if constexpr (K::WIDE) {
      mu(i0, mc, mw);
      mu_c = mw;
    } else {
      mu_c = mu;
    }
#pragma unroll
    for (int i = 0; i < MP; ++i) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= mc || c >= n) continue;
        const int e = (i0 + i) * n + c;
        const float v = in_u(i0 + i, c) - dot_row<NP>(mu_c, i, f, c);
        ou[e * s.plane + s.idx] = v;
        if constexpr (!K::WIDE)
          if (role == kSepRow) st.ur[e][t] = v;
      }
    }
  }
}

// The row-(r+1) thread's product emission and lambda store (see header):
// S into group g2 of the compact [nn, G2, B] output, and its lambda row as
// S (``fold``) or as the staged updated value. The wide tag reads u[r] from
// ``ou`` (this upper level's u slab) at knot r, one row at a time, into the
// n x n sums.
template <class K>
__device__ void emit_products(const Stage<K>& st,
                              const float* __restrict__ Asep,
                              const float* __restrict__ Bsep, float* Sout,
                              float* ol, const float* ou, bool fold, int g2,
                              int G2, int B, const Site& s, int n, int m) {
  constexpr int NP = K::NP, MP = K::MP;
  float a[NP * NP];
  load_compact<NP, NP>(a, Asep, n, n, g2, G2, B, s.b);
  const int t = threadIdx.x;
  if constexpr (K::WIDE) {
    float S[NP * NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        float acc = a[i * NP] * st.xr[c][t];
#pragma unroll
        for (int j = 1; j < NP; ++j)
          if (j < n) acc += a[i * NP + j] * st.xr[j * n + c][t];
        S[i * NP + c] = acc;
      }
    const size_t ir = s.idx - B;  // knot r = k - 1
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      float bj[NP], uj[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        bj[i] = i < n ? Bsep[cidx(i * m + j, g2, G2, B, s.b)] : 0.0f;
        uj[i] = i < n ? ou[(j * n + i) * s.plane + ir] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < NP; ++c) S[i * NP + c] += bj[i] * uj[c];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= n || c >= n) continue;
        const int e = i * n + c;
        const float acc = S[i * NP + c] - st.xr1[e][t] - st.lr1[e][t];
        Sout[cidx(e, g2, G2, B, s.b)] = acc;
        ol[e * s.plane + s.idx] = fold ? acc : st.lr1[e][t];
      }
  } else {
    float bm[NP * MP];
    load_compact<NP, MP>(bm, Bsep, n, m, g2, G2, B, s.b);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= n || c >= n) continue;
        const int e = i * n + c;
        float acc = a[i * NP] * st.xr[c][t];
#pragma unroll
        for (int j = 1; j < NP; ++j)
          if (j < n) acc += a[i * NP + j] * st.xr[j * n + c][t];
#pragma unroll
        for (int j = 0; j < MP; ++j)
          if (j < m) acc += bm[i * MP + j] * st.ur[j * n + c][t];
        acc = acc - st.xr1[e][t] - st.lr1[e][t];
        Sout[cidx(e, g2, G2, B, s.b)] = acc;
        ol[e * s.plane + s.idx] = fold ? acc : st.lr1[e][t];
      }
    }
  }
}

// Role of this thread's knot when level-``level`` products are emitted.
__device__ __forceinline__ int role_of(bool emit, const Site& s, int level) {
  if (!emit || !s.live) return kPlain;
  const int span = 2 << level, pos = s.k & (2 * span - 1);
  return pos == span - 1 ? kSepRow : (pos == span ? kAfterSep : kPlain);
}

// ---------------------------------------------------------------------------
// B12: RHS sweep, one level.
// ---------------------------------------------------------------------------

// (F @ zb)[i] for rows i of a slab F with n columns, zb zero past n.
template <int NP>
__device__ __forceinline__ float dot_plane(const float* F, int i, int n,
                                           const float* zb, const Site& s) {
  float acc = F[(i * n) * s.plane + s.idx] * zb[0];
#pragma unroll
  for (int j = 1; j < NP; ++j)
    if (j < n) acc += F[(i * n + j) * s.plane + s.idx] * zb[j];
  return acc;
}

template <class K>
__global__ void flat_rhs_kernel(const float* __restrict__ Fl,
                                const float* __restrict__ Fx,
                                const float* __restrict__ Fu, float* zy,
                                float* zx, float* zu,
                                const float* __restrict__ zbar, int N, int B,
                                int level, int n_, int m_) {
  constexpr int NP = K::NP, MP = K::MP;
  const int n = K::EX ? NP : n_, m = K::EX ? MP : m_;
  const Site s = site(N, B);
  if (!s.live) return;
  const int k = s.k, half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  float zb[NP];
  load_compact<1, NP>(zb, zbar, 1, n, k >> (level + 1), N >> (level + 1), B,
                      s.b);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i >= n) continue;
    const float acc = dot_plane<NP>(Fl, i, n, zb, s);
    const size_t o = i * s.plane + s.idx;
    const float v = zy[o];
    zy[o] = sep ? zb[i] : (keep ? v - acc : v);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (i < n) zx[i * s.plane + s.idx] -= dot_plane<NP>(Fx, i, n, zb, s);
  for (int ch = 0, i0 = 0; ch < chunks<K>(m); ++ch, i0 += MP) {
    const int mc = chunk_rows<K>(m, i0);
#pragma unroll
    for (int i = 0; i < MP; ++i)
      if (i < mc)
        zu[(i0 + i) * s.plane + s.idx] -=
            dot_plane<NP>(Fu, i0 + i, n, zb, s);
  }
}

// ---------------------------------------------------------------------------
// B10: one level's Schur update of every upper slab.
//
// Mapping: a thread owns RPT = 3 rows of one slab at one (knot, batch
// column), and holds only those rows of the level-L multiplier (3n floats)
// for every upper slab; a thread that held all 2n + m rows would need ~200
// registers at (6, 3) and leave 8 warps per SM. A slab of r rows has
// ceil(r / 3) row groups; rows past r in its last group are masked (none at
// (6, 3): 2 + 2 + 1 = 5 groups). A block is TB = 32 batch columns (one warp
// per row group and knot: coalesced 128-byte lines) by the row groups by
// LKB = 2 knots; at (6, 3) that is 320 threads, capped at 64 registers, so
// that three blocks (30 warps) fit an SM: a cap of 48 (four blocks) spilled
// 176-196 bytes and ran 1.2-1.9x slower (PERF.md). The solved separator f of
// the knot's group is read by all the column's threads through L1.
//
// Each thread keeps its 3n slab loads of an upper slab independent (the
// column loop is unrolled), so they are in flight together. A lambda row
// that calc_lambda leaves unchanged (not kept, not a separator knot) is
// neither read nor written: every slab element the level changes is written
// once, and the others are not touched.
//
// Emission (levels 0-1; its own instantiation, so that the levels without
// it carry none of its registers): knot tiles are shifted by one (the plan's
// ``shift``), so a block holds the pair (r, r + 1) of a next-level group,
// r = span - 1 odd, whenever r is a separator row. After the update of an
// upper slab, one __syncthreads() (per block, not per SM) makes the new x
// and u rows of r and x rows of r + 1 visible to the block, and the lambda
// threads of r + 1 form their rows of
//   S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] - l[r+1]
// (ndlqr_FactorInnerProduct, nested_dissection.c:114-134) from device
// memory (L1/L2), write them to the compact product and, on the next
// level's own slab (u = 0), into the lambda row of r + 1, which the level
// itself leaves unchanged there (the Sbar fold, ref solve.c:92-97).
// ---------------------------------------------------------------------------
// RPT = 3 slab rows per thread, LKB = 2 knots per block, groups_of: as in
// row_groups.cuh (ops/schur.py:_level_plan). One thread per row group holds
// n, m <= 8 to 576 threads; the wide tag (up to 28 row groups, 1,792
// threads) runs row_groups.cuh's row_level_kernel, which loops over them.

template <class K>
__host__ __device__ constexpr int level_threads() {
  return TB * (2 * groups_of(K::NP) + groups_of(K::MP)) * LKB;
}

// Blocks per SM the register cap aims at: 30 warps at (6, 3).
template <class K>
__host__ __device__ constexpr int level_min_blocks() {
  return 960 / level_threads<K>() > 1 ? 960 / level_threads<K>() : 1;
}

template <class K, bool EMIT>
__global__ void __launch_bounds__(level_threads<K>(), level_min_blocks<K>())
    flat_level_kernel(const float* __restrict__ FLl,
                      const float* __restrict__ FLx,
                      const float* __restrict__ FLu, Ptrs Fls, Ptrs Fxs,
                      Ptrs Fus, CPtrs fsol, const float* __restrict__ Asep,
                      const float* __restrict__ Bsep, Ptrs Sout, int U, int N,
                      int B, int level, int shift, int n_, int m_) {
  constexpr int NP = K::NP, MP = K::MP;
  const int n = K::EX ? NP : n_, m = K::EX ? MP : m_;
  // Every row group whole: nothing to mask.
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && MP % RPT == 0;
  const int NL = groups_of(n), NX = groups_of(n);  // lambda, x row groups
  const int b = blockIdx.x * TB + threadIdx.x;
  const int rg = threadIdx.y;
  const int k = blockIdx.y * LKB - shift + (int)threadIdx.z;
  const bool live = b < B && k >= 0 && k < N;
  const size_t plane = (size_t)N * B;
  const size_t idx = live ? (size_t)k * B + b : 0;
  const int half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  const int g = k >> (level + 1), G = N >> (level + 1);
  // This thread's slab (0 lambda, 1 x, 2 u), its first row there, and which
  // of its RPT rows the slab has.
  const int slab = rg < NL ? 0 : (rg < NL + NX ? 1 : 2);
  const int i0 = (rg - (slab == 0 ? 0 : (slab == 1 ? NL : NL + NX))) * RPT;
  const int rows = slab == 2 ? m : n;
  bool row_ok[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) row_ok[r] = WHOLE || i0 + r < rows;
  const bool lam = slab == 0;
  const bool upd = live && !(lam && (sep || !keep));  // reads M and its rows
  const bool put = live && lam && sep;                // writes f's rows
  // Emission: the lambda threads of knot r + 1.
  const int span = 2 << level;
  const bool erow = EMIT && live && lam && (k & (2 * span - 1)) == span;
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
          fc[j] = j < n ? fu[cidx(j * n + c, g, G, B, b)] : 0.0f;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          v[r] = row_ok[r] ? out[((i0 + r) * n + c) * plane + idx] : 0.0f;
        // v - M @ f with the product summed first, as the plain version
        // (and B1) sum it: subtracting term by term moved the flat solve of
        // the double integrator 100x further from kernels="off" (PERF.md).
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
          out[e * plane + idx] = fu[cidx(e, g, G, B, b)];
        }
    }
    if constexpr (EMIT) {
      __syncthreads();
      if (erow) {
        const size_t ir = idx - B;  // knot r = k - 1
        const int g2 = k >> (level + 2), G2 = N >> (level + 2);
        const float* xs = Fxs.p[u];
        const float* us = Fus.p[u];
        float* ls = Fls.p[u];
        float* so = Sout.p[u];
#pragma unroll 1
        for (int c = 0; c < n; ++c) {
          float xr[NP], ur[MP];
#pragma unroll
          for (int j = 0; j < NP; ++j)
            xr[j] = j < n ? xs[(j * n + c) * plane + ir] : 0.0f;
#pragma unroll
          for (int j = 0; j < MP; ++j)
            ur[j] = j < m ? us[(j * n + c) * plane + ir] : 0.0f;
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            if (!row_ok[r]) continue;
            const int i = i0 + r, e = i * n + c;
            float acc = Asep[cidx(i * n, g2, G2, B, b)] * xr[0];
#pragma unroll
            for (int j = 1; j < NP; ++j)
              if (j < n)
                acc = fmaf(Asep[cidx(i * n + j, g2, G2, B, b)], xr[j], acc);
#pragma unroll
            for (int j = 0; j < MP; ++j)
              if (j < m)
                acc = fmaf(Bsep[cidx(i * m + j, g2, G2, B, b)], ur[j], acc);
            acc = acc - xs[e * plane + idx] - ls[e * plane + idx];
            so[cidx(e, g2, G2, B, b)] = acc;
            if (u == 0) ls[e * plane + idx] = acc;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B11: leaf factors + level-0 update of every level's slab.
// ---------------------------------------------------------------------------

// Level-L leaf values at knot k (ndlqr_SolveLeaf, nested_dissection.c:
// 10-105; level(k) = trailing zeros of k+1, binary_tree.c:65-73), element
// (i, j):  fx = own ? Q^-1 A' : 0  - (prev ? Q^-1 : 0),
//          fu = ownu ? R^-1 B' : 0,
// from register blocks a (stride NP) and bm (stride MP).
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

template <int NP>
__device__ __forceinline__ float leaf_x(const float* a, const float* qi,
                                        LeafMask lm, int i, int j) {
  float v = lm.own ? a[j * NP + i] * qi[i] : 0.0f;
  if (i == j) v -= lm.prev ? qi[i] : 0.0f;
  return v;
}

template <int MP>
__device__ __forceinline__ float leaf_u(const float* bm, const float* ri,
                                        LeafMask lm, int i, int j) {
  return lm.ownu ? bm[j * MP + i] * ri[i] : 0.0f;
}

template <class K>
__global__ void flat_leaf_kernel(const float* __restrict__ A,
                                 const float* __restrict__ Bm,
                                 const float* __restrict__ qinv,
                                 const float* __restrict__ rinv,
                                 const float* __restrict__ S0, CPtrs fsol,
                                 const float* __restrict__ Asep,
                                 const float* __restrict__ Bsep, Ptrs Fls,
                                 Ptrs Fxs, Ptrs Fus, Ptrs Sout, int depth,
                                 int N, int B, int n_, int m_) {
  constexpr int NP = K::NP, MP = K::MP;
  const int n = K::EX ? NP : n_, m = K::EX ? MP : m_;
  __shared__ Stage<K> st;
  const Site s = site(N, B);
  const int k = s.k;
  const bool keep = k == 0;       // level-0 calc_lambda
  const bool sep = (k & 1) == 1;  // level-0 sep+1 rows
  const int g = k >> 1, G0 = N >> 1;
  const int role = role_of(true, s, 0);
  float a[NP * NP], bm[NP * MP], qi[NP], ri[MP];
  float fl0[NP * NP], fx0[NP * NP], fu0[MP * NP];
  // The wide tag's level-L leaf value of u row i, column j, from device
  // memory (B's column i and R^-1's entry i).
  const auto fu_at = [&](LeafMask lm, int i, int j) {
    return lm.ownu
               ? Bm[(j * m + i) * s.plane + s.idx] * rinv[i * s.plane + s.idx]
               : 0.0f;
  };
  const LeafMask lm0 = leaf_mask(0, k, N);
  if (s.live) {
    load_planes<NP, NP>(a, A, n, n, s);
    if constexpr (!K::WIDE) load_planes<NP, MP>(bm, Bm, n, m, s);
    load_planes<1, NP>(qi, qinv, 1, n, s);
    if constexpr (!K::WIDE) load_planes<1, MP>(ri, rinv, 1, m, s);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const bool in = i < n && j < n;
        fx0[i * NP + j] = in ? leaf_x<NP>(a, qi, lm0, i, j) : 0.0f;
        fl0[i * NP + j] = in && k == 0 ? -a[j * NP + i] : 0.0f;
      }
    }
    if constexpr (!K::WIDE) {
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < NP; ++j)
          fu0[i * NP + j] =
              i < m && j < n ? leaf_u<MP>(bm, ri, lm0, i, j) : 0.0f;
    }
    // Slab 0: leaf values, with level 0's own Sbar at its sep+1 rows.
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (i >= n || j >= n) continue;
        const int e = i * n + j;
        Fls.p[0][e * s.plane + s.idx] =
            sep ? S0[cidx(e, g, G0, B, s.b)] : fl0[i * NP + j];
        Fxs.p[0][e * s.plane + s.idx] = fx0[i * NP + j];
      }
    }
    if constexpr (K::WIDE) {
#pragma unroll 1
      for (int i = 0; i < m; ++i)
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (j < n)
            Fus.p[0][(i * n + j) * s.plane + s.idx] = fu_at(lm0, i, j);
    } else {
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (i < m && j < n)
            Fus.p[0][(i * n + j) * s.plane + s.idx] = fu0[i * NP + j];
    }
  }
  // The wide tag's level-0 u multiplier, chunk i0 (stride NP).
  const auto fu0_wide = [&](int i0, int mc, float (&mw)[MP * NP]) {
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        mw[i * NP + j] = i < mc && j < n ? fu_at(lm0, i0 + i, j) : 0.0f;
  };
  for (int u = 1; u < depth; ++u) {
    if (s.live) {
      float f[NP * NP];
      load_compact<NP, NP>(f, fsol.p[u - 1], n, n, g, G0, B, s.b);
      const LeafMask lm = leaf_mask(u, k, N);
      // Upper lambda slabs start at zero; x/u at the level-u leaf values.
      const auto in_l = [](int, int) { return 0.0f; };
      const auto in_x = [&](int i, int j) {
        return leaf_x<NP>(a, qi, lm, i, j);
      };
      if constexpr (K::WIDE)
        update_trio<K>(
            fl0, fx0, fu0_wide, f, keep, sep, in_l, in_x,
            [&](int i, int j) { return fu_at(lm, i, j); }, Fls.p[u],
            Fxs.p[u], Fus.p[u], st, role, s, n, m);
      else
        update_trio<K>(
            fl0, fx0, fu0, f, keep, sep, in_l, in_x,
            [&](int i, int j) { return leaf_u<MP>(bm, ri, lm, i, j); },
            Fls.p[u], Fxs.p[u], Fus.p[u], st, role, s, n, m);
    }
    __syncthreads();
    if (role == kAfterSep)
      emit_products<K>(st, Asep, Bsep, Sout.p[u - 1], Fls.p[u], Fus.p[u],
                       u == 1, k >> 2, N >> 2, B, s, n, m);
    __syncthreads();
  }
}

// Knots per block: schur_planes._kpt_for.
int kpt_for(int level, int N) {
  const int span = 1 << (level + 1);
  int kpt = 2 * span > 4 ? 2 * span : 4;
  kpt = kpt < 8 ? kpt : 8;
  return kpt < N ? kpt : N;
}

dim3 grid_for(int N, int B, int kpt) {
  return dim3((B + TB - 1) / TB, (N + kpt - 1) / kpt);
}

}  // namespace

extern "C" {

int rslqr_flat_rhs_update_level(const float* Fl, const float* Fx,
                                const float* Fu, float* zy, float* zx,
                                float* zu, const float* zbar, int N, int B,
                                int level, int n, int m, void* stream) {
  const int kpt = kpt_for(level, N);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    flat_rhs_kernel<K><<<grid_for(N, B, kpt), dim3(TB, kpt), 0, st>>>(
        Fl, Fx, Fu, zy, zx, zu, zbar, N, B, level, n, m);
  });
}

int rslqr_flat_schur_update_level(const float* FLl, const float* FLx,
                                  const float* FLu, void* const* Fls,
                                  void* const* Fxs, void* const* Fus,
                                  void* const* fsol, const float* Asep,
                                  const float* Bsep, void* const* S, int U,
                                  int N, int B, int level, int emit, int n,
                                  int m, int shift, int gy, int rgs,
                                  void* stream) {
  // The plan (ops/schur.py:_level_plan): gy rows of LKB knots starting at
  // knot -shift cover every knot; emission needs each (odd r, r + 1) pair in
  // one block, so a shift of one; rgs row groups cover the 2n + m rows. The
  // wide tag runs row_groups.cuh's kernel, whose knots loop over their row
  // groups in at most 16 slots.
  if (!small_blocks::row_plan_ok(U, N, level, emit, n, m, shift, gy, rgs))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + TB - 1) / TB, gy), block(TB, rgs, LKB);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    if constexpr (K::WIDE)
      small_blocks::launch_row_level<K, small_blocks::ElementMajor>(
          FLl, FLx, FLu, Fls, Fxs, Fus, fsol, Asep, Bsep, S, U, N, B, level,
          emit, n, m, shift, gy, st);
    else if (emit)
      flat_level_kernel<K, true><<<grid, block, 0, st>>>(
          FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep,
          Bsep, ptrs(S), U, N, B, level, shift, n, m);
    else
      flat_level_kernel<K, false><<<grid, block, 0, st>>>(
          FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep,
          Bsep, ptrs(S), U, N, B, level, shift, n, m);
  });
}

int rslqr_flat_leaf_schur_level0(const float* A, const float* Bm,
                                 const float* qinv, const float* rinv,
                                 const float* S0, void* const* fsol,
                                 const float* Asep, const float* Bsep,
                                 void* const* Fls, void* const* Fxs,
                                 void* const* Fus, void* const* S, int depth,
                                 int N, int B, int n, int m, void* stream) {
  const int kpt = kpt_for(0, N);
  if (depth < 2 || depth > MAXU || kpt != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    flat_leaf_kernel<K><<<grid_for(N, B, kpt), dim3(TB, kpt), 0, st>>>(
        A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep, ptrs(Fls), ptrs(Fxs),
        ptrs(Fus), ptrs(S), depth, N, B, n, m);
  });
}

}  // extern "C"
