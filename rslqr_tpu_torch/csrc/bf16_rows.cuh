// The bf16-slab instantiations of the level, pair and leaf kernels, on
// column pairs, with the product emission staged in shared memory.
//
//   row_level2_kernel <- rslqr_tpu/ops/schur_pallas.py:schur_update_level_em
//                        (B1 with bf16 slabs, bf16_kernels.cu)
//   row_pair2_kernel  <- rslqr_tpu/ops/schur_pallas.py:schur_update_pair_em
//                        (B4 with bf16 slabs, bf16_kernels.cu)
//   leaf_row2_kernel  <- rslqr_tpu/ops/schur_pallas.py:leaf_schur_level0_em
//                        (B3 with bf16 slabs, bf16_kernels.cu)
//
// The math, each batch column's order of sums and the roundings are those of
// row_level_kernel and row_pair_kernel (row_groups.cuh) and leaf_row_kernel
// (leaf_rows.cuh) in f32, with bf16 storage: slab elements loaded into f32,
// f32 math, one rounding (to nearest even) at each store; the products
// formed from the unrounded f32 values (schur_pallas.py:247-257); B4's
// level-(L+1) multiplier is slab L+1 as stored, rounded. Those kernels run
// f32 slabs; the bf16 slabs run here, on the same plan (ops/schur.py:
// _level_plan; the pair's slots for B3 and B4), except:
//
// * Column pairs. A thread owns its slab rows at two adjacent batch columns
//   b, b + 1 (CPT = 2), so that a slab element moves as one
//   __nv_bfloat162 (a warp's load or store is a 128-byte line, as in f32,
//   at half the instructions a byte) and every f32 operand as one float2.
//   A block is TB2 = 64 batch columns. Where B is odd or a tensor is not
//   aligned to its pair (the plan's ``vec`` off), the VEC = false
//   instantiation moves a pair as two scalar accesses, the second masked
//   past B (its own code, so that the aligned one carries no branch).
// * B4's slab rows by cp.async, a slab ahead. Below the wide tag a thread
//   copies its rows of slab u + 1 into a shared-memory double buffer
//   while it updates slab u, so that the loads of a slab are in flight
//   together and hold no registers (the f32 kernel loads a column's rows
//   after it stored the column before). Its level-L multiplier rows (slab
//   L as stored: bf16 values) wait in shared memory too, and the
//   level-(L+1) ones (slab L+1 as stored) in registers, packed, widened
//   exactly at each use.
// * The emission from shared memory. The products of a next-level group
//   read the f32 x and u rows of its separator knot r and the x rows of r +
//   1, and a block holds that pair (the plan's shift). (B1's f32 kernel
//   reads them back from the slabs; bf16 slabs hold them rounded.) In an emitting block
//   the threads of those rows write their unrounded values of each upper
//   slab into a stage, [2nn + mn][TB2] f32 (x at r, u at r, x at r + 1;
//   23,040 bytes at (6, 3)), beside A_sep and B_sep of the block's group;
//   after one barrier the block's threads take the products' elements from
//   it. So no f32 shadow goes through device memory, and the upper slabs
//   run outermost (a barrier per slab), each thread's row groups inside;
//   two stages where they fit (B3), else a second barrier frees the one.
// * Registers: 20 warps per SM at (6, 3), 96 registers: two columns a
//   thread keep as many column rows in flight as the f32 kernels' 24-30
//   warps. The compilers would hoist the widened multipliers and the
//   addresses out of the slab loop and share them between the unrolled
//   columns, holding them all at once (hundreds of bytes of spills): each
//   slab and column takes its addresses and widenings through a zero they
//   cannot fold (opaque), and offsets are 32-bit.
//
// A thread takes one row group below the wide tag, whose multiplier rows
// (B1, B4) and leaf values (B3) it holds across the slabs; at the wide tag
// (m > 8, several row groups a thread) it reloads them per slab.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstring>

#include "leaf_rows.cuh"
#include "row_groups.cuh"
#include "small_blocks.cuh"

namespace small_blocks {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int CPT = 2;         // batch columns per thread
constexpr int TB2 = CPT * TB;  // batch columns per block

// f32 values per batch column of the emission stage: the x and u rows of
// knot r and the x rows of r + 1.
__host__ __device__ constexpr int stage_rows(int n, int m) {
  return 2 * n * n + m * n;
}

// The dynamic shared memory a block may take on sm_90 (227 KB).
constexpr size_t SMEM2_MAX = 227 * 1024;

// Shared memory of a bf16 pair (B4, ``pair``) or leaf (B3) block of
// ``threads`` threads, in 4-byte words (ops/schur.py:_pair2_smem). Below
// the wide tag (m <= 8): B4's double buffer of each thread's rows of an
// upper slab (2 x RPT x n words a thread, filled by cp.async one slab
// ahead) and its level-L multiplier rows (RPT x n words a thread), and, in
// an emitting launch, the stage and (where the block can hold them) A_sep
// and B_sep of the block's group; two stages where that keeps the blocks
// an SM that the register cap aims at (one barrier a slab). At the wide
// tag: one stage, the products' A_sep and B_sep read from device memory.
struct Smem2 {
  int vbuf, mbuf, stage, nstage, sep;
  __host__ __device__ size_t bytes() const {
    return 4 * ((size_t)vbuf + mbuf + (size_t)nstage * stage + sep);
  }
};

__host__ __device__ inline Smem2 smem2(int n, int m, int threads, bool pair,
                                       bool emit) {
  const bool hold = m <= MAX_STATE_DIM;
  const int blocks = 640 / threads > 1 ? 640 / threads : 1;
  const size_t budget = 233472 / blocks - 1024 < SMEM2_MAX
                            ? 233472 / blocks - 1024
                            : SMEM2_MAX;
  Smem2 s;
  s.vbuf = pair && hold ? 2 * RPT * n * threads : 0;
  s.mbuf = pair && hold ? RPT * n * threads : 0;
  s.stage = emit ? stage_rows(n, m) * TB2 : 0;
  s.nstage = emit ? 1 : 0;
  s.sep = emit && hold ? (n * n + n * m) * TB2 : 0;
  if (s.bytes() > SMEM2_MAX) s.sep = 0;  // (8, 8) B4: from device memory
  if (emit && hold && s.bytes() + 4 * (size_t)s.stage <= budget)
    s.nstage = 2;
  return s;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every group of this thread's copies but the newest one has landed.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Blocks per SM the register cap aims at: 20 warps at (6, 3), two columns
// a thread (``threads`` a block).
__host__ __device__ constexpr int min_blocks2(int threads) {
  return 640 / threads > 1 ? 640 / threads : 1;
}

template <class K>
__host__ __device__ constexpr int pair2_min_blocks() {
  return min_blocks2(row_pair_threads<K>());
}

// A thread's site: its first batch column b (even), knot k, and its offset
// in a plane; ``two`` when b + 1 < B. Offsets are 32-bit: the wrapper
// refuses a tensor of 2^31 elements or more (ops/schur.py:_check_pair2),
// and each saves a register of the 64-bit ones.
struct PairSite {
  int b, k, zero;
  bool live, two, vec;
  unsigned plane, idx;
};

// Element e of group g of a group-major [G, E, B] array (GroupMajor::at).
__device__ __forceinline__ unsigned gm(int e, int g, int E, int B, int b) {
  return ((unsigned)g * E + e) * B + b;
}

__device__ __forceinline__ PairSite pair_site(int N, int B, int shift,
                                              bool vec) {
  PairSite s;
  s.b = ((int)blockIdx.x * TB + (int)threadIdx.x) * CPT;
  s.k = (int)blockIdx.y * LKB - shift + (int)threadIdx.z;
  s.zero = N >> 31;  // N > 0: a zero that no compiler can fold (opaque)
  s.live = s.b < B && s.k >= 0 && s.k < N;
  s.two = s.b + 1 < B;
  s.vec = vec;
  s.plane = (unsigned)N * B;
  s.idx = s.live ? (unsigned)s.k * B + s.b : 0;
  return s;
}

// -- Column-pair accesses (x: column b, y: column b + 1) --------------------

__device__ __forceinline__ bf162 ldh2(const bf16* p, unsigned o,
                                      const PairSite& s) {
  if (s.vec) return *reinterpret_cast<const bf162*>(p + o);
  return __halves2bfloat162(p[o], s.two ? p[o + 1] : __float2bfloat16_rn(0.0f));
}

__device__ __forceinline__ void sth2(bf16* p, unsigned o, bf162 h,
                                     const PairSite& s) {
  if (s.vec) {
    *reinterpret_cast<bf162*>(p + o) = h;
    return;
  }
  p[o] = __low2bfloat16(h);
  if (s.two) p[o + 1] = __high2bfloat16(h);
}

__device__ __forceinline__ bf162 rnd2(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ float2 up2(bf162 h) {
  return __bfloat1622float2(h);
}


// up2 through an opaque zero ``z`` (the same exact widening: a bf16 value
// is the high half of its f32).
__device__ __forceinline__ float2 up2z(bf162 h, int z) {
  unsigned x;
  memcpy(&x, &h, sizeof x);
  return make_float2(__uint_as_float(x << (16 + z)),
                     __uint_as_float(x & (0xffff0000u ^ (unsigned)z)));
}


// A zero the compilers cannot see through (the site's ``zero``, N >> 31),
// a distinct value for each ``salt``. An address or a widened value taken
// with it is formed where it is used: not hoisted out of the slab loop, nor
// shared between the unrolled columns (salted by slab and column), which
// would hold every widened multiplier and every address in registers at
// once and spill.
__device__ __forceinline__ int opaque(const PairSite& s, int salt) {
  return s.zero * salt;
}

// The site with its offsets taken through an opaque zero ``z``.
__device__ __forceinline__ PairSite through(const PairSite& s, int z) {
  PairSite t = s;
  t.plane += z;
  t.idx += z;
  return t;
}

__device__ __forceinline__ float2 ldf2(const float* p, unsigned o,
                                       const PairSite& s) {
  if (s.vec) return *reinterpret_cast<const float2*>(p + o);
  return make_float2(p[o], s.two ? p[o + 1] : 0.0f);
}

__device__ __forceinline__ void stf2(float* p, unsigned o, float2 v,
                                     const PairSite& s) {
  if (s.vec) {
    *reinterpret_cast<float2*>(p + o) = v;
    return;
  }
  p[o] = v.x;
  if (s.two) p[o + 1] = v.y;
}

__device__ __forceinline__ float2 zero2() { return make_float2(0.0f, 0.0f); }

__device__ __forceinline__ bf162 zeroh2() { return rnd2(zero2()); }

__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

__device__ __forceinline__ float2 fma2(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y));
}

// -- Row groups -------------------------------------------------------------

// Row group rg of a knot: its slab (0 lambda, 1 x, 2 u), its first row, and
// which of its RPT rows the slab has.
struct RowGroup {
  int slab, i0;
  bool ok[RPT];
};

template <bool WHOLE>
__device__ __forceinline__ RowGroup row_group(int rg, int NL, int n, int m) {
  RowGroup r;
  r.slab = rg < NL ? 0 : (rg < 2 * NL ? 1 : 2);
  r.i0 = (rg - r.slab * NL) * RPT;
  const int rows = r.slab == 2 ? m : n;
#pragma unroll
  for (int q = 0; q < RPT; ++q) r.ok[q] = WHOLE || r.i0 + q < rows;
  return r;
}

// Where the f32 values of a row group's rows go in the stage of an emitting
// block: x rows of r (0), u rows of r (nn), x rows of r + 1 (nn + mn); -1
// for none. ``zr`` is the knot's place in the block (0: r, 1: r + 1).
__device__ __forceinline__ int stage_part(int slab, int zr, int nn, int mn) {
  if (zr == 0) return slab == 1 ? 0 : (slab == 2 ? nn : -1);
  return slab == 1 ? nn + mn : -1;
}

// This thread's pair of columns in stage row ``row``.
__device__ __forceinline__ float2* stage_at(float* stage, int row) {
  return reinterpret_cast<float2*>(stage + (size_t)row * TB2) + threadIdx.x;
}

// Rows i0 .. of a bf16 slab M (n columns) at this site, packed; zero past
// the slab's rows and past n.
template <int NP>
__device__ __forceinline__ void load_rows2(bf162 (&r)[RPT][NP], const bf16* M,
                                           const RowGroup& R, int n,
                                           const PairSite& s) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      r[q][j] = R.ok[q] && j < n
                    ? ldh2(M, ((R.i0 + q) * n + j) * s.plane + s.idx, s)
                    : zeroh2();
}

// Column c of the solved separator f (n x n) of group g, zero past n.
template <int NP>
__device__ __forceinline__ void load_fcol2(float2 (&fc)[NP], const float* f,
                                           int c, int n, int g,
                                           const PairSite& s, int B) {
#pragma unroll
  for (int j = 0; j < NP; ++j)
    fc[j] = j < n ? ldf2(f, gm(j * n + c, g, n * n, B, s.b), s)
                  : zero2();
}

// (rows @ fc)[q] at both columns, summed in order (row_dot), from packed
// bf16 rows or from f32 rows.
template <int NP>
__device__ __forceinline__ float2 row_dot2(const bf162 (&r)[RPT][NP], int q,
                                           const float2 (&fc)[NP], int z) {
  float2 acc = mul2(up2z(r[q][0], z), fc[0]);
#pragma unroll
  for (int j = 1; j < NP; ++j) acc = fma2(up2z(r[q][j], z), fc[j], acc);
  return acc;
}

template <int NP>
__device__ __forceinline__ float2 row_dot2(const float2 (&r)[RPT][NP], int q,
                                           const float2 (&fc)[NP]) {
  float2 acc = mul2(r[q][0], fc[0]);
#pragma unroll
  for (int j = 1; j < NP; ++j) acc = fma2(r[q][j], fc[j], acc);
  return acc;
}

// Rows i0 .. of the solved separator f (group g) stored into ``out``.
template <int NP>
__device__ __forceinline__ void put_rows2(bf16* out, const float* f,
                                          const RowGroup& R, int n, int g,
                                          int B, const PairSite& s) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (!R.ok[q] || c >= n) continue;
      const int e = (R.i0 + q) * n + c;
      sth2(out, e * s.plane + s.idx,
           rnd2(ldf2(f, gm(e, g, n * n, B, s.b), s)), s);
    }
}

// The products of one upper slab at knot r + 1 (site ``e``) from the stage:
// S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] (- l[r+1] where ``lam``) into
// ``so`` at group g, and, where ``fold``, into the slab's lambda rows
// ``ls`` of r + 1. Its elements (row i, column c) go round the block's
// threads, each summed in row_dot's order.
// A_sep (rows 0 .. nn) and B_sep (nn ..) of group g at this lane's columns:
// from ``sep``, their copy in shared memory, or else from device memory.
__device__ __forceinline__ float2 sep_at(const float* sep, int w, bool b,
                                         const float* __restrict__ Asep,
                                         const float* __restrict__ Bsep,
                                         int g, int B, int n, int m,
                                         const PairSite& e) {
  const int nn = n * n;
  if (sep) return *stage_at(const_cast<float*>(sep), b ? nn + w : w);
  return b ? ldf2(Bsep, gm(w, g, n * m, B, e.b), e)
           : ldf2(Asep, gm(w, g, nn, B, e.b), e);
}

// Copy A_sep and B_sep of group g into ``sep`` (each row group of threads
// a share; before the block's first barrier).
__device__ __forceinline__ void load_sep(float* sep,
                                         const float* __restrict__ Asep,
                                         const float* __restrict__ Bsep,
                                         int g, int B, int n, int m,
                                         const PairSite& e) {
  if (!e.live) return;
  const int nn = n * n;
  for (int w = threadIdx.z * blockDim.y + threadIdx.y; w < nn + n * m;
       w += blockDim.y * blockDim.z)
    *stage_at(sep, w) = sep_at(nullptr, w < nn ? w : w - nn, w >= nn, Asep,
                               Bsep, g, B, n, m, e);
}

template <int NP>
__device__ __forceinline__ void emit2(float* stage, const float* sep,
                                      bool lam, bool fold, bf16* ls,
                                      float* so,
                                      const float* __restrict__ Asep,
                                      const float* __restrict__ Bsep, int g,
                                      int B, int n, int m,
                                      const PairSite& e) {
  if (!e.live) return;
  const int nn = n * n, mn = m * n;
  const int step = blockDim.y * blockDim.z;
  for (int el = threadIdx.z * blockDim.y + threadIdx.y; el < nn;
       el += step) {
    const int i = el / n, c = el - i * n;
    float2 acc = mul2(sep_at(sep, i * n, false, Asep, Bsep, g, B, n, m, e),
                      *stage_at(stage, c));
#pragma unroll
    for (int j = 1; j < NP; ++j)
      if (j < n)
        acc = fma2(sep_at(sep, i * n + j, false, Asep, Bsep, g, B, n, m, e),
                   *stage_at(stage, j * n + c), acc);
#pragma unroll 4
    for (int j = 0; j < m; ++j)
      acc = fma2(sep_at(sep, i * m + j, true, Asep, Bsep, g, B, n, m, e),
                 *stage_at(stage, nn + j * n + c), acc);
    const unsigned o = el * e.plane + e.idx;
    float2 v = sub2(acc, *stage_at(stage, nn + mn + el));
    if (lam) v = sub2(v, up2(ldh2(ls, o, e)));
    stf2(so, gm(el, g, nn, B, e.b), v, e);
    if (fold) sth2(ls, o, rnd2(v), e);
  }
}

// The site of the block's second knot k1 (r + 1 of an emitting pair).
__device__ __forceinline__ PairSite second_site(const PairSite& s, int k1,
                                                int B) {
  PairSite e = s;
  e.k = k1;
  e.live = s.b < B;
  e.idx = e.live ? (unsigned)k1 * B + s.b : 0;
  return e;
}

// ---------------------------------------------------------------------------
// B4, bf16 slabs: levels L and L+1 in one pass (row_pair_kernel's math).
// ---------------------------------------------------------------------------

// Column c of one row group's new rows at level L: v - M @ f1[:, c] (vc
// the column as loaded; ``mrow(r, j)`` the packed multiplier), summed as
// row_dot. ``z`` an opaque zero of the column (the widened multipliers and
// the addresses formed here).
template <int NP, class Mrow>
__device__ __forceinline__ void level_col(float2 (&v)[RPT],
                                          const bf162 (&vc)[RPT], Mrow mrow,
                                          const float* f, int c, int n, int g,
                                          int B, const PairSite& s,
                                          int z) {
  float2 fc[NP];
  load_fcol2<NP>(fc, f, c, n, g, s, B + z);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float2 acc = mul2(up2z(mrow(r, 0), z), fc[0]);
#pragma unroll
    for (int j = 1; j < NP; ++j) acc = fma2(up2z(mrow(r, j), z), fc[j], acc);
    v[r] = sub2(up2(vc[r]), acc);
  }
}

// This thread's rows (row group R) of slab ``src`` into vbuf buffer
// (u & 1), word (q, j) at ((u & 1) * RPT * n + q * n + j) * T: by cp.async
// where the pairs are aligned, else through registers.
template <int NP>
__device__ __forceinline__ void fetch_rows(unsigned* vbuf, int u,
                                           const bf16* src, const RowGroup& R,
                                           int n, int T, const PairSite& s) {
  const int z = opaque(s, u + 1), Tz = T + z;
  const PairSite sz = through(s, z);
  unsigned* dst = vbuf + (u & 1) * RPT * n * Tz;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (!R.ok[q] || j >= n) continue;
      const unsigned o = ((R.i0 + q) * n + j) * sz.plane + sz.idx;
      unsigned* d = dst + (q * n + j) * Tz;
      if (s.vec) {
        cp_async4(d, src + o);
      } else {
        const unsigned hi = s.two ? __bfloat16_as_ushort(src[o + 1]) : 0u;
        *d = __bfloat16_as_ushort(src[o]) | hi << 16;
      }
    }
}

template <class K, bool EMIT, bool VEC>
__global__ void __launch_bounds__(row_pair_threads<K>(),
                                  pair2_min_blocks<K>())
    row_pair2_kernel(const bf16* __restrict__ FLl,
                     const bf16* __restrict__ FLx,
                     const bf16* __restrict__ FLu, PtrsT<bf16> Fls,
                     PtrsT<bf16> Fxs, PtrsT<bf16> Fus, CPtrs fsol1,
                     const float* __restrict__ Sbar2, CPtrs fsol2,
                     const float* __restrict__ Asep3,
                     const float* __restrict__ Bsep3, Ptrs Sout, int U, int N,
                     int B, int level, int shift, int n_, int m_) {
  extern __shared__ float smem[];
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  constexpr bool HOLD = !K::WIDE;
  const int nn = n * n, NL = groups_of(n), rgs = 2 * NL + groups_of(m);
  const int T = blockDim.x * blockDim.y * blockDim.z;
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x +
                  threadIdx.x;
  const Smem2 sm = smem2(n, m, T, true, EMIT);
  unsigned* vbuf = reinterpret_cast<unsigned*>(smem) + tid;
  unsigned* mbuf = vbuf + sm.vbuf;
  float* stage = smem + sm.vbuf + sm.mbuf;
  float* sep = sm.sep ? stage + sm.nstage * sm.stage : nullptr;
  const PairSite s = pair_site(N, B, shift, VEC);
  const int k = s.k;
  const int half = 1 << level, span = 2 * half, span2 = 2 * span;
  const bool keep1 = (k & (half - 1)) != 0 || k == 0;
  const bool sep1 = (k & (span - 1)) == half;
  const bool keep2 = (k & (span - 1)) != 0 || k == 0;
  const bool sep2 = (k & (span2 - 1)) == span;
  const int g1 = k >> (level + 1), g2 = k >> (level + 2);
  // The block's knots are (r, r + 1) of a level-(L+2) group: it emits.
  const int k1 = (int)blockIdx.y * LKB - shift + 1;
  const bool emits = EMIT && k1 < N && (k1 & (2 * span2 - 1)) == span2;
  const int g3 = k1 >> (level + 3);
  if (emits && sep)
    load_sep(sep, Asep3, Bsep3, g3, B, n, m, second_site(s, k1, B));
  bf162 mrow[RPT][NP], m2[RPT][NP];

  // Below the wide tag a thread's one row group loads its rows of each slab
  // u into vbuf (u & 1) by cp.async a slab ahead of its update, where they
  // move from the slab as it is: at slab 0 where level L updates them, at
  // the upper slabs where both levels do (not at a level-(L+1) separator,
  // nor where the level-L one writes f1): fetch_rows, in the row group's
  // loop, which runs once there.
  auto slab_of = [&](const RowGroup& R, int u) {
    return R.slab == 0 ? Fls.p[u] : (R.slab == 1 ? Fxs.p[u] : Fus.p[u]);
  };
  // Column c of this thread's rows of slab u as loaded: from vbuf below the
  // wide tag (``z`` the column's opaque zero), else from ``vp``.
  auto vcol = [&](bf162 (&vc)[RPT], const bf162 (&vp)[RPT][HOLD ? 1 : NP],
                  int u, int c, int z) {
    const unsigned* vb = vbuf + (u & 1) * RPT * n * T;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if constexpr (HOLD) {
        const unsigned w = vb[(r * n + c) * (T + z)];
        memcpy(&vc[r], &w, sizeof w);
      } else {
        vc[r] = vp[r][c];
      }
    }
  };

  // Slab 0 (u = L+1): level L, then Sbar2 at sep2; its new rows are the
  // level-(L+1) multiplier's as stored.
  for (int rg = threadIdx.y; s.live && rg < rgs; rg += blockDim.y) {
    const RowGroup R = row_group<WHOLE>(rg, NL, n, m);
    const bool lam = R.slab == 0;
    const bool upd1 = !lam || (keep1 && !sep1);
    const bool need2 = U > 1 && (!lam || (keep2 && !sep2));
    bf16* o0 = slab_of(R, 0);
    if constexpr (HOLD) {
      if (upd1 && !(lam && (sep1 || sep2)))
        fetch_rows<NP>(vbuf, 0, o0, R, n, T, s);
      cp_async_commit();
      if (U > 1 && (!lam || (keep2 && !sep1 && !sep2)))
        fetch_rows<NP>(vbuf, 1, slab_of(R, 1), R, n, T, s);
      cp_async_commit();
      cp_async_wait_prev();
    }
    if (upd1) {
      load_rows2<NP>(mrow, lam ? FLl : (R.slab == 1 ? FLx : FLu), R, n, s);
      if constexpr (HOLD) {  // the upper slabs read them from mbuf
#pragma unroll
        for (int q = 0; q < RPT; ++q)
#pragma unroll
          for (int j = 0; j < NP; ++j)
            if (j < n) memcpy(mbuf + (q * n + j) * T, &mrow[q][j], 4);
      }
    }
    if (lam && sep2) {
      put_rows2<NP>(o0, Sbar2, R, n, g2, B, s);
    } else if (lam && sep1) {
      put_rows2<NP>(o0, fsol1.p[0], R, n, g1, B, s);
      if (need2) load_rows2<NP>(m2, o0, R, n, s);
    } else if (upd1) {
      bf162 vp[RPT][HOLD ? 1 : NP];
      if constexpr (!HOLD) load_rows2<NP>(vp, o0, R, n, s);
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (c >= n) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) m2[r][c] = zeroh2();
          continue;
        }
        const int z = opaque(s, c + 1);
        const PairSite sc = through(s, z);
        float2 v[RPT];
        bf162 vc[RPT];
        vcol(vc, vp, 0, c, z);
        level_col<NP>(v, vc, [&](int r, int j) { return mrow[r][j]; },
                      fsol1.p[0], c, n, g1, B, s, z);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const bf162 nv = rnd2(v[r]);
          m2[r][c] = R.ok[r] ? nv : zeroh2();
          if (R.ok[r])
            sth2(o0, ((R.i0 + r) * n + c) * sc.plane + sc.idx, nv, s);
        }
      }
    } else if (need2) {
      load_rows2<NP>(m2, o0, R, n, s);
    }
  }

  // Upper slabs: level L (multiplier rows mrow, f1), then level L+1
  // (multiplier rows m2, f2); in an emitting block, then the slab's
  // level-(L+2) products.
  for (int u = 1; u < U; ++u) {
    const float* f1 = fsol1.p[u];
    const float* f2 = fsol2.p[u - 1];
    float* st = stage + (sm.nstage == 2 ? (u & 1) * sm.stage : 0);
    const PairSite su = through(s, opaque(s, u));
    for (int rg = threadIdx.y; s.live && rg < rgs; rg += blockDim.y) {
      const RowGroup R = row_group<WHOLE>(rg, NL, n, m);
      const bool lam = R.slab == 0;
      bf16* out = slab_of(R, u);
      const bool from_f = lam && sep1;
      if constexpr (HOLD) {
        if (u + 1 < U && (!lam || (keep2 && !sep1 && !sep2)))
          fetch_rows<NP>(vbuf, u + 1, slab_of(R, u + 1), R, n, T, s);
        cp_async_commit();
        cp_async_wait_prev();
      }
      bf162 vp[RPT][HOLD ? 1 : NP];
      if constexpr (!HOLD) {
        const bool upd1 = !lam || (keep1 && !sep1);
        const bool need2 = !lam || (keep2 && !sep2);
        bf16* o0 = lam ? Fls.p[0] : (R.slab == 1 ? Fxs.p[0] : Fus.p[0]);
        if (upd1)
          load_rows2<NP>(mrow, lam ? FLl : (R.slab == 1 ? FLx : FLu), R, n,
                         su);
        if (need2) load_rows2<NP>(m2, o0, R, n, su);
        if (!(lam && sep2) && (!lam || keep2) && !from_f)
          load_rows2<NP>(vp, out, R, n, su);
      }
      const int part =
          emits ? stage_part(R.slab, (int)threadIdx.z, nn, n * m) : -1;
      if (lam && sep2) {
        put_rows2<NP>(out, f2, R, n, g2, B, su);
      } else if (!lam || keep2) {
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          if (c >= n) continue;
          const int z = opaque(s, 16 * u + c + 1);
          const PairSite sc = through(s, z);
          float2 v[RPT], fc[NP];
          if (from_f) {
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              v[r] = R.ok[r]
                         ? ldf2(f1, gm((R.i0 + r) * n + c, g1, nn, B + z, s.b),
                                s)
                         : zero2();
          } else {
            bf162 vc[RPT];
            vcol(vc, vp, u, c, z);
            if constexpr (HOLD) {
              level_col<NP>(
                  v, vc,
                  [&](int r, int j) {
                    bf162 h = zeroh2();
                    if (j < n)
                      memcpy(&h, mbuf + (r * n + j) * (T + z), sizeof h);
                    return h;
                  },
                  f1, c, n, g1, B, s, z);
            } else {
              level_col<NP>(v, vc, [&](int r, int j) { return mrow[r][j]; },
                            f1, c, n, g1, B, s, z);
            }
          }
          load_fcol2<NP>(fc, f2, c, n, g2, s, B + z);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float2 res = sub2(v[r], row_dot2<NP>(m2, r, fc, z));
            if (!R.ok[r]) continue;
            const int el = (R.i0 + r) * n + c;
            sth2(out, el * sc.plane + sc.idx, rnd2(res), s);
            if (part >= 0) *stage_at(st, part + el) = res;
          }
        }
      }
      // Lambda rows at the other knots: neither level moves them.
    }
    if (emits) {
      __syncthreads();
      emit2<NP>(st, sep, true, u == 1, Fls.p[u], Sout.p[u - 1], Asep3,
                       Bsep3, g3, B, n, m, second_site(s, k1, B));
      if (sm.nstage == 1) __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// B1, bf16 slabs: one level of every upper slab (row_level_kernel's math).
// ---------------------------------------------------------------------------

// The upper slabs run outermost, so that an emitting block (one in 2^(L+1)
// at level L: its knots are (r, r + 1) of a next-level group) stages the
// rows its products read and takes the slab's products after one barrier;
// the other blocks take no barrier. Below the wide tag a thread holds its
// one row group's level-L multiplier rows (packed) across the slabs, and
// loads its rows of each slab at once before their math (every load of a
// slab in flight together); at the wide tag it reloads the multiplier per
// slab and takes a slab's rows a column at a time.
template <class K, bool EMIT, bool VEC>
__global__ void __launch_bounds__(row_level_threads<K>(),
                                  min_blocks2(row_level_threads<K>()))
    row_level2_kernel(const bf16* __restrict__ FLl,
                      const bf16* __restrict__ FLx,
                      const bf16* __restrict__ FLu, PtrsT<bf16> Fls,
                      PtrsT<bf16> Fxs, PtrsT<bf16> Fus, CPtrs fsol,
                      const float* __restrict__ Asep,
                      const float* __restrict__ Bsep, Ptrs Sout, int U, int N,
                      int B, int level, int shift, int n_, int m_) {
  extern __shared__ float smem[];
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  constexpr bool HOLD = !K::WIDE;
  const int nn = n * n, NL = groups_of(n), rgs = 2 * NL + groups_of(m);
  const Smem2 sm =
      smem2(n, m, blockDim.x * blockDim.y * blockDim.z, false, EMIT);
  float* stage = smem;
  float* sep = sm.sep ? stage + sm.nstage * sm.stage : nullptr;
  const PairSite s = pair_site(N, B, shift, VEC);
  const int k = s.k;
  const int half = 1 << level, span = 2 * half;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sepk = (k & (span - 1)) == half;
  const int g = k >> (level + 1);
  // The block's knots are (r, r + 1) of a next-level group: it emits.
  const int k1 = (int)blockIdx.y * LKB - shift + 1;
  const bool emits = EMIT && k1 < N && (k1 & (2 * span - 1)) == span;
  const int g2 = k1 >> (level + 2);
  if (emits && sep)
    load_sep(sep, Asep, Bsep, g2, B, n, m, second_site(s, k1, B));
  auto mult_of = [&](const RowGroup& R) {
    return R.slab == 0 ? FLl : (R.slab == 1 ? FLx : FLu);
  };
  auto slab_of = [&](const RowGroup& R, int u) {
    return R.slab == 0 ? Fls.p[u] : (R.slab == 1 ? Fxs.p[u] : Fus.p[u]);
  };
  // Lambda rows that calc_lambda skips or the separator overwrites read no
  // multiplier rows.
  auto updates = [&](const RowGroup& R) {
    return R.slab != 0 || (keep && !sepk);
  };
  bf162 mrow[RPT][NP];
  if constexpr (HOLD) {
    if (s.live && (int)threadIdx.y < rgs) {
      const RowGroup R = row_group<WHOLE>(threadIdx.y, NL, n, m);
      if (updates(R)) load_rows2<NP>(mrow, mult_of(R), R, n, s);
    }
  }

  for (int u = 0; u < U; ++u) {
    const float* fu = fsol.p[u];
    float* st = stage + (sm.nstage == 2 ? (u & 1) * sm.stage : 0);
    const PairSite su = through(s, opaque(s, u + 1));
    for (int rg = threadIdx.y; s.live && rg < rgs; rg += blockDim.y) {
      const RowGroup R = row_group<WHOLE>(rg, NL, n, m);
      bf16* out = slab_of(R, u);
      if (!updates(R)) {
        if (R.slab == 0 && sepk) put_rows2<NP>(out, fu, R, n, g, B, su);
        continue;  // lambda rows neither level moves
      }
      if constexpr (!HOLD) load_rows2<NP>(mrow, mult_of(R), R, n, su);
      bf162 vp[RPT][HOLD ? NP : 1];
      if constexpr (HOLD) load_rows2<NP>(vp, out, R, n, su);
      const int part =
          emits ? stage_part(R.slab, (int)threadIdx.z, nn, n * m) : -1;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (c >= n) continue;
        const int z = opaque(s, 16 * u + c + 1);
        const PairSite sc = through(s, z);
        float2 fc[NP];
        load_fcol2<NP>(fc, fu, c, n, g, s, B + z);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (!R.ok[r]) continue;
          const int el = (R.i0 + r) * n + c;
          const unsigned o = el * sc.plane + sc.idx;
          bf162 v;
          if constexpr (HOLD)
            v = vp[r][c];
          else
            v = ldh2(out, o, s);
          const float2 res = sub2(up2(v), row_dot2<NP>(mrow, r, fc, z));
          sth2(out, o, rnd2(res), s);
          if (part >= 0) *stage_at(st, part + el) = res;
        }
      }
    }
    if (emits) {
      __syncthreads();
      emit2<NP>(st, sep, true, u == 0, Fls.p[u], Sout.p[u], Asep, Bsep, g2,
                B, n, m, second_site(s, k1, B));
      if (sm.nstage == 1) __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// B3, bf16 slabs: the fused leaf (leaf_row_kernel's math).
// ---------------------------------------------------------------------------

// A row group's multiplier rows, held across the slabs: a value row
// group's level-0 ones (x rows: Q^-1 A', u rows: R^-1 B'), w[q][j] =
// src[j][i] * scale[i]; knot 0's lambda rows, w[q][j] = -A[j][i] (fl_0 =
// -A'). One set of registers for either; the scale entries are loaded
// again at each slab (they would hold 6 registers more).
template <int NP>
struct LeafRows2 {
  float2 w[RPT][NP];
};

// The scale entries (Q^-1 or R^-1) of a value row group's rows.
__device__ __forceinline__ void leaf_scale2(float2 (&sc)[RPT],
                                            const float* scale,
                                            const RowGroup& R,
                                            const PairSite& s) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    sc[q] = R.ok[q] ? ldf2(scale, (R.i0 + q) * s.plane + s.idx, s) : zero2();
}

template <int NP>
__device__ __forceinline__ void leaf_rows2(LeafRows2<NP>& L, const float* A,
                                           const float* src,
                                           const float* scale,
                                           const RowGroup& R, int cols, int n,
                                           int k, const PairSite& s) {
  if (R.slab == 0) {
    if (k != 0) return;
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (R.ok[q] && j < n) {
          const float2 a = ldf2(A, (j * n + R.i0 + q) * s.plane + s.idx, s);
          L.w[q][j] = make_float2(-a.x, -a.y);
        } else {
          L.w[q][j] = zero2();
        }
      }
    return;
  }
  float2 sc[RPT];
  leaf_scale2(sc, scale, R, s);
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      L.w[q][j] =
          R.ok[q] && j < n
              ? mul2(ldf2(src, (j * cols + R.i0 + q) * s.plane + s.idx, s),
                     sc[q])
              : zero2();
}

// Slab u's x (``xrows``) or u rows of this row group (leaf_value_rows at one
// slab); ``part`` their place in the stage of an emitting block, or -1. The
// columns are unrolled, so that a row's own level-u value src[c][i] *
// scale[i] is w[q][c], the product leaf_rows2 formed (the f32 kernel reads
// src again to keep its column loop at run time).
template <int NP>
__device__ __forceinline__ void leaf_value_slab2(
    const LeafRows2<NP>& L, const float* __restrict__ scale, bool xrows,
    bf16* o, const float* fs, float* stage, int part, int u, const RowGroup& R,
    int n, int k, int N, int g, int B, const PairSite& s) {
  const LeafMask l0 = leaf_mask(0, k, N), lu = leaf_mask(u, k, N);
  const bool own0 = xrows ? l0.own : l0.ownu, prev0 = xrows && l0.prev;
  const bool own = xrows ? lu.own : lu.ownu, prev = xrows && lu.prev;
  float2 scl[RPT];
  leaf_scale2(scl, scale, R, s);
#pragma unroll
  for (int c = 0; c < NP; ++c) {
    if (c >= n) continue;
    const int z = opaque(s, 16 * u + c + 1);
    const PairSite sc = through(s, z);
    // f's column, or, after a level-0 separator, its rows' entries.
    float2 fc[NP];
    if (u > 0 && own0) {
      load_fcol2<NP>(fc, fs, c, n, g, s, B + z);
    } else if (u > 0 && prev0) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        fc[q] = R.ok[q] ? ldf2(fs, gm((R.i0 + q) * n + c, g, n * n, B + z,
                                      s.b),
                               s)
                        : zero2();
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (!R.ok[q]) continue;
      const int i = R.i0 + q;
      // (M_0 @ f)[i, c], summed in order (leaf_value_rows).
      float2 acc = zero2();
      if (u > 0 && own0) {
        acc = row_dot2<NP>(L.w, q, fc);
      } else if (u > 0 && prev0) {
        acc = make_float2(-scl[q].x * fc[q].x, -scl[q].y * fc[q].y);
      }
      float2 v = own ? L.w[q][c] : zero2();
      if (c == i) v = sub2(v, prev ? scl[q] : zero2());
      if (u > 0) v = sub2(v, acc);
      sth2(o, (i * n + c) * sc.plane + sc.idx, rnd2(v), s);
      if (part >= 0) *stage_at(stage, part + i * n + c) = v;
    }
  }
}

// Slab u's lambda rows of this row group (leaf_lambda_rows at one slab);
// at knot 0 from L's rows (-A').
template <int NP>
__device__ __forceinline__ void leaf_lambda_slab2(
    const LeafRows2<NP>& L, const float* __restrict__ A,
    const float* __restrict__ S0, bf16* o, const float* fs, int u,
    const RowGroup& R, int n, int k, int g, int B, const PairSite& s) {
  if (k & 1) {
    put_rows2<NP>(o, u == 0 ? S0 : fs, R, n, g, B, s);
    return;
  }
  if (u == 1 && (k & 3) == 2) return;  // the product emission writes them
  if (k != 0) {
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int c = 0; c < NP; ++c)
        if (R.ok[q] && c < n)
          sth2(o, ((R.i0 + q) * n + c) * s.plane + s.idx, zeroh2(), s);
    return;
  }
  // Knot 0: fl_0 = -A' (slab 0), -(fl_0 @ f) (upper slabs).
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    float2 fc[NP];
    if (u > 0) load_fcol2<NP>(fc, fs, c, n, g, s, B);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (!R.ok[q]) continue;
      float2 v;
      if (u > 0) {
        v = sub2(zero2(), row_dot2<NP>(L.w, q, fc));
      } else {
        const float2 a = ldf2(A, (c * n + R.i0 + q) * s.plane + s.idx, s);
        v = make_float2(-a.x, -a.y);
      }
      sth2(o, ((R.i0 + q) * n + c) * s.plane + s.idx, rnd2(v), s);
    }
  }
}

// B3's scalar-pair path takes one block an SM: under the 20-warp cap it
// spilled 8 bytes at (6, 3) (151 registers without it).
template <class K, bool VEC>
__global__ void __launch_bounds__(row_pair_threads<K>(),
                                  VEC ? pair2_min_blocks<K>() : 1)
    leaf_row2_kernel(const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ qinv,
                     const float* __restrict__ rinv,
                     const float* __restrict__ S0, CPtrs fsol,
                     const float* __restrict__ Asep,
                     const float* __restrict__ Bsep, PtrsT<bf16> Fls,
                     PtrsT<bf16> Fxs, PtrsT<bf16> Fus, Ptrs Sout, int depth,
                     int N, int B, int n_, int m_) {
  extern __shared__ float smem[];
  constexpr int NP = K::NP;
  const int n = K::EX ? NP : n_, m = K::EX ? K::MP : m_;
  constexpr bool WHOLE = K::EX && NP % RPT == 0 && K::MP % RPT == 0;
  constexpr bool HOLD = !K::WIDE;
  const int nn = n * n, NL = groups_of(n), rgs = 2 * NL + groups_of(m);
  const Smem2 sm =
      smem2(n, m, blockDim.x * blockDim.y * blockDim.z, false, true);
  float* stage = smem;
  float* sep = sm.sep ? stage + sm.nstage * sm.stage : nullptr;
  const PairSite s = pair_site(N, B, 1, VEC);
  const int k = s.k, g = k >> 1;
  // The block's second knot is r + 1 of a level-1 group: it emits.
  const int k1 = (int)blockIdx.y * LKB;
  const bool emits = k1 < N && (k1 & 3) == 2;
  if (emits && sep)
    load_sep(sep, Asep, Bsep, k1 >> 2, B, n, m,
             second_site(s, k1, B));
  LeafRows2<NP> L;
  auto rows = [&](const RowGroup& R, const PairSite& at) {
    const bool x = R.slab == 1;
    leaf_rows2<NP>(L, A, x ? A : Bm, x ? qinv : rinv, R, x ? n : m, n, k, at);
  };
  if constexpr (HOLD) {
    if (s.live && (int)threadIdx.y < rgs)
      rows(row_group<WHOLE>(threadIdx.y, NL, n, m), s);
  }
  for (int u = 0; u < depth; ++u) {
    const float* fs = u > 0 ? fsol.p[u - 1] : nullptr;
    float* st = stage + (sm.nstage == 2 ? (u & 1) * sm.stage : 0);
    const int z = opaque(s, u + 1);
    const PairSite su = through(s, z);
    for (int rg = threadIdx.y; s.live && rg < rgs; rg += blockDim.y) {
      const RowGroup R = row_group<WHOLE>(rg, NL, n, m);
      if constexpr (!HOLD) rows(R, su);
      if (R.slab == 0) {
        leaf_lambda_slab2<NP>(L, A, S0, Fls.p[u], fs, u, R, n, k, g, B + z,
                              su);
        continue;
      }
      const bool xrows = R.slab == 1;
      const int part = emits && u > 0
                           ? stage_part(R.slab, (int)threadIdx.z, nn, n * m)
                           : -1;
      leaf_value_slab2<NP>(L, xrows ? qinv : rinv, xrows,
                           xrows ? Fxs.p[u] : Fus.p[u], fs, st, part, u, R, n,
                           k, N, g, B + z, su);
    }
    if (emits && u > 0) {
      __syncthreads();
      emit2<NP>(st, sep, false, u == 1, Fls.p[u], Sout.p[u - 1], Asep,
                       Bsep, k1 >> 2, B, n, m,
                       second_site(s, k1, B));
      if (sm.nstage == 1) __syncthreads();
    }
  }
}

// -- Launchers --------------------------------------------------------------

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class F>
int with_stage(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The bf16 plan's checks: ``smem`` the block's shared memory (smem2) for
// ``slots`` row-group slots, ``vec`` only where B is even.
inline bool plan2_ok(int slots, bool pair, int emit, int n, int m, int B,
                     int vec, long long smem) {
  const int threads = TB * LKB * slots;
  return smem == (long long)smem2(n, m, threads, pair, emit).bytes() &&
         (vec == 0 || (vec == 1 && B % 2 == 0));
}

// B3 and B4: the pair kernel's slots.
inline bool pair2_plan_ok(bool pair, int emit, int n, int m, int B, int vec,
                          long long smem) {
  return plan2_ok(pair_slots_of(n, m, m > MAX_STATE_DIM), pair, emit, n, m,
                  B, vec, smem);
}

// B1: the level kernel's slots, no slab buffers.
inline bool level2_plan_ok(int emit, int n, int m, int B, int vec,
                           long long smem) {
  return plan2_ok(slots_of(n, m), false, emit, n, m, B, vec, smem);
}

template <class K>
int launch_row_level2(const void* FLl, const void* FLx, const void* FLu,
                      void* const* Fls, void* const* Fxs, void* const* Fus,
                      void* const* fsol, const float* Asep, const float* Bsep,
                      void* const* S, int U, int N, int B, int level,
                      int emit, int n, int m, int shift, int gy, int vec,
                      size_t smem, cudaStream_t st) {
  const dim3 grid((B + TB2 - 1) / TB2, gy), block(TB, slots_of(n, m), LKB);
  const auto ml = static_cast<const bf16*>(FLl);
  const auto mx = static_cast<const bf16*>(FLx);
  const auto mu = static_cast<const bf16*>(FLu);
  auto kernel = emit ? (vec ? row_level2_kernel<K, true, true>
                            : row_level2_kernel<K, true, false>)
                     : (vec ? row_level2_kernel<K, false, true>
                            : row_level2_kernel<K, false, false>);
  if (const int err = with_stage(kernel, smem)) return err;
  kernel<<<grid, block, smem, st>>>(
      ml, mx, mu, ptrs<bf16>(Fls), ptrs<bf16>(Fxs), ptrs<bf16>(Fus),
      cptrs(fsol), Asep, Bsep, ptrs(S), U, N, B, level, shift, n, m);
  return 0;
}

template <class K>
int launch_row_pair2(const void* FLl, const void* FLx, const void* FLu,
                     void* const* Fls, void* const* Fxs, void* const* Fus,
                     void* const* fsol1, const float* Sbar2,
                     void* const* fsol2, const float* Asep3,
                     const float* Bsep3, void* const* S, int U, int N, int B,
                     int level, int emit, int n, int m, int shift, int gy,
                     int vec, size_t smem, cudaStream_t st) {
  const dim3 grid((B + TB2 - 1) / TB2, gy),
      block(TB, pair_slots_of(n, m, K::WIDE), LKB);
  const auto ml = static_cast<const bf16*>(FLl);
  const auto mx = static_cast<const bf16*>(FLx);
  const auto mu = static_cast<const bf16*>(FLu);
  auto kernel = emit ? (vec ? row_pair2_kernel<K, true, true>
                            : row_pair2_kernel<K, true, false>)
                     : (vec ? row_pair2_kernel<K, false, true>
                            : row_pair2_kernel<K, false, false>);
  if (const int err = with_stage(kernel, smem)) return err;
  kernel<<<grid, block, smem, st>>>(
      ml, mx, mu, ptrs<bf16>(Fls), ptrs<bf16>(Fxs), ptrs<bf16>(Fus),
      cptrs(fsol1), Sbar2, cptrs(fsol2), Asep3, Bsep3, ptrs(S), U, N, B,
      level, shift, n, m);
  return 0;
}

template <class K>
int launch_leaf_rows2(const float* A, const float* Bm, const float* qinv,
                      const float* rinv, const float* S0, void* const* fsol,
                      const float* Asep, const float* Bsep, void* const* Fls,
                      void* const* Fxs, void* const* Fus, void* const* S,
                      int depth, int N, int B, int n, int m, int gy, int vec,
                      size_t smem, cudaStream_t st) {
  const dim3 grid((B + TB2 - 1) / TB2, gy),
      block(TB, pair_slots_of(n, m, K::WIDE), LKB);
  auto kernel = vec ? leaf_row2_kernel<K, true> : leaf_row2_kernel<K, false>;
  if (const int err = with_stage(kernel, smem)) return err;
  kernel<<<grid, block, smem, st>>>(
      A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep, ptrs<bf16>(Fls),
      ptrs<bf16>(Fxs), ptrs<bf16>(Fus), ptrs(S), depth, N, B, n, m);
  return 0;
}

}  // namespace small_blocks
