// Hand-written Hopper kernels for the element-major rsLQR sweep.
//
// Four kernels, one per TPU kernel of rslqr_tpu/ops/schur_pallas.py:
//   row_level_kernel <- schur_update_level_em (one tree level, every upper
//                       slab; row_groups.cuh, on row groups)
//   row_pair_kernel  <- schur_update_pair_em  (levels L and L+1 in one pass;
//                       row_groups.cuh, on the same row groups)
//   leaf_row_kernel  <- leaf_schur_level0_em  (leaf factors + level 0;
//                       leaf_rows.cuh, on the same row groups)
//   rhs_kernel       <- rhs_update_level_em   (one level of the RHS sweep)
//
// Layout (as in the JAX package): factor slabs are element-major planes
// [e, N, B] (element e of knot k, batch column b at e*N*B + k*B + b);
// solved separator blocks and emitted products are group-major [G, e, B].
// float32 only. Block sizes: every 1 <= n <= 8, 1 <= m <= 64, through the
// instantiations of small_blocks.cuh (the exact (6, 3), the (4, 4) and
// (8, 8) capacities with n, m at run time, and the wide tag whose u rows
// come in chunks of 8).
//
// Mapping of rhs_kernel (the others: see row_groups.cuh and leaf_rows.cuh):
// one thread per (knot, batch column). A block is TB=32 batch columns (one
// warp, so every slab load/store is a coalesced 128-byte line) by TK knots
// (tk_of: 8, or 4 at the (8, 8) capacity and the wide tag), block row y
// covering knots y*TK-1 .. y*TK+TK-2.
//
// Bound: bandwidth (~0.4 FLOP/byte). Each launcher returns
// cudaGetLastError() right after the launch; the Python wrapper raises on a
// nonzero code. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC (rslqr_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cstddef>

#include "leaf_rows.cuh"
#include "row_groups.cuh"
#include "small_blocks.cuh"

namespace {

using small_blocks::chunk_rows;
using small_blocks::chunks;
using small_blocks::load_blk;
using small_blocks::TB;
using small_blocks::with_block;

// Knots per block.
template <class K>
__host__ __device__ constexpr int tk_of() {
  return K::NP * K::NP + K::MP * K::NP > 64 ? 4 : 8;
}

struct Site {
  int b, k;
  bool live;
  size_t idx, plane;
};

template <int TK>
__device__ __forceinline__ Site site(int N, int B) {
  Site s;
  s.b = blockIdx.x * TB + threadIdx.x;
  s.k = blockIdx.y * TK + threadIdx.y - 1;
  s.live = s.b < B && s.k >= 0 && s.k < N;
  s.plane = (size_t)N * B;
  s.idx = s.live ? (size_t)s.k * B + s.b : 0;
  return s;
}

// Element e of group g of a group-major [G, E, B] array.
__device__ __forceinline__ size_t gidx(int g, int E, int e, int B, int b) {
  return ((size_t)g * E + e) * B + b;
}

// A rows x cols block of group g of a group-major array.
template <int R, int C>
__device__ __forceinline__ void load_group(float (&r)[R * C],
                                           const float* src, int rows,
                                           int cols, int g, int B, int b) {
  const int E = rows * cols;
  load_blk<R, C>(r, rows, cols,
                 [&](int e) { return src[gidx(g, E, e, B, b)]; });
}

// ---------------------------------------------------------------------------
// B2: RHS sweep, one level.
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
__global__ void rhs_kernel(const float* __restrict__ Fl,
                           const float* __restrict__ Fx,
                           const float* __restrict__ Fu, float* zy, float* zx,
                           float* zu, const float* __restrict__ zbar, int N,
                           int B, int level, int n_, int m_) {
  constexpr int NP = K::NP, MP = K::MP;
  const int n = K::EX ? NP : n_, m = K::EX ? MP : m_;
  const Site s = site<tk_of<K>()>(N, B);
  if (!s.live) return;
  const int k = s.k, half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  float zb[NP];
  load_group<1, NP>(zb, zbar, 1, n, k >> (level + 1), B, s.b);
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

template <class K>
dim3 grid_for(int N, int B) {
  constexpr int TK = tk_of<K>();
  return dim3((B + TB - 1) / TB, (N + TK) / TK);  // knots -1 .. N-1
}

template <class K>
dim3 block_for() {
  return dim3(TB, tk_of<K>());
}

}  // namespace

extern "C" {

const char* rslqr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rslqr_rhs_update_level(const float* Fl, const float* Fx, const float* Fu,
                           float* zy, float* zx, float* zu, const float* zbar,
                           int N, int B, int level, int n, int m,
                           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    rhs_kernel<K><<<grid_for<K>(N, B), block_for<K>(), 0, st>>>(
        Fl, Fx, Fu, zy, zx, zu, zbar, N, B, level, n, m);
  });
}

// B1 on the plan of ops/schur.py:_level_plan (``shift``, ``gy`` grid rows,
// ``rgs`` row groups); a plan that does not cover the level is refused.
int rslqr_schur_update_level(const float* FLl, const float* FLx,
                             const float* FLu, void* const* Fls,
                             void* const* Fxs, void* const* Fus,
                             void* const* fsol, const float* Asep,
                             const float* Bsep, void* const* S, int U, int N,
                             int B, int level, int emit, int n, int m,
                             int shift, int gy, int rgs, void* stream) {
  if (!small_blocks::row_plan_ok(U, N, level, emit, n, m, shift, gy, rgs))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    small_blocks::launch_row_level<K, small_blocks::GroupMajor>(
        FLl, FLx, FLu, Fls, Fxs, Fus, fsol, Asep, Bsep, S, U, N, B, level,
        emit, n, m, shift, gy, st);
  });
}

// B4 on the same plan as B1 (ops/schur.py:_level_plan); the pair needs
// whole level-(L+1) groups and at most MAXU upper slabs.
int rslqr_schur_update_pair(const float* FLl, const float* FLx,
                            const float* FLu, void* const* Fls,
                            void* const* Fxs, void* const* Fus,
                            void* const* fsol1, const float* Sbar2,
                            void* const* fsol2, const float* Asep3,
                            const float* Bsep3, void* const* S, int U, int N,
                            int B, int level, int emit, int n, int m,
                            int shift, int gy, int rgs, void* stream) {
  if (U < 1 || !small_blocks::row_plan_ok(U, N, level, emit, n, m, shift, gy,
                                          rgs) ||
      (N >> (level + 2)) < 1 || (emit && (N >> (level + 3)) < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    small_blocks::launch_row_pair<K, small_blocks::GroupMajor>(
        FLl, FLx, FLu, Fls, Fxs, Fus, fsol1, Sbar2, fsol2, Asep3, Bsep3, S,
        U, N, B, level, emit, n, m, shift, gy, st);
  });
}

// B3 on the pair kernel's emitting plan (ops/schur.py:_level_plan).
int rslqr_leaf_schur_level0(const float* A, const float* Bm,
                            const float* qinv, const float* rinv,
                            const float* S0, void* const* fsol,
                            const float* Asep, const float* Bsep,
                            void* const* Fls, void* const* Fxs,
                            void* const* Fus, void* const* S, int depth, int N,
                            int B, int n, int m, int shift, int gy, int rgs,
                            void* stream) {
  if (!small_blocks::leaf_plan_ok(depth, N, n, m, shift, gy, rgs))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    small_blocks::launch_leaf_rows<K, small_blocks::GroupMajor>(
        A, Bm, qinv, rinv, S0, fsol, Asep, Bsep, Fls, Fxs, Fus, S, depth, N,
        B, n, m, gy, st);
  });
}

}  // extern "C"
