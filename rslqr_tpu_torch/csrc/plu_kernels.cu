// Hand-written Hopper kernel for the unpivoted multi-right-hand-side LU
// solve on element planes (1 <= n <= 64):
//   plu_kernel <- rslqr_tpu/ops/planes_pallas.py: plu_solve_multi /
//                 plu_solve (_lu_solve_kernel)
//
// Computes X_r = A^-1 B_r for 1..4 right-hand sides with ONE unpivoted
// Doolittle LU of A per plane element: A [n, n, F], B_r and X_r [n, w_r, F],
// element (i, j) of a block at (i*cols + j)*F + f. No pivoting, as in the TPU
// kernel: its callers (the parallel scan's I + C J and I + V J U blocks)
// have eigenvalues >= 1. X_r are fresh outputs (separate pointers from
// B_r): the TPU kernel's donation of B_r is an aliasing hint there, and an
// in-place write here would overwrite operands the caller still reads.
// One launch per call, of plu_kernel<W> at the register width W (12, 36,
// 48 or 64) that holds n.
//
// Bound: at the scan's shapes (n = 36 with 74 or 37 right-hand columns,
// n = 12 with 12) the LU and the substitutions do 2n^3/3 + 2n^2 w FLOP over
// 4(n^2 + 2nw) bytes, ~6-9 FLOP/byte, under the H100's ~20 f32 FLOP/byte:
// bytes-bound at the roofline. But the scan calls it on small planes
// (F = 1,792-4,096), where what sets the time is how many SMs and warps
// the call keeps busy and how long each block's chain of steps is.
//
// plu_kernel. A block owns LU_LANES = 8 plane elements (one 32-byte
// sector) and W slots of 8 threads (W = 12, 36, 48 or 64, the register
// width that holds n). The grid runs (plane chunk x column group), the
// groups of one chunk next to each other (A comes from HBM once, then from
// L2). Factor: slot i holds row i of its element's A in registers (every
// load in flight at once) and the factorization runs right-looking, one
// barrier a step: row k, final at step k, writes U(k, k..n-1) and
// 1/u(k, k) to shared memory; each row i > k forms l(i, k), writes it
// beside, and updates its entries from U's row k. The shared LU is
// column-major, in dynamic shared memory (41.5 KB at W = 36: four blocks
// per SM, where the first kernel's 166 KB allowed one; 72 KB at W = 48
// and 128 KB at W = 64, opted in above 48 KB). Solve: each slot takes
// right-hand columns in turn, each in registers through the unit-lower
// forward and the upper back substitution, both right-looking from the
// shared LU (one shared load per FMA at an immediate offset; the four slots
// of a warp read the same word). Every block refactors its chunk's A (at n = 36, 15k FMAs per
// element against 1,260 per right-hand column), so the launcher makes as
// many column groups as keep the grid within one wave of resident blocks:
// at the pscan's (36, 1, 36, 1) on F = 2,048, 512 blocks of 8 elements and
// 37 columns, where the first kernel ran 64 blocks of 32 elements whose 8
// warps took the 74 columns in 10 passes. The loops are unrolled to W with
// branches on the runtime n. Not chosen (PERF.md, timed on the H100): the
// right-hand columns in each row's registers through the elimination
// (1.1-1.6x slower than the old kernel), and the factorization in shared
// memory by rows, a dependent shared load, FMA and store per update (no
// faster than the old kernel).
//
// Above 36 (W = 48, 64) the same design replaces plu_scratch_kernel,
// which kept each lane's LU in a global scratch (a
// dependent global load, FMA and store per update, 64 blocks at F = 2,048);
// registers set the blocks per SM: two of 384 threads at W = 48 (80
// registers), one of 512 at W = 64 (128).
//
// Each launcher returns cudaGetLastError() right after the launch; the
// Python wrapper (rslqr_tpu_torch/ops/planes.py) raises on a nonzero code.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAXD = 64;      // largest block dim (matches ops/planes.py)
constexpr int MAX_RHS = 4;    // right-hand sides per launch
constexpr int LU_LANES = 8;   // plane elements per block

// Blocks per SM the register cap of plu_kernel<W> aims at.
template <int W>
__host__ __device__ constexpr int plu_min_blocks() {
  return W <= 36 ? 4 : (W <= 48 ? 2 : 1);
}

// Dynamic shared memory of a plu_kernel<W> block: the column-major LU and
// 1 / u(k, k), W * W + W words a plane element.
template <int W>
constexpr size_t plu_smem() {
  return (size_t)(W * W + W) * LU_LANES * sizeof(float);
}

struct LuArgs {
  const float* A;          // [n, n, F]
  const float* B[MAX_RHS];  // [n, w_r, F]
  float* X[MAX_RHS];        // [n, w_r, F]
  int w[MAX_RHS];           // 0 past the last right-hand side in use
  int nrhs, n, F;
  int groups, gw;  // plu_kernel: column groups per chunk, columns per group
};

// Stacked right-hand column c: offset of its (row, column) origin in B_r /
// X_r, its right-hand side r and that side's width.
struct RhsCol {
  int r, w;
  size_t off;  // (0 * w + cc) * F, the column's row 0
};

__device__ __forceinline__ RhsCol rhs_col(const LuArgs& a, int c) {
  int r = 0, cc = c;
  const int w0 = a.w[0], w1 = a.w[1], w2 = a.w[2];
  if (cc >= w0) {
    cc -= w0;
    r = 1;
    if (cc >= w1) {
      cc -= w1;
      r = 2;
      if (cc >= w2) {
        cc -= w2;
        r = 3;
      }
    }
  }
  const int w = r == 0 ? w0 : r == 1 ? w1 : r == 2 ? w2 : a.w[3];
  return {r, w, (size_t)cc * a.F};
}

__device__ __forceinline__ const float* rhs_in(const LuArgs& a, int r) {
  return r == 0 ? a.B[0] : r == 1 ? a.B[1] : r == 2 ? a.B[2] : a.B[3];
}

__device__ __forceinline__ float* rhs_out(const LuArgs& a, int r) {
  return r == 0 ? a.X[0] : r == 1 ? a.X[1] : r == 2 ? a.X[2] : a.X[3];
}

// Offset of LU element (i, j) of lane 0 in a plu_kernel block's shared LU:
// column-major with a column stride of W rows, so every access of the
// unrolled loops is an immediate offset.
template <int W>
__device__ __forceinline__ constexpr int lu_at(int i, int j) {
  return (j * W + i) * LU_LANES;
}

// W slots of 8 threads: factor rows, then right-hand columns.
template <int W>
__global__ void __launch_bounds__(LU_LANES * W, plu_min_blocks<W>())
    plu_kernel(const LuArgs a) {
  extern __shared__ float smem[];
  float* lu = smem;                       // plu_smem<W>(): 41.5 KB at 36
  float* dinv = smem + W * W * LU_LANES;  // 1 / u(k, k)
  const int lane = threadIdx.x % LU_LANES;
  const int s = threadIdx.x / LU_LANES;  // the thread's slot
  const int chunk = blockIdx.x / a.groups;
  const int c0 = (blockIdx.x % a.groups) * a.gw;  // first stacked column
  const int total = a.w[0] + a.w[1] + a.w[2] + a.w[3];
  const int g = min(a.gw, total - c0);
  const int n = a.n;
  const int f0 = chunk * LU_LANES + lane;
  const bool live = f0 < a.F;
  const size_t F = a.F;
  const size_t f = live ? f0 : a.F - 1;  // dead lanes load a valid address
  float* my = lu + lane;

  {  // Factor: slot s holds row s of A in registers, right-looking.
    const int i = s;
    const bool row = i < n;
    float r[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      r[j] = row && j < n ? a.A[((size_t)i * n + j) * F + f] : 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < n) {
        if (i == k) {  // U(k, k..n-1), final now, and 1 / u(k, k)
#pragma unroll
          for (int j = k; j < W; ++j)
            if (j < n) my[lu_at<W>(k, j)] = r[j];
          dinv[k * LU_LANES + lane] = 1.f / r[k];
        }
        __syncthreads();
        if (row && i > k) {
          const float l = r[k] * dinv[k * LU_LANES + lane];
          my[lu_at<W>(i, k)] = l;
#pragma unroll
          for (int j = k + 1; j < W; ++j)
            if (j < n) r[j] = fmaf(-l, my[lu_at<W>(k, j)], r[j]);
        }
      }
    }
  }  // the last step's barrier follows every write of L and U

  // Solve: slot s takes right-hand columns c0 + s, + W, ... in registers
  // through the unit-lower forward and the upper back substitution, both
  // right-looking.
  for (int cs = s; cs < g; cs += W) {
    const RhsCol c = rhs_col(a, c0 + cs);
    const float* B = rhs_in(a, c.r) + c.off + f;
    const size_t rs = (size_t)c.w * F;  // row stride of B_r and X_r
    float x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = k < n ? B[k * rs] : 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < n) {
#pragma unroll
        for (int i = k + 1; i < W; ++i)
          if (i < n) x[i] = fmaf(-my[lu_at<W>(i, k)], x[k], x[i]);
      }
    }
#pragma unroll
    for (int k = W - 1; k >= 0; --k) {
      if (k < n) {
        x[k] *= dinv[k * LU_LANES + lane];
#pragma unroll
        for (int i = 0; i < k; ++i)
          x[i] = fmaf(-my[lu_at<W>(i, k)], x[k], x[i]);
      }
    }
    if (live) {
      float* X = rhs_out(a, c.r) + c.off + f;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (k < n) X[k * rs] = x[k];
    }
  }
}

// Column groups: one per W right-hand columns (a column per slot), but no
// more than keep the grid within one wave of resident blocks (132 SMs
// (H100 SXM) x plu_min_blocks<W>(), the register cap; at W = 36 the 41.5
// KB shared LU allows 5), since each group refactors its chunk's A; past
// that the slots take several columns in turn. At the pscan's
// (36, 1, 36, 1) on F = 2,048 that is 2 groups of 37 (0.097 ms chained on
// the H100, against 0.125 for 3 groups of 25), at (36, 1) on F = 1,792 2
// groups of 19 (0.057, against 0.071 for one group).
template <int W>
int launch_plu(LuArgs a, cudaStream_t st) {
  const int total = a.w[0] + a.w[1] + a.w[2] + a.w[3];
  const long long chunks = (a.F + LU_LANES - 1) / LU_LANES;
  const long long fit = 132LL * plu_min_blocks<W>() / chunks;
  a.groups = (int)(fit < 1 ? 1 : fit < (total + W - 1) / W
                                     ? fit : (total + W - 1) / W);
  a.gw = (total + a.groups - 1) / a.groups;  // even groups
  const long long blocks = chunks * a.groups;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = plu_smem<W>();
  if (smem > 48 * 1024) {  // dynamic shared memory past 48 KB: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        plu_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plu_kernel<W><<<(unsigned)blocks, LU_LANES * W, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Solve A X_r = B_r for r < nrhs (1..4). X_r must not alias A or any B.
int rslqr_plu_solve_multi(const float* A, const float* const* Bs,
                          float* const* Xs, const int* ws, int nrhs, int n,
                          int F, void* stream) {
  if (n < 1 || n > MAXD || nrhs < 1 || nrhs > MAX_RHS || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LuArgs a = {};
  a.A = A;
  for (int r = 0; r < nrhs; ++r) {
    if (ws[r] < 1 || ws[r] > MAXD)
      return static_cast<int>(cudaErrorInvalidValue);
    a.B[r] = Bs[r];
    a.X[r] = Xs[r];
    a.w[r] = ws[r];
  }
  a.nrhs = nrhs;
  a.n = n;
  a.F = F;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= 12) return launch_plu<12>(a, st);
  if (n <= 36) return launch_plu<36>(a, st);
  if (n <= 48) return launch_plu<48>(a, st);
  return launch_plu<64>(a, st);
}

}  // extern "C"
