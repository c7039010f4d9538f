// Hand-written Hopper kernel for the unpivoted multi-right-hand-side LU solve
// on element planes (8 < n <= 64):
//   plu_kernel  <- rslqr_tpu/ops/planes_pallas.py: plu_solve_multi / plu_solve
//                  (_lu_solve_kernel)
//
// Computes X_r = A^-1 B_r for 1..4 right-hand sides with ONE unpivoted
// Doolittle LU of A per plane element: A [n, n, F], B_r and X_r [n, w_r, F],
// element (i, j) of a block at (i*cols + j)*F + f. No pivoting, as in the TPU
// kernel: its callers (the parallel scan's I + C J and I + V J U blocks)
// have eigenvalues >= 1. X_r are fresh outputs (separate pointers from
// B_r): the TPU kernel's donation of B_r is an aliasing hint there, and an
// in-place write here would overwrite operands the caller still reads.
//
// Bound: at the scan's shapes (n = 36 with 74 or 37 right-hand columns,
// n = 12 with 12) the LU and the substitutions do 2n^3/3 + 2n^2 w FLOP over
// 4(n^2 + 2nw) bytes, ~6-9 FLOP/byte, under the H100's ~20 f32 FLOP/byte:
// bytes-bound at the roofline, but with few blocks per call (F = 4096 plane
// elements is 128 blocks) it is latency-bound in practice.
//
// Design (a simple one that is right; the TPU kernel is one pallas_call with
// a VMEM LU scratch, and this is one launch per call too): a block owns 32
// plane elements, one per lane, so every load and store is a coalesced
// 128-byte line. Its 8 warps first copy the lanes' A into the LU scratch
// (shared memory: n^2 * 32 floats, 166 KB at n = 36; a lane-private slot of a
// global scratch for n > 36, where it does not fit), then factor it
// right-looking, one column step per __syncthreads with the rows below the
// pivot spread over the warps. Then every warp takes right-hand columns: a
// column lives in registers through the unit-lower forward and the upper
// back substitution, reading L and U from the scratch. Register columns are
// instantiated for 12, 36 and 64 floats, as in planes_kernels.cu, and their
// unrolled loops carry no branch on the runtime n.
//
// The launcher returns cudaGetLastError() right after the launch; the Python
// wrapper (rslqr_tpu_torch/ops/planes.py) raises on a nonzero code.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAXD = 64;      // largest block dim (matches ops/planes.py)
constexpr int LANES = 32;     // plane elements per block (one per lane)
constexpr int LU_WARPS = 8;   // warps per block
constexpr int MAX_RHS = 4;    // right-hand sides per launch
constexpr int SMEM_W = 36;    // widths up to this factor in shared memory

struct LuArgs {
  const float* A;          // [n, n, F]
  float* scratch;          // [n, n, gridDim.x * LANES] (n > SMEM_W only)
  const float* B[MAX_RHS];  // [n, w_r, F]
  float* X[MAX_RHS];        // [n, w_r, F]
  int w[MAX_RHS];
  int nrhs, n, F;
};

__device__ __forceinline__ int clampk(int k, int K) {
  return k < K ? k : K - 1;
}

template <int W, bool SMEM>
__global__ void __launch_bounds__(LANES * LU_WARPS)
    plu_kernel(const LuArgs a) {
  extern __shared__ float S[];  // [n][n][LANES] when SMEM
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int f0 = blockIdx.x * LANES + lane;
  const bool live = f0 < a.F;
  const size_t F = a.F;
  const size_t f = live ? f0 : a.F - 1;  // dead lanes load a valid address
  const int n = a.n;
  // This lane's LU element (i, j): its shared-memory slot, or its own slot
  // of the global scratch (indexed by f0, so dead lanes write apart).
  float* lu;
  size_t ls;
  if constexpr (SMEM) {
    lu = S + lane;
    ls = LANES;
  } else {
    lu = a.scratch + f0;
    ls = (size_t)gridDim.x * LANES;
  }
  auto at = [&](int i, int j) -> float& {
    return lu[((size_t)i * n + j) * ls];
  };

  for (int t = warp; t < n * n; t += LU_WARPS)
    lu[(size_t)t * ls] = a.A[(size_t)t * F + f];
  __syncthreads();
  // Right-looking Doolittle: step k scales column k below the pivot and
  // updates the trailing rows (each warp its own rows).
  for (int k = 0; k + 1 < n; ++k) {
    const float inv = 1.f / at(k, k);
    for (int i = k + 1 + warp; i < n; i += LU_WARPS) {
      const float l = at(i, k) * inv;
      at(i, k) = l;
#pragma unroll 4
      for (int j = k + 1; j < n; ++j) at(i, j) = fmaf(-l, at(k, j), at(i, j));
    }
    __syncthreads();
  }

  // Unused right-hand sides have width 0, so the stacked columns end at
  // the last one in use.
  const int w0 = a.w[0], w1 = a.w[1], w2 = a.w[2], w3 = a.w[3];
  const int total = w0 + w1 + w2 + w3;
  for (int c = warp; c < total; c += LU_WARPS) {
    // Column c of the stacked right-hand sides: RHS r, its column cc.
    int r = 0, cc = c;
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
    const float* B = r == 0 ? a.B[0] : r == 1 ? a.B[1] : r == 2 ? a.B[2]
                                                                 : a.B[3];
    float* X = r == 0 ? a.X[0] : r == 1 ? a.X[1] : r == 2 ? a.X[2] : a.X[3];
    const int w = r == 0 ? w0 : r == 1 ? w1 : r == 2 ? w2 : w3;
    float x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float v = B[((size_t)clampk(k, n) * w + cc) * F + f];
      x[k] = k < n ? v : 0.f;
    }
#pragma unroll
    for (int i = 1; i < W; ++i) {  // unit-lower forward substitution
      if (i < n) {
        float s = x[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = fmaf(-at(i, k), x[k], s);
        x[i] = s;
      }
    }
#pragma unroll
    for (int i = W - 1; i >= 0; --i) {  // U back substitution
      if (i < n) {
        float s = x[i];
#pragma unroll
        for (int k = i + 1; k < W; ++k)  // x[k] = 0 for k >= n
          s = fmaf(-at(i, clampk(k, n)), x[k], s);
        x[i] = s * (1.f / at(i, i));
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i < n) X[((size_t)i * w + cc) * F + f] = x[i];
    }
  }
}

template <int W>
int launch_plu(const LuArgs& a, cudaStream_t st) {
  const dim3 grid((a.F + LANES - 1) / LANES);
  const dim3 block(LANES, LU_WARPS);
  if constexpr (W <= SMEM_W) {
    const int smem = a.n * a.n * LANES * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        plu_kernel<W, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    plu_kernel<W, true><<<grid, block, smem, st>>>(a);
  } else {
    if (!a.scratch) return static_cast<int>(cudaErrorInvalidValue);
    plu_kernel<W, false><<<grid, block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Solve A X_r = B_r for r < nrhs (1..4). ``scratch`` holds n*n*ceil(F/32)*32
// floats when n > 36 (else it may be null). X_r must not alias A or any B.
int rslqr_plu_solve_multi(const float* A, float* scratch,
                          const float* const* Bs, float* const* Xs,
                          const int* ws, int nrhs, int n, int F,
                          void* stream) {
  if (n < 1 || n > MAXD || nrhs < 1 || nrhs > MAX_RHS || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LuArgs a = {};
  a.A = A;
  a.scratch = scratch;
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
  if (n <= SMEM_W) return launch_plu<36>(a, st);
  return launch_plu<64>(a, st);
}

}  // extern "C"
