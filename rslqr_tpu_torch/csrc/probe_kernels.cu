// Hand-written Hopper kernels for the two kernel-measurement probes of the
// JAX package (probes/probe_pgemm.py):
//   pgemm_ib_kernel  <- pgemm_ib   (_gemm_kernel_ib: C = A @ B over element
//                                   planes, ib rows of A per pass over B)
//   fma_peak_kernel  <- fma_peak   (_fma_peak_kernel: reps dependent FMAs
//                                   per element)
// They lie on no solver path: they measure what the row kernel of B5
// (planes_kernels.cu) could gain from register blocking, and what this
// card's f32 FMA pipes give.
//
// pgemm_ib_kernel. Layout as planes_kernels.cu: A [p, K, F], B [K, q, F],
// C [p, q, F], block element (i, j) a dense plane of F elements at
// (i*cols + j)*F + f. Bound: bytes. At the probe's shape (p = K = q = 36,
// F = 512 * 128) it does 2K = 72 FLOP per output float over ~3 floats
// moved, ~6 FLOP/byte, under the H100's ~20 f32 FLOP/byte: A, B and C once
// are 1.02 GB, 0.304 ms at 3.35 TB/s.
//
// Geometry: rows_kernel's (planes_kernels.cu). A block owns 32 plane
// elements (one per lane, so every plane load and store is a coalesced
// 128-byte line) and one column tile of TC columns (9 at K = 36, 12 for
// K <= 32, 6 up to K = 64, 1 for a single column). The 1-D grid runs the
// column tiles of one plane chunk next to each other, so the chunk's rows of
// A, read once per column tile, come from HBM once and then from L2. The
// block stages B[:, c0:c0+TC] for its lanes in shared memory (K x TC x 32
// floats, at most 48 KB, so several blocks share an SM; the earlier design
// staged B[:, j0:j0+36], 166 KB at K = 36, one block per SM).
//
// The probe's question stays: each warp takes IB rows of A per pass (IB =
// 1, 2 or 4, the probe's ``ib``) and the tile's TC columns. Per term k it
// makes IB coalesced loads of A[i+d, k] and TC shared-memory loads of the
// staged row k, each staged value feeding IB FMAs, with IB x TC
// accumulators in registers. So IB sets the shared-memory (L1) traffic per
// FMA. A row past p repeats row p - 1 and is not stored. With p = 36, IB =
// 4 gives 9 row groups, so at W = 8 warp 0 takes a second group alone and
// at W = 16 seven warps only stage B. Splitting the tile's columns into
// thirds among the warps at IB = 4 (27 items for 8 or 16 warps) was 1.4x
// slower still: three warps then read each row of A from L2 (PERF.md).
//
// ``W`` (the probe's ``t1``, 8 or 16) is the warps of a block. The staged
// slice arrives by cp.async, which holds no registers: staging through
// registers either spilled (three terms' TC loads in flight) or, at eight
// loads in flight, ran IB = 2 19% slower than cp.async (PERF.md). The
// register cap (kIbMinBlocks) follows the accumulators, so that no
// instantiation spills. It is a kernel of its own, not a template flag on rows_kernel, so
// that rows_kernel compiles as it does (such a flag cost it 3.5-5%,
// PERF.md).
//
// fma_peak_kernel. Each element runs acc = x; acc = acc * x + x, ``reps``
// times, as one fmaf per step (the TPU kernel's multiply and add, one
// rounding fewer). Bound: operations (2 FLOP per step, 8 bytes per element).
// Each thread carries FMA_ELEMS independent chains (elements a grid stride
// apart, so the loads stay coalesced), and the step loop is unrolled by
// FMA_UNROLL, so each scheduler finds an FMA whose operands are ready. x is
// read from memory and feeds every step, so nvcc cannot fold the chain. At
// F = 132 * 2048 * FMA_ELEMS elements every SM holds 2048 threads.
//
// Each launcher returns cudaGetLastError() right after the launch; the
// Python wrapper (rslqr_tpu_torch/ops/probe.py) raises on a nonzero code.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAXD = 64;          // largest block dim (matches ops/probe.py)
constexpr int LANES = 32;         // plane elements per block (one per lane)
constexpr int SMEM_TILE = 48 * 1024;  // staged B slice, no opt-in needed
constexpr int FMA_THREADS = 256;
constexpr int FMA_ELEMS = 4;      // independent chains per thread
constexpr int FMA_UNROLL = 16;

// Blocks per SM that the register cap leaves, by the IB x TC accumulators
// of a warp: up to 18, 64 registers (four blocks of 8 warps or two of 16:
// 32 warps an SM); up to 36 (IB = 4 at the 9-column tile), 80 registers at
// 8 warps (24 warps an SM) and 128 at 16 (16 warps); past 36, 128.
template <int IB, int TC, int W>
constexpr int kIbMinBlocks =
    IB * TC <= 18 ? (W == 8 ? 4 : 2)
                  : (W == 16 ? 1 : (IB * TC <= 36 ? 3 : 2));

// Copy 4 bytes from device to shared memory without registers, or write a
// zero when !valid (src must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <int IB, int TC, int W>
__global__ void __launch_bounds__(LANES * W, (kIbMinBlocks<IB, TC, W>))
    pgemm_ib_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ C, int p, int K, int q, int F,
                    int ctiles) {
  extern __shared__ float Bs[];  // [K][TC][LANES]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  // Column tile fastest: the tiles of one plane chunk run together.
  const int c0 = (blockIdx.x % ctiles) * TC;
  const int chunk = blockIdx.x / ctiles;
  const int f0 = chunk * LANES + lane;
  const bool live = f0 < F;
  const size_t Fs = F;
  const size_t f = live ? f0 : F - 1;  // dead lanes load a valid address
  // Stage B[:, c0:c0+TC] (zero past q): every copy in flight at once.
#pragma unroll 4
  for (int t = warp; t < K * TC; t += W) {
    const int k = t / TC, j = t - k * TC;
    const int c = c0 + j < q ? c0 + j : q - 1;  // a dead column reads q - 1
    cp_async4(Bs + t * LANES + lane, B + ((size_t)k * q + c) * Fs + f,
              c0 + j < q);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i0 = warp * IB; i0 < p; i0 += W * IB) {
    const float* arow[IB];
#pragma unroll
    for (int d = 0; d < IB; ++d) {
      const int i = i0 + d < p ? i0 + d : p - 1;  // a dead row repeats
      arow[d] = A + (size_t)i * K * Fs + f;
    }
    float acc[IB][TC];
#pragma unroll
    for (int d = 0; d < IB; ++d)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[d][j] = 0.f;
    // The term loop unrolled by 8 / IB: 8 loads of A in flight at every IB.
#pragma unroll (8 / IB)
    for (int k = 0; k < K; ++k) {
      float a[IB];
#pragma unroll
      for (int d = 0; d < IB; ++d) a[d] = arow[d][(size_t)k * Fs];
      const float* bk = Bs + k * TC * LANES + lane;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float b = bk[j * LANES];
#pragma unroll
        for (int d = 0; d < IB; ++d) acc[d][j] = fmaf(a[d], b, acc[d][j]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int d = 0; d < IB; ++d) {
      if (i0 + d >= p) continue;
      float* crow = C + ((size_t)(i0 + d) * q + c0) * Fs + f;
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (c0 + j < q) crow[(size_t)j * Fs] = acc[d][j];
    }
  }
}

// Column tile: 1 for a single column, else the widest of 12, 9, 6 whose
// staged slice (K x TC x 32 floats) fits 48 KB (rows_kernel's tile_for).
int ib_tile(int q, int K) {
  const int col = LANES * (int)sizeof(float);  // bytes per staged term
  if (q == 1) return 1;
  if (K * 12 * col <= SMEM_TILE) return 12;
  return K * 9 * col <= SMEM_TILE ? 9 : 6;
}

template <int IB, int TC, int W>
int launch_ib(const float* A, const float* B, float* C, int p, int K, int q,
              int F, cudaStream_t st) {
  const int ctiles = (q + TC - 1) / TC;
  const long long blocks = (long long)ctiles * ((F + LANES - 1) / LANES);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = K * TC * LANES * (int)sizeof(float);  // <= 48 KB
  pgemm_ib_kernel<IB, TC, W><<<(unsigned)blocks, dim3(LANES, W), smem, st>>>(
      A, B, C, p, K, q, F, ctiles);
  return static_cast<int>(cudaGetLastError());
}

template <int IB, int W>
int launch_ib_w(const float* A, const float* B, float* C, int p, int K, int q,
                int F, cudaStream_t st) {
  switch (ib_tile(q, K)) {
    case 1:
      return launch_ib<IB, 1, W>(A, B, C, p, K, q, F, st);
    case 12:
      return launch_ib<IB, 12, W>(A, B, C, p, K, q, F, st);
    case 9:
      return launch_ib<IB, 9, W>(A, B, C, p, K, q, F, st);
    default:
      return launch_ib<IB, 6, W>(A, B, C, p, K, q, F, st);
  }
}

template <int IB>
int launch_ib_ib(const float* A, const float* B, float* C, int p, int K,
                 int q, int F, int warps, cudaStream_t st) {
  return warps == 8 ? launch_ib_w<IB, 8>(A, B, C, p, K, q, F, st)
                    : launch_ib_w<IB, 16>(A, B, C, p, K, q, F, st);
}

__global__ void __launch_bounds__(FMA_THREADS)
    fma_peak_kernel(const float* __restrict__ X, float* __restrict__ out,
                    int F, int reps) {
  const size_t stride = (size_t)gridDim.x * FMA_THREADS;
  const size_t f0 = (size_t)blockIdx.x * FMA_THREADS + threadIdx.x;
  float x[FMA_ELEMS], acc[FMA_ELEMS];
#pragma unroll
  for (int e = 0; e < FMA_ELEMS; ++e) {
    const size_t f = f0 + e * stride;
    x[e] = f < (size_t)F ? X[f] : 0.f;
    acc[e] = x[e];
  }
  int r = 0;
  for (; r + FMA_UNROLL <= reps; r += FMA_UNROLL) {
#pragma unroll
    for (int u = 0; u < FMA_UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < FMA_ELEMS; ++e) acc[e] = fmaf(acc[e], x[e], x[e]);
  }
  for (; r < reps; ++r) {
#pragma unroll
    for (int e = 0; e < FMA_ELEMS; ++e) acc[e] = fmaf(acc[e], x[e], x[e]);
  }
#pragma unroll
  for (int e = 0; e < FMA_ELEMS; ++e) {
    const size_t f = f0 + e * stride;
    if (f < (size_t)F) out[f] = acc[e];
  }
}

bool dims_ok(int a) { return a >= 1 && a <= MAXD; }

}  // namespace

extern "C" {

// C = A @ B over F plane elements, ib rows of A per pass, ``warps`` warps
// per block; C must not alias A or B.
int rslqr_pgemm_ib(const float* A, const float* B, float* C, int p, int K,
                   int q, int F, int ib, int warps, void* stream) {
  if (!dims_ok(p) || !dims_ok(K) || !dims_ok(q) || F < 1 ||
      (warps != 8 && warps != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (ib) {
    case 1:
      return launch_ib_ib<1>(A, B, C, p, K, q, F, warps, st);
    case 2:
      return launch_ib_ib<2>(A, B, C, p, K, q, F, warps, st);
    case 4:
      return launch_ib_ib<4>(A, B, C, p, K, q, F, warps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[f] = the reps-step chain acc = acc * X[f] + X[f] from acc = X[f].
int rslqr_fma_peak(const float* X, float* out, int F, int reps,
                   void* stream) {
  if (F < 1 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = (long long)FMA_THREADS * FMA_ELEMS;
  const int blocks = (int)((F + per_block - 1) / per_block);
  fma_peak_kernel<<<blocks, FMA_THREADS, 0, static_cast<cudaStream_t>(
                                               stream)>>>(X, out, F, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
