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
// (i*cols + j)*F + f. Bound: bytes. At the probe's shape (p = K = q = 36)
// it does 2K = 72 FLOP per output float over ~3 floats moved, ~6 FLOP/byte,
// under the H100's ~20 f32 FLOP/byte. The design is rows_kernel's: a block
// owns 32 plane elements (one per lane, so every plane load and store is a
// coalesced 128-byte line) and stages their B[:, j0:j0+QC] in shared memory
// ([K][QC][32] floats, 166 KB at K = QC = 36: one block per SM). What
// differs is the row loop: each warp takes IB rows of A at a time
// (IB = 1, 2 or 4, the probe's ``ib``; at IB = 1 the kernel is
// rows_kernel's product loop, with its unroll and without __restrict__, so
// that IB alone sets the two apart). Per term k it makes IB coalesced
// loads of A[i+d, k] and one pass over the staged row k, each shared-memory
// value feeding IB FMAs, so the shared-memory reads per FMA drop by IB and
// IB * QC accumulators (up to 4 * 36 = 144) live in registers. It is a kernel
// of its own, not a template flag on rows_kernel, so that rows_kernel
// compiles as it does (such a flag cost it 3.5-5%, PERF.md).
//
// ``warps`` is the counterpart of the TPU probe's ``t1`` (the plane tile's
// sublane count, 8 or 16): the warps of a block, 8 or 16. All of a block's
// warps share one staged B, so more warps amortise the staging over more
// rows in flight, at 255 (8 warps) or 128 (16 warps) registers per thread;
// 16 warps with IB = 4 and QC = 36 need more than 128 and spill. With
// p = 36 a pass has 36 / IB row groups, so at IB = 4 only 9 warps of a block
// have rows.
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
constexpr int SMEM_MAX = 232448;  // shared memory a block can use (H100)
constexpr int FMA_THREADS = 256;
constexpr int FMA_ELEMS = 4;      // independent chains per thread
constexpr int FMA_UNROLL = 16;

// Term k of IB rows: IB loads of A[i+d, k], each staged B[k, j] feeding IB
// FMAs.
template <int IB, int QC>
__device__ __forceinline__ void ib_term(float (&acc)[IB][QC],
                                        const float* const (&arow)[IB],
                                        const float* Rs, int lane, int k,
                                        size_t Fs) {
  float a[IB];
#pragma unroll
  for (int d = 0; d < IB; ++d) a[d] = arow[d][(size_t)k * Fs];
  const float* rk = Rs + k * QC * LANES + lane;
#pragma unroll
  for (int j = 0; j < QC; ++j) {
    const float r = rk[j * LANES];
#pragma unroll
    for (int d = 0; d < IB; ++d) acc[d][j] = fmaf(a[d], r, acc[d][j]);
  }
}

template <int IB, int QC, int W>
__global__ void __launch_bounds__(LANES * W)
    pgemm_ib_kernel(const float* A, const float* B, float* C, int p, int K,
                    int q, int F) {
  extern __shared__ float Rs[];  // [K][QC][LANES]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int f0 = blockIdx.x * LANES + lane;
  const bool live = f0 < F;
  const size_t f = live ? f0 : F - 1;  // dead lanes load a valid address
  const size_t Fs = F;
  for (int j0 = 0; j0 < q; j0 += QC) {
    const int qc = q - j0 < QC ? q - j0 : QC;
    // Stage B[:, j0:j0+QC] for the block's lanes (zero past q).
    __syncthreads();
#pragma unroll 8
    for (int t = warp; t < K * QC; t += W) {
      const int k = t / QC, j = t - k * QC;
      Rs[t * LANES + lane] =
          j < qc ? B[((size_t)k * q + j0 + j) * Fs + f] : 0.f;
    }
    __syncthreads();
    for (int i0 = warp * IB; i0 < p; i0 += W * IB) {
      // Rows i0 .. i0+IB-1; a row past p repeats row p-1 and is not stored.
      const float* arow[IB];
#pragma unroll
      for (int d = 0; d < IB; ++d) {
        const int i = i0 + d < p ? i0 + d : p - 1;
        arow[d] = A + (size_t)i * K * Fs + f;
      }
      float acc[IB][QC];
#pragma unroll
      for (int d = 0; d < IB; ++d)
#pragma unroll
        for (int j = 0; j < QC; ++j) acc[d][j] = 0.f;
      // The term loop unrolled by 8 / IB: 8 loads of A in flight at every
      // IB, as rows_kernel's loop (this one at IB = 1) has.
      if constexpr (IB == 1) {
#pragma unroll 8
        for (int k = 0; k < K; ++k) ib_term(acc, arow, Rs, lane, k, Fs);
      } else if constexpr (IB == 2) {
#pragma unroll 4
        for (int k = 0; k < K; ++k) ib_term(acc, arow, Rs, lane, k, Fs);
      } else {
#pragma unroll 2
        for (int k = 0; k < K; ++k) ib_term(acc, arow, Rs, lane, k, Fs);
      }
      if (!live) continue;
#pragma unroll
      for (int d = 0; d < IB; ++d) {
        if (i0 + d < p) {
          float* crow = C + ((size_t)(i0 + d) * q + j0) * Fs + f;
#pragma unroll
          for (int j = 0; j < QC; ++j)
            if (j < qc) crow[(size_t)j * Fs] = acc[d][j];
        }
      }
    }
  }
}

template <int IB, int QC, int W>
int launch_ib(const float* A, const float* B, float* C, int p, int K, int q,
              int F, cudaStream_t st) {
  const int smem = K * QC * LANES * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      pgemm_ib_kernel<IB, QC, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pgemm_ib_kernel<IB, QC, W><<<(F + LANES - 1) / LANES, dim3(LANES, W), smem,
                               st>>>(A, B, C, p, K, q, F);
  return static_cast<int>(cudaGetLastError());
}

// Column chunk: 12 for q <= 12 or where [K][36][LANES] would not fit in
// shared memory, else 36.
template <int IB, int W>
int launch_ib_w(const float* A, const float* B, float* C, int p, int K, int q,
                int F, cudaStream_t st) {
  if (q <= 12 || (size_t)K * 36 * LANES * sizeof(float) > SMEM_MAX)
    return launch_ib<IB, 12, W>(A, B, C, p, K, q, F, st);
  return launch_ib<IB, 36, W>(A, B, C, p, K, q, F, st);
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
