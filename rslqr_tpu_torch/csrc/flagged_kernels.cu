// Hand-written Hopper kernel for the flagged planewise product of the
// parallel-scan combines.
//
//   flagged_kernel <- rslqr_tpu/ops/planes_pallas.py:_pgemm_call with its
//                     flags (ta, tbt, Cin +/-, diag, dconst, sym, kscale)
//
// C = Cin -/+ op(A) diag(ks) op(B), plus diag and dconst at (i, i); op(A)
// [p, K], op(B) [K, q], every operand an element-plane block [., ., F]
// (block element (i, j) is a dense plane of F elements at (i*q + j)*F + f),
// p, K, q <= 64, float32.
//
// What bounds it. Each plane element is its own small product: no operand
// value is shared between plane elements, only between the output entries
// of one element. At the scan's shapes (36x36 blocks, K = 36) the product
// does ~6 FLOP per byte it must move, far below the card's f32 balance of
// ~20, so it is bound by bytes, and at the scan's small planes (F = 1,792 -
// 4,096) by how many of them are in flight: a launch moves 10-60 MB.
//
// The design (the plan comes from ops/planes.py:_flagged_plan):
// * a block owns 32 plane elements (one per lane, so every plane load and
//   store is a coalesced 128-byte line) and ONE output tile of TR x TC
//   entries (TR = 2 rows per warp x 3 or 6 warps; TC = 6 columns). The grid
//   is (plane chunks of 32, tiles): at F = 2,048 and 36x36 blocks that is
//   64 x 18 blocks (64 x 12 under sym) instead of 64;
// * the block stages op(B)[:, c0:c0+TC] (times ks) for its lanes in shared
//   memory, K x TC x 32 floats (27 KB at K = 36, at most 48 KB, so no
//   opt-in and no per-launch attribute call). Each warp keeps
//   three terms' loads in flight while staging: a staging loop that waits
//   on each load before its store is bound by load latency (PERF.md). Each
//   warp then reads its two rows of op(A) once,
//   straight from device memory (no other warp needs them), and keeps
//   2 x TC accumulators: per term two coalesced loads and TC shared-memory
//   loads feed 2 TC FMAs;
// * under sym the plan holds only the tiles on or below the diagonal; a
//   warp whose rows all lie above it stops after the staging, and each
//   lower entry is stored at (i, j) and (j, i), so no mirror pass runs;
// * ta and tbt change only the strides of the row loads and of the staging
//   loads; Cin is read from its own pointer and C written fresh (C must not
//   alias an input); diag and dconst are added at (i, i) after Cin.
//
// The launcher returns cudaGetLastError() right after the launch; the Python
// wrapper raises on a nonzero code.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int LANES = 32;     // plane elements per block (one per lane)
constexpr int IB = 2;         // output rows per warp (ops/planes.py)
constexpr int MAX_WARPS = 6;  // warps per block (3 or 6, the plan's)
constexpr int MAXD = 64;      // largest block dim
constexpr int TC = 6;         // output columns per tile (ops/planes.py)
constexpr int MAX_TILES = 128;  // >= ceil(64 / 6) * ceil(64 / 6)

struct FlaggedArgs {
  const float* A;     // [p, K, F], or [K, p, F] with ta
  const float* B;     // [K, q, F], or [q, K, F] with tbt
  const float* Cin;   // [p, q, F] or null
  const float* diag;  // [p, F] or null
  const float* ks;    // [K, F] or null
  float* C;           // [p, q, F], a fresh output
  int p, K, q, F;
  int ta, tbt, sub, sym;  // sub: Cin - (else Cin +)
  float dconst;
  unsigned char r0[MAX_TILES], c0[MAX_TILES];  // tile origins
};

__global__ void __launch_bounds__(LANES * MAX_WARPS)
    flagged_kernel(const FlaggedArgs a) {
  extern __shared__ float Bs[];  // [K][TC][LANES]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int f0 = blockIdx.x * LANES + lane;
  const bool live = f0 < a.F;
  const size_t F = a.F;
  const size_t f = live ? f0 : a.F - 1;  // dead lanes load a valid address
  const int r0 = a.r0[blockIdx.y], c0 = a.c0[blockIdx.y];
  // op(B)[k, j] at (k*bk + j*bj)*F; op(A)[i, k] at i*ai*F + k*ak. The
  // element offsets (< 64*64) stay 32-bit, only their product with F is
  // 64-bit. Staging: warp w takes terms k = w, w + warps, ...; each iteration
  // issues its TC (+1) loads together, and the unroll keeps three
  // iterations' loads in flight before their shared-memory stores.
  const int bk = a.tbt ? 1 : a.q, bj = a.tbt ? a.K : 1;
#pragma unroll 3
  for (int k = warp; k < a.K; k += blockDim.y) {
    const float s = a.ks ? a.ks[(size_t)k * F + f] : 1.f;
    float v[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + j < a.q ? c0 + j : a.q - 1;  // a dead column repeats
      v[j] = a.B[(size_t)(k * bk + c * bj) * F + f];
    }
#pragma unroll
    for (int j = 0; j < TC; ++j)
      Bs[(k * TC + j) * LANES + lane] = c0 + j < a.q ? v[j] * s : 0.f;
  }
  __syncthreads();
  const int i0 = r0 + warp * IB;  // this warp's rows: i0, i0 + 1
  if (i0 >= a.p || (a.sym && i0 + IB - 1 < c0)) return;
  const int ai = a.ta ? 1 : a.K;
  const size_t ak = (size_t)(a.ta ? a.p : 1) * F;
  const float* arow[IB];
#pragma unroll
  for (int ii = 0; ii < IB; ++ii) {
    const int i = i0 + ii < a.p ? i0 + ii : a.p - 1;  // a dead row repeats
    arow[ii] = a.A + (size_t)(i * ai) * F + f;
  }
  float acc[IB][TC];
#pragma unroll
  for (int ii = 0; ii < IB; ++ii)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[ii][j] = 0.f;
#pragma unroll 6
  for (int k = 0; k < a.K; ++k) {
    float av[IB];
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) av[ii] = arow[ii][k * ak];
    const float* bkr = Bs + k * TC * LANES + lane;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float b = bkr[j * LANES];
#pragma unroll
      for (int ii = 0; ii < IB; ++ii) acc[ii][j] = fmaf(av[ii], b, acc[ii][j]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int ii = 0; ii < IB; ++ii) {
    const int i = i0 + ii;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + j;
      if (i < a.p && c < a.q && (!a.sym || c <= i)) {
        const size_t o = ((size_t)i * a.q + c) * F + f;
        float v = acc[ii][j];
        if (a.Cin) v = a.sub ? a.Cin[o] - v : a.Cin[o] + v;
        if (c == i) {
          if (a.diag) v += a.diag[(size_t)i * F + f];
          if (a.dconst != 0.f) v += a.dconst;
        }
        a.C[o] = v;
        if (a.sym && c != i) a.C[((size_t)c * a.q + i) * F + f] = v;
      }
    }
  }
}

bool dims_ok(int a) { return a >= 1 && a <= MAXD; }

}  // namespace

extern "C" {

// C = Cin -/+ op(A) diag(ks) op(B) (+ diag, + dconst on the diagonal), sym
// or not; Cin, diag and ks may be null; C must not alias any input. The
// launch geometry is the caller's plan: ``warps`` warps per block (each
// IB = 2 rows of a tile of TC = 6 columns), and ``ntiles`` tile origins
// ``tiles[2t]`` (row), ``tiles[2t + 1]`` (column), one grid row each.
int rslqr_pgemm_flagged(const float* A, const float* B, const float* Cin,
                        const float* diag, const float* ks, float* C, int p,
                        int K, int q, int F, int ta, int tbt, int sub, int sym,
                        float dconst, int warps, int ntiles,
                        const int* tiles, void* stream) {
  if (!dims_ok(p) || !dims_ok(K) || !dims_ok(q) || F < 1 ||
      ((sym || diag || dconst != 0.f) && p != q) || warps < 1 ||
      warps > MAX_WARPS || ntiles < 1 || ntiles > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  FlaggedArgs a = {A, B, Cin, diag, ks, C, p, K, q, F,
                   ta, tbt, sub, sym, dconst, {}, {}};
  for (int t = 0; t < ntiles; ++t) {
    const int r = tiles[2 * t], c = tiles[2 * t + 1];
    if (r < 0 || r >= p || c < 0 || c >= q)
      return static_cast<int>(cudaErrorInvalidValue);
    a.r0[t] = static_cast<unsigned char>(r);
    a.c0[t] = static_cast<unsigned char>(c);
  }
  const dim3 grid((F + LANES - 1) / LANES, ntiles), block(LANES, warps);
  const auto st = static_cast<cudaStream_t>(stream);
  const int smem = K * TC * LANES * (int)sizeof(float);  // <= 48 KB
  flagged_kernel<<<grid, block, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
