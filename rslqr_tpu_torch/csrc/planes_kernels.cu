// Hand-written Hopper kernels for the mid-block (8 < n <= 80) element-plane
// linear algebra of the rsLQR path.
//
// Three kernels for four TPU kernels of rslqr_tpu/ops/planes_pallas.py (B8,
// plu_solve_multi, is in plu_kernels.cu; _pgemm_call with its flags, the
// pscan combines' product, in flagged_kernels.cu):
//   rows_kernel        <- _pgemm_call / pgemm        (C = A @ B, no flags)
//                      <- schur3_update_planes       (fused lambda/x/u update)
//                      <- schur_update_planes        (one slab of the same)
//   pchol_kernel       <- pchol                      (Cholesky, lower L)
//   pcho_solve_kernel  <- pcho_solve                 ((L L') X = B in place)
//
// Layout: element-plane blocks [p, q, F]: block element (i, j) is a dense
// plane of F elements (the flattened knot x batch or group x batch grid) at
// (i*q + j)*F + f. float32 only; block dims are runtime arguments up to 80
// (MAXD: a humanoid's whole-body state, nx = 70-76, fits).
//
// Bound: bandwidth. At n=36 the products do 2K = 72 FLOP per output float
// over ~3 floats moved per output (~6 FLOP/byte), the Schur update ~3
// FLOP/byte, the solves and the Cholesky less; the H100's f32 balance is
// ~20 FLOP/byte. So each kernel must read every operand once and keep
// enough loads in flight.
//
// rows_kernel (products and the Schur update): a block owns 32 plane
// elements (one per lane, so every plane load and store is a coalesced
// 128-byte line) and one column tile of TC columns (9 at K = 36, 12 for
// K <= 32, 6 at K = 64, 1 for a single column) of every stacked output row.
// The 1-D grid runs the column tiles of one plane chunk next to each other,
// so the chunk's rows of A, read once per column tile, come from HBM once
// and then from L2 (at the quadruped's planes, F = 512 x 256, one operand is
// 340 MB, far past the 50 MB L2). The block stages R[:, c0:c0+TC] for its
// lanes in shared memory (K x TC x 32 floats, at most 48 KB, so four blocks
// fit an SM; the old design staged R[K][36][32], 166 KB at K = 36, one block
// per SM), each warp keeping three terms' loads in flight. Its 8 warps then
// take the rows two at a time, reading them straight from device memory,
// with 2 x TC accumulators: per term two coalesced loads and TC
// shared-memory loads feed 2 TC FMAs (the old design: one shared load per
// FMA). A block with every row of a product reads R once; a tile of a few
// rows (flagged_kernel's) re-read it per row tile, and 6-column tiles read A
// six times: 1.2-1.4x slower than the old kernel at the quadruped's shapes
// (PERF.md). Past K = 64 no tile of 6 fits 48 KB (53.8 KB at K = 70): the
// launcher opts in to the dynamic shared memory it needs, up to 61 KB at
// K = 80, so three or four blocks still fit an SM; K <= 64 launches as
// before. For the Schur update the rows are the three slabs' (lambda rows
// masked, separator rows overwritten with R's row) and R is the compact
// solved separator of each lane's knot group; lambda rows that no lane's
// knot keeps skip the product and only write the separator rows.
//
// pcho_solve_kernel: one right-hand column per thread in registers, L's
// triangle staged in shared memory per block (see the kernel). Past 64 with
// several columns, wide::pcho_solve_kernel: bytes and FMAs would allow 0.48
// ms at the G1's n = w = 70, F = 32,768, but the substitutions' dependent
// chain sets the pace, so it keeps a 5 x 6 tile of X a thread and walks
// panels of 5 rows, one warp a row tile, each shared load feeding 5 or 6
// FMAs: 6.6x that bound (the column-a-thread kernel it replaced, 18.9x; see
// the kernel). pchol_kernel:
// one row of one plane element's block per thread in registers, eight
// elements per block, right-looking over a shared column (see the kernel).
// Both are instantiated for register widths of 12, 16, 36, 64 and 80 floats
// (n <= 12, the state dims 13..16 a raised mxu_block_threshold sends here,
// the quadruped path's 36, 64 for any larger block up to 64, and 80 for the
// wide blocks 65..80: a humanoid's nx = 70), launched with the smallest that
// holds the block; their unrolled loops index the registers statically and
// skip the rows past the runtime dim with branches. W = 80 has mappings of
// its own where the register file asks for them (see each kernel).
//
// Each launcher returns cudaGetLastError() right after the launch; the
// Python wrapper (rslqr_tpu_torch/ops/planes.py) raises on a nonzero code.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAXD = 80;        // largest block dim (ops/planes.py MAX_BLOCK)
constexpr int NARROW = 64;      // widest block of the narrow widths (<= 64)
constexpr int LANES = 32;       // plane elements per block (one per lane)

// Runs the statement list (a lambda) with the constexpr int W set to the
// register-column width (12, 16, 36, 64 or 80) that holds d values.
#define RSLQR_BY_WIDTH(d, ...)   \
  do {                           \
    if ((d) <= 12) {             \
      constexpr int W = 12;      \
      __VA_ARGS__();             \
    } else if ((d) <= 16) {      \
      constexpr int W = 16;      \
      __VA_ARGS__();             \
    } else if ((d) <= 36) {      \
      constexpr int W = 36;      \
      __VA_ARGS__();             \
    } else if ((d) <= NARROW) {  \
      constexpr int W = 64;      \
      __VA_ARGS__();             \
    } else {                     \
      constexpr int W = MAXD;    \
      __VA_ARGS__();             \
    }                            \
  } while (0)

// What rows_kernel computes: C_g[i, :] (=, or -=) A_g[i, :] @ R for up to
// three row groups g, stacked (rows of group 0, then 1, then 2). For the
// Schur update (schur != 0) R is the compact fsol [K, q, G, B] read at the
// lane's knot group, and group 0 is the lambda slab: rows skip the update
// where calc_lambda is false and take R's row i at separator knots
// (nested_dissection.c:154-177).
struct RowsArgs {
  const float* A[3];  // [rows_g, K, F]
  float* C[3];        // [rows_g, q, F]
  int rows[3];
  const float* R;     // [K, q, F] (product) or [K, q, G, B] (Schur update)
  int K, q, F;
  int schur, N, B, level;
  int ctiles;  // column tiles of TC columns
};

constexpr int IB = 2;     // output rows per warp and pass
constexpr int WARPS = 8;  // warps per block
constexpr int SMEM_TILE = 48 * 1024;  // staged R slice, no opt-in needed

// Registers are capped at 64 so that four blocks (32 warps) fit an SM:
// uncapped, the 9- and 12-column tiles took 80 and 96 registers and left 3-4
// blocks of 6 warps, 1.2-1.5x slower at the quadruped's shapes (PERF.md).
template <int TC>
__global__ void __launch_bounds__(LANES * WARPS, 4)
    rows_kernel(const RowsArgs a) {
  extern __shared__ float Rs[];  // [K][TC][LANES]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  // Column tile fastest: the tiles of one plane chunk run together.
  const int c0 = (blockIdx.x % a.ctiles) * TC;
  const int chunk = blockIdx.x / a.ctiles;
  const int f0 = chunk * LANES + lane;
  const bool live = f0 < a.F;
  const size_t F = a.F;
  const size_t f = live ? f0 : a.F - 1;  // dead lanes load a valid address
  // The lane's knot (Schur update): masks and the compact R offset.
  bool keep = true, sep = false;
  size_t roff = f;  // offset of R[k, j] at this lane: (k*q + j)*rs + roff
  size_t rs = F;
  if (a.schur) {
    const int knot = (int)(f / a.B);
    const int half = 1 << a.level;
    keep = (knot & (half - 1)) != 0 || knot == 0;
    sep = (knot & (2 * half - 1)) == half;
    const int G = a.N >> (a.level + 1);
    rs = (size_t)G * a.B;
    roff = (size_t)(knot >> (a.level + 1)) * a.B + (f - (size_t)knot * a.B);
  }
  // Stage R[:, c0:c0+TC] (zero past q): warp w takes terms w, w + WARPS,
  // ...; the unroll keeps three terms' loads in flight.
#pragma unroll 3
  for (int k = warp; k < a.K; k += WARPS) {
    float v[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + j < a.q ? c0 + j : a.q - 1;  // a dead column repeats
      v[j] = a.R[((size_t)k * a.q + c) * rs + roff];
    }
#pragma unroll
    for (int j = 0; j < TC; ++j)
      Rs[(k * TC + j) * LANES + lane] = c0 + j < a.q ? v[j] : 0.f;
  }
  __syncthreads();
  const int r1 = a.rows[0], r2 = r1 + a.rows[1], total = r2 + a.rows[2];
  // Lambda rows that no lane's knot keeps need no product.
  const bool any_keep = __any_sync(0xffffffffu, live && keep);
  for (int i0 = warp * IB; i0 < total; i0 += IB * WARPS) {
    const float* arow[IB];
    float* crow[IB];
    int irow[IB];
    bool lam[IB], need = false;
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      const int r = i0 + ii < total ? i0 + ii : total - 1;  // dead row repeats
      const int g = (r >= r1) + (r >= r2);
      const int i = r - (g == 0 ? 0 : (g == 1 ? r1 : r2));
      irow[ii] = i;
      lam[ii] = a.schur && g == 0;
      arow[ii] = (g == 0 ? a.A[0] : (g == 1 ? a.A[1] : a.A[2])) +
                 (size_t)i * a.K * F + f;
      crow[ii] = (g == 0 ? a.C[0] : (g == 1 ? a.C[1] : a.C[2])) +
                 ((size_t)i * a.q + c0) * F + f;
      need = need || !lam[ii] || any_keep;
    }
    float acc[IB][TC];
#pragma unroll
    for (int ii = 0; ii < IB; ++ii)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[ii][j] = 0.f;
    if (need) {
#pragma unroll 4
      for (int k = 0; k < a.K; ++k) {
        float av[IB];
#pragma unroll
        for (int ii = 0; ii < IB; ++ii) av[ii] = arow[ii][(size_t)k * F];
        const float* rk = Rs + k * TC * LANES + lane;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float b = rk[j * LANES];
#pragma unroll
          for (int ii = 0; ii < IB; ++ii)
            acc[ii][j] = fmaf(av[ii], b, acc[ii][j]);
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      if (i0 + ii >= total) continue;
      const float* rrow = Rs + irow[ii] * TC * LANES + lane;  // R's row i
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        if (c0 + j >= a.q) continue;
        float* c = crow[ii] + (size_t)j * F;
        if (!a.schur)
          *c = acc[ii][j];
        else if (!lam[ii])
          *c -= acc[ii][j];
        else if (sep)
          *c = rrow[j * LANES];
        else if (keep)
          *c -= acc[ii][j];
      }
    }
  }
}

// Column tile of rows_kernel: 1 for a single column, else the widest of
// 12, 9, 6 whose staged slice (K x TC x 32 floats) fits 48 KB (9 at K = 36,
// which tiles q = 36 exactly), else 6 (K > 64, opted in past 48 KB).
int tile_for(int q, int K) {
  const int col = LANES * (int)sizeof(float);  // bytes per staged term
  if (q == 1) return 1;
  if (K * 12 * col <= SMEM_TILE) return 12;
  return K * 9 * col <= SMEM_TILE ? 9 : 6;
}

// Launch rows_kernel: one block per (column tile, plane chunk of 32), the
// column tile fastest; each block takes every stacked row.
template <int TC>
int launch_rows_tc(RowsArgs a, cudaStream_t st) {
  a.ctiles = (a.q + TC - 1) / TC;
  const long long blocks =
      (long long)a.ctiles * ((a.F + LANES - 1) / LANES);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = a.K * TC * LANES * (int)sizeof(float);
  if (smem > SMEM_TILE) {  // K > 64: a 6-column tile past 48 KB
    cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rows_kernel<TC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rows_kernel<TC><<<(unsigned)blocks, dim3(LANES, WARPS), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const RowsArgs& a, cudaStream_t st) {
  switch (tile_for(a.q, a.K)) {
    case 1:
      return launch_rows_tc<1>(a, st);
    case 12:
      return launch_rows_tc<12>(a, st);
    case 9:
      return launch_rows_tc<9>(a, st);
    default:
      return launch_rows_tc<6>(a, st);
  }
}

// Cholesky, lower L (B6). What bounds it: bytes. At n = 36 a plane element
// reads A's lower triangle (666 floats) and writes all of L (1,296, the zeros
// included): 0.514 GB over F = 65,536, 0.154 ms at 3.35 TB/s, against n^3/6
// = 7,776 FMAs.
//
// Mapping. A block owns CHOL_LANES = 8 plane elements (8 floats fill one
// 32-byte sector) and gives each thread one row i of one element's block:
// the row's lower part, L(i, 0..i), lives in registers from the load to the
// store, so each element of A is read once and each element of L written
// once. A warp holds four consecutive rows, so the rows' lengths differ
// little within it. Right-looking, one step per column k: every row i >= k
// publishes its entry u(i, k) of the updated matrix to a shared column (two
// of them, used in turn, so one barrier a step suffices), row k also
// 1/sqrt(u(k, k)); then each row i > k turns its u(i, k) into l(i, k) and
// subtracts l(i, k) l(j, k) from its u(i, j), k < j <= i, reading u(j, k)
// from the shared column: one shared load per FMA, and the n^3/6 dependent
// chain that one thread per element would carry is spread over n threads.
// At n = 36 a block is 9 warps and 2.3 KB of shared memory; eight plane
// elements per block give the small upper-level planes (F = 256 at level
// 8) 32 blocks, where 32 elements per block would give 8. The loops over k
// and j are unrolled to the register width W (12, 16, 36, 64 or 80), with
// per-row branches on the runtime n and on j <= i, so that ptxas does not
// hoist every load (24 B of spill at W = 36 and 64).
//
// Wide blocks (W = 80, n = 65..80). A row of 80 floats lives in registers,
// so eight elements a block (640 threads) would leave 102 registers a
// thread on the SM's 65,536 with the row inside them, and one block an SM.
// The wide instantiation takes CHOL_LANES_WIDE = 4 elements a block (8 rows
// a warp, 320 threads at n = 80) and a cap of 102 registers (two blocks,
// 20 warps an SM). Four lanes read 16 contiguous bytes, half a sector; the
// next block reads the other half, adjacent in time, from L2. B6 is ~1% of
// a G1 solve's bytes (PERF.md), so occupancy over sector use.
constexpr int CHOL_LANES = 8;
constexpr int CHOL_LANES_WIDE = 4;

// Plane elements per block: 8, or 4 past the narrow widths.
template <int W>
constexpr int kCholLanes = W <= NARROW ? CHOL_LANES : CHOL_LANES_WIDE;

// Blocks per SM the register cap allows (four at W = 36: 56 registers).
template <int W>
constexpr int kCholMinBlocks =
    W <= 16 ? 8 : (W <= 36 ? 4 : (W <= NARROW ? 1 : 2));

template <int W>
__global__ void __launch_bounds__(kCholLanes<W> * W, kCholMinBlocks<W>)
    pchol_kernel(const float* __restrict__ A, float* __restrict__ L, int n,
                 int F) {
  constexpr int E = kCholLanes<W>;
  __shared__ float col[2][W][E];  // u(j, k) of step k, in turns
  __shared__ float piv[2][E];     // 1/sqrt(u(k, k))
  const int lane = threadIdx.x % E;
  const int i = threadIdx.x / E;  // the thread's row
  const int f0 = blockIdx.x * E + lane;
  const bool live = f0 < F;
  const bool row = i < n;  // the block's last warp may hold rows past n
  const size_t Fs = F;
  const size_t f = live ? f0 : F - 1;  // dead lanes read a valid address
  float r[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    r[j] = row && j <= i ? A[((size_t)i * n + j) * Fs + f] : 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < n) {
      float* c = &col[k & 1][0][0] + lane;
      if (row && i >= k) {
        c[i * E] = r[k];
        if (i == k) piv[k & 1][lane] = rsqrtf(r[k]);
      }
      __syncthreads();
      if (row && i >= k) {
        const float inv = piv[k & 1][lane];
        r[k] *= inv;  // l(i, k); l(k, k) = u(k, k) / sqrt(u(k, k))
        const float mlt = r[k] * inv;  // l(i, k) / sqrt(u(k, k))
#pragma unroll
        for (int j = k + 1; j < W; ++j)
          if (j <= i) r[j] = fmaf(-mlt, c[j * E], r[j]);
      }
    }
  }
  if (!live || !row) return;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j < n) L[((size_t)i * n + j) * Fs + f] = r[j];  // zeros past i
}

// (L L') X = B in place on X (B7). What bounds it: bytes. At n = w = 36 a
// plane element moves 666 floats of L's lower triangle and 2 x 1,296 of X
// (0.854 GB over F = 65,536: 0.255 ms at 3.35 TB/s) against 46,656 FMAs.
//
// Mapping. A block owns 32 plane elements (one per lane: coalesced lines)
// and ``blockDim.y`` right-hand columns, one per warp, each thread keeping
// its column in registers. The grid runs (plane chunk x group of columns),
// the groups of one chunk next to each other (L comes from HBM once, then
// from L2); the launcher picks the warps per block that split the columns
// evenly and still give the card two blocks per SM, down to one warp per
// block on the upper levels' small planes (F = 512: 16 chunks x 36 columns
// = 576 blocks, where one block per chunk would leave most SMs idle). 12
// warps per block ran the quadruped's n = w = 36 solves ~10% faster than 9
// and ~30% faster than 18 (PERF.md).
//
// STAGED (several columns, n <= 36): the block first copies its lanes'
// lower triangles of L into shared memory (cp.async, every copy in flight at
// once; 85 KB at n = 36, so two blocks of up to 12 warps per SM, and one's
// copy overlaps the other's substitution), then runs both substitutions
// right-looking, so each step's updates are independent of each other:
// forward (L y = b) by columns, x_k /= l_kk, then x_i -= l_ik x_k for
// i > k; back (L' x = y) by rows from the bottom, x_i /= l_ii, then
// x_k -= l_ik x_i for k < i. Each x_i takes its terms one FMA at a time, in
// ascending k (forward) and descending i (back), and is divided by the
// diagonal as the reference does; no inverse of L is formed.
//
// Direct (one column, or n > 36, whose triangle would not fit): L read
// through L1/L2 by rows only (a column of L spans n x F floats of device
// memory, and walking one ran 1.5-2.0x slower), the forward pass
// left-looking, x_i = (b_i - sum_k l_ik x_k) / l_ii, the back pass
// right-looking. Both modes skip the rows and columns
// past n with uniform branches, which also keep ptxas from hoisting every
// load of the unrolled loops (with n fixed at compile time the instances
// spilled 6-9 KB). Two or four columns per thread (one load of l_ik for
// several FMAs) lost to one: their registers cost the warps that hide the
// substitutions' latency (PERF.md).
//
// Wide blocks (W = 80, n = 65..80), several columns: wide::pcho_solve_kernel
// (below). The direct mode spills there (1.3 KB at the cap of 128) and
// reads one l_ik from L1 per FMA: 99x its bound at the G1's n = w = 70. A
// triangle of 2,485 floats for 32 lanes (318 KB) fits no SM; for 8 it is
// 79.5 KB (104 KB at n = 80), so the wide kernel stages the triangles of 8
// plane elements a block and gives each thread one column of one of them,
// as the staged mode does for 32. One column: the direct mode.
constexpr int SOLVE_WARPS = 12;  // most columns (warps) per staged block
constexpr int DIRECT_WARPS = 4;  // the same, direct mode
constexpr int SM_COUNT = 132;    // H100 SXM
constexpr int STAGE_MAX_W = 36;  // widest triangle staged (85 KB)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Offset of l(i, k), k <= i, in the staged triangle [i(i+1)/2 + k][LANES].
__host__ __device__ constexpr int tri(int i, int k) {
  return (i * (i + 1) / 2 + k) * LANES;
}

// Register cap: staged, two blocks per SM (shared memory allows no more at
// n = 36: 24 warps, 85 registers); direct (every width, 80 too), 128
// registers (a cap of 73 at n = 36 spilled 396 bytes and ran the one-column
// solve in 0.53 ms, against 0.16 ms at 80 registers).
template <bool STAGED>
constexpr int kSolveMinBlocks = STAGED ? 2 : 4;

template <int W, bool STAGED>
__global__ void __launch_bounds__(LANES*(STAGED ? SOLVE_WARPS : DIRECT_WARPS),
                                  kSolveMinBlocks<STAGED>)
    pcho_solve_kernel(const float* __restrict__ L, float* __restrict__ X,
                      int n, int w, int F, int groups) {
  extern __shared__ float Ls[];  // STAGED: [tri(i, k) + lane]
  const int lane = threadIdx.x;
  const int chunk = blockIdx.x / groups;
  const int c = (blockIdx.x % groups) * blockDim.y + threadIdx.y;
  const int f0 = chunk * LANES + lane;
  const bool live = f0 < F;
  const size_t Fs = F;
  const size_t f = live ? f0 : F - 1;  // dead lanes read a valid address
  if constexpr (STAGED) {
    for (int i = 0; i < n; ++i)
      for (int k = threadIdx.y; k <= i; k += blockDim.y)
        cp_async4(Ls + tri(i, k) + lane, L + ((size_t)i * n + k) * Fs + f);
  }
  // The thread's column, loaded while the triangle's copies are in flight.
  float x[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    x[k] = k < n ? X[((size_t)k * w + c) * Fs + f] : 0.f;
  if constexpr (STAGED) {
    cp_async_wait_all();
    __syncthreads();
    const float* Ll = Ls + lane;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < n) {
        x[k] = x[k] / Ll[tri(k, k)];
#pragma unroll
        for (int i = k + 1; i < W; ++i)
          if (i < n) x[i] = fmaf(-Ll[tri(i, k)], x[k], x[i]);
      }
    }
#pragma unroll
    for (int i = W - 1; i >= 0; --i) {
      if (i < n) {
        x[i] = x[i] / Ll[tri(i, i)];
#pragma unroll
        for (int k = 0; k < i; ++k) x[k] = fmaf(-Ll[tri(i, k)], x[i], x[k]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < n) {
        const float* row = L + (size_t)i * n * Fs + f;
        float s = x[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = fmaf(-__ldg(row + k * Fs), x[k], s);
        x[i] = s / __ldg(row + i * Fs);
      }
    }
#pragma unroll
    for (int i = W - 1; i >= 0; --i) {
      if (i < n) {
        const float* row = L + (size_t)i * n * Fs + f;
        x[i] = x[i] / __ldg(row + i * Fs);
#pragma unroll
        for (int k = 0; k < i; ++k)
          x[k] = fmaf(-__ldg(row + k * Fs), x[i], x[k]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < n) X[((size_t)k * w + c) * Fs + f] = x[k];
}

// Warps (columns) per block: the most, up to ``most``, that divide the
// columns and still give two blocks per SM; one warp per block otherwise.
int solve_warps(int w, int chunks, int most) {
  for (int wpb = most; wpb > 1; --wpb)
    if (w % wpb == 0 && (long long)chunks * (w / wpb) >= 2 * SM_COUNT)
      return wpb;
  return 1;
}

template <int W, bool STAGED>
int launch_solve_mode(const float* L, float* X, int n, int w, int F,
                      cudaStream_t st) {
  const int chunks = (F + LANES - 1) / LANES;
  const int wpb = solve_warps(w, chunks, STAGED ? SOLVE_WARPS : DIRECT_WARPS);
  const int groups = w / wpb;
  const long long blocks = (long long)chunks * groups;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = STAGED ? tri(n, 0) * (int)sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pcho_solve_kernel<W, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned)blocks), block(LANES, wpb);
  pcho_solve_kernel<W, STAGED><<<grid, block, smem, st>>>(L, X, n, w, F,
                                                          groups);
  return static_cast<int>(cudaGetLastError());
}

// B7 at the wide widths (W = 80), several columns: wide::pcho_solve_kernel.
//
// What bounds it: at n = w = 70 a plane element moves L's triangle (2,485
// floats) and X twice (9,800), 49 KB, for n^2 w = 343,000 FMAs: 14 FLOP a
// byte, near the card's f32 ridge (~20); 0.481 ms at the G1's level 0 (F =
// 32,768). In practice the substitutions' dependent chain sets the pace: a
// panel's divisions and the barrier after it, hidden only by other warps.
//
// Mapping. A block owns E = 8 plane elements (8 floats: one 32-byte
// sector) and COLS = 24 right-hand columns, and stages its elements' lower
// triangles in shared memory by cp.async (79.5 KB at n = 70: two blocks an
// SM). Thread (e, column tile, row tile) keeps an R x S = 5 x 6 tile of X
// of element e in registers: R rows of one row tile, S columns of one of
// four column tiles. A warp is one row tile: 8 elements by 4 column tiles,
// so each shared load of l(i, k) reads 8 banks and broadcasts to 4 threads,
// and the block has one warp per row tile (14 at n = 70, 16 at 80). The
// substitutions run by panels of R rows: in the forward pass, row tile p
// solves its panel's R x R triangle on its own tile, writes the solved rows
// to a panel buffer, and after one barrier every row tile below applies the
// rank-R update x_ic -= l_ik x_kc; the back pass is the mirror image with
// L'. Per term of an update, R loads of l and S loads of x feed R x S FMAs
// (0.37 shared loads an FMA; the column-a-thread kernel it replaces took
// one, and unrolled both 80 x 80 triangles into 31,312 SASS instructions,
// against 4,248 here). The panel loops are rolled; the panel step and the
// panel's triangle are unrolled, so the tile stays in registers. Two panel
// buffers let row tile p + 1 solve its panel while the others still read
// panel p. Rows past n (the last row tile where 5 does not divide n) read
// l from a row of zeros, so their terms are exact no-ops (x stays +0
// there), and their divisions are skipped. Registers are capped at 64 (two
// blocks of 512 threads an SM): 28 bytes spill (136 bytes reloaded). Measured
// (H100, PERF.md): 3.17 ms chained at n = w = 70, F = 32,768, 6.6x its
// bound (the kernel it replaces: 9.09 ms, 18.9x). Tiles of 7, 8, 10 or 14
// rows ran 6-80% slower (fewer warps to hide the chain; 10 rows, with no
// spill, 19%), panels solved in shared memory by rolled loops 20%.
//
// Numerics: each x_i takes its terms one fmaf at a time in ascending k, then
// the division by l_ii, in the forward pass; in the back pass, descending i.
// That is the column-a-thread kernel's order, so the result is bit for bit
// that kernel's.
namespace wide {

constexpr int E = 8;            // plane elements per block
constexpr int R = 5;            // rows of a thread's tile and of a panel
constexpr int S = 6;            // columns of a thread's tile
constexpr int SUBS = 4;         // column tiles a row tile (a warp: 8 x 4)
constexpr int COLS = S * SUBS;  // right-hand columns per block
constexpr int PANEL = R * COLS * E;  // floats of one panel buffer

__host__ __device__ constexpr int tiles(int n) { return (n + R - 1) / R; }

// Offset of l(i, k), k <= i, in the staged triangles [i(i+1)/2 + k][E].
__host__ __device__ constexpr int tri(int i, int k) {
  return (i * (i + 1) / 2 + k) * E;
}

// Copies the block's lower triangles into Ls, V floats a copy: E / V
// threads a term (i, k), walking the terms in row order; ``src`` is the
// plane offset of the thread's first float.
template <int V>
__device__ __forceinline__ void stage(float* Ls, const float* L, int n,
                                      size_t Fs, size_t src, int tid,
                                      int threads) {
  constexpr int P = E / V;
  const int part = tid % P * V;
  int i = 0, k = tid / P;
  while (k > i) k -= ++i;
  while (i < n) {
    float* const dst = Ls + tri(i, k) + part;
    const float* const from = L + ((size_t)i * n + k) * Fs + src;
    if constexpr (V == 4)
      cp_async16(dst, from);
    else
      cp_async4(dst, from);
    k += threads / P;
    while (k > i) k -= ++i;
  }
}

// Shared floats of a block at block dim n: the triangles, the row of zeros
// for the rows past n, two panel buffers [R][S][SUBS][E].
template <int W>
__host__ __device__ constexpr int smem_floats(int n) {
  return tri(n, 0) + tiles(W) * R * E + 2 * PANEL;
}

// Forward: row tile p's panel, its terms from rows above already applied.
__device__ __forceinline__ void panel_forward(float (&x)[R][S],
                                              const float* Ls,
                                              const int (&row)[R], int i0,
                                              int n) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < a; ++b) {
      const float l = Ls[row[a] + (i0 + b) * E];
#pragma unroll
      for (int j = 0; j < S; ++j) x[a][j] = fmaf(-l, x[b][j], x[a][j]);
    }
    if (i0 + a < n) {
      const float d = Ls[row[a] + (i0 + a) * E];
#pragma unroll
      for (int j = 0; j < S; ++j) x[a][j] = x[a][j] / d;
    }
  }
}

// Back: row tile p's panel, its terms from rows below already applied.
__device__ __forceinline__ void panel_back(float (&x)[R][S], const float* Ls,
                                           const int (&row)[R], int i0,
                                           int n) {
#pragma unroll
  for (int a = R - 1; a >= 0; --a) {
    if (i0 + a < n) {
      const float d = Ls[row[a] + (i0 + a) * E];
#pragma unroll
      for (int j = 0; j < S; ++j) x[a][j] = x[a][j] / d;
    }
#pragma unroll
    for (int b = 0; b < a; ++b) {
      const float l = Ls[row[a] + (i0 + b) * E];
#pragma unroll
      for (int j = 0; j < S; ++j) x[b][j] = fmaf(-l, x[a][j], x[b][j]);
    }
  }
}

// The thread's tile into its slot of a panel buffer ([k][j] at SUBS x E).
__device__ __forceinline__ void put(float* slot, const float (&x)[R][S]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < S; ++j) slot[(a * S + j) * SUBS * E] = x[a][j];
}

template <int W>
__global__ void __launch_bounds__(E * SUBS * tiles(W), 2)
    pcho_solve_kernel(const float* __restrict__ L, float* __restrict__ X,
                      int n, int w, int F, int groups) {
  extern __shared__ float Ls[];  // [tri(i, k) + e], zeros, panel buffers
  const int e = threadIdx.x % E;
  const int sub = threadIdx.x / E;
  const int t = threadIdx.y;  // the thread's row tile
  const int T = blockDim.y;   // tiles(n)
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.x + blockDim.x * t;
  const int zero = tri(n, 0);
  const int chunk = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * COLS + sub * S;
  const int f0 = chunk * E + e;
  const bool live = f0 < F;
  const size_t Fs = F;
  const size_t f = live ? f0 : F - 1;  // dead lanes read a valid address
  // Whole sectors (16 bytes a copy) where the chunk is whole and aligned.
  if (F % 4 == 0 && (chunk + 1) * E <= F && (size_t)L % 16 == 0)
    stage<4>(Ls, L, n, Fs, (size_t)chunk * E + tid % 2 * 4, tid, threads);
  else
    stage<1>(Ls, L, n, Fs, f, tid, threads);
  for (int q = tid; q < tiles(W) * R * E; q += threads) Ls[zero + q] = 0.f;
  // The thread's tile (a dead column repeats the last), loaded while the
  // triangles' copies are in flight; row[a]: row i0 + a's offset.
  const int i0 = t * R;
  int row[R];
  float x[R][S];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + a;
    row[a] = (i < n ? tri(i, 0) : zero) + e;
#pragma unroll
    for (int j = 0; j < S; ++j)
      x[a][j] = i < n ? X[((size_t)i * w + min(c0 + j, w - 1)) * Fs + f]
                      : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  float* const slot = Ls + zero + tiles(W) * R * E + sub * E + e;
  int step = 0;  // panel steps so far: the buffer of step s is s & 1
  // Forward, one panel a step: rank-R updates of the tiles below, in
  // ascending k.
#pragma unroll 1
  for (int p = 0; p < T - 1; ++p, ++step) {
    float* const y = slot + (step & 1) * PANEL;
    if (t == p) {
      panel_forward(x, Ls, row, i0, n);
      put(y, x);
    }
    __syncthreads();
    if (t > p) {
      const int k0 = p * R;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float yk[S];
#pragma unroll
        for (int j = 0; j < S; ++j) yk[j] = y[(k * S + j) * SUBS * E];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float l = Ls[row[a] + (k0 + k) * E];
#pragma unroll
          for (int j = 0; j < S; ++j) x[a][j] = fmaf(-l, yk[j], x[a][j]);
        }
      }
    }
  }
  if (t == T - 1) panel_forward(x, Ls, row, i0, n);
  // Back, one panel a step from the last: rank-R updates of the tiles
  // above, in descending i.
#pragma unroll 1
  for (int p = T - 1; p > 0; --p, ++step) {
    float* const y = slot + (step & 1) * PANEL;
    if (t == p) {
      panel_back(x, Ls, row, i0, n);
      put(y, x);
    }
    __syncthreads();
    if (t < p) {
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
        const int i = p * R + k;
        const float* const li = Ls + (i < n ? tri(i, i0) : zero + i0 * E) + e;
        float yk[S];
#pragma unroll
        for (int j = 0; j < S; ++j) yk[j] = y[(k * S + j) * SUBS * E];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float l = li[a * E];
#pragma unroll
          for (int j = 0; j < S; ++j) x[a][j] = fmaf(-l, yk[j], x[a][j]);
        }
      }
    }
  }
  if (t == 0) panel_back(x, Ls, row, i0, n);
  if (!live) return;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (i0 + a < n && c0 + j < w)
        X[((size_t)(i0 + a) * w + c0 + j) * Fs + f] = x[a][j];
}

template <int W>
int launch(const float* L, float* X, int n, int w, int F, cudaStream_t st) {
  const int chunks = (F + E - 1) / E;
  const int groups = (w + COLS - 1) / COLS;
  const long long blocks = (long long)chunks * groups;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_floats<W>(n) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pcho_solve_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pcho_solve_kernel<W>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  pcho_solve_kernel<W>
      <<<(unsigned)blocks, dim3(E * SUBS, tiles(n)), smem, st>>>(
          L, X, n, w, F, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

// Staged where the triangle fits and there are several columns (the wide
// kernel past 64); direct otherwise.
template <int W>
int launch_solve(const float* L, float* X, int n, int w, int F,
                 cudaStream_t st) {
  if constexpr (W <= STAGE_MAX_W) {
    if (w > 1) return launch_solve_mode<W, true>(L, X, n, w, F, st);
  } else if constexpr (W > NARROW) {
    if (w > 1) return wide::launch<W>(L, X, n, w, F, st);
  }
  return launch_solve_mode<W, false>(L, X, n, w, F, st);
}

bool dims_ok(int a) { return a >= 1 && a <= MAXD; }

// B9 across the upper levels: levels::rows_kernel.
//
// Replaces rslqr_tpu/ops/planes_pallas.py:503 schur3_update_planes as the
// factor sweep calls it, once per (level l, upper level u): one launch
// updates every upper level u = l+1 .. of level l, with the masks, the
// compact fsol reads and the arithmetic of rows_kernel's Schur mode.
//
// What bounds it: bytes. A level moves its multiplier trio FL (X bytes:
// (2n + m) x n floats a plane element) once, each upper trio read and
// written (2U X) and the U compact separator solves (R): (2U + 1) X + R.
// At the quadruped's n = 36, m = 12, N = 512, B = 256, X = 1.59 GB; the
// update does ~3 FLOP a byte against the H100's ~20. Called once per
// upper level, rows_kernel reads FL from HBM U times a level (36 times
// where 8 do at N = 512).
//
// Mapping. A block owns 32 plane elements (one a lane: coalesced lines),
// one upper level u and one column tile of TC columns (12 at K <= 38: 3
// tiles at q = 36; 7 past it: 10 at the G1's q = 70), and every stacked
// output row (lambda, x, u), IB = 3
// rows a warp pass (7 warps: 4 passes of 21 rows at the quadruped's 84).
// Every operand reaches shared memory by cp.async, each lane copying and
// reading only its own plane element's values, so the copies need no
// barrier but the block's one.
//  1. FL from HBM once a level: the 1-D grid runs the (upper level x
//     column tile) blocks of one plane chunk next to each other (3 U of
//     them), so the chunk's FL rows (387 KB at the quadruped) come from
//     HBM once and then from L2. A block that copied its rows of FL into
//     shared memory once and walked every upper level and tile (FL into
//     the SM once) ran 1.5x slower at the quadruped: 212 KB of shared
//     memory a block left 7 warps an SM to hide its shared-memory latency.
//  2. Each upper trio read and written once, its loads issued ahead: a
//     warp copies its pass's C tile (IB x TC x 32 floats) into its slot of
//     shared memory before the pass's K loop, so the loads are in flight
//     under the FMAs (rows_kernel issues them after its K loop).
//  3. No FL re-read from HBM per tile (point 1); from L2, FL's terms pass
//     through a ring of S = 8 stages a warp: the pass's first S terms are
//     copied before the K loop, and term k + S as term k is consumed, so
//     eight terms' loads are in flight while the FMAs run (rows_kernel
//     loads A's rows in its K loop and waits out each miss; at the
//     quadruped's level 0 this kernel without the ring ran 17.3 ms, with
//     it 13.6, the per-level kernels 17.0). The block's fsol tile and the
//     first pass's C tile and terms are all issued before the one
//     barrier. Per term, IB + TC shared loads feed IB x TC FMAs (0.42 an
//     FMA; rows_kernel 0.61, half of them from device memory). Registers
//     capped at 128 (rows_kernel: 64), no spill; two blocks an SM (109 KB
//     of shared memory each at K = 36). Tiles of 9 and 18 columns, 4 rows
//     a pass, 4 or 6 ring stages, 8 warps, or one stream of FL's terms
//     over all passes ran 1-100% slower (PERF.md, section 6).
// Of rows_kernel's costs, this removes the C loads after the K loop and the
// 64-register cap, and cuts its re-reads of FL from L2 per column tile from
// four to three at q = 36.
// Same arithmetic as rows_kernel: each output's sum starts at 0 and takes
// fmaf over k = 0..K-1 in order, then c - sum (or the separator row), so
// the result is rows_kernel's bit for bit.
namespace levels {

constexpr int UG = 16;    // upper levels a launch (ops/planes.py UPPER_GROUP)
constexpr int IB = 3;     // output rows per warp and pass
constexpr int WARPS = 7;  // warps per block
constexpr int S = 8;      // FL terms in flight per warp
constexpr int SMEM_MAX = 110 * 1024;  // two blocks per SM

struct Args {
  const float* A[3];   // level l's FLl, FLx, FLu: [rows_g, K, F]
  const float* R[UG];  // upper level u's compact fsol: [K, q, G, B]
  float* C[UG][3];     // upper level u's Cl, Cx, Cu: [rows_g, q, F]
  int rows[3];
  int K, q, F, N, B, level;
  int count;   // upper levels in this launch
  int ctiles;  // column tiles of TC columns
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every group of this thread's copies but the newest PENDING has landed.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Shared floats of a block: the fsol tile [K][TC][LANES], then each warp's
// C slot [IB][TC][LANES] and FL ring [S][IB][LANES].
__host__ __device__ constexpr int smem_floats(int K, int TC) {
  return (K * TC + WARPS * IB * (TC + S)) * LANES;
}

template <int TC>
__global__ void __launch_bounds__(LANES * WARPS, 2)
    rows_kernel(const Args a) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  float* Rs = sm;                                         // [K][TC][LANES]
  float* Cs = sm + (a.K * TC + warp * IB * (TC + S)) * LANES;
  float* As = Cs + IB * TC * LANES;                       // [S][IB][LANES]
  // (upper level, column tile) fastest: the blocks of one chunk together.
  const int per_chunk = a.count * a.ctiles;
  const int chunk = blockIdx.x / per_chunk;
  const int u = (blockIdx.x % per_chunk) / a.ctiles;
  const int c0 = (blockIdx.x % a.ctiles) * TC;
  const float* R = a.R[0];
  float *C0 = a.C[0][0], *C1 = a.C[0][1], *C2 = a.C[0][2];
#pragma unroll
  for (int i = 1; i < UG; ++i) {  // static indices: no local copy
    if (i == u) {
      R = a.R[i];
      C0 = a.C[i][0];
      C1 = a.C[i][1];
      C2 = a.C[i][2];
    }
  }
  const int f0 = chunk * LANES + lane;
  const bool live = f0 < a.F;
  const size_t F = a.F;
  const size_t f = live ? f0 : a.F - 1;  // dead lanes load a valid address
  // The lane's knot: masks and the compact R offset (rows_kernel's).
  const int knot = (int)(f / a.B);
  const int half = 1 << a.level;
  const bool keep = (knot & (half - 1)) != 0 || knot == 0;
  const bool sep = (knot & (2 * half - 1)) == half;
  const size_t rs = (size_t)(a.N >> (a.level + 1)) * a.B;
  const size_t roff =
      (size_t)(knot >> (a.level + 1)) * a.B + (f - (size_t)knot * a.B);
  // Stage R[:, c0:c0+TC] (zero past q): warp w takes terms w, w + WARPS, ..
  for (int k = warp; k < a.K; k += WARPS) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float* dst = Rs + (k * TC + j) * LANES + lane;
      if (c0 + j < a.q)
        cp_async4(dst, R + ((size_t)k * a.q + c0 + j) * rs + roff);
      else
        *dst = 0.f;
    }
  }
  cp_async_commit();
  const int r1 = a.rows[0], r2 = r1 + a.rows[1], total = r2 + a.rows[2];
  // Lambda rows that no lane's knot keeps need no product.
  const bool any_keep = __any_sync(0xffffffffu, live && keep);
  const int passes = (total + IB * WARPS - 1) / (IB * WARPS);
  for (int p = 0; p < passes; ++p) {
    const int i0 = (p * WARPS + warp) * IB;
    const float* arow[IB];
    float* crow[IB];
    int irow[IB];
    bool on[IB], lam[IB], need = false;
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      on[ii] = i0 + ii < total;
      const int r = on[ii] ? i0 + ii : total - 1;  // dead rows repeat
      const int g = (r >= r1) + (r >= r2);
      const int i = r - (g == 0 ? 0 : (g == 1 ? r1 : r2));
      irow[ii] = i;
      lam[ii] = g == 0;
      arow[ii] = (g == 0 ? a.A[0] : (g == 1 ? a.A[1] : a.A[2])) +
                 (size_t)i * a.K * F + f;
      crow[ii] = (g == 0 ? C0 : (g == 1 ? C1 : C2)) +
                 ((size_t)i * a.q + c0) * F + f;
      need = need || (on[ii] && (!lam[ii] || any_keep));
    }
    // The ring's first S terms (one group each; the C tile joins the
    // last), then one group a term: term k's group always has S - 1 newer.
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (need && s < a.K) {
#pragma unroll
        for (int ii = 0; ii < IB; ++ii)
          cp_async4(As + (s * IB + ii) * LANES + lane,
                    arow[ii] + (size_t)s * F);
      }
      if (s == S - 1) {
#pragma unroll
        for (int ii = 0; ii < IB; ++ii)
#pragma unroll
          for (int j = 0; j < TC; ++j)
            if (live && on[ii] && c0 + j < a.q && (!lam[ii] || keep))
              cp_async4(Cs + (ii * TC + j) * LANES + lane,
                        crow[ii] + (size_t)j * F);
      }
      cp_async_commit();
    }
    if (p == 0) {  // the fsol tile has landed, for every warp
      cp_async_wait<S>();
      __syncthreads();
    }
    float acc[IB][TC];
#pragma unroll
    for (int ii = 0; ii < IB; ++ii)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[ii][j] = 0.f;
    if (need) {
#pragma unroll 2
      for (int k = 0; k < a.K; ++k) {
        cp_async_wait<S - 1>();  // term k has landed
        float* ak = As + (k % S) * IB * LANES + lane;
        float av[IB];
#pragma unroll
        for (int ii = 0; ii < IB; ++ii) av[ii] = ak[ii * LANES];
        const float* rk = Rs + k * TC * LANES + lane;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float b = rk[j * LANES];
#pragma unroll
          for (int ii = 0; ii < IB; ++ii)
            acc[ii][j] = fmaf(av[ii], b, acc[ii][j]);
        }
        if (k + S < a.K) {  // term k + S into the slot term k left
#pragma unroll
          for (int ii = 0; ii < IB; ++ii)
            cp_async4(ak + ii * LANES, arow[ii] + (size_t)(k + S) * F);
        }
        cp_async_commit();
      }
    }
    cp_async_wait<0>();  // this thread's C copies (it reads only its own)
    if (!live) continue;
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      if (!on[ii]) continue;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        if (c0 + j >= a.q) continue;
        float* c = crow[ii] + (size_t)j * F;
        const float old = Cs[(ii * TC + j) * LANES + lane];
        if (!lam[ii])
          *c = old - acc[ii][j];
        else if (sep)
          *c = Rs[(irow[ii] * TC + j) * LANES + lane];  // R's row i
        else if (keep)
          *c = old - acc[ii][j];
      }
    }
  }
}

// 12 columns a tile where two blocks still fit an SM (K <= 38), else 7
// (up to K = 80, the widest block: 109 KB; q = 70 in 10 tiles). At the
// G1's K = q = 70 tiles of 7 ran its levels 7-10% faster than 6 (12 tiles),
// and 12 (one block an SM) 6-14% slower (PERF.md).
int tile_for(int K) {
  return smem_floats(K, 12) * (int)sizeof(float) <= SMEM_MAX ? 12 : 7;
}

template <int TC>
int launch_tc(Args a, cudaStream_t st) {
  a.ctiles = (a.q + TC - 1) / TC;
  const long long blocks =
      (long long)a.count * a.ctiles * ((a.F + LANES - 1) / LANES);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_floats(a.K, TC) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rows_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rows_kernel<TC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  rows_kernel<TC><<<(unsigned)blocks, dim3(LANES, WARPS), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, cudaStream_t st) {
  return tile_for(a.K) == 12 ? launch_tc<12>(a, st) : launch_tc<7>(a, st);
}

}  // namespace levels

}  // namespace

extern "C" {

int rslqr_pgemm(const float* A, const float* B, float* C, int p, int K, int q,
                int F, void* stream) {
  if (!dims_ok(p) || !dims_ok(K) || !dims_ok(q) || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a = {};
  a.A[0] = A;
  a.C[0] = C;
  a.rows[0] = p;
  a.R = B;
  a.K = K;
  a.q = q;
  a.F = F;
  return launch_rows(a, static_cast<cudaStream_t>(stream));
}

// One slab of the Schur update, in place on C, through rows_kernel's Schur
// mode: C -= FL @ fs (lam = 0, the x/u slab's group), or the lambda slab's
// masked update with the separator write-back (lam = 1, p <= n); fs is the
// compact solved separators [n, q, G, B].
int rslqr_schur_update_planes(const float* FL, const float* fsol, float* C,
                              int p, int n, int q, int N, int B, int level,
                              int lam, void* stream) {
  if (!dims_ok(p) || !dims_ok(n) || !dims_ok(q) || (lam && p > n) ||
      N < 2 || B < 1 || level < 0 || (N >> (level + 1)) < 1 ||
      (long long)N * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a = {};
  const int g = lam ? 0 : 1;  // group 0 is the masked lambda slab
  a.A[g] = FL;
  a.C[g] = C;
  a.rows[g] = p;
  a.R = fsol;
  a.K = n;
  a.q = q;
  a.F = N * B;
  a.schur = 1;
  a.N = N;
  a.B = B;
  a.level = level;
  return launch_rows(a, static_cast<cudaStream_t>(stream));
}

int rslqr_pchol(const float* A, float* L, int n, int F, void* stream) {
  if (!dims_ok(n) || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  // Rows rounded up to whole warps.
  RSLQR_BY_WIDTH(n, [&] {
    constexpr int E = kCholLanes<W>, R = LANES / E;  // R rows a warp
    const int threads = E * ((n + R - 1) / R * R);
    const unsigned blocks = (unsigned)((F + E - 1) / E);
    pchol_kernel<W><<<blocks, threads, 0, st>>>(A, L, n, F);
  });
  return static_cast<int>(cudaGetLastError());
}

int rslqr_pcho_solve(const float* L, float* X, int n, int w, int F,
                     void* stream) {
  if (!dims_ok(n) || !dims_ok(w) || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int err = 0;
  RSLQR_BY_WIDTH(n, [&] { err = launch_solve<W>(L, X, n, w, F, st); });
  return err;
}

int rslqr_schur3_update_planes(const float* FLl, const float* FLx,
                               const float* FLu, const float* fsol, float* Cl,
                               float* Cx, float* Cu, int n, int m, int q,
                               int N, int B, int level, void* stream) {
  if (!dims_ok(n) || !dims_ok(m) || !dims_ok(q) || N < 2 || B < 1 ||
      level < 0 || (N >> (level + 1)) < 1 ||
      (long long)N * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a = {};
  const float* As[3] = {FLl, FLx, FLu};
  float* Cs[3] = {Cl, Cx, Cu};
  const int rows[3] = {n, n, m};
  for (int g = 0; g < 3; ++g) {
    a.A[g] = As[g];
    a.C[g] = Cs[g];
    a.rows[g] = rows[g];
  }
  a.R = fsol;
  a.K = n;
  a.q = q;
  a.F = N * B;
  a.schur = 1;
  a.N = N;
  a.B = B;
  a.level = level;
  return launch_rows(a, static_cast<cudaStream_t>(stream));
}

// B9 for ``count`` upper levels of one level (levels::rows_kernel): the
// slab trio of upper level u (Cls[u], Cxs[u], Cus[u]) updated in place
// with its compact fsols[u], as rslqr_schur3_update_planes would, one
// launch for all of them.
int rslqr_schur3_update_levels(const float* FLl, const float* FLx,
                               const float* FLu, const float* const* fsols,
                               float* const* Cls, float* const* Cxs,
                               float* const* Cus, int count, int n, int m,
                               int q, int N, int B, int level, void* stream) {
  if (!dims_ok(n) || !dims_ok(m) || !dims_ok(q) || count < 1 ||
      count > levels::UG || N < 2 || B < 1 || level < 0 ||
      (N >> (level + 1)) < 1 || (long long)N * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  levels::Args a = {};
  a.A[0] = FLl;
  a.A[1] = FLx;
  a.A[2] = FLu;
  for (int u = 0; u < count; ++u) {
    a.R[u] = fsols[u];
    a.C[u][0] = Cls[u];
    a.C[u][1] = Cxs[u];
    a.C[u][2] = Cus[u];
  }
  a.rows[0] = n;
  a.rows[1] = n;
  a.rows[2] = m;
  a.K = n;
  a.q = q;
  a.F = N * B;
  a.N = N;
  a.B = B;
  a.level = level;
  a.count = count;
  return levels::launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
