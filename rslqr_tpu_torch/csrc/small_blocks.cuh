// Block-size instantiations of the small-block sweep kernels
// (schur_kernels.cu, flat_kernels.cu), and what they share.
//
// A kernel is a template on a tag K that carries the block capacity NP x MP
// (state dim n <= NP, input dim m <= MP), whether the dims are exact, and
// whether the input dim is wide:
//   * exact (6, 3): n and m are the constants 6 and 3, so every block
//     product unrolls into register FMAs with nothing masked;
//   * generic (4, 4) and (8, 8): n and m arrive at run time. Register blocks
//     keep the capacity's stride (element (i, j) of an R x C block at
//     i*C + j) and are zero past n and m, so a product over the capacity
//     adds exact zeros; loads and stores past n or m are masked. Device
//     memory keeps its own stride (element (i, j) at i*cols + j).
//   * wide (8, 8): n <= 8 < m <= MAX_INPUT_DIM, both at run time. The u rows
//     are independent of each other in every update (u -= MU @ f, and the
//     leaf value R^-1 B' is taken row by row since R is diagonal), so the
//     RHS kernels take them in chunks of MP = 8 rows (``chunks``) and the
//     row-group kernels (row_groups.cuh, leaf_rows.cuh) loop over more row
//     groups; the one sum over m, the product emission's B_sep @ u[r],
//     reads u[r] back from device memory.
// So every small block the solver routes to these kernels (1 <= n <= 8,
// 1 <= m <= 64: the reference's small-block Schur kernels are gated on n
// alone) has one, and the path's own (6, 3) pays nothing for the others.

#pragma once

#include <cuda_runtime.h>

namespace small_blocks {

template <int NP_, int MP_, bool EX_, bool WIDE_ = false>
struct Blk {
  static constexpr int NP = NP_, MP = MP_;
  static constexpr bool EX = EX_, WIDE = WIDE_;
};

// The largest block dims any instantiation serves (ops/schur.py MAX_STATE,
// MAX_INPUT; MAX_INPUT itself is a macro of <limits.h>).
constexpr int MAX_STATE_DIM = 8;
constexpr int MAX_INPUT_DIM = 64;

// Call launch(K{}) with the instantiation that serves (n, m); the launch's
// error code, or cudaErrorInvalidValue when none does.
template <class F>
int with_block(int n, int m, F&& launch) {
  if (n == 6 && m == 3)
    launch(Blk<6, 3, true>{});
  else if (n >= 1 && m >= 1 && n <= 4 && m <= 4)
    launch(Blk<4, 4, false>{});
  else if (n >= 1 && m >= 1 && n <= MAX_STATE_DIM && m <= MAX_STATE_DIM)
    launch(Blk<8, 8, false>{});
  else if (n >= 1 && m >= 1 && n <= MAX_STATE_DIM && m <= MAX_INPUT_DIM)
    launch(Blk<8, 8, false, true>{});
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Chunks of MP u rows a kernel takes: one, except at the wide tag. The
// chunk at row i0 has min(MP, m - i0) rows (``chunk_rows``).
template <class K>
__host__ __device__ __forceinline__ int chunks(int m) {
  return K::WIDE ? (m + K::MP - 1) / K::MP : 1;
}

template <class K>
__host__ __device__ __forceinline__ int chunk_rows(int m, int i0) {
  return K::WIDE ? (m - i0 < K::MP ? m - i0 : K::MP) : m;
}

constexpr int MAXU = 24;  // upper slabs per launch (matches ops/schur.py)
constexpr int TB = 32;    // batch columns per block

// Slab pointer lists, passed by value (MAXU entries).
struct Ptrs {
  float* p[MAXU];
};
struct CPtrs {
  const float* p[MAXU];
};

// Pointer lists arrive from the host as MAXU-entry arrays.
inline Ptrs ptrs(void* const* src) {
  Ptrs out;
  for (int i = 0; i < MAXU; ++i) out.p[i] = static_cast<float*>(src[i]);
  return out;
}

inline CPtrs cptrs(void* const* src) {
  CPtrs out;
  for (int i = 0; i < MAXU; ++i) out.p[i] = static_cast<const float*>(src[i]);
  return out;
}

// An R x C register block r (stride C) from rows x cols device elements,
// element (i, j) = at(i*cols + j); zero past rows or cols.
template <int R, int C, class At>
__device__ __forceinline__ void load_blk(float (&r)[R * C], int rows,
                                         int cols, At at) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      r[i * C + j] = (i < rows && j < cols) ? at(i * cols + j) : 0.0f;
}

}  // namespace small_blocks
