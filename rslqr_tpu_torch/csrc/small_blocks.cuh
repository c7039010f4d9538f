// Block-size instantiations of the small-block sweep kernels
// (schur_kernels.cu, flat_kernels.cu).
//
// A kernel is a template on a tag K that carries the block capacity NP x MP
// (state dim n <= NP, input dim m <= MP) and whether the dims are exact:
//   * exact (6, 3): n and m are the constants 6 and 3, so every block
//     product unrolls into register FMAs with nothing masked;
//   * generic (4, 4) and (8, 8): n and m arrive at run time. Register blocks
//     keep the capacity's stride (element (i, j) of an R x C block at
//     i*C + j) and are zero past n and m, so a product over the capacity
//     adds exact zeros; loads and stores past n or m are masked. Device
//     memory keeps its own stride (element (i, j) at i*cols + j).
// So every small block the solver routes to these kernels (1 <= n, m <= 8)
// has one, and the path's own (6, 3) pays nothing for the others.

#pragma once

#include <cuda_runtime.h>

namespace small_blocks {

template <int NP_, int MP_, bool EX_>
struct Blk {
  static constexpr int NP = NP_, MP = MP_;
  static constexpr bool EX = EX_;
};

// The largest block dims any instantiation serves (ops/schur.py MAX_SMALL).
constexpr int MAX_SMALL = 8;

// Call launch(K{}) with the instantiation that serves (n, m); the launch's
// error code, or cudaErrorInvalidValue when none does.
template <class F>
int with_block(int n, int m, F&& launch) {
  if (n == 6 && m == 3)
    launch(Blk<6, 3, true>{});
  else if (n >= 1 && m >= 1 && n <= 4 && m <= 4)
    launch(Blk<4, 4, false>{});
  else if (n >= 1 && m >= 1 && n <= MAX_SMALL && m <= MAX_SMALL)
    launch(Blk<8, 8, false>{});
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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

// (M @ f)[i, c] for register blocks M (p x n, stride NP) and f (n x n,
// stride NP), zero past n: the terms past n add exact zeros.
template <int NP>
__device__ __forceinline__ float dot_row(const float* M, int i,
                                         const float* f, int c) {
  float acc = M[i * NP] * f[c];
#pragma unroll
  for (int j = 1; j < NP; ++j) acc += M[i * NP + j] * f[j * NP + c];
  return acc;
}

}  // namespace small_blocks
