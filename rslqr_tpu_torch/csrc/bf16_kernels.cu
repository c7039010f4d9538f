// Hand-written Hopper kernels for B1, B3 and B4 with bf16 factor slabs
// (SolveOptions.factor_dtype = "bfloat16"): bf16_rows.cuh's column-pair
// kernels, which stage the product emission in shared memory. The f32 slabs
// of the same functions, and B2 in both storages, are schur_kernels.cu's.
//
//   row_level2_kernel <- rslqr_tpu/ops/schur_pallas.py:schur_update_level_em
//   row_pair2_kernel  <- rslqr_tpu/ops/schur_pallas.py:schur_update_pair_em
//   leaf_row2_kernel  <- rslqr_tpu/ops/schur_pallas.py:leaf_schur_level0_em
//
// Each entry takes the plan of ops/schur.py:_level_plan with ``bf16`` (the
// row groups, knots and shift of the f32 kernels; 64 batch columns a block;
// ``vec`` the column-pair accesses; ``smem`` the emission stage), refuses a
// plan that does not cover the launch, and returns cudaGetLastError() right
// after it. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (rslqr_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>

#include "bf16_rows.cuh"
#include "row_groups.cuh"
#include "small_blocks.cuh"

extern "C" {

// B1, bf16 slabs.
int rslqr_schur_update_level_bf16(
    const void* FLl, const void* FLx, const void* FLu, void* const* Fls,
    void* const* Fxs, void* const* Fus, void* const* fsol, const float* Asep,
    const float* Bsep, void* const* S, int U, int N, int B, int level,
    int emit, int n, int m, int shift, int gy, int rgs, int vec,
    long long smem, void* stream) {
  if (!small_blocks::row_plan_ok(U, N, level, emit, n, m, shift, gy, rgs) ||
      !small_blocks::level2_plan_ok(emit, n, m, B, vec, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const int launched = small_blocks::with_block(n, m, [&](auto k) {
    err = small_blocks::launch_row_level2<decltype(k)>(
        FLl, FLx, FLu, Fls, Fxs, Fus, fsol, Asep, Bsep, S, U, N, B, level,
        emit, n, m, shift, gy, vec, (size_t)smem, st);
  });
  return err ? err : launched;
}

// B4, bf16 slabs.
int rslqr_schur_update_pair_bf16(
    const void* FLl, const void* FLx, const void* FLu, void* const* Fls,
    void* const* Fxs, void* const* Fus, void* const* fsol1,
    const float* Sbar2, void* const* fsol2, const float* Asep3,
    const float* Bsep3, void* const* S, int U, int N, int B, int level,
    int emit, int n, int m, int shift, int gy, int rgs, int vec,
    long long smem, void* stream) {
  if (!small_blocks::pair_plan_ok(U, N, level, emit, n, m, shift, gy, rgs) ||
      !small_blocks::pair2_plan_ok(true, emit, n, m, B, vec, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const int launched = small_blocks::with_block(n, m, [&](auto k) {
    err = small_blocks::launch_row_pair2<decltype(k)>(
        FLl, FLx, FLu, Fls, Fxs, Fus, fsol1, Sbar2, fsol2, Asep3, Bsep3, S, U,
        N, B, level, emit, n, m, shift, gy, vec, (size_t)smem, st);
  });
  return err ? err : launched;
}

// B3, bf16 slabs out.
int rslqr_leaf_schur_level0_bf16(
    const float* A, const float* Bm, const float* qinv, const float* rinv,
    const float* S0, void* const* fsol, const float* Asep, const float* Bsep,
    void* const* Fls, void* const* Fxs, void* const* Fus, void* const* S,
    int depth, int N, int B, int n, int m, int shift, int gy, int rgs,
    int vec, long long smem, void* stream) {
  if (!small_blocks::leaf_plan_ok(depth, N, n, m, shift, gy, rgs) ||
      !small_blocks::pair2_plan_ok(false, 1, n, m, B, vec, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const int launched = small_blocks::with_block(n, m, [&](auto k) {
    err = small_blocks::launch_leaf_rows2<decltype(k)>(
        A, Bm, qinv, rinv, S0, fsol, Asep, Bsep, Fls, Fxs, Fus, S, depth, N,
        B, n, m, gy, vec, (size_t)smem, st);
  });
  return err ? err : launched;
}

}  // extern "C"
