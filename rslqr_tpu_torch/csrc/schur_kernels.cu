// Hand-written Hopper kernels for the element-major rsLQR sweep.
//
// Four kernels, one per TPU kernel of rslqr_tpu/ops/schur_pallas.py:
//   row_level_kernel <- schur_update_level_em (one tree level, every upper
//                       slab; row_groups.cuh, on row groups)
//   row_pair_kernel  <- schur_update_pair_em  (levels L and L+1 in one pass;
//                       row_groups.cuh, on the same row groups)
//   leaf_kernel      <- leaf_schur_level0_em  (leaf factors + level 0)
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
// Mapping of leaf_kernel and rhs_kernel (row_level_kernel and
// row_pair_kernel: see row_groups.cuh): one thread per (knot, batch
// column). A block is TB=32 batch columns (one warp, so every slab
// load/store is a coalesced 128-byte line) by TK=8 knots (4 at the (8, 8)
// capacity, whose staging of 8 knots would pass the 48 KB of static shared
// memory). Knot tiles are shifted by one:
// block row y covers knots y*TK-1 .. y*TK+TK-2, so each (odd knot, odd
// knot + 1) pair lies in one block. The next-level product emission needs
// exactly such a pair (the separator row r, always odd, and r+1) and nothing
// else across knots: the thread of row r stages its updated x/u blocks in
// shared memory, and after a __syncthreads() the thread of row r+1 forms
//   S = A_sep @ Fx[r] + B_sep @ Fu[r] - Fx[r+1] - Fl[r+1]
// (ndlqr_FactorInnerProduct, nested_dissection.c:114-134), writes S and,
// for the next level's own slab, folds it into its lambda row.
//
// Bound: bandwidth (~0.4 FLOP/byte). Each launcher returns
// cudaGetLastError() right after the launch; the Python wrapper raises on a
// nonzero code. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC (rslqr_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cstddef>

#include "row_groups.cuh"
#include "small_blocks.cuh"

namespace {

using small_blocks::chunk_rows;
using small_blocks::chunks;
using small_blocks::CPtrs;
using small_blocks::cptrs;
using small_blocks::dot_row;
using small_blocks::load_blk;
using small_blocks::MAXU;
using small_blocks::Ptrs;
using small_blocks::ptrs;
using small_blocks::TB;
using small_blocks::with_block;

// Knots per block (even: holds whole odd/even pairs).
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

// A rows x cols block of this thread's knot from element-major planes.
template <int R, int C>
__device__ __forceinline__ void load_planes(float (&r)[R * C],
                                            const float* src, int rows,
                                            int cols, const Site& s) {
  load_blk<R, C>(r, rows, cols,
                 [&](int e) { return src[e * s.plane + s.idx]; });
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

// Shared-memory staging of separator rows: one slot per odd/even knot pair
// (the wide tag stages x only).
template <class K>
struct Stage {
  float x[tk_of<K>() / 2][K::NP * K::NP][TB];
  float u[K::WIDE ? 1 : tk_of<K>() / 2][K::WIDE ? 1 : K::MP * K::NP][TB];
};

// The row-(r+1) thread's product emission and optional fold (see header).
// ``ol``/``ox``/``ou`` are its own lambda/x/u slab pointers (already
// written); the wide tag reads u[r] from ``ou`` at knot r, one row at a
// time, into the n x n sums.
template <class K>
__device__ void emit_products(const Stage<K>& st, int slot,
                              const float* __restrict__ Asep,
                              const float* __restrict__ Bsep, float* Sout,
                              float* ol, const float* ox, const float* ou,
                              bool fold, int g2, int B, const Site& s, int n,
                              int m) {
  constexpr int NP = K::NP, MP = K::MP;
  const int nn = n * n;
  const int t = threadIdx.x;
  float a[NP * NP];
  load_group<NP, NP>(a, Asep, n, n, g2, B, s.b);
  if constexpr (K::WIDE) {
    float S[NP * NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        float acc = a[i * NP] * st.x[slot][c][t];
#pragma unroll
        for (int j = 1; j < NP; ++j)
          if (j < n) acc += a[i * NP + j] * st.x[slot][j * n + c][t];
        S[i * NP + c] = acc;
      }
    const size_t ir = s.idx - B;  // knot r = k - 1
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      float bj[NP], uj[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        bj[i] = i < n ? Bsep[gidx(g2, n * m, i * m + j, B, s.b)] : 0.0f;
        uj[i] = i < n ? ou[(j * n + i) * s.plane + ir] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < NP; ++c) S[i * NP + c] += bj[i] * uj[c];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= n || c >= n) continue;
        const int e = i * n + c;
        const float acc =
            S[i * NP + c] - ox[e * s.plane + s.idx] - ol[e * s.plane + s.idx];
        Sout[gidx(g2, nn, e, B, s.b)] = acc;
        if (fold) ol[e * s.plane + s.idx] = acc;
      }
  } else {
    float bm[NP * MP];
    load_group<NP, MP>(bm, Bsep, n, m, g2, B, s.b);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= n || c >= n) continue;
        const int e = i * n + c;
        float acc = a[i * NP] * st.x[slot][c][t];
#pragma unroll
        for (int j = 1; j < NP; ++j)
          if (j < n) acc += a[i * NP + j] * st.x[slot][j * n + c][t];
#pragma unroll
        for (int j = 0; j < MP; ++j)
          if (j < m) acc += bm[i * MP + j] * st.u[slot][j * n + c][t];
        acc = acc - ox[e * s.plane + s.idx] - ol[e * s.plane + s.idx];
        Sout[gidx(g2, nn, e, B, s.b)] = acc;
        if (fold) ol[e * s.plane + s.idx] = acc;
      }
    }
  }
}

// The u rows' multiplier of chunk i0 (rows i0 .. i0 + mc - 1) as a register
// block (stride NP): ``mu`` itself, except at the wide tag, where ``mu`` is a
// callable that fills ``mw``.
template <class K, class Mu>
__device__ __forceinline__ const float* mu_chunk(const Mu& mu, int i0, int mc,
                                                 float (&mw)[K::MP * K::NP]) {
  if constexpr (K::WIDE) {
    mu(i0, mc, mw);
    return mw;
  } else {
    return mu;
  }
}

// One level's update of one upper slab trio at this thread's knot:
//   l = sep ? f : (keep ? l - ML@f : l);  x -= MX@f;  u -= MU@f
// ``ml``/``mx`` hold the multiplier blocks, ``mu`` the u rows' (a register
// block, or at the wide tag a callable giving each chunk's). The slab values
// are read from and written back to ``ol``/``ox``/``ou`` in place; for a
// separator row r (``stage``) the new x/u blocks also go to the staging slot
// (x only at the wide tag).
template <class K, class Mu>
__device__ __forceinline__ void update_trio(
    const float* ml, const float* mx, const Mu& mu, const float* f,
    bool keep, bool sep, float* ol, float* ox, float* ou, Stage<K>& st,
    int slot, bool stage, const Site& s, int n, int m) {
  constexpr int NP = K::NP, MP = K::MP;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (i >= n || c >= n) continue;
      const size_t o = (i * n + c) * s.plane + s.idx;
      const float v = ol[o];
      ol[o] = sep ? f[i * NP + c] : (keep ? v - dot_row<NP>(ml, i, f, c) : v);
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (i >= n || c >= n) continue;
      const int e = i * n + c;
      const size_t o = e * s.plane + s.idx;
      const float v = ox[o] - dot_row<NP>(mx, i, f, c);
      ox[o] = v;
      if (stage) st.x[slot][e][t] = v;
    }
  }
  for (int ch = 0, i0 = 0; ch < chunks<K>(m); ++ch, i0 += MP) {
    const int mc = chunk_rows<K>(m, i0);
    float mw[MP * NP];
    const float* mu_c = mu_chunk<K>(mu, i0, mc, mw);
#pragma unroll
    for (int i = 0; i < MP; ++i) {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (i >= mc || c >= n) continue;
        const int e = (i0 + i) * n + c;
        const size_t o = e * s.plane + s.idx;
        const float v = ou[o] - dot_row<NP>(mu_c, i, f, c);
        ou[o] = v;
        if constexpr (!K::WIDE)
          if (stage) st.u[slot][e][t] = v;
      }
    }
  }
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

// ---------------------------------------------------------------------------
// B3: leaf factors + level-0 update of every level's slab.
// ---------------------------------------------------------------------------

// Level-L leaf values at knot k (ndlqr_SolveLeaf, nested_dissection.c:
// 10-105; level(k) = trailing zeros of k+1, binary_tree.c:65-73):
//   fx = own ? Q^-1 A' : 0  - (prev ? Q^-1 : 0),  fu = ownu ? R^-1 B' : 0,
// as register blocks (stride NP), zero past n and m.
template <class K>
__device__ __forceinline__ void leaf_values(const float* a, const float* bm,
                                            const float* qi, const float* ri,
                                            int L, int k, int N, float* fx,
                                            float* fu, int n, int m) {
  constexpr int NP = K::NP, MP = K::MP;
  const int mask = (2 << L) - 1;
  const bool own = ((k + 1) & mask) == (1 << L) && k >= 1 && k < N - 1;
  const bool prev = (k & mask) == (1 << L);
  const bool ownu = own || (L == 0 && k == 0);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float v = 0.0f;
      if (i < n && j < n) {
        v = own ? a[j * NP + i] * qi[i] : 0.0f;
        if (i == j) v -= prev ? qi[i] : 0.0f;
      }
      fx[i * NP + j] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < MP; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      fu[i * NP + j] =
          (i < m && j < n && ownu) ? bm[j * MP + i] * ri[i] : 0.0f;
  }
}

// Store a rows x n register block (stride NP) into this thread's knot of
// element-major planes.
template <int R, int NP>
__device__ __forceinline__ void store_planes(float* dst, const float* r,
                                             int rows, int n, const Site& s) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (i < rows && j < n) dst[(i * n + j) * s.plane + s.idx] = r[i * NP + j];
}

template <class K>
__global__ void leaf_kernel(const float* __restrict__ A,
                            const float* __restrict__ Bm,
                            const float* __restrict__ qinv,
                            const float* __restrict__ rinv,
                            const float* __restrict__ S0, CPtrs fsol,
                            const float* __restrict__ Asep,
                            const float* __restrict__ Bsep, Ptrs Fls, Ptrs Fxs,
                            Ptrs Fus, Ptrs Sout, int depth, int N, int B,
                            int n_, int m_) {
  constexpr int NP = K::NP, MP = K::MP;
  const int n = K::EX ? NP : n_, m = K::EX ? MP : m_;
  const int nn = n * n;
  __shared__ Stage<K> st;
  const Site s = site<tk_of<K>()>(N, B);
  const int k = s.k;
  const bool keep = k == 0;             // level-0 calc_lambda
  const bool sep = (k & 1) == 1;        // level-0 sep+1 rows
  const int g = k >> 1;
  const int pos = k & 3;                // level-1 separator rows 1 and 2
  const bool er = s.live && pos == 1;
  const bool er1 = s.live && pos == 2;
  const int slot = threadIdx.y >> 1;
  float a[NP * NP], bm[NP * MP], qi[NP], ri[MP];
  float fl0[NP * NP], fx0[NP * NP], fu0[MP * NP];
  // The wide tag's u rows i0 .. i0 + mc - 1: their columns of B and their
  // entries of R^-1, then their level-L leaf values (stride NP).
  const auto fu_wide = [&](int L, int i0, int mc, float (&fw)[MP * NP]) {
    float bc[NP * MP], rc[MP], fx[NP * NP];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int i = 0; i < MP; ++i)
        bc[j * MP + i] = j < n && i < mc
                             ? Bm[(j * m + i0 + i) * s.plane + s.idx]
                             : 0.0f;
#pragma unroll
    for (int i = 0; i < MP; ++i)
      rc[i] = i < mc ? rinv[(i0 + i) * s.plane + s.idx] : 0.0f;
    leaf_values<K>(a, bc, qi, rc, L, k, N, fx, fw, n, mc);
  };
  if (s.live) {
    load_planes<NP, NP>(a, A, n, n, s);
    load_planes<1, NP>(qi, qinv, 1, n, s);
    if constexpr (!K::WIDE) {
      load_planes<NP, MP>(bm, Bm, n, m, s);
      load_planes<1, MP>(ri, rinv, 1, m, s);
    }
    leaf_values<K>(a, bm, qi, ri, 0, k, N, fx0, fu0, n, K::WIDE ? 0 : m);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j)
        fl0[i * NP + j] = (k == 0 && i < n && j < n) ? -a[j * NP + i] : 0.0f;
    }
    // Slab 0: leaf values, with level 0's own Sbar at its sep+1 rows.
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (i >= n || j >= n) continue;
        const int e = i * n + j;
        Fls.p[0][e * s.plane + s.idx] =
            sep ? S0[gidx(g, nn, e, B, s.b)] : fl0[i * NP + j];
        Fxs.p[0][e * s.plane + s.idx] = fx0[i * NP + j];
      }
    }
    if constexpr (K::WIDE) {
      for (int i0 = 0; i0 < m; i0 += MP) {
        const int mc = chunk_rows<K>(m, i0);
        float fw[MP * NP];
        fu_wide(0, i0, mc, fw);
        store_planes<MP, NP>(Fus.p[0] + (size_t)i0 * n * s.plane, fw, mc, n,
                             s);
      }
    } else {
      store_planes<MP, NP>(Fus.p[0], fu0, m, n, s);
    }
  }
  const auto fu0_wide = [&](int i0, int mc, float (&fw)[MP * NP]) {
    fu_wide(0, i0, mc, fw);
  };
  for (int u = 1; u < depth; ++u) {
    if (s.live) {
      float f[NP * NP], fx[NP * NP], fu[MP * NP];
      load_group<NP, NP>(f, fsol.p[u - 1], n, n, g, B, s.b);
      leaf_values<K>(a, bm, qi, ri, u, k, N, fx, fu, n, K::WIDE ? 0 : m);
      float* ol = Fls.p[u];
      float* ox = Fxs.p[u];
      float* ou = Fus.p[u];
      // Upper lambda slabs start at zero.
#pragma unroll
      for (int e = 0; e < NP * NP; ++e)
        if (e < nn) ol[e * s.plane + s.idx] = 0.0f;
      store_planes<NP, NP>(ox, fx, n, n, s);
      if constexpr (K::WIDE) {
        for (int i0 = 0; i0 < m; i0 += MP) {
          const int mc = chunk_rows<K>(m, i0);
          float fw[MP * NP];
          fu_wide(u, i0, mc, fw);
          store_planes<MP, NP>(ou + (size_t)i0 * n * s.plane, fw, mc, n, s);
        }
        update_trio<K>(fl0, fx0, fu0_wide, f, keep, sep, ol, ox, ou, st,
                       slot, er, s, n, m);
      } else {
        store_planes<MP, NP>(ou, fu, m, n, s);
        update_trio<K>(fl0, fx0, fu0, f, keep, sep, ol, ox, ou, st, slot, er,
                       s, n, m);
      }
    }
    __syncthreads();
    if (er1)
      emit_products<K>(st, slot, Asep, Bsep, Sout.p[u - 1], Fls.p[u],
                       Fxs.p[u], Fus.p[u], u == 1, k >> 2, B, s, n, m);
    __syncthreads();
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

int rslqr_leaf_schur_level0(const float* A, const float* Bm,
                            const float* qinv, const float* rinv,
                            const float* S0, void* const* fsol,
                            const float* Asep, const float* Bsep,
                            void* const* Fls, void* const* Fxs,
                            void* const* Fus, void* const* S, int depth, int N,
                            int B, int n, int m, void* stream) {
  if (depth < 2 || depth > MAXU)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_block(n, m, [&](auto k) {
    using K = decltype(k);
    leaf_kernel<K><<<grid_for<K>(N, B), block_for<K>(), 0, st>>>(
        A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep, ptrs(Fls), ptrs(Fxs),
        ptrs(Fus), ptrs(S), depth, N, B, n, m);
  });
}

}  // extern "C"
