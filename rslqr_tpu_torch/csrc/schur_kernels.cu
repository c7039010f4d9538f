// Hand-written Hopper kernels for the element-major rsLQR sweep.
//
// Four kernels, one per TPU kernel of rslqr_tpu/ops/schur_pallas.py:
//   level_kernel  <- schur_update_level_em  (one tree level, every upper slab)
//   pair_kernel   <- schur_update_pair_em   (levels L and L+1 in one pass)
//   leaf_kernel   <- leaf_schur_level0_em   (leaf factors + level 0)
//   rhs_kernel    <- rhs_update_level_em    (one level of the RHS sweep)
//
// Layout (as in the JAX package): factor slabs are element-major planes
// [e, N, B] (element e of knot k, batch column b at e*N*B + k*B + b);
// solved separator blocks and emitted products are group-major [G, e, B].
// float32 only. Block sizes n, m are template parameters (instantiated for
// n=6, m=3), so every small block product unrolls into register FMAs.
//
// Mapping: one thread per (knot, batch column). A block is TB=32 batch
// columns (one warp, so every slab load/store is a coalesced 128-byte line)
// by TK=8 knots. Knot tiles are shifted by one: block row y covers knots
// y*TK-1 .. y*TK+TK-2, so each (odd knot, odd knot + 1) pair lies in one
// block. The next-level product emission needs exactly such a pair (the
// separator row r, always odd, and r+1) and nothing else across knots: the
// thread of row r stages its updated x/u blocks in shared memory, and after
// a __syncthreads() the thread of row r+1 forms
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

namespace {

constexpr int MAXU = 24;  // upper slabs per launch (matches ops/schur.py)
constexpr int TB = 32;    // batch columns per block
constexpr int TK = 8;     // knots per block (even: holds whole odd/even pairs)

struct Ptrs {
  float* p[MAXU];
};
struct CPtrs {
  const float* p[MAXU];
};

struct Site {
  int b, k;
  bool live;
  size_t idx, plane;
};

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

template <int E>
__device__ __forceinline__ void load_planes(float (&r)[E], const float* src,
                                            const Site& s) {
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = src[e * s.plane + s.idx];
}

template <int E>
__device__ __forceinline__ void load_group(float (&r)[E], const float* src,
                                           int g, int B, int b) {
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = src[gidx(g, E, e, B, b)];
}

// (M @ f)[i, c] for a p x n block M (row-major planes) and n x n block f.
template <int n>
__device__ __forceinline__ float dot_row(const float* M, int i,
                                         const float* f, int c) {
  float acc = M[i * n] * f[c];
#pragma unroll
  for (int j = 1; j < n; ++j) acc += M[i * n + j] * f[j * n + c];
  return acc;
}

// Shared-memory staging of separator rows: one slot per odd/even knot pair.
template <int n, int m>
struct Stage {
  float x[TK / 2][n * n][TB];
  float u[TK / 2][m * n][TB];
};

// The row-(r+1) thread's product emission and optional fold (see header).
// ``ol``/``ox`` are its own lambda/x slab pointers (already written).
template <int n, int m>
__device__ void emit_products(const Stage<n, m>& st, int slot,
                              const float* __restrict__ Asep,
                              const float* __restrict__ Bsep, float* Sout,
                              float* ol, const float* ox, bool fold, int g2,
                              int B, const Site& s) {
  constexpr int nn = n * n;
  float a[nn], bm[n * m];
  load_group(a, Asep, g2, B, s.b);
  load_group(bm, Bsep, g2, B, s.b);
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      float acc = a[i * n] * st.x[slot][c][t];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += a[i * n + j] * st.x[slot][j * n + c][t];
#pragma unroll
      for (int j = 0; j < m; ++j) acc += bm[i * m + j] * st.u[slot][j * n + c][t];
      acc = acc - ox[e * s.plane + s.idx] - ol[e * s.plane + s.idx];
      Sout[gidx(g2, nn, e, B, s.b)] = acc;
      if (fold) ol[e * s.plane + s.idx] = acc;
    }
  }
}

// One level's update of one upper slab trio at this thread's knot:
//   l = sep ? f : (keep ? l - ML@f : l);  x -= MX@f;  u -= MU@f
// ``ml``/``mx``/``mu`` hold the multiplier blocks. The slab values are read
// from and written back to ``ol``/``ox``/``ou`` in place; for a separator
// row r (``stage``) the new x/u blocks also go to the staging slot.
template <int n, int m>
__device__ __forceinline__ void update_trio(
    const float* ml, const float* mx, const float* mu, const float* f,
    bool keep, bool sep, float* ol, float* ox, float* ou, Stage<n, m>& st,
    int slot, bool stage, const Site& s) {
  constexpr int nn = n * n;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const size_t o = e * s.plane + s.idx;
      const float v = ol[o];
      ol[o] = sep ? f[e] : (keep ? v - dot_row<n>(ml, i, f, c) : v);
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const size_t o = e * s.plane + s.idx;
      const float v = ox[o] - dot_row<n>(mx, i, f, c);
      ox[o] = v;
      if (stage) st.x[slot][e][t] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const size_t o = e * s.plane + s.idx;
      const float v = ou[o] - dot_row<n>(mu, i, f, c);
      ou[o] = v;
      if (stage) st.u[slot][e][t] = v;
    }
  }
  (void)nn;
}

// ---------------------------------------------------------------------------
// B2: RHS sweep, one level.
// ---------------------------------------------------------------------------
template <int n, int m>
__global__ void rhs_kernel(const float* __restrict__ Fl,
                           const float* __restrict__ Fx,
                           const float* __restrict__ Fu, float* zy, float* zx,
                           float* zu, const float* __restrict__ zbar, int N,
                           int B, int level) {
  const Site s = site(N, B);
  if (!s.live) return;
  const int k = s.k, half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  float zb[n];
  load_group(zb, zbar, k >> (level + 1), B, s.b);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float acc = Fl[(i * n) * s.plane + s.idx] * zb[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += Fl[(i * n + j) * s.plane + s.idx] * zb[j];
    const size_t o = i * s.plane + s.idx;
    const float v = zy[o];
    zy[o] = sep ? zb[i] : (keep ? v - acc : v);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float acc = Fx[(i * n) * s.plane + s.idx] * zb[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += Fx[(i * n + j) * s.plane + s.idx] * zb[j];
    zx[i * s.plane + s.idx] -= acc;
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
    float acc = Fu[(i * n) * s.plane + s.idx] * zb[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += Fu[(i * n + j) * s.plane + s.idx] * zb[j];
    zu[i * s.plane + s.idx] -= acc;
  }
}

// ---------------------------------------------------------------------------
// B1: one level's Schur update of every upper slab.
// ---------------------------------------------------------------------------
template <int n, int m>
__global__ void level_kernel(const float* __restrict__ FLl,
                             const float* __restrict__ FLx,
                             const float* __restrict__ FLu, Ptrs Fls,
                             Ptrs Fxs, Ptrs Fus, CPtrs fsol,
                             const float* __restrict__ Asep,
                             const float* __restrict__ Bsep, Ptrs Sout, int U,
                             int N, int B, int level, int emit) {
  constexpr int nn = n * n, mn = m * n;
  __shared__ Stage<n, m> st;
  const Site s = site(N, B);
  const int k = s.k, half = 1 << level, span = 2 * half;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (span - 1)) == half;
  const int g = k >> (level + 1);
  // Next-level separator rows r (odd) and r+1 within groups of 2*span.
  const int pos = k & (2 * span - 1);
  const bool er = emit && s.live && pos == span - 1;
  const bool er1 = emit && s.live && pos == span;
  const int slot = threadIdx.y >> 1;
  float ml[nn], mx[nn], mu[mn];
  if (s.live) {
    load_planes(ml, FLl, s);
    load_planes(mx, FLx, s);
    load_planes(mu, FLu, s);
  }
  for (int u = 0; u < U; ++u) {
    if (s.live) {
      float f[nn];
      load_group(f, fsol.p[u], g, B, s.b);
      update_trio<n, m>(ml, mx, mu, f, keep, sep, Fls.p[u], Fxs.p[u],
                        Fus.p[u], st, slot, er, s);
    }
    if (emit) {
      __syncthreads();
      if (er1)
        emit_products<n, m>(st, slot, Asep, Bsep, Sout.p[u], Fls.p[u],
                            Fxs.p[u], u == 0, k >> (level + 2), B, s);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// B4: levels L and L+1 in one pass.
// ---------------------------------------------------------------------------
template <int n, int m>
__global__ void pair_kernel(const float* __restrict__ FLl,
                            const float* __restrict__ FLx,
                            const float* __restrict__ FLu, Ptrs Fls, Ptrs Fxs,
                            Ptrs Fus, CPtrs fsol1,
                            const float* __restrict__ Sbar2, CPtrs fsol2,
                            const float* __restrict__ Asep3,
                            const float* __restrict__ Bsep3, Ptrs Sout, int U,
                            int N, int B, int level, int emit) {
  constexpr int nn = n * n, mn = m * n;
  __shared__ Stage<n, m> st;
  const Site s = site(N, B);
  const int k = s.k, half = 1 << level, span = 2 * half, span2 = 2 * span;
  const bool keep1 = (k & (half - 1)) != 0 || k == 0;
  const bool sep1 = (k & (span - 1)) == half;
  const bool keep2 = (k & (span - 1)) != 0 || k == 0;
  const bool sep2 = (k & (span2 - 1)) == span;
  const int g1 = k >> (level + 1), g2 = k >> (level + 2);
  const int pos = k & (2 * span2 - 1);
  const bool er = emit && s.live && pos == span2 - 1;
  const bool er1 = emit && s.live && pos == span2;
  const int slot = threadIdx.y >> 1;
  const int t = threadIdx.x;
  float ml[nn], mx[nn], mu[mn];
  if (s.live) {
    load_planes(ml, FLl, s);
    load_planes(mx, FLx, s);
    load_planes(mu, FLu, s);
    // Slab L+1: level-L update, then its Sbar at the level-(L+1) sep+1 rows.
    float f[nn];
    load_group(f, fsol1.p[0], g1, B, s.b);
    update_trio<n, m>(ml, mx, mu, f, keep1, sep1, Fls.p[0], Fxs.p[0],
                      Fus.p[0], st, slot, false, s);
    if (sep2) {
#pragma unroll
      for (int e = 0; e < nn; ++e)
        Fls.p[0][e * s.plane + s.idx] = Sbar2[gidx(g2, nn, e, B, s.b)];
    }
  }
  // Upper slabs: level-L update, then level L+1 with slab L+1 (this
  // thread's own knot, just written) as the multiplier.
  const float* M2l = Fls.p[0];
  const float* M2x = Fxs.p[0];
  const float* M2u = Fus.p[0];
  for (int uu = 1; uu < U; ++uu) {
    if (s.live) {
      float f1[nn], f2[nn];
      load_group(f1, fsol1.p[uu], g1, B, s.b);
      load_group(f2, fsol2.p[uu - 1], g2, B, s.b);
      float* ol = Fls.p[uu];
      float* ox = Fxs.p[uu];
      float* ou = Fus.p[uu];
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float r2[n];
#pragma unroll
        for (int j = 0; j < n; ++j) r2[j] = M2l[(i * n + j) * s.plane + s.idx];
#pragma unroll
        for (int c = 0; c < n; ++c) {
          const int e = i * n + c;
          const size_t o = e * s.plane + s.idx;
          float v = ol[o];
          v = sep1 ? f1[e] : (keep1 ? v - dot_row<n>(ml, i, f1, c) : v);
          float acc2 = r2[0] * f2[c];
#pragma unroll
          for (int j = 1; j < n; ++j) acc2 += r2[j] * f2[j * n + c];
          ol[o] = sep2 ? f2[e] : (keep2 ? v - acc2 : v);
        }
      }
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float r2[n];
#pragma unroll
        for (int j = 0; j < n; ++j) r2[j] = M2x[(i * n + j) * s.plane + s.idx];
#pragma unroll
        for (int c = 0; c < n; ++c) {
          const int e = i * n + c;
          const size_t o = e * s.plane + s.idx;
          float acc2 = r2[0] * f2[c];
#pragma unroll
          for (int j = 1; j < n; ++j) acc2 += r2[j] * f2[j * n + c];
          const float v = (ox[o] - dot_row<n>(mx, i, f1, c)) - acc2;
          ox[o] = v;
          if (er) st.x[slot][e][t] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < m; ++i) {
        float r2[n];
#pragma unroll
        for (int j = 0; j < n; ++j) r2[j] = M2u[(i * n + j) * s.plane + s.idx];
#pragma unroll
        for (int c = 0; c < n; ++c) {
          const int e = i * n + c;
          const size_t o = e * s.plane + s.idx;
          float acc2 = r2[0] * f2[c];
#pragma unroll
          for (int j = 1; j < n; ++j) acc2 += r2[j] * f2[j * n + c];
          const float v = (ou[o] - dot_row<n>(mu, i, f1, c)) - acc2;
          ou[o] = v;
          if (er) st.u[slot][e][t] = v;
        }
      }
    }
    if (emit) {
      __syncthreads();
      if (er1)
        emit_products<n, m>(st, slot, Asep3, Bsep3, Sout.p[uu - 1],
                            Fls.p[uu], Fxs.p[uu], uu == 1, k >> (level + 3),
                            B, s);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// B3: leaf factors + level-0 update of every level's slab.
// ---------------------------------------------------------------------------

// Level-L leaf values at knot k (ndlqr_SolveLeaf, nested_dissection.c:
// 10-105; level(k) = trailing zeros of k+1, binary_tree.c:65-73):
//   fx = own ? Q^-1 A' : 0  - (prev ? Q^-1 : 0),  fu = ownu ? R^-1 B' : 0.
template <int n, int m>
__device__ __forceinline__ void leaf_values(const float* a, const float* bm,
                                            const float* qi, const float* ri,
                                            int L, int k, int N, float* fx,
                                            float* fu) {
  const int mask = (2 << L) - 1;
  const bool own = ((k + 1) & mask) == (1 << L) && k >= 1 && k < N - 1;
  const bool prev = (k & mask) == (1 << L);
  const bool ownu = own || (L == 0 && k == 0);
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float v = own ? a[j * n + i] * qi[i] : 0.0f;
      if (i == j) v -= prev ? qi[i] : 0.0f;
      fx[i * n + j] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) fu[i * n + j] = ownu ? bm[j * m + i] * ri[i] : 0.0f;
  }
}

template <int n, int m>
__global__ void leaf_kernel(const float* __restrict__ A,
                            const float* __restrict__ Bm,
                            const float* __restrict__ qinv,
                            const float* __restrict__ rinv,
                            const float* __restrict__ S0, CPtrs fsol,
                            const float* __restrict__ Asep,
                            const float* __restrict__ Bsep, Ptrs Fls, Ptrs Fxs,
                            Ptrs Fus, Ptrs Sout, int depth, int N, int B) {
  constexpr int nn = n * n, mn = m * n;
  __shared__ Stage<n, m> st;
  const Site s = site(N, B);
  const int k = s.k;
  const bool keep = k == 0;             // level-0 calc_lambda
  const bool sep = (k & 1) == 1;        // level-0 sep+1 rows
  const int g = k >> 1;
  const int pos = k & 3;                // level-1 separator rows 1 and 2
  const bool er = s.live && pos == 1;
  const bool er1 = s.live && pos == 2;
  const int slot = threadIdx.y >> 1;
  float a[nn], bm[n * m], qi[n], ri[m];
  float fl0[nn], fx0[nn], fu0[mn];
  if (s.live) {
    load_planes(a, A, s);
    load_planes(bm, Bm, s);
    load_planes(qi, qinv, s);
    load_planes(ri, rinv, s);
    leaf_values<n, m>(a, bm, qi, ri, 0, k, N, fx0, fu0);
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) fl0[i * n + j] = k == 0 ? -a[j * n + i] : 0.0f;
    }
    // Slab 0: leaf values, with level 0's own Sbar at its sep+1 rows.
#pragma unroll
    for (int e = 0; e < nn; ++e) {
      Fls.p[0][e * s.plane + s.idx] = sep ? S0[gidx(g, nn, e, B, s.b)] : fl0[e];
      Fxs.p[0][e * s.plane + s.idx] = fx0[e];
    }
#pragma unroll
    for (int e = 0; e < mn; ++e) Fus.p[0][e * s.plane + s.idx] = fu0[e];
  }
  for (int u = 1; u < depth; ++u) {
    if (s.live) {
      float f[nn], fx[nn], fu[mn];
      load_group(f, fsol.p[u - 1], g, B, s.b);
      leaf_values<n, m>(a, bm, qi, ri, u, k, N, fx, fu);
      float* ol = Fls.p[u];
      float* ox = Fxs.p[u];
      float* ou = Fus.p[u];
      // Upper lambda slabs start at zero.
#pragma unroll
      for (int e = 0; e < nn; ++e) ol[e * s.plane + s.idx] = 0.0f;
#pragma unroll
      for (int e = 0; e < nn; ++e) ox[e * s.plane + s.idx] = fx[e];
#pragma unroll
      for (int e = 0; e < mn; ++e) ou[e * s.plane + s.idx] = fu[e];
      update_trio<n, m>(fl0, fx0, fu0, f, keep, sep, ol, ox, ou, st, slot, er,
                        s);
    }
    __syncthreads();
    if (er1)
      emit_products<n, m>(st, slot, Asep, Bsep, Sout.p[u - 1], Fls.p[u],
                          Fxs.p[u], u == 1, k >> 2, B, s);
    __syncthreads();
  }
}

dim3 grid_for(int N, int B) {
  return dim3((B + TB - 1) / TB, (N + TK) / TK);  // knots -1 .. N-1
}

// Pointer lists arrive from the host as MAXU-entry arrays.
Ptrs ptrs(void* const* src) {
  Ptrs out;
  for (int i = 0; i < MAXU; ++i) out.p[i] = static_cast<float*>(src[i]);
  return out;
}

CPtrs cptrs(void* const* src) {
  CPtrs out;
  for (int i = 0; i < MAXU; ++i) out.p[i] = static_cast<const float*>(src[i]);
  return out;
}

}  // namespace

#define RSLQR_BLOCKS_OK(n, m) ((n) == 6 && (m) == 3)

extern "C" {

const char* rslqr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rslqr_rhs_update_level(const float* Fl, const float* Fx, const float* Fu,
                           float* zy, float* zx, float* zu, const float* zbar,
                           int N, int B, int level, int n, int m,
                           void* stream) {
  if (!RSLQR_BLOCKS_OK(n, m)) return static_cast<int>(cudaErrorInvalidValue);
  rhs_kernel<6, 3><<<grid_for(N, B), dim3(TB, TK), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      Fl, Fx, Fu, zy, zx, zu, zbar, N, B, level);
  return static_cast<int>(cudaGetLastError());
}

int rslqr_schur_update_level(const float* FLl, const float* FLx,
                             const float* FLu, void* const* Fls,
                             void* const* Fxs, void* const* Fus,
                             void* const* fsol, const float* Asep,
                             const float* Bsep, void* const* S, int U, int N,
                             int B, int level, int emit, int n, int m,
                             void* stream) {
  if (!RSLQR_BLOCKS_OK(n, m) || U < 0 || U > MAXU)
    return static_cast<int>(cudaErrorInvalidValue);
  level_kernel<6, 3><<<grid_for(N, B), dim3(TB, TK), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs),
      ptrs(Fus), cptrs(fsol), Asep, Bsep,
      ptrs(S), U, N, B, level, emit);
  return static_cast<int>(cudaGetLastError());
}

int rslqr_schur_update_pair(const float* FLl, const float* FLx,
                            const float* FLu, void* const* Fls,
                            void* const* Fxs, void* const* Fus,
                            void* const* fsol1, const float* Sbar2,
                            void* const* fsol2, const float* Asep3,
                            const float* Bsep3, void* const* S, int U, int N,
                            int B, int level, int emit, int n, int m,
                            void* stream) {
  if (!RSLQR_BLOCKS_OK(n, m) || U < 1 || U > MAXU)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_kernel<6, 3><<<grid_for(N, B), dim3(TB, TK), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs),
      ptrs(Fus), cptrs(fsol1), Sbar2,
      cptrs(fsol2), Asep3, Bsep3, ptrs(S), U, N,
      B, level, emit);
  return static_cast<int>(cudaGetLastError());
}

int rslqr_leaf_schur_level0(const float* A, const float* Bm,
                            const float* qinv, const float* rinv,
                            const float* S0, void* const* fsol,
                            const float* Asep, const float* Bsep,
                            void* const* Fls, void* const* Fxs,
                            void* const* Fus, void* const* S, int depth, int N,
                            int B, int n, int m, void* stream) {
  if (!RSLQR_BLOCKS_OK(n, m) || depth < 2 || depth > MAXU)
    return static_cast<int>(cudaErrorInvalidValue);
  leaf_kernel<6, 3><<<grid_for(N, B), dim3(TB, TK), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep,
      ptrs(Fls), ptrs(Fxs),
      ptrs(Fus), ptrs(S), depth, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
