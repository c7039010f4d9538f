// Hand-written Hopper kernels for the flat-plane rsLQR sweep.
//
// Three kernels, one per TPU kernel of rslqr_tpu/ops/schur_planes.py:
//   flat_level_kernel <- schur_update_level_flat (one tree level, every upper
//                        slab)
//   flat_leaf_kernel  <- leaf_schur_level0_flat  (leaf factors + level 0)
//   flat_rhs_kernel   <- rhs_update_level_flat   (one level of the RHS sweep)
//
// Layout: the JAX kernels' flat planes [e, N*B/128, 128] are the bytes of
// element-major [e, N, B] planes (element e of knot k, batch column b at
// e*N*B + k*B + b), which is how these kernels index them. What differs from
// schur_kernels.cu (the [nn, N, B] suite, B1-B4) is the schedule: compact
// solved separators and emitted products are element-major [e, G, B] (there
// group-major [G, e, B]), products are emitted at levels 0 and 1 only, and
// there is no level pairing. float32 only; block sizes n, m are template
// parameters (instantiated for n=6, m=3).
//
// Mapping: one thread per (knot, batch column). A block is TB=32 batch
// columns (one warp, so every slab load and store is a coalesced 128-byte
// line) by KPT knots, KPT = the JAX tile's knots per tile (_kpt_for: 4 at
// level 0, 8 above, at most N). Blocks start at multiples of KPT, so at an
// emitting level (2 * span == KPT) a block holds exactly one next-level
// group, its separator row r = span - 1 and the row r + 1 after it.
//
// Every slab element is written once. The row-r thread stages its new x/u
// blocks in shared memory; the row-(r+1) thread stages its new lambda/x
// blocks and holds back its lambda store. After a __syncthreads() the
// row-(r+1) thread forms S = A_sep @ x[r] + B_sep @ u[r] - x[r+1] - l[r+1]
// (ndlqr_FactorInnerProduct, nested_dissection.c:114-134), writes S and
// stores its lambda row: S on the next level's own slab (the Sbar fold,
// ref solve.c:92-97), else the staged value.
//
// Bound: bandwidth. Per knot and batch column and upper level a kernel reads
// and writes about 90 floats of slab against ~6 FMAs per slab element (about
// 0.4 FLOP per byte, far below the H100's ~20 FLOP/byte f32 balance). The
// design streams each slab once with coalesced lines, keeps the level-L
// multiplier blocks in registers for every upper level, and emits the
// products from the values just computed. Each launcher returns
// cudaGetLastError() right after the launch. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (rslqr_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAXU = 24;  // upper slabs per launch (matches ops/schur.py)
constexpr int TB = 32;    // batch columns per block

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

// Block (x: strip of TB batch columns, y: tile of blockDim.y knots).
__device__ __forceinline__ Site site(int N, int B) {
  Site s;
  s.b = blockIdx.x * TB + threadIdx.x;
  s.k = blockIdx.y * blockDim.y + threadIdx.y;
  s.live = s.b < B && s.k < N;
  s.plane = (size_t)N * B;
  s.idx = s.live ? (size_t)s.k * B + s.b : 0;
  return s;
}

// Element e of group g of an element-major compact [E, G, B] array.
__device__ __forceinline__ size_t cidx(int e, int g, int G, int B, int b) {
  return ((size_t)e * G + g) * B + b;
}

template <int E>
__device__ __forceinline__ void load_planes(float (&r)[E], const float* src,
                                            const Site& s) {
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = src[e * s.plane + s.idx];
}

template <int E>
__device__ __forceinline__ void load_compact(float (&r)[E], const float* src,
                                             int g, int G, int B, int b) {
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = src[cidx(e, g, G, B, b)];
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

// Shared-memory staging of one next-level group's rows r (x, u) and r+1
// (lambda, x), per batch column of the block.
template <int n, int m>
struct Stage {
  float xr[n * n][TB];
  float ur[m * n][TB];
  float lr1[n * n][TB];
  float xr1[n * n][TB];
};

enum Role { kPlain = 0, kSepRow = 1, kAfterSep = 2 };

// One level's update of one upper slab trio at this thread's knot, from the
// trio's current values (in_l/in_x/in_u: element -> value), written once:
//   l = sep ? f : (keep ? l - ML@f : l);  x -= MX@f;  u -= MU@f.
// kSepRow stages its new x/u; kAfterSep stages its new lambda/x and leaves
// its lambda store to emit_products.
template <int n, int m, class InL, class InX, class InU>
__device__ __forceinline__ void update_trio(
    const float* ml, const float* mx, const float* mu, const float* f,
    bool keep, bool sep, InL in_l, InX in_x, InU in_u, float* ol, float* ox,
    float* ou, Stage<n, m>& st, int role, const Site& s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const float l = in_l(e);
      const float v = sep ? f[e] : (keep ? l - dot_row<n>(ml, i, f, c) : l);
      if (role == kAfterSep)
        st.lr1[e][t] = v;
      else
        ol[e * s.plane + s.idx] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const float v = in_x(e) - dot_row<n>(mx, i, f, c);
      ox[e * s.plane + s.idx] = v;
      if (role == kSepRow) st.xr[e][t] = v;
      if (role == kAfterSep) st.xr1[e][t] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      const float v = in_u(e) - dot_row<n>(mu, i, f, c);
      ou[e * s.plane + s.idx] = v;
      if (role == kSepRow) st.ur[e][t] = v;
    }
  }
}

// The row-(r+1) thread's product emission and lambda store (see header):
// S into group g2 of the compact [nn, G2, B] output, and its lambda row as
// S (``fold``) or as the staged updated value.
template <int n, int m>
__device__ void emit_products(const Stage<n, m>& st,
                              const float* __restrict__ Asep,
                              const float* __restrict__ Bsep, float* Sout,
                              float* ol, bool fold, int g2, int G2, int B,
                              const Site& s) {
  constexpr int nn = n * n;
  float a[nn], bm[n * m];
  load_compact(a, Asep, g2, G2, B, s.b);
  load_compact(bm, Bsep, g2, G2, B, s.b);
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const int e = i * n + c;
      float acc = a[i * n] * st.xr[c][t];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += a[i * n + j] * st.xr[j * n + c][t];
#pragma unroll
      for (int j = 0; j < m; ++j) acc += bm[i * m + j] * st.ur[j * n + c][t];
      acc = acc - st.xr1[e][t] - st.lr1[e][t];
      Sout[cidx(e, g2, G2, B, s.b)] = acc;
      ol[e * s.plane + s.idx] = fold ? acc : st.lr1[e][t];
    }
  }
}

// Role of this thread's knot when level-``level`` products are emitted.
__device__ __forceinline__ int role_of(bool emit, const Site& s, int level) {
  if (!emit || !s.live) return kPlain;
  const int span = 2 << level, pos = s.k & (2 * span - 1);
  return pos == span - 1 ? kSepRow : (pos == span ? kAfterSep : kPlain);
}

// ---------------------------------------------------------------------------
// B12: RHS sweep, one level.
// ---------------------------------------------------------------------------
template <int n, int m>
__global__ void flat_rhs_kernel(const float* __restrict__ Fl,
                                const float* __restrict__ Fx,
                                const float* __restrict__ Fu, float* zy,
                                float* zx, float* zu,
                                const float* __restrict__ zbar, int N, int B,
                                int level) {
  const Site s = site(N, B);
  if (!s.live) return;
  const int k = s.k, half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  float zb[n];
  load_compact(zb, zbar, k >> (level + 1), N >> (level + 1), B, s.b);
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
// B10: one level's Schur update of every upper slab.
// ---------------------------------------------------------------------------
template <int n, int m>
__global__ void flat_level_kernel(const float* __restrict__ FLl,
                                  const float* __restrict__ FLx,
                                  const float* __restrict__ FLu, Ptrs Fls,
                                  Ptrs Fxs, Ptrs Fus, CPtrs fsol,
                                  const float* __restrict__ Asep,
                                  const float* __restrict__ Bsep, Ptrs Sout,
                                  int U, int N, int B, int level, int emit) {
  constexpr int nn = n * n, mn = m * n;
  __shared__ Stage<n, m> st;
  const Site s = site(N, B);
  const int k = s.k, half = 1 << level;
  const bool keep = (k & (half - 1)) != 0 || k == 0;
  const bool sep = (k & (2 * half - 1)) == half;
  const int g = k >> (level + 1), G = N >> (level + 1);
  const int role = role_of(emit, s, level);
  float ml[nn], mx[nn], mu[mn];
  if (s.live) {
    load_planes(ml, FLl, s);
    load_planes(mx, FLx, s);
    load_planes(mu, FLu, s);
  }
  for (int u = 0; u < U; ++u) {
    if (s.live) {
      float f[nn];
      load_compact(f, fsol.p[u], g, G, B, s.b);
      float* ol = Fls.p[u];
      float* ox = Fxs.p[u];
      float* ou = Fus.p[u];
      update_trio<n, m>(
          ml, mx, mu, f, keep, sep,
          [&](int e) { return ol[e * s.plane + s.idx]; },
          [&](int e) { return ox[e * s.plane + s.idx]; },
          [&](int e) { return ou[e * s.plane + s.idx]; }, ol, ox, ou, st,
          role, s);
    }
    if (emit) {
      __syncthreads();
      if (role == kAfterSep)
        emit_products<n, m>(st, Asep, Bsep, Sout.p[u], Fls.p[u], u == 0,
                            k >> (level + 2), N >> (level + 2), B, s);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// B11: leaf factors + level-0 update of every level's slab.
// ---------------------------------------------------------------------------

// Level-L leaf values at knot k (ndlqr_SolveLeaf, nested_dissection.c:
// 10-105; level(k) = trailing zeros of k+1, binary_tree.c:65-73), element
// e = (i, j):  fx = own ? Q^-1 A' : 0  - (prev ? Q^-1 : 0),
//              fu = ownu ? R^-1 B' : 0.
struct LeafMask {
  bool own, prev, ownu;
};

__device__ __forceinline__ LeafMask leaf_mask(int L, int k, int N) {
  const int mask = (2 << L) - 1;
  LeafMask lm;
  lm.own = ((k + 1) & mask) == (1 << L) && k >= 1 && k < N - 1;
  lm.prev = (k & mask) == (1 << L);
  lm.ownu = lm.own || (L == 0 && k == 0);
  return lm;
}

template <int n>
__device__ __forceinline__ float leaf_x(const float* a, const float* qi,
                                        LeafMask lm, int e) {
  const int i = e / n, j = e % n;
  float v = lm.own ? a[j * n + i] * qi[i] : 0.0f;
  if (i == j) v -= lm.prev ? qi[i] : 0.0f;
  return v;
}

template <int n, int m>
__device__ __forceinline__ float leaf_u(const float* bm, const float* ri,
                                        LeafMask lm, int e) {
  const int i = e / n, j = e % n;
  return lm.ownu ? bm[j * m + i] * ri[i] : 0.0f;
}

template <int n, int m>
__global__ void flat_leaf_kernel(const float* __restrict__ A,
                                 const float* __restrict__ Bm,
                                 const float* __restrict__ qinv,
                                 const float* __restrict__ rinv,
                                 const float* __restrict__ S0, CPtrs fsol,
                                 const float* __restrict__ Asep,
                                 const float* __restrict__ Bsep, Ptrs Fls,
                                 Ptrs Fxs, Ptrs Fus, Ptrs Sout, int depth,
                                 int N, int B) {
  constexpr int nn = n * n, mn = m * n;
  __shared__ Stage<n, m> st;
  const Site s = site(N, B);
  const int k = s.k;
  const bool keep = k == 0;       // level-0 calc_lambda
  const bool sep = (k & 1) == 1;  // level-0 sep+1 rows
  const int g = k >> 1, G0 = N >> 1;
  const int role = role_of(true, s, 0);
  float a[nn], bm[n * m], qi[n], ri[m];
  float fl0[nn], fx0[nn], fu0[mn];
  if (s.live) {
    load_planes(a, A, s);
    load_planes(bm, Bm, s);
    load_planes(qi, qinv, s);
    load_planes(ri, rinv, s);
    const LeafMask lm0 = leaf_mask(0, k, N);
#pragma unroll
    for (int e = 0; e < nn; ++e) {
      fx0[e] = leaf_x<n>(a, qi, lm0, e);
      fl0[e] = k == 0 ? -a[(e % n) * n + e / n] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < mn; ++e) fu0[e] = leaf_u<n, m>(bm, ri, lm0, e);
    // Slab 0: leaf values, with level 0's own Sbar at its sep+1 rows.
#pragma unroll
    for (int e = 0; e < nn; ++e) {
      Fls.p[0][e * s.plane + s.idx] = sep ? S0[cidx(e, g, G0, B, s.b)] : fl0[e];
      Fxs.p[0][e * s.plane + s.idx] = fx0[e];
    }
#pragma unroll
    for (int e = 0; e < mn; ++e) Fus.p[0][e * s.plane + s.idx] = fu0[e];
  }
  for (int u = 1; u < depth; ++u) {
    if (s.live) {
      float f[nn];
      load_compact(f, fsol.p[u - 1], g, G0, B, s.b);
      const LeafMask lm = leaf_mask(u, k, N);
      // Upper lambda slabs start at zero; x/u at the level-u leaf values.
      update_trio<n, m>(
          fl0, fx0, fu0, f, keep, sep, [](int) { return 0.0f; },
          [&](int e) { return leaf_x<n>(a, qi, lm, e); },
          [&](int e) { return leaf_u<n, m>(bm, ri, lm, e); }, Fls.p[u],
          Fxs.p[u], Fus.p[u], st, role, s);
    }
    __syncthreads();
    if (role == kAfterSep)
      emit_products<n, m>(st, Asep, Bsep, Sout.p[u - 1], Fls.p[u], u == 1,
                          k >> 2, N >> 2, B, s);
    __syncthreads();
  }
}

// Knots per block: schur_planes._kpt_for.
int kpt_for(int level, int N) {
  const int span = 1 << (level + 1);
  int kpt = 2 * span > 4 ? 2 * span : 4;
  kpt = kpt < 8 ? kpt : 8;
  return kpt < N ? kpt : N;
}

dim3 grid_for(int N, int B, int kpt) {
  return dim3((B + TB - 1) / TB, (N + kpt - 1) / kpt);
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

#define RSLQR_FLAT_BLOCKS_OK(n, m) ((n) == 6 && (m) == 3)

extern "C" {

int rslqr_flat_rhs_update_level(const float* Fl, const float* Fx,
                                const float* Fu, float* zy, float* zx,
                                float* zu, const float* zbar, int N, int B,
                                int level, int n, int m, void* stream) {
  if (!RSLQR_FLAT_BLOCKS_OK(n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int kpt = kpt_for(level, N);
  flat_rhs_kernel<6, 3><<<grid_for(N, B, kpt), dim3(TB, kpt), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Fl, Fx, Fu, zy, zx, zu, zbar, N, B, level);
  return static_cast<int>(cudaGetLastError());
}

int rslqr_flat_schur_update_level(const float* FLl, const float* FLx,
                                  const float* FLu, void* const* Fls,
                                  void* const* Fxs, void* const* Fus,
                                  void* const* fsol, const float* Asep,
                                  const float* Bsep, void* const* S, int U,
                                  int N, int B, int level, int emit, int n,
                                  int m, void* stream) {
  const int kpt = kpt_for(level, N);
  // Emission needs one whole next-level group per block.
  if (!RSLQR_FLAT_BLOCKS_OK(n, m) || U < 0 || U > MAXU ||
      (emit && kpt != (2 << (level + 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  flat_level_kernel<6, 3><<<grid_for(N, B, kpt), dim3(TB, kpt), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      FLl, FLx, FLu, ptrs(Fls), ptrs(Fxs), ptrs(Fus), cptrs(fsol), Asep, Bsep,
      ptrs(S), U, N, B, level, emit);
  return static_cast<int>(cudaGetLastError());
}

int rslqr_flat_leaf_schur_level0(const float* A, const float* Bm,
                                 const float* qinv, const float* rinv,
                                 const float* S0, void* const* fsol,
                                 const float* Asep, const float* Bsep,
                                 void* const* Fls, void* const* Fxs,
                                 void* const* Fus, void* const* S, int depth,
                                 int N, int B, int n, int m, void* stream) {
  const int kpt = kpt_for(0, N);
  if (!RSLQR_FLAT_BLOCKS_OK(n, m) || depth < 2 || depth > MAXU || kpt != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  flat_leaf_kernel<6, 3><<<grid_for(N, B, kpt), dim3(TB, kpt), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      A, Bm, qinv, rinv, S0, cptrs(fsol), Asep, Bsep, ptrs(Fls), ptrs(Fxs),
      ptrs(Fus), ptrs(S), depth, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
