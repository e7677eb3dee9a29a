// K8: the SOS-dual tensor operator's adjoint and the duplicate-copy
// projections on the expanded pair basis (layout as in symdual_apply.cu:
// n~ = 2 + q + q^2, o = 2 + q; every original column has two copies).
//
// Three modes, each its own entry point and one launch:
//   adjoint    replaces ops/symdual.py _adjoint_tensor (SymDualOp.adjoint)
//              of the JAX package: W[u, v] = the class value of the entry
//              (u, v), chosen by index coincidence from the per-degree
//              tensors (y0, y1, Y2, Y3, Y4) exactly as the JAX where-chain
//              does.  Fused epilogue: the degree-d value times scale[d]
//              (the (AA')^-1 scaling, SymDualOp.scale_idAAt) and
//              + c1 * B1 + c2 * B2 (the residual adjoint(y) - S - Xm/sigma
//              of the dual cost in one pass).
//   sym_factor replaces _symmetrize_jit (SymDualOp.symmetrize): each column
//              of a (p, n~) factor averaged with its duplicate partner
//              column, then (renorm) divided by its norm.
//   sym_mat    replaces SymDualOp.symmetrize_mat: each entry of an
//              (n~, n~) matrix averaged over its 4-element copy orbit
//              {u, pi(u)} x {v, pi(v)} in the JAX order (columns first,
//              then rows).
// The partner pi: 0 <-> 1, 2 + a <-> o + a q + a, o + i q + j <-> o + j q + i.
//
// adjoint's row-block mode replaces parallel/symdual_sharded.py
// adjoint_sharded (ShardedSymDualOp.adjoint): Y4 is a block of ql rows
// (q/D, q, q, q) at row offset i0, y0 .. Y3 whole; the output is ``top``,
// the rows u < o (replicated), and the block's Q rows (i, j), i0 <= i <
// i0 + ql, as (ql q, n~) rows.  A block a row as in the full mode, o + ql q
// blocks in all; a Q row reads its Y4 run at i - i0.  No communication.
//
// What bounds it on an H100: bytes.  At q = 60 (n~ = 3,662) adjoint writes
// 107 MB and reads Y4 (104 MB) in f64, 63 us at 3.35 TB/s; with both
// bases it reads 214 MB more.  sym_mat reads and writes 107 MB each.
//
// The design:
//   adjoint: a block per row u.  On a Q row (i, j) with i != j (96.6 % of
//     the entries at q = 60) the Q block of the row is Y4[i, j, :, :], a
//     contiguous q^2 run, except where k = l or {k, l} meets {i, j} (5q - 6
//     fix-up entries).  The block stages the run (with B1's and B2's, and
//     the fix-ups' class slots) in shared memory by one batch of cp.async,
//     16-byte copies between ragged ends, so a whole row's bytes are in
//     flight at once (in chunks where they pass 48 KB: the f64 residual);
//     then writes the row in 16-byte vectors (its start aligned by a short
//     head), a fix-up lane taking its staged slot, so a don't-care slot
//     staged with the run never enters the arithmetic.  Rows u < o, the q
//     rows with i = j, the border columns v < o and the head and tail of a
//     row take the where-chain entry by entry, the border while the run is
//     in flight.  (k, l) is walked with a counter; the divisions by q that
//     remain are one multiply-high (DivQ).
//   sym_mat: a block per orbit {u, pi u} of rows, both rows staged in
//     shared memory by coalesced reads (the Q block's grid rows padded to
//     q + 1, so the partner reads, q apart, fall on distinct banks), the
//     two output rows written in order; past 227 KB of shared memory (q >
//     118 in f64), orbit tiles.
//   sym_factor (and sym_mat's large-q path): the columns are cut into
//     pi-closed tiles (OrbitTiles): a T x T tile of the Q grid with its
//     mirror tile, a diagonal tile without its diagonal, or a chunk of the
//     border orbits {0, 1}, {2 + a, o + a (q + 1)}, staged in shared memory
//     in memory order, each orbit formed once.  sym_factor: a block per
//     column tile of T = 4 (16 orbits; 124 blocks at q = 60), all p rows
//     staged at once (in chunks past 384 f64 / 768 f32 rows), one thread
//     per orbit running the norm's chain.
//
// Bits: equal to the one-thread-an-entry kernels before this design, whose
// SASS shows nvcc's contractions, written here as explicit operations:
//   adjoint    v = v * scale[d];  v = fma(B1, c1, v);  v = fma(B2, c2, v)
//   sym_mat    (u, v) = 0.5 * fma(s_u, 0.5, 0.5 * s_pu), s_r = M[r, v] +
//              M[r, pi v] (a sum is the same from either column, and row
//              pi u's value is the same formula with the sums swapped)
//   sym_factor a_r = 0.5 * (Y[r, v] + Y[r, pi v]), s = fma(a_r, a_r, s) over
//              r = 0 .. p - 1 in order, out = a_r / max(sqrt(s), 1e-30)

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "oblique_tile.cuh"

namespace {

constexpr int kThreads = 256;
// DivQ is exact for t q < 2^32; t < q^2 keeps that up to q = 1625
constexpr int kMaxQ = 1625;

// t / q for 0 <= t < 2^32 / q by one multiply-high, m = ceil(2^32 / q)
struct DivQ {
  uint64_t m;
  __device__ __forceinline__ int operator()(int t) const {
    return (int)(((uint64_t)(uint32_t)t * m) >> 32);
  }
};

inline DivQ make_div(int q) {
  return DivQ{((uint64_t{1} << 32) + (uint64_t)q - 1) / (uint64_t)q};
}

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}
template <>
__device__ __forceinline__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ double add_rn<double>(double a, double b) {
  return __dadd_rn(a, b);
}
template <>
__device__ __forceinline__ float add_rn<float>(float a, float b) {
  return __fadd_rn(a, b);
}

// the per-degree tensors; the where-chain below picks an entry's address,
// so a caller can issue the loads of several entries together
template <typename T>
struct Tensors {
  const T* y0;
  const T* y1;
  const T* Y2;
  const T* Y3;
  const T* Y4;
  int q;
  int i0;  // the first row of Y4 given (0 but in the row-block mode)
  __device__ __forceinline__ const T* at0() const { return y0; }
  __device__ __forceinline__ const T* at1(int a) const { return y1 + a; }
  __device__ __forceinline__ const T* at2(int a, int b) const {
    return Y2 + ((int64_t)a * q + b);
  }
  __device__ __forceinline__ const T* at3(int a, int b, int c) const {
    return Y3 + (((int64_t)a * q + b) * q + c);
  }
  __device__ __forceinline__ const T* at4(int i, int j, int k, int l) const {
    return Y4 + ((((int64_t)(i - i0) * q + j) * q + k) * q + l);
  }
};

// class slot and degree of an (x_b, Q-slot (i, j)) pair: H_w[b, i, j]
template <typename T>
__device__ __forceinline__ const T* lq(const Tensors<T>& Y, int b, int i,
                                       int j, int* deg) {
  if (i == j) {
    if (b == i) { *deg = 0; return Y.at0(); }
    *deg = 2; return Y.at2(b, i);
  }
  if (b == i) { *deg = 1; return Y.at1(j); }
  if (b == j) { *deg = 1; return Y.at1(i); }
  *deg = 3; return Y.at3(b, i, j);
}

// class slot and degree of a (Q-slot (i, j), Q-slot (k, l)) pair: T_w
template <typename T>
__device__ __forceinline__ const T* qq(const Tensors<T>& Y, int i, int j,
                                       int k, int l, int* deg) {
  const bool fd = i == j, sd = k == l;
  if (fd && sd) {
    if (i == k) { *deg = 0; return Y.at0(); }
    *deg = 2; return Y.at2(i, k);
  }
  if (fd) {
    if (i == k) { *deg = 1; return Y.at1(l); }
    if (i == l) { *deg = 1; return Y.at1(k); }
    *deg = 3; return Y.at3(i, k, l);
  }
  if (sd) {
    if (k == i) { *deg = 1; return Y.at1(j); }
    if (k == j) { *deg = 1; return Y.at1(i); }
    *deg = 3; return Y.at3(i, j, k);
  }
  if ((i == k && j == l) || (i == l && j == k)) { *deg = 0; return Y.at0(); }
  if (i == k) { *deg = 2; return Y.at2(j, l); }
  if (i == l) { *deg = 2; return Y.at2(j, k); }
  if (j == k) { *deg = 2; return Y.at2(i, l); }
  if (j == l) { *deg = 2; return Y.at2(i, k); }
  *deg = 4; return Y.at4(i, j, k, l);
}

// the (const / x_a) side of a pair with a Q-slot: E_w[i, j]
template <typename T>
__device__ __forceinline__ const T* cq(const Tensors<T>& Y, int i, int j,
                                       int* deg) {
  if (i == j) { *deg = 1; return Y.at1(i); }
  *deg = 2; return Y.at2(i, j);
}

// the class slot and degree of entry (u, v)
template <typename T>
__device__ __forceinline__ const T* entry(const Tensors<T>& Y, DivQ dq,
                                          int u, int v, int* deg) {
  const int q = Y.q, o = 2 + q;
  if (u < 2) {
    if (v < 2) { *deg = 0; return Y.at0(); }
    if (v < o) { *deg = 1; return Y.at1(v - 2); }
    const int k = dq(v - o);
    return cq(Y, k, v - o - k * q, deg);
  }
  if (u < o) {
    const int a = u - 2;
    if (v < 2) { *deg = 1; return Y.at1(a); }
    if (v < o) {
      if (a == v - 2) { *deg = 0; return Y.at0(); }
      *deg = 2; return Y.at2(a, v - 2);
    }
    const int k = dq(v - o);
    return lq(Y, a, k, v - o - k * q, deg);
  }
  const int i = dq(u - o), j = u - o - i * q;
  if (v < 2) return cq(Y, i, j, deg);
  if (v < o) return lq(Y, v - 2, i, j, deg);
  const int k = dq(v - o);
  return qq(Y, i, j, k, v - o - k * q, deg);
}

template <typename T>
struct AdjointArgs {
  Tensors<T> Y;
  DivQ dq;
  int n;
  const T* scale;
  const T* B1;
  T c1;
  const T* B2;
  T c2;
  T* out;        // row u < o at out + u n~
  T* outq;       // Q row u at outq + (u - o - i0 q) n~ (out + o n~ in full)
  int cv;        // output vectors of a Q row staged at once (0: none)
};

template <typename T>
__device__ __forceinline__ T* out_row(const AdjointArgs<T>& A, int u) {
  const int o = 2 + A.Y.q;
  return u < o ? A.out + (int64_t)u * A.n
               : A.outq + (int64_t)(u - o - A.Y.i0 * A.Y.q) * A.n;
}

// the epilogue, in the order (and with the contractions) of the
// one-thread-an-entry kernel; sc is scale[deg].  S (a scale) and HB (B1
// or B2 given) are template flags, which of B1 / B2 is a uniform branch.
template <typename T, bool S, bool HB>
__device__ __forceinline__ T epilogue(const AdjointArgs<T>& A, T v, T sc,
                                      T b1, T b2) {
  if (S) v = mul_rn(v, sc);
  if (HB && A.B1 != nullptr) v = fma_t(b1, A.c1, v);
  if (HB && A.B2 != nullptr) v = fma_t(b2, A.c2, v);
  return v;
}

// one entry of the output (at dst; at flat offset at of B1 / B2) from its
// class slot
template <typename T, bool S, bool HB>
__device__ __forceinline__ void store_entry(const AdjointArgs<T>& A, T* dst,
                                            int64_t at, const T* slot,
                                            int deg) {
  const T b1 = HB && A.B1 != nullptr ? A.B1[at] : T(0);
  const T b2 = HB && A.B2 != nullptr ? A.B2[at] : T(0);
  *dst = epilogue<T, S, HB>(A, *slot, S ? A.scale[deg] : T(1), b1, b2);
}

// entry() out of line, so the rare where-chain path does not set the
// kernel's register count
template <typename T>
struct Slot {
  const T* at;
  int deg;
};

template <typename T>
__device__ __noinline__ Slot<T> entry_slot(const Tensors<T> Y, DivQ dq,
                                           int u, int v) {
  Slot<T> s;
  s.at = entry(Y, dq, u, v, &s.deg);
  return s;
}

// columns [v0, v1) of row u by the where-chain
template <typename T, bool S, bool HB>
__device__ __forceinline__ void chain_cols(const AdjointArgs<T>& A, int u,
                                           int v0, int v1) {
  const int64_t row = (int64_t)u * A.n;
  T* orow = out_row(A, u);
  for (int v = v0 + (int)threadIdx.x; v < v1; v += kThreads) {
    const Slot<T> slot = entry_slot(A.Y, A.dq, u, v);
    store_entry<T, S, HB>(A, orow + v, row + v, slot.at, slot.deg);
  }
}

// 16-byte vectors
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void st16(T* p, const T (&r)[kVec<T>]) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <typename T>
__device__ __forceinline__ int phase(const T* p) {
  return (int)(((uintptr_t)p % 16) / sizeof(T));
}

// Stage g[0 .. cnt) into shared s[ph .. ph + cnt), ph = g's phase within
// 16 bytes (s is 16-byte aligned): 16-byte copies between the ragged ends.
template <typename T>
__device__ __forceinline__ void stage_run(T* s, const T* g, int cnt) {
  constexpr int N = kVec<T>;
  const int ph = phase(g);
  const int head = min((N - ph) % N, cnt), nvec = (cnt - head) / N;
  for (int x = threadIdx.x; x < head; x += kThreads)
    cp_async_elem(s + ph + x, g + x);
  for (int v = threadIdx.x; v < nvec; v += kThreads)
    cp_async16(s + ph + head + v * N, g + head + v * N);
  for (int x = head + nvec * N + threadIdx.x; x < cnt; x += kThreads)
    cp_async_elem(s + ph + x, g + x);
}

// The 5q - 6 fix-up entries (k, l) of Q row (i, j), i != j, numbered e:
// the grid rows k = i (e = l) and k = j (e = q + l), then for every other k
// in order (r-th, skipping i and j) l = k, i, j (e = 2q + 3r + 0, 1, 2).
__device__ __forceinline__ bool is_fix(int i, int j, int k, int l) {
  return k == i || k == j || l == k || l == i || l == j;
}

__device__ __forceinline__ void fix_entry(int q, int i, int j, int e, int* k,
                                          int* l) {
  if (e < 2 * q) {
    *k = e < q ? i : j;
    *l = e < q ? e : e - q;
    return;
  }
  const int r = (e - 2 * q) / 3, c = e - 2 * q - 3 * r;
  *k = r + (r >= min(i, j));
  *k += *k >= max(i, j);
  *l = c == 0 ? *k : c == 1 ? i : j;
}

__device__ __forceinline__ int fix_index(int q, int i, int j, int k, int l) {
  if (k == i) return l;
  if (k == j) return q + l;
  const int r = k - (k > min(i, j)) - (k > max(i, j));
  return 2 * q + 3 * r + (l == k ? 0 : l == i ? 1 : 2);
}

// The Q block of row (i, j), i != j, from its head h on (d0 its offset in
// B1 / B2, od its output): nv vectors of N
// entries, cv at a time.  Each chunk of Y4's run (and of B1 / B2) and the
// chunk's fix-up slots are staged in shared memory by one batch of
// cp.async, so a whole chunk's bytes are in flight at once; then each
// thread writes output vectors from it, a fix-up lane taking its staged
// slot (so a don't-care slot staged with the run never enters the
// arithmetic).  ``edges`` (the border and head columns) runs while the
// first chunk is in flight.
template <typename T, bool S, bool HB, class Edges>
__device__ __forceinline__ void bulk_q(const AdjointArgs<T>& A, int i, int j,
                                       int64_t d0, T* od, int h, int nv,
                                       Edges edges) {
  constexpr int N = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = A.Y.q, cv = A.cv;
  const bool h1 = HB && A.B1 != nullptr, h2 = HB && A.B2 != nullptr;
  T* run = reinterpret_cast<T*>(smem_raw);
  T* b1s = run + (cv + 1) * N;
  T* b2s = b1s + (h1 ? (cv + 1) * N : 0);
  T* fixv = b2s + (h2 ? (cv + 1) * N : 0);
  const T* y4 = A.Y.Y4 + ((int64_t)(i - A.Y.i0) * q + j) * q * q;
  const T s4 = S ? A.scale[4] : T(1);
  for (int w0 = 0; w0 < nv; w0 += cv) {
    const int w1 = min(nv, w0 + cv);
    const int t0 = h + w0 * N, t1 = h + w1 * N;
    stage_run(run, y4 + t0, t1 - t0);
    if (h1) stage_run(b1s, A.B1 + d0 + t0, t1 - t0);
    if (h2) stage_run(b2s, A.B2 + d0 + t0, t1 - t0);
    for (int e = threadIdx.x; e < 5 * q - 6; e += kThreads) {
      int k, l, deg;
      fix_entry(q, i, j, e, &k, &l);
      if (k * q + l >= t0 && k * q + l < t1)
        cp_async_elem(fixv + e, qq(A.Y, i, j, k, l, &deg));
    }
    if (w0 == 0) edges();
    cp_async_wait_all();
    __syncthreads();
    const int ph = phase(y4 + t0);
    for (int w = w0 + threadIdx.x; w < w1; w += kThreads) {
      const int t = h + w * N, at = t - t0;
      int k = A.dq(t), l = t - k * q;
      T o[N];
#pragma unroll
      for (int x = 0; x < N; ++x) {
        T val = run[ph + at + x], sc = s4;
        if (is_fix(i, j, k, l)) {
          int deg;
          qq(A.Y, i, j, k, l, &deg);
          val = fixv[fix_index(q, i, j, k, l)];
          if (S) sc = A.scale[deg];
        }
        o[x] = epilogue<T, S, HB>(A, val, sc, h1 ? b1s[at + x] : T(0),
                                  h2 ? b2s[at + x] : T(0));
        if (++l == q) { l = 0; ++k; }
      }
      st16(od + t, o);
    }
    __syncthreads();
  }
}

template <typename T, bool S, bool HB>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(AdjointArgs<T> A) {
  constexpr int N = kVec<T>;
  const int q = A.Y.q, o = 2 + q, n = A.n;
  // the block's row: the rows u < o, then the Q rows from row i0
  const int u = (int)blockIdx.x < o ? (int)blockIdx.x
                                    : (int)blockIdx.x + A.Y.i0 * q;
  const int i = u < o ? -1 : A.dq(u - o), j = u < o ? -1 : u - o - i * q;
  const int64_t d0 = (int64_t)u * n + o;
  T* od = out_row(A, u) + o;
  // the head that aligns the output to 16 bytes; B1 / B2 must then be
  // aligned too, else the row takes the where-chain throughout
  const int h = min((N - phase(od)) % N, q * q);
  if (i == j || A.cv == 0 ||            // u < o, or a Q row with i = j
      (HB && ((A.B1 != nullptr && phase(A.B1 + d0) != phase(od)) ||
              (A.B2 != nullptr && phase(A.B2 + d0) != phase(od))))) {
    chain_cols<T, S, HB>(A, u, 0, n);
    return;
  }
  const int nv = (q * q - h) / N;
  bulk_q<T, S, HB>(A, i, j, d0, od, h, nv,
                   [&] { chain_cols<T, S, HB>(A, u, 0, o + h); });
  chain_cols<T, S, HB>(A, u, o + h + nv * N, n);
}

// ---- orbit tiles -------------------------------------------------------
//
// The n~ columns cut into tiles closed under pi.  For a side T, with
// nt = ceil(q / T) bands of the Q grid: first the pairs of bands KB < LB,
// the (KB, LB) tile with its (LB, KB) mirror (orbits (k, l) ~ (l, k)); then
// the nt diagonal tiles (KB, KB) without their diagonal (orbits k < l); then
// chunks of T^2 border orbits e = 0 .. q: {0, 1}, then {2 + a, o + a q + a}
// for e = a + 1.  A tile lists its slots (columns) in memory order.
struct OrbitTiles {
  int q, T, nt, npair, nborder;
  __host__ __device__ int count() const { return npair + nt + nborder; }
};

inline OrbitTiles make_tiles(int q, int T) {
  const int nt = (q + T - 1) / T;
  return OrbitTiles{q, T, nt, nt * (nt - 1) / 2, (q + T * T) / (T * T)};
}

// Fill tile ``tile``'s slots: col[s] the column of slot s, orb[s] its orbit,
// sa[c] / sb[c] the slots of orbit c's two columns.  All threads of the
// block take part; *ns slots, *nc orbits (the same in every thread).
__device__ void tile_fill(const OrbitTiles& ts, int tile, int* col, int* orb,
                          int* sa, int* sb, int* ns, int* nc) {
  const int q = ts.q, T = ts.T, o = 2 + q;
  if (tile < ts.npair) {
    int kb = 0, rem = tile;
    while (rem >= ts.nt - 1 - kb) {
      rem -= ts.nt - 1 - kb;
      ++kb;
    }
    const int lb = kb + 1 + rem;
    const int tk = min(T, q - kb * T), tl = min(T, q - lb * T);
    const int k0 = kb * T, l0 = lb * T;
    *nc = tk * tl;
    *ns = 2 * tk * tl;
    for (int s = threadIdx.x; s < *ns; s += blockDim.x) {
      int c;
      if (s < tk * tl) {
        const int kr = s / tl, lr = s - kr * tl;
        c = s;
        col[s] = o + (k0 + kr) * q + l0 + lr;
        sa[c] = s;
      } else {
        const int lr = (s - tk * tl) / tk, kr = s - tk * tl - lr * tk;
        c = kr * tl + lr;
        col[s] = o + (l0 + lr) * q + k0 + kr;
        sb[c] = s;
      }
      orb[s] = c;
    }
  } else if (tile < ts.npair + ts.nt) {
    const int kb = tile - ts.npair, k0 = kb * T;
    const int t = min(T, q - k0);
    *ns = t * (t - 1);
    *nc = *ns / 2;
    for (int s = threadIdx.x; s < *ns; s += blockDim.x) {
      const int kr = s / (t - 1), x = s - kr * (t - 1);
      const int lr = x < kr ? x : x + 1;
      const int a = min(kr, lr), b = max(kr, lr);
      const int c = a * (t - 1) - a * (a - 1) / 2 + b - a - 1;
      col[s] = o + (k0 + kr) * q + k0 + lr;
      if (kr < lr) sa[c] = s; else sb[c] = s;
      orb[s] = c;
    }
  } else {
    const int e0 = (tile - ts.npair - ts.nt) * T * T;
    *nc = min(T * T, q + 1 - e0);
    *ns = 2 * *nc;
    for (int s = threadIdx.x; s < *ns; s += blockDim.x) {
      const int c = s < *nc ? s : s - *nc, e = e0 + c;
      if (s < *nc) {
        col[s] = e == 0 ? 0 : 1 + e;
        sa[c] = s;
      } else {
        col[s] = e == 0 ? 1 : o + (e - 1) * (q + 1);
        sb[c] = s;
      }
      orb[s] = c;
    }
  }
}

// ---- sym_factor ----------------------------------------------------------

constexpr int kFT = 4;                     // column tile side: 16 orbits
constexpr int kFS = 2 * kFT * kFT;         // slots a tile (a staged row)
constexpr size_t kFBudget = 96 * 1024;     // staged rows' shared memory

template <typename T>
__device__ __forceinline__ void factor_stage(const T* __restrict__ Y, int n,
                                             int r0, int rc, int ns,
                                             const int* col, T* sm) {
  for (int idx = threadIdx.x; idx < rc * kFS; idx += kThreads) {
    const int r = idx / kFS, s = idx % kFS;
    if (s < ns) cp_async_elem(sm + idx, Y + (int64_t)(r0 + r) * n + col[s]);
  }
  cp_async_wait_all();
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T half_sum(const T* row, int a, int b) {
  return mul_rn(T(0.5), add_rn(row[a], row[b]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_factor_kernel(const T* __restrict__ Y, int p, int n, OrbitTiles ts,
                  int renorm, int R, T* __restrict__ out) {
  __shared__ int col[kFS], orb[kFS], sa[kFS / 2], sb[kFS / 2];
  __shared__ T scl[kFS / 2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  int ns, nc;
  tile_fill(ts, blockIdx.x, col, orb, sa, sb, &ns, &nc);
  __syncthreads();
  if (ns == 0) return;
  const int c = threadIdx.x;
  if (renorm) {
    T s = T(0);
    for (int r0 = 0; r0 < p; r0 += R) {
      const int rc = min(R, p - r0);
      factor_stage(Y, n, r0, rc, ns, col, sm);
      if (c < nc) {
        const int a = sa[c], b = sb[c];
        for (int r = 0; r < rc; ++r) {
          const T v = half_sum(sm + r * kFS, a, b);
          s = fma_t(v, v, s);
        }
      }
      __syncthreads();
    }
    if (c < nc) {
      const T nrm = tile_sqrt<T>(s);
      scl[c] = nrm > T(1e-30) ? nrm : T(1e-30);
    }
    __syncthreads();
  }
  // with every row staged at once the norm's staging serves the outputs
  const bool staged = renorm && R >= p;
  for (int r0 = 0; r0 < p; r0 += R) {
    const int rc = min(R, p - r0);
    if (!staged) factor_stage(Y, n, r0, rc, ns, col, sm);
    for (int idx = threadIdx.x; idx < rc * kFS; idx += kThreads) {
      const int r = idx / kFS, s = idx % kFS;
      if (s < ns) {
        const int e = orb[s];
        const T v = half_sum(sm + r * kFS, sa[e], sb[e]);
        out[(int64_t)(r0 + r) * n + col[s]] = renorm ? v / scl[e] : v;
      }
    }
    __syncthreads();
  }
}

// ---- sym_mat -------------------------------------------------------------

// Where a row pair fits in shared memory (2 (n~ + q) entries: q <= 118 in
// f64, q <= 168 in f32) a block takes an orbit {u, pi u} of rows (the one
// with u < pi u): both rows staged by coalesced reads, the Q block's grid
// rows padded to q + 1 entries so the partner reads, q apart, fall on
// distinct banks, every output of the two rows written in order from the
// pair's sums.  Past that, a block per (row tile of T = 4, column tile of
// T = 8): 32 rows by 128 columns staged, each orbit of rows times orbit of
// columns formed once from its four entries.
constexpr int kRT = 4, kCT = 8;            // row / column tile sides
constexpr int kRS = 2 * kRT * kRT;         // rows a block (32)
constexpr int kCS = 2 * kCT * kCT;         // columns a block (128)
constexpr size_t kPairBudget = 227 * 1024;

// the partner of index v, and where v sits in a padded staged row
__device__ __forceinline__ int partner(int v, int q, DivQ dq) {
  const int o = 2 + q;
  if (v < 2) return 1 - v;
  if (v < o) return o + (v - 2) * (q + 1);
  const int k = dq(v - o), l = v - o - k * q;
  return k == l ? 2 + k : o + l * q + k;
}

__device__ __forceinline__ int padded(int v, int q, DivQ dq) {
  return v < 2 + q ? v : v + dq(v - 2 - q);
}

// row u's value 0.5 fma(s_u, 0.5, 0.5 s_pu), s_r = M[r, v] + M[r, pi v]
template <typename T>
__device__ __forceinline__ T orbit_value(T su, T sp) {
  return mul_rn(T(0.5), fma_t(su, T(0.5), mul_rn(T(0.5), sp)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_mat_pair_kernel(const T* __restrict__ M, int n, int q, DivQ dq,
                    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);
  T* sp = su + n + q;
  const int u = blockIdx.x, pu = partner(u, q, dq);
  if (pu < u) return;
  const T* mu = M + (int64_t)u * n;
  const T* mp = M + (int64_t)pu * n;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int at = padded(v, q, dq);
    cp_async_elem(su + at, mu + v);
    cp_async_elem(sp + at, mp + v);
  }
  cp_async_wait_all();
  __syncthreads();
  T* ou = out + (int64_t)u * n;
  T* op = out + (int64_t)pu * n;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int a = padded(v, q, dq), b = padded(partner(v, q, dq), q, dq);
    const T s_u = add_rn(su[a], su[b]), s_p = add_rn(sp[a], sp[b]);
    ou[v] = orbit_value(s_u, s_p);
    op[v] = orbit_value(s_p, s_u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_mat_tile_kernel(const T* __restrict__ M, int n, OrbitTiles rt,
                    OrbitTiles ct, T* __restrict__ out) {
  __shared__ int row[kRS], rorb[kRS], ra[kRS / 2], rb[kRS / 2];
  __shared__ int col[kCS], corb[kCS], ca[kCS / 2], cb[kCS / 2];
  __shared__ T sm[kRS][kCS + 1];
  const int nct = ct.count();
  int nrs, nrc, ncs, ncc;
  tile_fill(rt, blockIdx.x / nct, row, rorb, ra, rb, &nrs, &nrc);
  tile_fill(ct, blockIdx.x % nct, col, corb, ca, cb, &ncs, &ncc);
  __syncthreads();
  if (nrs == 0 || ncs == 0) return;
  for (int idx = threadIdx.x; idx < nrs * kCS; idx += kThreads) {
    const int r = idx / kCS, s = idx % kCS;
    if (s < ncs)
      cp_async_elem(&sm[r][s], M + (int64_t)row[r] * n + col[s]);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrc * (kCS / 2); idx += kThreads) {
    const int er = idx / (kCS / 2), ec = idx % (kCS / 2);
    if (ec < ncc) {
      const int u = ra[er], pu = rb[er], v = ca[ec], pv = cb[ec];
      const T s_u = add_rn(sm[u][v], sm[u][pv]);
      const T s_p = add_rn(sm[pu][v], sm[pu][pv]);
      const T xu = orbit_value(s_u, s_p), xp = orbit_value(s_p, s_u);
      sm[u][v] = xu;
      sm[u][pv] = xu;
      sm[pu][v] = xp;
      sm[pu][pv] = xp;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrs * kCS; idx += kThreads) {
    const int r = idx / kCS, s = idx % kCS;
    if (s < ncs) out[(int64_t)row[r] * n + col[s]] = sm[r][s];
  }
}

// ---- launchers -----------------------------------------------------------

// a Q row's staging: Y4's run, B1's and B2's, cv vectors each (and one
// vector of phase), and the row's fix-up slots, in 48 KB
constexpr size_t kRowBudget = 48 * 1024;

template <typename T, bool S, bool HB>
int launch_adjoint_mode(const AdjointArgs<T>& A, int rows, size_t smem,
                        cudaStream_t stream) {
  auto kern = adjoint_kernel<T, S, HB>;
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kern<<<rows, kThreads, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

// i0, ql: the row-block mode's Y4 rows (i0 = 0, ql = q in the full mode),
// outq its Q rows' output (null: the full (n~, n~) output)
template <typename T>
int launch_adjoint(const void* y0, const void* y1, const void* Y2,
                   const void* Y3, const void* Y4, int q, const void* scale,
                   const void* B1, double c1, const void* B2, double c2,
                   void* out, int i0, int ql, void* outq, void* stream) {
  constexpr int N = kVec<T>;
  if (q <= 0) return (int)cudaSuccess;
  if (q > kMaxQ || i0 < 0 || ql < 0 || i0 + ql > q)
    return (int)cudaErrorInvalidValue;
  const int n = 2 + q + q * q;
  const int nbuf = 1 + (B1 != nullptr) + (B2 != nullptr);
  const long room = (long)(kRowBudget / sizeof(T)) - 5L * q;
  const int cv = (int)std::max(0L, std::min<long>(room / nbuf / N - 1,
                                                  ((long)q * q + N - 1) / N));
  const size_t smem =
      cv > 0 ? ((size_t)nbuf * (cv + 1) * N + 5 * q) * sizeof(T) : 0;
  T* qrows = outq != nullptr ? (T*)outq : (T*)out + (int64_t)(2 + q) * n;
  AdjointArgs<T> A{
      Tensors<T>{(const T*)y0, (const T*)y1, (const T*)Y2, (const T*)Y3,
                 (const T*)Y4, q, i0},
      make_div(q), n, (const T*)scale, (const T*)B1, (T)c1,
      (const T*)B2, (T)c2, (T*)out, qrows, cv};
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = 2 + q + ql * q;
  const bool hb = B1 != nullptr || B2 != nullptr;
  if (scale != nullptr)
    return hb ? launch_adjoint_mode<T, true, true>(A, rows, smem, s)
              : launch_adjoint_mode<T, true, false>(A, rows, smem, s);
  return hb ? launch_adjoint_mode<T, false, true>(A, rows, smem, s)
            : launch_adjoint_mode<T, false, false>(A, rows, smem, s);
}

template <typename T>
int launch_sym_factor(const void* Y, int p, int q, int renorm, void* out,
                      void* stream) {
  const int n = 2 + q + q * q;
  if (q <= 0 || p <= 0) return (int)cudaSuccess;
  const OrbitTiles ts = make_tiles(q, kFT);
  const int R = (int)std::min<size_t>(p, kFBudget / (kFS * sizeof(T)));
  const size_t smem = (size_t)R * kFS * sizeof(T);
  auto kern = sym_factor_kernel<T>;
  // past the 48 KB a launch gets without the attribute
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kern<<<ts.count(), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)Y, p, n, ts, renorm, R, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym_mat(const void* M, int q, void* out, void* stream) {
  const int n = 2 + q + q * q;
  if (q <= 0) return (int)cudaSuccess;
  if (q > kMaxQ) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)2 * (n + q) * sizeof(T);
  if (smem <= kPairBudget) {
    auto kern = sym_mat_pair_kernel<T>;
    static size_t allowed = 0;
    if (smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed = smem;
    }
    kern<<<n, kThreads, smem, s>>>((const T*)M, n, q, make_div(q), (T*)out);
  } else {
    const OrbitTiles rt = make_tiles(q, kRT), ct = make_tiles(q, kCT);
    sym_mat_tile_kernel<T><<<rt.count() * ct.count(), kThreads, 0, s>>>(
        (const T*)M, n, rt, ct, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symdual_adjoint_f64(const void* y0, const void* y1, const void* Y2,
                        const void* Y3, const void* Y4, int q,
                        const void* scale, const void* B1, double c1,
                        const void* B2, double c2, void* out, void* stream) {
  return launch_adjoint<double>(y0, y1, Y2, Y3, Y4, q, scale, B1, c1, B2, c2,
                                out, 0, q, nullptr, stream);
}

int symdual_adjoint_f32(const void* y0, const void* y1, const void* Y2,
                        const void* Y3, const void* Y4, int q,
                        const void* scale, const void* B1, double c1,
                        const void* B2, double c2, void* out, void* stream) {
  return launch_adjoint<float>(y0, y1, Y2, Y3, Y4, q, scale, B1, c1, B2, c2,
                               out, 0, q, nullptr, stream);
}

// the row-block mode: Y4l the (ql, q, q, q) rows from i0; top (2 + q, n~),
// rowsQ (ql q, n~)
int symdual_adjoint_rows_f64(const void* y0, const void* y1, const void* Y2,
                             const void* Y3, const void* Y4l, int q, int i0,
                             int ql, void* top, void* rowsQ, void* stream) {
  return launch_adjoint<double>(y0, y1, Y2, Y3, Y4l, q, nullptr, nullptr, 0.0,
                                nullptr, 0.0, top, i0, ql, rowsQ, stream);
}

int symdual_adjoint_rows_f32(const void* y0, const void* y1, const void* Y2,
                             const void* Y3, const void* Y4l, int q, int i0,
                             int ql, void* top, void* rowsQ, void* stream) {
  return launch_adjoint<float>(y0, y1, Y2, Y3, Y4l, q, nullptr, nullptr, 0.0,
                               nullptr, 0.0, top, i0, ql, rowsQ, stream);
}

int symdual_sym_factor_f64(const void* Y, int p, int q, int renorm, void* out,
                           void* stream) {
  return launch_sym_factor<double>(Y, p, q, renorm, out, stream);
}

int symdual_sym_factor_f32(const void* Y, int p, int q, int renorm, void* out,
                           void* stream) {
  return launch_sym_factor<float>(Y, p, q, renorm, out, stream);
}

int symdual_sym_mat_f64(const void* M, int q, void* out, void* stream) {
  return launch_sym_mat<double>(M, q, out, stream);
}

int symdual_sym_mat_f32(const void* M, int q, void* out, void* stream) {
  return launch_sym_mat<float>(M, q, out, stream);
}

}  // extern "C"
