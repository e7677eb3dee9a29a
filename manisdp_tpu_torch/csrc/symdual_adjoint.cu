// K8: the SOS-dual tensor operator's adjoint and the duplicate-copy
// projections on the expanded pair basis (layout as in symdual_apply.cu:
// n~ = 2 + q + q^2, o = 2 + q; every original column has two copies).
//
// Three modes, each its own entry point:
//   adjoint    replaces ops/symdual.py _adjoint_tensor (SymDualOp.adjoint)
//              of the JAX package: W[u, v] = the class value of the entry
//              (u, v), chosen by index coincidence from the per-degree
//              tensors (y0, y1, Y2, Y3, Y4) exactly as the JAX where-chain
//              does.  Fused epilogue: the degree-d value times scale[d]
//              (the (AA')^-1 scaling, SymDualOp.scale_idAAt) and
//              + c1 * B1 + c2 * B2 (the residual adjoint(y) - S - Xm/sigma
//              of the dual cost in one pass).  One thread per entry.
//   sym_factor replaces _symmetrize_jit (SymDualOp.symmetrize): each column
//              of a (p, n~) factor averaged with its duplicate partner
//              column, then (renorm) divided by its norm.  One thread per
//              column walks its p rows twice, like K2.
//   sym_mat    replaces SymDualOp.symmetrize_mat: each entry of an
//              (n~, n~) matrix averaged over its 4-element copy orbit
//              {u, pi(u)} x {v, pi(v)} in the JAX order (columns first,
//              then rows).  One thread per entry.
// The partner pi: 0 <-> 1, 2 + a <-> o + a q + a, o + i q + j <-> o + j q + i.
//
// What bounds it on an H100: bytes.  At q = 60 (n~ = 3,662) adjoint writes
// 107 MB and reads Y4 (104 MB) in f64, 63 us at 3.35 TB/s; with both
// bases it reads 214 MB more.  sym_mat reads and writes 107 MB each.
// Threads of a warp take neighbouring v, so the writes and the reads of
// B1 / B2 / Y4[i,j,k,l] along l are coalesced; the partner reads of
// sym_mat (M[u, pi(v)]) stride by q.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Tensors {
  const T* y0;
  const T* y1;
  const T* Y2;
  const T* Y3;
  const T* Y4;
  int q;
  __device__ __forceinline__ T v1(int a) const { return y1[a]; }
  __device__ __forceinline__ T v2(int a, int b) const {
    return Y2[(int64_t)a * q + b];
  }
  __device__ __forceinline__ T v3(int a, int b, int c) const {
    return Y3[((int64_t)a * q + b) * q + c];
  }
  __device__ __forceinline__ T v4(int i, int j, int k, int l) const {
    return Y4[(((int64_t)i * q + j) * q + k) * q + l];
  }
};

// class value and degree of an (x_b, Q-slot (i, j)) pair: H_w[b, i, j]
template <typename T>
__device__ __forceinline__ T lq(const Tensors<T>& Y, int b, int i, int j,
                                int* deg) {
  if (i == j) {
    if (b == i) { *deg = 0; return Y.y0[0]; }
    *deg = 2; return Y.v2(b, i);
  }
  if (b == i) { *deg = 1; return Y.v1(j); }
  if (b == j) { *deg = 1; return Y.v1(i); }
  *deg = 3; return Y.v3(b, i, j);
}

// class value and degree of a (Q-slot (i, j), Q-slot (k, l)) pair: T_w
template <typename T>
__device__ __forceinline__ T qq(const Tensors<T>& Y, int i, int j, int k,
                                int l, int* deg) {
  const bool fd = i == j, sd = k == l;
  if (fd && sd) {
    if (i == k) { *deg = 0; return Y.y0[0]; }
    *deg = 2; return Y.v2(i, k);
  }
  if (fd) {
    if (i == k) { *deg = 1; return Y.v1(l); }
    if (i == l) { *deg = 1; return Y.v1(k); }
    *deg = 3; return Y.v3(i, k, l);
  }
  if (sd) {
    if (k == i) { *deg = 1; return Y.v1(j); }
    if (k == j) { *deg = 1; return Y.v1(i); }
    *deg = 3; return Y.v3(i, j, k);
  }
  if ((i == k && j == l) || (i == l && j == k)) { *deg = 0; return Y.y0[0]; }
  if (i == k) { *deg = 2; return Y.v2(j, l); }
  if (i == l) { *deg = 2; return Y.v2(j, k); }
  if (j == k) { *deg = 2; return Y.v2(i, l); }
  if (j == l) { *deg = 2; return Y.v2(i, k); }
  *deg = 4; return Y.v4(i, j, k, l);
}

// the (const / x_a) side of a pair with a Q-slot: E_w[i, j]
template <typename T>
__device__ __forceinline__ T cq(const Tensors<T>& Y, int i, int j, int* deg) {
  if (i == j) { *deg = 1; return Y.v1(i); }
  *deg = 2; return Y.v2(i, j);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(Tensors<T> Y, int n, const T* __restrict__ scale,
               const T* __restrict__ B1, T c1, const T* __restrict__ B2, T c2,
               T* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int u = blockIdx.y;
  if (v >= n) return;
  const int q = Y.q, o = 2 + q;
  int deg;
  T val;
  if (u < 2) {
    if (v < 2) { deg = 0; val = Y.y0[0]; }
    else if (v < o) { deg = 1; val = Y.v1(v - 2); }
    else val = cq(Y, (v - o) / q, (v - o) % q, &deg);
  } else if (u < o) {
    const int a = u - 2;
    if (v < 2) { deg = 1; val = Y.v1(a); }
    else if (v < o) {
      const int b = v - 2;
      if (a == b) { deg = 0; val = Y.y0[0]; }
      else { deg = 2; val = Y.v2(a, b); }
    } else val = lq(Y, a, (v - o) / q, (v - o) % q, &deg);
  } else {
    const int i = (u - o) / q, j = (u - o) % q;
    if (v < 2) val = cq(Y, i, j, &deg);
    else if (v < o) val = lq(Y, v - 2, i, j, &deg);
    else val = qq(Y, i, j, (v - o) / q, (v - o) % q, &deg);
  }
  if (scale != nullptr) val = val * scale[deg];
  const int64_t at = (int64_t)u * n + v;
  if (B1 != nullptr) val = val + c1 * B1[at];
  if (B2 != nullptr) val = val + c2 * B2[at];
  out[at] = val;
}

__device__ __forceinline__ int partner(int v, int q) {
  const int o = 2 + q;
  if (v < 2) return 1 - v;
  if (v < o) return o + (v - 2) * (q + 1);
  const int i = (v - o) / q, j = (v - o) % q;
  return i == j ? 2 + i : o + j * q + i;
}

template <typename T>
__device__ __forceinline__ T sqrt_t(T v);
template <>
__device__ __forceinline__ double sqrt_t<double>(double v) { return sqrt(v); }
template <>
__device__ __forceinline__ float sqrt_t<float>(float v) { return sqrtf(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_factor_kernel(const T* __restrict__ Y, int p, int n, int q, int renorm,
                  T* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int w = partner(v, q);
  T scale = T(1);
  if (renorm) {
    T s = T(0);
    for (int r = 0; r < p; ++r) {
      const T a = T(0.5) * (Y[(int64_t)r * n + v] + Y[(int64_t)r * n + w]);
      s += a * a;
    }
    const T nrm = sqrt_t<T>(s);
    scale = nrm > T(1e-30) ? nrm : T(1e-30);
  }
  for (int r = 0; r < p; ++r) {
    const T a = T(0.5) * (Y[(int64_t)r * n + v] + Y[(int64_t)r * n + w]);
    out[(int64_t)r * n + v] = renorm ? a / scale : a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_mat_kernel(const T* __restrict__ M, int n, int q, T* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int u = blockIdx.y;
  if (v >= n) return;
  const int pu = partner(u, q), pv = partner(v, q);
  const T a = T(0.5) * (M[(int64_t)u * n + v] + M[(int64_t)u * n + pv]);
  const T b = T(0.5) * (M[(int64_t)pu * n + v] + M[(int64_t)pu * n + pv]);
  out[(int64_t)u * n + v] = T(0.5) * (a + b);
}

template <typename T>
int launch_adjoint(const void* y0, const void* y1, const void* Y2,
                   const void* Y3, const void* Y4, int q, const void* scale,
                   const void* B1, double c1, const void* B2, double c2,
                   void* out, void* stream) {
  const int n = 2 + q + q * q;
  if (q <= 0) return (int)cudaSuccess;
  Tensors<T> Y{(const T*)y0, (const T*)y1, (const T*)Y2, (const T*)Y3,
               (const T*)Y4, q};
  const dim3 grid((n + kThreads - 1) / kThreads, n);
  adjoint_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Y, n, (const T*)scale, (const T*)B1, (T)c1, (const T*)B2, (T)c2,
      (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym_factor(const void* Y, int p, int q, int renorm, void* out,
                      void* stream) {
  const int n = 2 + q + q * q;
  if (q <= 0 || p <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads);
  sym_factor_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)Y, p, n, q, renorm, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sym_mat(const void* M, int q, void* out, void* stream) {
  const int n = 2 + q + q * q;
  if (q <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, n);
  sym_mat_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)M, n, q, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symdual_adjoint_f64(const void* y0, const void* y1, const void* Y2,
                        const void* Y3, const void* Y4, int q,
                        const void* scale, const void* B1, double c1,
                        const void* B2, double c2, void* out, void* stream) {
  return launch_adjoint<double>(y0, y1, Y2, Y3, Y4, q, scale, B1, c1, B2, c2,
                                out, stream);
}

int symdual_adjoint_f32(const void* y0, const void* y1, const void* Y2,
                        const void* Y3, const void* Y4, int q,
                        const void* scale, const void* B1, double c1,
                        const void* B2, double c2, void* out, void* stream) {
  return launch_adjoint<float>(y0, y1, Y2, Y3, Y4, q, scale, B1, c1, B2, c2,
                               out, stream);
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
