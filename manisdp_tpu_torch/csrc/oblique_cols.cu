// K2: column operations of the oblique manifold on a (p, n) factor.
//
// Replaces manifolds/oblique.py Oblique.proj / tangent / transp / retr /
// renormalize of the JAX package (each a per-column reduction over the
// p rows followed by an elementwise pass):
//   mode 0 proj        : out = u - x o colsum(x o u)
//                        [- v o g]   (v (p, n), g (n,) given: the oblique
//                        Hessian epilogue eH - Y o colsum(Y o eH) - U o YeG
//                        of solvers/dual_al.py:123-124)
//   mode 1 retr        : out = (x + u) / ||x + u||_col
//   mode 2 renormalize : out = x / ||x||_col
// Masked mode (a 0/1 column mask given; replaces manifolds/product.py
// MaskedProduct.proj / retr / renormalize, the multiblock drivers'
// product geometry, and their masked Hessian epilogue
// eH - Y o (colsum(Y o eH) o mask) - U o YeG, solvers/multiblock.py:59-63,
// dual_multiblock.py:71-75): a column with mask 0 skips the projection
// (its colsum is multiplied by 0) and the normalization (divided by 1),
// as the JAX expressions do.  Without a mask every mode computes exactly
// what it did before.
// Instance mode (nb > 1; the batched MaxCut driver's (B, p, n) factor,
// replacing the jax.vmap of these ops in solvers/batch.py:78-87):
// blockIdx.y is the instance, x, u, v and out advance by p * n per
// instance and g by n; the mask, when given, is shared.
// Zero padding rows stay zero.  A zero column gives 0/0 = NaN, exactly
// as the JAX expressions do.
//
// Layout: x, u, out are contiguous row-major (p, n).  One thread owns one
// column and walks down its p rows twice (reduce, then write), so the 32
// lanes of a warp read 32 neighbouring columns of one row: every load and
// store is coalesced along n.  The second walk re-reads the column from
// L1/L2.
//
// What bounds it on an H100: bytes.  At n = 10^4, p_pad = 48 in f64 a
// call reads 2 * 3.8 MB and writes 3.8 MB, about 3.5 us at 3.35 TB/s (less
// from L2), so like K1 it is near the ~5 us launch latency at this size;
// fusing it into the tCG vector step is later work.  n / 256 blocks
// (40 at n = 10^4) leave most SMs idle; splitting the p walk across warps
// with a shared-memory reduction is the next step if it shows in a trace.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T sqrt_t(T v);
template <>
__device__ __forceinline__ double sqrt_t<double>(double v) { return sqrt(v); }
template <>
__device__ __forceinline__ float sqrt_t<float>(float v) { return sqrtf(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
oblique_cols_kernel(const T* __restrict__ x, const T* __restrict__ u,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const T* __restrict__ mask, int p, int n, int mode,
                    T* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t inst = blockIdx.y, at = inst * p * n;
  x += at;
  out += at;
  if (u != nullptr) u += at;
  if (v != nullptr) v += at;
  if (g != nullptr) g += inst * n;
  // masked mode: a column with mask 0 is Euclidean
  const bool skip = mask != nullptr && !(mask[j] > T(0));
  T s = T(0);
  if (mode == 0) {
    for (int r = 0; r < p; ++r) {
      const int64_t o = (int64_t)r * n + j;
      s += x[o] * u[o];
    }
    if (mask != nullptr) s = s * mask[j];
    if (v != nullptr) {
      const T gj = g[j];
      for (int r = 0; r < p; ++r) {
        const int64_t o = (int64_t)r * n + j;
        out[o] = (u[o] - x[o] * s) - v[o] * gj;
      }
    } else {
      for (int r = 0; r < p; ++r) {
        const int64_t o = (int64_t)r * n + j;
        out[o] = u[o] - x[o] * s;
      }
    }
  } else if (mode == 1) {
    for (int r = 0; r < p; ++r) {
      const int64_t o = (int64_t)r * n + j;
      const T d = x[o] + u[o];
      s += d * d;
    }
    const T nrm = skip ? T(1) : sqrt_t<T>(s);
    for (int r = 0; r < p; ++r) {
      const int64_t o = (int64_t)r * n + j;
      out[o] = (x[o] + u[o]) / nrm;
    }
  } else {
    for (int r = 0; r < p; ++r) {
      const T xv = x[(int64_t)r * n + j];
      s += xv * xv;
    }
    const T nrm = skip ? T(1) : sqrt_t<T>(s);
    for (int r = 0; r < p; ++r) {
      const int64_t o = (int64_t)r * n + j;
      out[o] = x[o] / nrm;
    }
  }
}

template <typename T>
int launch(const void* x, const void* u, const void* v, const void* g,
           const void* mask, int p, int n, int nb, int mode, void* out,
           void* stream) {
  if (n <= 0 || p <= 0 || nb <= 0) return (int)cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, nb);
  oblique_cols_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)u, (const T*)v, (const T*)g, (const T*)mask, p,
      n, mode, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int oblique_cols_f64(const void* x, const void* u, const void* v,
                     const void* g, const void* mask, int p, int n, int nb,
                     int mode, void* out, void* stream) {
  return launch<double>(x, u, v, g, mask, p, n, nb, mode, out, stream);
}

int oblique_cols_f32(const void* x, const void* u, const void* v,
                     const void* g, const void* mask, int p, int n, int nb,
                     int mode, void* out, void* stream) {
  return launch<float>(x, u, v, g, mask, p, n, nb, mode, out, stream);
}

}  // extern "C"
