// K11: the vector step of truncated CG (Steihaug-Toint), one scalar set
// per instance.
//
// Replaces the body of the inner lax.while_loop of the JAX package's
// core/trustregions.py _make_tcg (:102-160), and its jax.vmap over the
// instance axis in solvers/batch.py:78.  Around one Hessian-vector
// product Hd = H[d] an iteration needs <d, Hd>, <d, r>, the step length
// (alpha, or the exact boundary root tau), the masked updates of eta,
// H eta, r and the model value, ||r_new||^2, beta and the next
// direction r_new + beta d, which the caller re-projects onto the
// tangent space (M.tangent, kernel K2 on the oblique manifold).
//
// Three launches per iteration, each over the B instances (blockIdx.y)
// and nblk blocks per instance (blockIdx.x), every block walking its
// instance's L = p * n entries with a fixed grid stride:
//   dots   : partial <d, Hd>, <d, r> per block -> part (B, nblk, 2)
//   update : every block sums its instance's partials in a fixed order,
//            evaluates the scalar logic of the reference (alpha, e_Pe,
//            boundary, tau, step, model value, stop codes 1 / 2 / 6),
//            updates eta, Heta (unless the model increased: stop 6 keeps
//            the previous iterate) and r <- r - alpha Hd in place, and
//            writes partial ||r||^2 -> part2 (B, nblk); block 0 writes
//            the instance's step scalars -> xs (B, 4)
//   finish : sums part2 the same way, sets stop codes 3 / 4 (kappa /
//            theta target), beta, e_Pd, d_Pd, and d <- r + beta d in
//            place; block 0 writes the next scalar state (sc_next,
//            st_next), so no block reads a scalar another block writes
//            in the same launch.
// Scalar state sc (B, 8): e_Pe, e_Pd, d_Pd, z_r (= <r, r>), model value,
// Delta^2, kappa target, linear (1: stop code 3 on the target, 0: 4);
// st (B, 2) int32: completed iterations j and the stop code (0 = active).
// An instance whose stop code is not 0 is left untouched: its iteration
// is a no-op, as in the vmapped while_loop.
//
// No float atomics: a block's partial is a warp-shuffle tree and then a
// sum of the warp totals in warp order, and the partials are summed in
// block order, so the result depends only on (L, nblk), which the
// wrapper derives from L.  Every block of an instance computes the same
// scalars from the same partials.
//
// What bounds it on an H100: bytes.  Per iteration the three passes read
// d, Hd, r (dots), d, Hd, eta, Heta, r and write eta, Heta, r (update),
// read r, d and write d (finish): 14 vectors of L entries, against 9 for
// one read of each input (d, Hd, r, eta, Heta) and one write of each
// output (eta, Heta, r, d).  At G67 (L = 4 * 10^5, f64) that is 45 MB,
// about 13 us at 3.35 TB/s; much of it hits the 50 MB L2.
// Fusing the three passes needs a grid-wide barrier (a cooperative
// launch) and is later work; so is a CUDA graph over a chunk of
// iterations, since at these sizes each launch costs about as much as
// its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T sqrt_t(T v);
template <>
__device__ __forceinline__ double sqrt_t<double>(double v) { return sqrt(v); }
template <>
__device__ __forceinline__ float sqrt_t<float>(float v) { return sqrtf(v); }

// Sum of v over the block in a fixed order; every thread gets the total.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // sh may still be read from a previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  T s = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w];
  return s;
}

// Sum of the instance's nblk partials (stride `stride`) in a fixed order.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* __restrict__ part, int nblk,
                                       int stride, T* sh) {
  T v = T(0);
  for (int k = threadIdx.x; k < nblk; k += kThreads) v += part[k * stride];
  return block_sum(v, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tcg_dots_kernel(const T* __restrict__ d, const T* __restrict__ Hd,
                const T* __restrict__ r, const int* __restrict__ st,
                int64_t L, int nblk, T* __restrict__ part) {
  __shared__ T sh[kWarps];
  const int b = blockIdx.y, blk = blockIdx.x;
  T* out = part + ((int64_t)b * nblk + blk) * 2;
  if (st[2 * b + 1] != 0) {
    if (threadIdx.x == 0) out[0] = out[1] = T(0);
    return;  // the whole block leaves together
  }
  const int64_t base = (int64_t)b * L;
  T a1 = T(0), a2 = T(0);
  for (int64_t e = (int64_t)blk * kThreads + threadIdx.x; e < L;
       e += (int64_t)nblk * kThreads) {
    const T dv = d[base + e];
    a1 += dv * Hd[base + e];
    a2 += dv * r[base + e];
  }
  a1 = block_sum(a1, sh);
  a2 = block_sum(a2, sh);
  if (threadIdx.x == 0) {
    out[0] = a1;
    out[1] = a2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tcg_update_kernel(const T* __restrict__ part, const T* __restrict__ sc,
                  const int* __restrict__ st, const T* __restrict__ d,
                  const T* __restrict__ Hd, T* __restrict__ eta,
                  T* __restrict__ Heta, T* __restrict__ r, int64_t L,
                  int nblk, T* __restrict__ part2, T* __restrict__ xs) {
  __shared__ T sh[kWarps];
  const int b = blockIdx.y, blk = blockIdx.x;
  if (st[2 * b + 1] != 0) {
    if (threadIdx.x == 0) part2[(int64_t)b * nblk + blk] = T(0);
    return;
  }
  const T* pb = part + (int64_t)b * nblk * 2;
  const T d_Hd = sum_parts(pb, nblk, 2, sh);
  const T d_r = sum_parts(pb + 1, nblk, 2, sh);
  const T* s = sc + 8 * b;
  const T e_Pe = s[0], e_Pd = s[1], d_Pd = s[2], z_r = s[3], mv = s[4],
          DD = s[5];
  const T alpha = z_r / d_Hd;
  const T e_Pe_new = e_Pe + T(2) * alpha * e_Pd + alpha * alpha * d_Pd;
  const bool boundary = (d_Hd <= T(0)) || (e_Pe_new >= DD);
  // exact boundary solve (tCG.m:188); not read unless boundary
  const T tau = (-e_Pd + sqrt_t<T>(e_Pd * e_Pd + d_Pd * (DD - e_Pe))) / d_Pd;
  const T step = boundary ? tau : alpha;
  // incremental model value m(eta - t d) = m(eta) - t<d, r> + t^2/2 <d, Hd>
  const T new_mv = mv - step * d_r + T(0.5) * step * step * d_Hd;
  const bool keep = !boundary && (new_mv >= mv);  // model increase
  const int stop_n = boundary ? (d_Hd <= T(0) ? 1 : 2) : (keep ? 6 : 0);

  const int64_t base = (int64_t)b * L;
  T acc = T(0);
  for (int64_t e = (int64_t)blk * kThreads + threadIdx.x; e < L;
       e += (int64_t)nblk * kThreads) {
    const int64_t o = base + e;
    const T hv = Hd[o];
    if (!keep) {
      const T dv = d[o];
      eta[o] = eta[o] - step * dv;
      Heta[o] = Heta[o] - step * hv;
    }
    const T rn = r[o] - alpha * hv;
    r[o] = rn;
    acc += rn * rn;
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    part2[(int64_t)b * nblk + blk] = acc;
    if (blk == 0) {
      T* x = xs + 4 * b;
      x[0] = alpha;
      x[1] = boundary ? e_Pe : e_Pe_new;
      x[2] = keep ? mv : new_mv;
      x[3] = T(stop_n);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tcg_finish_kernel(const T* __restrict__ part2, const T* __restrict__ sc,
                  const int* __restrict__ st, const T* __restrict__ xs,
                  const T* __restrict__ r, T* __restrict__ d, int64_t L,
                  int nblk, int mininner, T* __restrict__ sc_next,
                  int* __restrict__ st_next) {
  __shared__ T sh[kWarps];
  const int b = blockIdx.y, blk = blockIdx.x;
  const T* s = sc + 8 * b;
  const bool lead = blk == 0 && threadIdx.x == 0;
  if (st[2 * b + 1] != 0) {
    if (lead) {
      for (int k = 0; k < 8; ++k) sc_next[8 * b + k] = s[k];
      st_next[2 * b] = st[2 * b];
      st_next[2 * b + 1] = st[2 * b + 1];
    }
    return;
  }
  const T r_r = sum_parts(part2 + (int64_t)b * nblk, nblk, 1, sh);
  const T* x = xs + 4 * b;
  const T alpha = x[0];
  const int j = st[2 * b];
  int stop = (int)x[3];
  if (stop == 0 && j + 1 >= mininner && sqrt_t<T>(r_r) <= s[6])
    stop = s[7] > T(0) ? 3 : 4;
  const T beta = r_r / s[3];

  const int64_t base = (int64_t)b * L;
  for (int64_t e = (int64_t)blk * kThreads + threadIdx.x; e < L;
       e += (int64_t)nblk * kThreads) {
    const int64_t o = base + e;
    d[o] = r[o] + beta * d[o];
  }
  if (lead) {
    T* n = sc_next + 8 * b;
    n[0] = x[1];
    n[1] = beta * (s[1] + alpha * s[2]);
    n[2] = r_r + beta * beta * s[2];
    n[3] = r_r;
    n[4] = x[2];
    n[5] = s[5];
    n[6] = s[6];
    n[7] = s[7];
    st_next[2 * b] = j + 1;
    st_next[2 * b + 1] = stop;
  }
}

template <typename T>
int launch_dots(const void* d, const void* Hd, const void* r, const void* st,
                int64_t L, int nb, int nblk, void* part, void* stream) {
  if (nb <= 0 || nblk <= 0) return (int)cudaSuccess;
  tcg_dots_kernel<T><<<dim3(nblk, nb), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)d, (const T*)Hd, (const T*)r, (const int*)st, L, nblk,
      (T*)part);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(const void* part, const void* sc, const void* st,
                  const void* d, const void* Hd, void* eta, void* Heta,
                  void* r, int64_t L, int nb, int nblk, void* part2,
                  void* xs, void* stream) {
  if (nb <= 0 || nblk <= 0) return (int)cudaSuccess;
  tcg_update_kernel<T><<<dim3(nblk, nb), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)part, (const T*)sc, (const int*)st, (const T*)d,
      (const T*)Hd, (T*)eta, (T*)Heta, (T*)r, L, nblk, (T*)part2, (T*)xs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const void* part2, const void* sc, const void* st,
                  const void* xs, const void* r, void* d, int64_t L, int nb,
                  int nblk, int mininner, void* sc_next, void* st_next,
                  void* stream) {
  if (nb <= 0 || nblk <= 0) return (int)cudaSuccess;
  tcg_finish_kernel<T><<<dim3(nblk, nb), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)part2, (const T*)sc, (const int*)st, (const T*)xs,
      (const T*)r, (T*)d, L, nblk, mininner, (T*)sc_next, (int*)st_next);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define K11_EXPORTS(SUF, T)                                                  \
  int tcg_dots_##SUF(const void* d, const void* Hd, const void* r,          \
                     const void* st, int64_t L, int nb, int nblk,           \
                     void* part, void* stream) {                            \
    return launch_dots<T>(d, Hd, r, st, L, nb, nblk, part, stream);         \
  }                                                                          \
  int tcg_update_##SUF(const void* part, const void* sc, const void* st,    \
                       const void* d, const void* Hd, void* eta,            \
                       void* Heta, void* r, int64_t L, int nb, int nblk,    \
                       void* part2, void* xs, void* stream) {               \
    return launch_update<T>(part, sc, st, d, Hd, eta, Heta, r, L, nb, nblk, \
                            part2, xs, stream);                             \
  }                                                                          \
  int tcg_finish_##SUF(const void* part2, const void* sc, const void* st,   \
                       const void* xs, const void* r, void* d, int64_t L,   \
                       int nb, int nblk, int mininner, void* sc_next,       \
                       void* st_next, void* stream) {                       \
    return launch_finish<T>(part2, sc, st, xs, r, d, L, nb, nblk, mininner, \
                            sc_next, st_next, stream);                      \
  }

K11_EXPORTS(f64, double)
K11_EXPORTS(f32, float)

#undef K11_EXPORTS

}  // extern "C"
