// K7: the SOS-dual tensor operator's forward map on the expanded pair
// basis (the class sums of an (n~, n~) matrix, every degree at once).
//
// Replaces ops/symdual.py _apply_tensor of the JAX package (its einsum /
// transpose chain, called by SymDualOp.apply and y_step).  Basis layout
// (n~ = 2 + q + q^2, o = 2 + q): columns 0, 1 = the two copies of the
// constant; 2 + a = x_a; o + i*q + j = x_i x_j for i != j and the second
// copy of x_a at i = j = a.  Blocks of M (row-major, leading dim n~):
//   T[i,j,k,l] = M[o+iq+j, o+kq+l]   H[b,i,j] = M[2+b, o+iq+j]
//   K[i,j,b]   = M[o+iq+j, 2+b]      E[s,i,j] = M[s, o+iq+j]
//   F[i,j,s]   = M[o+iq+j, s]        G[a,b]   = M[2+a, 2+b]
// The output is the flat per-degree layout y = [y0, y1 (q), Y2 (q,q),
// Y3 (q,q,q), Y4 (q,q,q,q)]; slots with a repeated index (don't-care in
// the JAX function: never read by the adjoint, zero in b) are written 0.
// Optional epilogue (y_step): y0 <- (y0 - shift) * scale[0] and every
// degree-d slot times scale[d].
//
// Two launches:
//   symdual_low: the index-coincidence patterns of the JAX einsums; one
//     thread per Y3 slot (24 reads), one warp per slot of y1 and Y2 (the
//     lanes split the O(q) sums over the shared index, 8 (q - 1) and
//     8 (q - 2) reads, then a shuffle reduction); block 0 reduces y0 over
//     the q^2 coincidence planes of T.
//   symdual_y4: Y4 is invariant under all 24 permutations of (i,j,k,l),
//     so one thread owns each sorted 4-set i < j < k < l, reads the 24
//     entries of T once and writes their sum to all 24 slots; the
//     threads of the other slots write the don't-care zeros.  Block
//     (i, j) walks (k, l), so the zero writes run along l.
// What bounds it on an H100: bytes.  At q = 60 (n~ = 3,662) reading T
// (12.96 M entries) and writing Y4 moves 207 MB in f64, 62 us at
// 3.35 TB/s (31 us in f32); the low launch touches O(q^3) entries.  The
// 24 reads and writes of a 4-set are scattered (strides q^3 .. 1), so a
// sector carries one useful element: simple first, a tiled transpose
// through shared memory is the known next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__constant__ unsigned char kPerm[24][4] = {
    {0, 1, 2, 3}, {0, 1, 3, 2}, {0, 2, 1, 3}, {0, 2, 3, 1}, {0, 3, 1, 2},
    {0, 3, 2, 1}, {1, 0, 2, 3}, {1, 0, 3, 2}, {1, 2, 0, 3}, {1, 2, 3, 0},
    {1, 3, 0, 2}, {1, 3, 2, 0}, {2, 0, 1, 3}, {2, 0, 3, 1}, {2, 1, 0, 3},
    {2, 1, 3, 0}, {2, 3, 0, 1}, {2, 3, 1, 0}, {3, 0, 1, 2}, {3, 0, 2, 1},
    {3, 1, 0, 2}, {3, 1, 2, 0}, {3, 2, 0, 1}, {3, 2, 1, 0}};

template <typename T>
struct Blocks {
  const T* M;
  int64_t n;  // n~
  int q, o;
  __device__ __forceinline__ T at(int64_t u, int64_t v) const {
    return M[u * n + v];
  }
  __device__ __forceinline__ T Tq(int i, int j, int k, int l) const {
    return at(o + (int64_t)i * q + j, o + (int64_t)k * q + l);
  }
  __device__ __forceinline__ T H(int b, int i, int j) const {
    return at(2 + b, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T K(int i, int j, int b) const {
    return at(o + (int64_t)i * q + j, 2 + b);
  }
  __device__ __forceinline__ T E(int s, int i, int j) const {
    return at(s, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T F(int i, int j, int s) const {
    return at(o + (int64_t)i * q + j, s);
  }
  __device__ __forceinline__ T G(int a, int b) const { return at(2 + a, 2 + b); }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symdual_low(Blocks<T> B, const T* __restrict__ scale,
            const T* __restrict__ shift, T* __restrict__ y) {
  const int q = B.q;
  const int64_t q2 = (int64_t)q * q;
  const int64_t nw = q + q2;                          // warp slots: y1, Y2
  const int64_t nwb = (nw + kWarps - 1) / kWarps;
  if (blockIdx.x == 0) {
    // y0: pairs of copies of one column
    __shared__ T red[kThreads];
    T acc = T(0);
    for (int64_t t = threadIdx.x; t < q2; t += kThreads) {
      const int i = (int)(t / q), j = (int)(t % q);
      if (i == j)
        acc += B.G(i, i) + B.H(i, i, i) + B.K(i, i, i) + B.Tq(i, i, i, i);
      else
        acc += B.Tq(i, j, i, j) + B.Tq(i, j, j, i);
    }
    if (threadIdx.x == 0) acc += B.at(0, 0) + B.at(0, 1) + B.at(1, 0) + B.at(1, 1);
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      T y0 = red[0];
      if (shift != nullptr) y0 = y0 - shift[0];
      if (scale != nullptr) y0 = y0 * scale[0];
      y[0] = y0;
    }
    return;
  }
  if (blockIdx.x <= nwb) {
    // one warp per slot of y1 and Y2: the lanes split the O(q) sum
    const int64_t e = (int64_t)(blockIdx.x - 1) * kWarps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (e >= nw) return;                               // warp-uniform
    if (e < q) {
      // y1[a]: (const, x_a) over all copies and the (x_c, x_c x_a) patterns
      const int a = (int)e;
      T acc = T(0);
      for (int i = lane; i < q; i += 32) {
        if (i == a) continue;
        acc += B.H(i, i, a) + B.H(i, a, i) + B.K(i, a, i) + B.K(a, i, i) +
               B.Tq(i, i, i, a) + B.Tq(i, i, a, i) + B.Tq(i, a, i, i) +
               B.Tq(a, i, i, i);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        acc += B.at(0, 2 + a) + B.at(1, 2 + a) + B.at(2 + a, 0) +
               B.at(2 + a, 1) + B.E(0, a, a) + B.E(1, a, a) + B.F(a, a, 0) +
               B.F(a, a, 1);
        y[1 + a] = scale != nullptr ? acc * scale[1] : acc;
      }
      return;
    }
    // Y2[a, b], a != b
    const int64_t t = e - q;
    const int a = (int)(t / q), b = (int)(t % q);
    if (a == b) {
      if (lane == 0) y[1 + q + t] = T(0);
      return;
    }
    T acc = T(0);
    for (int c = lane; c < q; c += 32) {
      if (c == a || c == b) continue;
      acc += B.Tq(a, c, b, c) + B.Tq(a, c, c, b) + B.Tq(c, a, b, c) +
             B.Tq(c, a, c, b) + B.Tq(b, c, a, c) + B.Tq(b, c, c, a) +
             B.Tq(c, b, a, c) + B.Tq(c, b, c, a);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      acc += B.G(a, b) + B.G(b, a) + B.E(0, a, b) + B.E(1, a, b) +
             B.E(0, b, a) + B.E(1, b, a) + B.F(a, b, 0) + B.F(a, b, 1) +
             B.F(b, a, 0) + B.F(b, a, 1) + B.H(a, b, b) + B.H(b, a, a) +
             B.K(b, b, a) + B.K(a, a, b) + B.Tq(a, a, b, b) + B.Tq(b, b, a, a);
      y[1 + q + t] = scale != nullptr ? acc * scale[2] : acc;
    }
    return;
  }
  // Y3[a, b, c], distinct: x_x times an off-diagonal slot (y, z) of the
  // other two, first copies (H, K) and Q-diagonal copies (planes of T)
  const int64_t t = (int64_t)(blockIdx.x - 1 - nwb) * kThreads + threadIdx.x;
  if (t >= q2 * q) return;
  const int a = (int)(t / q2), b = (int)((t / q) % q), c = (int)(t % q);
  T acc = T(0);
  if (a != b && a != c && b != c) {
    const int idx[3] = {a, b, c};
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const int ex = idx[x], ey = idx[(x + 1) % 3], ez = idx[(x + 2) % 3];
      acc += B.H(ex, ey, ez) + B.Tq(ex, ex, ey, ez) + B.K(ey, ez, ex) +
             B.Tq(ey, ez, ex, ex);
      acc += B.H(ex, ez, ey) + B.Tq(ex, ex, ez, ey) + B.K(ez, ey, ex) +
             B.Tq(ez, ey, ex, ex);
    }
    if (scale != nullptr) acc = acc * scale[3];
  }
  y[1 + q + q2 + t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symdual_y4(Blocks<T> B, const T* __restrict__ scale, T* __restrict__ y4) {
  const int q = B.q;
  const int i = (int)(blockIdx.x / q), j = (int)(blockIdx.x % q);
  const int64_t q2 = (int64_t)q * q;
  const int64_t base = (int64_t)blockIdx.x * q2;   // (i*q + j) * q^2
  const T s4 = scale != nullptr ? scale[4] : T(1);
  for (int64_t t = threadIdx.x; t < q2; t += kThreads) {
    const int k = (int)(t / q), l = (int)(t % q);
    const bool distinct = i != j && i != k && i != l && j != k && j != l &&
                          k != l;
    if (!distinct) {
      y4[base + t] = T(0);
      continue;
    }
    if (!(i < j && j < k && k < l)) continue;   // written by its sorted owner
    const int idx[4] = {i, j, k, l};
    T acc = T(0);
#pragma unroll 4
    for (int p = 0; p < 24; ++p)
      acc += B.Tq(idx[kPerm[p][0]], idx[kPerm[p][1]], idx[kPerm[p][2]],
                  idx[kPerm[p][3]]);
    if (scale != nullptr) acc = acc * s4;
#pragma unroll 4
    for (int p = 0; p < 24; ++p) {
      const int64_t at = (((int64_t)idx[kPerm[p][0]] * q + idx[kPerm[p][1]]) * q +
                          idx[kPerm[p][2]]) * q + idx[kPerm[p][3]];
      y4[at] = acc;
    }
  }
}

template <typename T>
int launch(const void* M, int q, const void* scale, const void* shift,
           void* y, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  Blocks<T> B{(const T*)M, 2 + q + (int64_t)q * q, q, 2 + q};
  const int64_t q2 = (int64_t)q * q;
  const int64_t nlow = q + q2 + q2 * q;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid_low((unsigned)(1 + (q + q2 + kWarps - 1) / kWarps +
                                 (q2 * q + kThreads - 1) / kThreads));
  symdual_low<T><<<grid_low, kThreads, 0, s>>>(B, (const T*)scale,
                                               (const T*)shift, (T*)y);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  T* y4 = (T*)y + 1 + nlow;
  symdual_y4<T><<<(unsigned)q2, kThreads, 0, s>>>(B, (const T*)scale, y4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symdual_apply_f64(const void* M, int q, const void* scale,
                      const void* shift, void* y, void* stream) {
  return launch<double>(M, q, scale, shift, y, stream);
}

int symdual_apply_f32(const void* M, int q, const void* scale,
                      const void* shift, void* y, void* stream) {
  return launch<float>(M, q, scale, shift, y, stream);
}

}  // extern "C"
