// K10: the exact adjoint of K9, A'(y) of the BQP moment-SDP operator on
// the expanded pair basis (layout as in symmom_apply.cu), with an optional
// fused epilogue out = base + alpha * A'(y).
//
// Replaces ops/symmom.py _adjoint_jit of the JAX package:
// _entries_from_rows (the masked reads of the flat y, the sums over one
// axis, the last-axis-preserving permutes 'cabd' / 'acbd'), then
// _spread_entries (the coefficient tensors spread over the copy slots)
// and the final (M + M^T) / 2.  Only the valid slots of y are read: every
// read is guarded by its family's index mask, so a don't-care slot never
// reaches the result.
//
// Two passes:
//   small_kernel the O(q^2) coefficient vectors that need a sum over one
//                axis: w00, wD, wA, wG, wP0 (1 + 2q + 2q^2 entries, one
//                thread each), into a small workspace.
//   entry_kernel one thread per output entry (u, v), a single writer and no
//                atomics.  An entry of the T block (ab, cd) gathers its wT
//                (EQ6, SUBp and D2 terms), wHs, wG and wD terms in registers
//                for both (ab, cd) and (cd, ab), which is the transpose of
//                the symmetrization; the H, E, G and constant blocks read
//                the workspace and O(1) slots of y.  Threads of a warp take
//                neighbouring v, so the writes (and the base reads) are
//                coalesced.
//
// What bounds it on an H100: bytes.  At q = 60 in f64 it must read y
// (m = 13.4 M slots, 107 MB) and write n~^2 = 13.4 M entries (107 MB):
// 64 us at 3.35 TB/s (with the base, 107 MB more).  Only about 1/12 of the
// EQ6 slots are valid, so the scattered y reads touch far less than m.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// masked reads of the flat multiplier, the JAX package's where-masks
template <typename T>
struct Rows {
  const T* y;
  int q;
  int64_t oD2, oSv, oSp, oE2, oE4, oE6;
  __device__ __forceinline__ T D1(int a) const { return y[1 + a]; }
  __device__ __forceinline__ T D2(int a, int b) const {
    return a != b ? y[oD2 + (int64_t)a * q + b] : T(0);
  }
  __device__ __forceinline__ T Sv(int k, int b) const {
    return k != b ? y[oSv + (int64_t)k * q + b] : T(0);
  }
  __device__ __forceinline__ T Sp(int k, int b, int c) const {
    return (b < c && k != b && k != c)
               ? y[oSp + ((int64_t)k * q + b) * q + c] : T(0);
  }
  __device__ __forceinline__ T E2(int a, int b) const {
    return a < b ? y[oE2 + (int64_t)a * q + b] : T(0);
  }
  __device__ __forceinline__ T E4(int i, int j, int k) const {
    return (i != j && k > i && k > j)
               ? y[oE4 + ((int64_t)i * q + j) * q + k] : T(0);
  }
  __device__ __forceinline__ int64_t at6(int i, int j, int k, int l) const {
    return oE6 + (((int64_t)i * q + j) * q + k) * q + l;
  }
  __device__ __forceinline__ T E6a(int i, int j, int k, int l) const {
    return (i < j && j < k && k < l) ? y[at6(i, j, k, l)] : T(0);
  }
  __device__ __forceinline__ T E6b(int i, int j, int k, int l) const {
    return (j < i && i < k && k < l) ? y[at6(i, j, k, l)] : T(0);
  }
};

template <typename T>
__host__ __device__ __forceinline__ Rows<T> make_rows(const T* y, int q) {
  const int64_t q2 = (int64_t)q * q, q3 = q2 * q;
  Rows<T> R;
  R.y = y;
  R.q = q;
  R.oD2 = 1 + q;
  R.oSv = R.oD2 + q2;
  R.oSp = R.oSv + q2;
  R.oE2 = R.oSp + q3;
  R.oE4 = R.oE2 + q2;
  R.oE6 = R.oE4 + q3;
  return R;
}

// workspace layout: [w00, wD (q), wA (q), wG (q^2), wP0 (q^2)]
template <typename T>
__global__ void __launch_bounds__(kThreads)
small_kernel(const T* __restrict__ y, int q, T* __restrict__ ws) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int q2 = q * q;
  if (t >= 1 + 2 * q + 2 * q2) return;
  const Rows<T> R = make_rows(y, q);
  T val = T(0);
  if (t == 0) {
    T s = T(0);
    for (int a = 0; a < q; ++a) s += R.D1(a);
    val = y[0] + T(0.5) * s;
  } else if (t < 1 + q) {
    const int a = t - 1;
    T s = T(0);
    for (int b = 0; b < q; ++b) s += R.D2(a, b);
    val = T(-0.5) * R.D1(a) + T(0.5) * s;
  } else if (t < 1 + 2 * q) {
    const int b = t - 1 - q;
    T s = T(0);
    for (int k = 0; k < q; ++k) s += R.Sv(k, b);
    val = T(-2) * s;
  } else {
    const int r = (t - 1 - 2 * q) % q2;
    const int a = r / q, b = r % q;
    if (a != b) {
      T s = T(0);
      for (int k = 0; k < q; ++k) s += R.Sp(k, a, b);
      val = (t - 1 - 2 * q < q2) ? R.E2(a, b) - s : -R.E2(a, b) - s;
    }
  }
  ws[t] = val;
}

template <typename T>
struct Coefs {
  Rows<T> R;
  const T* w00;
  const T* wD;
  const T* wA;
  const T* wG;
  const T* wP0;
  int q;
  // wH[a, b, c] (b != c) and its symmetrization over (b, c)
  __device__ __forceinline__ T wH(int a, int b, int c) const {
    if (b == c) return T(0);
    return (a == b ? T(2) * R.Sv(a, c) : T(0)) + R.E4(b, c, a) -
           R.E4(a, b, c);
  }
  __device__ __forceinline__ T wHs(int a, int b, int c) const {
    return T(0.25) * (wH(a, b, c) + wH(a, c, b));
  }
  // wT[a, b, c, d] (a != b, c != d)
  __device__ __forceinline__ T wT(int a, int b, int c, int d) const {
    if (a == b || c == d) return T(0);
    T v = (a == c && b == d) ? T(-0.5) * R.D2(a, b) : T(0);
    if (a == c) v += T(2) * R.Sp(a, b, d);
    return v + R.E6a(c, a, b, d) - R.E6b(c, a, b, d) - R.E6a(a, b, c, d) +
           R.E6b(a, c, b, d);
  }
  __device__ __forceinline__ T wTs(int a, int b, int c, int d) const {
    return T(0.25) * (wT(a, b, c, d) + wT(a, b, d, c)) +
           T(0.25) * (wT(b, a, c, d) + wT(b, a, d, c));
  }
  // the spread blocks before the symmetrization
  __device__ __forceinline__ T Eacc(int i, int j) const {
    return (i == j ? T(0.25) * wA[i] : T(0)) +
           T(0.25) * (wP0[i * q + j] + wP0[j * q + i]);
  }
  __device__ __forceinline__ T Gacc(int a, int b) const {
    return T(0.25) * ((a == b ? wD[a] : T(0)) + wG[a * q + b]);
  }
  __device__ __forceinline__ T Hacc(int a, int b, int c) const {
    T v = (a == b && a == c) ? T(0.5) * wD[a] : T(0);
    if (b == c) v += T(0.25) * wG[a * q + b] + T(0.25) * wG[b * q + a];
    return v + wHs(a, b, c);
  }
  __device__ __forceinline__ T Tacc(int a, int b, int c, int d) const {
    T v = (a == b && b == c && c == d) ? T(0.25) * wD[a] : T(0);
    if (a == b && c == d) v += T(0.25) * wG[a * q + c];
    if (a == b) v += wHs(a, c, d);
    return v + wTs(a, b, c, d);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
entry_kernel(Coefs<T> W, int n, const T* __restrict__ base, T alpha,
             T* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int u = blockIdx.y;
  if (v >= n) return;
  const int q = W.q, o = 2 + q;
  T val;
  if (u < 2) {
    if (v < 2) val = T(0.25) * W.w00[0];
    else if (v < o) val = T(0.125) * W.wA[v - 2];
    else val = T(0.5) * W.Eacc((v - o) / q, (v - o) % q);
  } else if (u < o) {
    const int a = u - 2;
    if (v < 2) val = T(0.125) * W.wA[a];
    else if (v < o) val = T(0.5) * (W.Gacc(a, v - 2) + W.Gacc(v - 2, a));
    else val = T(0.5) * W.Hacc(a, (v - o) / q, (v - o) % q);
  } else {
    const int a = (u - o) / q, b = (u - o) % q;
    if (v < 2) val = T(0.5) * W.Eacc(a, b);
    else if (v < o) val = T(0.5) * W.Hacc(v - 2, a, b);
    else {
      const int c = (v - o) / q, d = (v - o) % q;
      val = T(0.5) * (W.Tacc(a, b, c, d) + W.Tacc(c, d, a, b));
    }
  }
  const int64_t at = (int64_t)u * n + v;
  out[at] = base != nullptr ? base[at] + alpha * val : alpha * val;
}

template <typename T>
int launch(const void* y, int q, const void* base, double alpha, void* ws,
           void* out, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  const int n = 2 + q + q * q;
  const int nsmall = 1 + 2 * q + 2 * q * q;
  cudaStream_t s = (cudaStream_t)stream;
  small_kernel<T><<<(nsmall + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const T*)y, q, (T*)ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const T* w = (const T*)ws;
  Coefs<T> W;
  W.R = make_rows((const T*)y, q);
  W.w00 = w;
  W.wD = w + 1;
  W.wA = w + 1 + q;
  W.wG = w + 1 + 2 * q;
  W.wP0 = w + 1 + 2 * q + q * q;
  W.q = q;
  const dim3 grid((n + kThreads - 1) / kThreads, n);
  entry_kernel<T><<<grid, kThreads, 0, s>>>(W, n, (const T*)base, (T)alpha,
                                            (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symmom_adjoint_f64(const void* y, int q, const void* base, double alpha,
                       void* ws, void* out, void* stream) {
  return launch<double>(y, q, base, alpha, ws, out, stream);
}

int symmom_adjoint_f32(const void* y, int q, const void* base, double alpha,
                       void* ws, void* out, void* stream) {
  return launch<float>(y, q, base, alpha, ws, out, stream);
}

}  // extern "C"
