// K10: the exact adjoint of K9, A'(y) of the BQP moment-SDP operator on
// the expanded pair basis (layout as in symmom_apply.cu), with an optional
// fused epilogue out = base + alpha * A'(y).
//
// Replaces ops/symmom.py _adjoint_jit of the JAX package:
// _entries_from_rows (the masked reads of the flat y, the sums over one
// axis, the last-axis-preserving permutes 'cabd' / 'acbd'), then
// _spread_entries (the coefficient tensors spread over the copy slots)
// and the final (M + M^T) / 2.  Only the valid slots of y are read: every
// read is a select guarded by its family's index mask, so a don't-care
// slot (even a NaN) never reaches the result.
//
// Two launches, each output written by one thread in a fixed order:
//   coef_kernel  the spread T block before the symmetrization,
//                Tacc (q^2 x q^2), into a q^4 workspace W:
//                - a block per pair a < b: the row (a, b) of
//                  V = wT + wT[b, a, ., .] in shared memory, every E6 read
//                  in the JAX package's last-axis-preserving form (a
//                  thread per (c, d), consecutive d), then
//                  W[ab, cd] = (V[cd] + V[dc]) / 4, the (c, d) swap read
//                  transposed from shared memory; W's row (b, a) equals
//                  (a, b) and is not stored;
//                - a block per a: the row (a, a), wHs[a] (wH staged the
//                  same way) plus the wG and wD diagonals;
//                - a thread per entry of the small workspace w00, wD, wA,
//                  wG, wP0 (1 + 2q + 2q^2 sums over one axis).
//   out_kernel   a block per pair of 32 x 32 tiles (I, J), (J, I) of the
//                T block: both tiles of W staged in shared memory, then
//                out = base + alpha * (W + W^T) / 2 on both, coalesced;
//                a thread per entry of the rows and columns 0 .. o-1 (the
//                constant, E, G and H blocks) from the small workspace and
//                O(1) slots of y.
// What bounds it on an H100: bytes.  The function reads the valid slots of
// y (about 1/12 of the EQ6 family) and writes n~^2 entries: at q = 60 in
// f32, 58 MB, 17 us at 3.35 TB/s.  The workspace adds a q^4 / 2 write
// and a q^4 read (about 2.5x the bound's bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

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
  // wH[a, b, c] (b != c)
  __device__ __forceinline__ T wH(int a, int b, int c) const {
    if (b == c) return T(0);
    return (a == b ? T(2) * Sv(a, c) : T(0)) + E4(b, c, a) - E4(a, b, c);
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

// entry t of the small workspace [w00, wD (q), wA (q), wG (q^2), wP0 (q^2)]
template <typename T>
__device__ T small_value(const Rows<T>& R, int t) {
  const int q = R.q, q2 = q * q;
  if (t == 0) {
    T s = T(0);
#pragma unroll 8
    for (int a = 0; a < q; ++a) s += R.D1(a);
    return R.y[0] + T(0.5) * s;
  }
  if (t < 1 + q) {
    const int a = t - 1;
    T s = T(0);
#pragma unroll 8
    for (int b = 0; b < q; ++b) s += R.D2(a, b);
    return T(-0.5) * R.D1(a) + T(0.5) * s;
  }
  if (t < 1 + 2 * q) {
    const int b = t - 1 - q;
    T s = T(0);
#pragma unroll 8
    for (int k = 0; k < q; ++k) s += R.Sv(k, b);
    return T(-2) * s;
  }
  const int r = (t - 1 - 2 * q) % q2;
  const int a = r / q, b = r % q;
  if (a == b) return T(0);
  T s = T(0);
#pragma unroll 8
  for (int k = 0; k < q; ++k) s += R.Sp(k, a, b);
  return (t - 1 - 2 * q < q2) ? R.E2(a, b) - s : -R.E2(a, b) - s;
}

template <typename T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// W's rows (a, b) and (b, a) are equal; only (min, max) is stored
__device__ __forceinline__ int lo_row(int r, int q) {
  const int a = r / q, b = r - a * q;
  return a <= b ? r : b * q + a;
}

// (I, J), I <= J, of entry p of the upper triangle taken column by column
__device__ __forceinline__ void tri(int64_t p, int& I, int& J) {
  int64_t j = (int64_t)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  J = (int)j;
  I = (int)(p - j * (j + 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_kernel(Rows<T> R, T* __restrict__ ws, T* __restrict__ W) {
  const int q = R.q, qp = q + 1;
  const int q2 = q * q;
  const int nsmall = 1 + 2 * q + 2 * q2;
  const int64_t nsb = (nsmall + kThreads - 1) / kThreads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* s = smem<T>();
  int64_t bid = blockIdx.x;
  // the roles with O(q) sums first, so their dependent loads overlap the
  // pair rows
  if (bid < q) {
    // the row (a, a): wHs[a, c, d], the wG diagonal (c = d) and wD
    // (c = d = a)
    const int a = (int)bid;
    for (int c = warp; c < q; c += kWarps)
      for (int d = lane; d < q; d += 32) s[c * qp + d] = R.wH(a, c, d);
    __syncthreads();
    T* wr = W + ((int64_t)a * q + a) * q2;
    for (int c = warp; c < q; c += kWarps)
      for (int d = lane; d < q; d += 32) {
        T v = T(0.25) * (s[c * qp + d] + s[d * qp + c]);
        if (c == d) {
          v += T(0.25) * small_value(R, 1 + 2 * q + a * q + c);
          if (c == a) v += T(0.25) * small_value(R, 1 + a);
        }
        wr[c * q + d] = v;
      }
    return;
  }
  bid -= q;
  if (bid < nsb) {
    const int t = (int)(bid * kThreads + threadIdx.x);
    if (t < nsmall) ws[t] = small_value(R, t);
    return;
  }
  bid -= nsb;
  // the row (a, b), a < b, which is also the row (b, a)
  int a, b;
  tri(bid, a, b);
  ++b;
  // V[c, d] = wT[a, b, c, d] + wT[b, a, c, d], a warp per c, the lanes
  // along d.  wT[a, b, c, d] (a != b, c != d) is
  //   [a = c, b = d] (-D2[a, b] / 2) + [a = c] 2 Sp[a, b, d]
  //   + E6a[c, a, b, d] - E6b[c, a, b, d] - E6a[a, b, c, d] + E6b[a, c, b, d]
  // with E6a / E6b y's EQ6 slots under their masks (i < j < k < l and
  // j < i < k < l); which of the three E6 rows a warp reads, and with what
  // sign, depends on c only.  wT[b, a, ...] reads no E6 slot (b > a fails
  // every mask), only its D2 and Sp terms.
  for (int c = warp; c < q; c += kWarps) {
    const T* e1 = R.y + R.at6(c, a, b, 0);     // y6[c, a, b, d], d > b
    const T* e2 = R.y + R.at6(a, b, c, 0);     // y6[a, b, c, d], d > c
    const T* e3 = R.y + R.at6(a, c, b, 0);     // y6[a, c, b, d], d > b
    const bool p1 = c < a, m1 = a < c && c < b, m2 = b < c;
    for (int d = lane; d < q; d += 32) {
      T v = T(0);
      if (c != d) {
        if (p1 && d > b) v += e1[d] + e3[d];
        if (m1 && d > b) v -= e1[d];
        if (m2 && d > c) v -= e2[d];
        if (c == a) {
          if (d == b) v += T(-0.5) * R.D2(a, b);
          v += T(2) * R.Sp(a, b, d);
        }
        if (c == b) {
          if (d == a) v += T(-0.5) * R.D2(b, a);
          v += T(2) * R.Sp(b, a, d);
        }
      }
      s[c * qp + d] = v;
    }
  }
  __syncthreads();
  T* wa = W + ((int64_t)a * q + b) * q2;
  for (int c = warp; c < q; c += kWarps)
    for (int d = lane; d < q; d += 32)
      wa[c * q + d] = T(0.25) * (s[c * qp + d] + s[d * qp + c]);
}

// the spread blocks outside the T block, before the symmetrization
template <typename T>
struct Coefs {
  Rows<T> R;
  const T* w00;
  const T* wD;
  const T* wA;
  const T* wG;
  const T* wP0;
  int q;
  __device__ __forceinline__ T wHs(int a, int b, int c) const {
    return T(0.25) * (R.wH(a, b, c) + R.wH(a, c, b));
  }
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
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_kernel(Coefs<T> C, const T* __restrict__ W, int n,
           const T* __restrict__ base, T alpha, T* __restrict__ out) {
  const int q = C.q, o = 2 + q;
  const int64_t q2 = (int64_t)q * q;
  const int64_t top = (int64_t)o * n;
  const int64_t nedge = (top + q2 * o + kThreads - 1) / kThreads;
  int64_t bid = blockIdx.x;
  if (bid >= nedge) {
    // the T block: (W + W^T) / 2 on the tile pair (I, J), (J, I)
    bid -= nedge;
    T* s = smem<T>();
    T* a = s;
    T* b = s + kTile * (kTile + 1);
    int I, J;
    tri(bid, I, J);
    const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
    const int n2 = (int)q2;
    // the tiles' stored rows, one division each (-1 past the end)
    __shared__ int src[2 * kTile];
    if (threadIdx.x < 2 * kTile) {
      const int row = (threadIdx.x < kTile ? I : J) * kTile + threadIdx.x % kTile;
      src[threadIdx.x] = row >= n2 ? -1 : lo_row(row, q);
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kThreads / kTile) {
      const int col = J * kTile + tx, col2 = I * kTile + tx;
      if (src[r] >= 0 && col < n2)
        a[r * (kTile + 1) + tx] = W[(int64_t)src[r] * n2 + col];
      if (I != J && src[kTile + r] >= 0 && col2 < n2)
        b[r * (kTile + 1) + tx] = W[(int64_t)src[kTile + r] * n2 + col2];
    }
    __syncthreads();
    const T* bt = I == J ? a : b;
    for (int r = ty; r < kTile; r += kThreads / kTile) {
      const int64_t row = (int64_t)I * kTile + r, col = (int64_t)J * kTile + tx;
      if (row < q2 && col < q2) {
        const T val = T(0.5) * (a[r * (kTile + 1) + tx] + bt[tx * (kTile + 1) + r]);
        const int64_t at = (o + row) * n + o + col;
        out[at] = base != nullptr ? base[at] + alpha * val : alpha * val;
      }
      const int64_t row2 = (int64_t)J * kTile + r, col2 = (int64_t)I * kTile + tx;
      if (I != J && row2 < q2 && col2 < q2) {
        const T val = T(0.5) * (b[r * (kTile + 1) + tx] + a[tx * (kTile + 1) + r]);
        const int64_t at = (o + row2) * n + o + col2;
        out[at] = base != nullptr ? base[at] + alpha * val : alpha * val;
      }
    }
    return;
  }
  // rows 0 .. o-1 (all columns), then columns 0 .. o-1 of the rows >= o
  const int64_t t = bid * kThreads + threadIdx.x;
  if (t >= top + q2 * o) return;
  int u, v;
  if (t < top) {
    u = (int)(t / n);
    v = (int)(t % n);
  } else {
    u = o + (int)((t - top) / o);
    v = (int)((t - top) % o);
  }
  T val;
  if (u < 2) {
    if (v < 2) val = T(0.25) * C.w00[0];
    else if (v < o) val = T(0.125) * C.wA[v - 2];
    else val = T(0.5) * C.Eacc((v - o) / q, (v - o) % q);
  } else if (u < o) {
    const int a = u - 2;
    if (v < 2) val = T(0.125) * C.wA[a];
    else if (v < o) val = T(0.5) * (C.Gacc(a, v - 2) + C.Gacc(v - 2, a));
    else val = T(0.5) * C.Hacc(a, (v - o) / q, (v - o) % q);
  } else {
    const int a = (u - o) / q, b = (u - o) % q;
    if (v < 2) val = T(0.5) * C.Eacc(a, b);
    else val = T(0.5) * C.Hacc(v - 2, a, b);
  }
  const int64_t at = (int64_t)u * n + v;
  out[at] = base != nullptr ? base[at] + alpha * val : alpha * val;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const void* y, int q, const void* base, double alpha, void* ws,
           void* out, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  const int n = 2 + q + q * q;
  const int64_t q2 = (int64_t)q * q;
  const int nsmall = 1 + 2 * q + 2 * q * q;
  cudaStream_t s = (cudaStream_t)stream;
  T* w = (T*)ws;
  T* W = w + nsmall;                   // q^4: the T block's Tacc
  const Rows<T> R = make_rows((const T*)y, q);
  const size_t slab = sizeof(T) * (size_t)q * (q + 1);
  cudaError_t err = allow_smem(coef_kernel<T>, slab);
  if (err != cudaSuccess) return (int)err;
  const unsigned g1 = (unsigned)((nsmall + kThreads - 1) / kThreads +
                                 (int64_t)q * (q - 1) / 2 + q);
  coef_kernel<T><<<g1, kThreads, slab, s>>>(R, w, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Coefs<T> C;
  C.R = R;
  C.w00 = w;
  C.wD = w + 1;
  C.wA = w + 1 + q;
  C.wG = w + 1 + 2 * q;
  C.wP0 = w + 1 + 2 * q + q * q;
  C.q = q;
  const int64_t nt = (q2 + kTile - 1) / kTile;
  const int64_t edge = (int64_t)(2 + q) * n + q2 * (2 + q);
  const unsigned g2 = (unsigned)(nt * (nt + 1) / 2 +
                                 (edge + kThreads - 1) / kThreads);
  const size_t tiles = sizeof(T) * 2 * kTile * (kTile + 1);
  out_kernel<T><<<g2, kThreads, tiles, s>>>(C, W, n, (const T*)base,
                                            (T)alpha, (T*)out);
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
