// K9: the BQP moment-SDP operator A(M) on the expanded pair basis
// (n~ = 2 + q + q^2, o = 2 + q: columns 0, 1 the two copies of the
// constant, 2 + a the first copy of x_a, o + i q + j the grid slot
// x_i x_j, whose diagonal o + a q + a is the second copy of x_a).
//
// Replaces ops/symmom.py _apply_jit of the JAX package (_compress_entries
// and _rows_from_entries on Ms = (M + M^T) / 2): the copy-averaged
// original-entry tensors c00, cA, cD, cG, cP0, cH, cT, then the bqpmom row
// families written into the flat layout
//   [r0 (1), D1 (q), D2 (q^2), SUBv (q^2), SUBp (q^3), EQ2 (q^2),
//    EQ4 (q^3), EQ6 (q^4)]
// with every don't-care slot exactly 0 (the JAX function's where-chain).
//
// Two passes:
//   ct_kernel   cT[a,b,c,d] = 1/8 sum of the 8 entries of M at
//               (ab|ba, cd|dc) and their transposes (cT of Ms), into a q^4
//               workspace.  One block per row pair (a, b): it reads the
//               rows ab and ba of the T block (coalesced) and the columns
//               ab and ba (one element per row; neighbouring blocks read
//               neighbouring columns, so the sectors come from L2), sums
//               them into a q x q slab Z in shared memory, and writes
//               cT[a,b,c,d] = (Z[c,d] + Z[d,c]) / 8: the (c,d) swap, the
//               minor-axis transpose, happens in shared memory.
//   rows_kernel one thread per flat slot.  The q^4 EQ6 family reads cT at
//               [j,k,i,l], [i,j,k,l] and [i,k,j,l]: the last index stays
//               in place, so the 32 lanes of a warp (consecutive l) read
//               coalesced, and only valid slots (l > k > max(i, j)) read at
//               all.  The O(q^3) families read the small blocks of M
//               directly (Ms entries on the fly) and cT's diagonals.
//
// What bounds it on an H100: bytes.  At q = 60 in f64 the function must
// read M (n~^2 = 13.4 M entries, 107 MB) and write the m = 13.4 M slots
// (107 MB): 64 us at 3.35 TB/s.  This design moves the T block about
// four times (two row reads, two column reads mostly from L2), writes and
// re-reads the 104 MB workspace: several times the bound, correct first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ct_kernel(const T* __restrict__ M, int q, int n, T* __restrict__ ct) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Z = reinterpret_cast<T*>(smem_raw);
  const int q2 = q * q, o = 2 + q;
  const int a = blockIdx.x / q, b = blockIdx.x % q;
  const int cab = o + a * q + b, cba = o + b * q + a;
  const T* rab = M + (int64_t)cab * n + o;
  const T* rba = M + (int64_t)cba * n + o;
  for (int s = threadIdx.x; s < q2; s += kThreads) {
    const T* rs = M + (int64_t)(o + s) * n;
    Z[s] = (rab[s] + rba[s]) + (rs[cab] + rs[cba]);
  }
  __syncthreads();
  T* out = ct + (int64_t)blockIdx.x * q2;
  for (int s = threadIdx.x; s < q2; s += kThreads) {
    const int c = s / q, d = s - c * q;
    out[s] = T(0.125) * (Z[s] + Z[d * q + c]);
  }
}

// entries of Ms = (M + M^T) / 2 by basis block, and the copy averages
template <typename T>
struct Expanded {
  const T* M;
  const T* ct;
  int n, q, o;
  __device__ __forceinline__ T ms(int u, int v) const {
    return T(0.5) * (M[(int64_t)u * n + v] + M[(int64_t)v * n + u]);
  }
  __device__ __forceinline__ T G(int a, int b) const {
    return ms(2 + a, 2 + b);
  }
  __device__ __forceinline__ T H(int a, int i, int j) const {
    return ms(2 + a, o + i * q + j);
  }
  __device__ __forceinline__ T T4(int a, int b, int c, int d) const {
    return ms(o + a * q + b, o + c * q + d);
  }
  __device__ __forceinline__ T E(int s, int i, int j) const {
    return ms(s, o + i * q + j);
  }
  __device__ __forceinline__ T c00() const {
    return T(0.25) * (ms(0, 0) + ms(0, 1) + ms(1, 0) + ms(1, 1));
  }
  __device__ __forceinline__ T cA(int a) const {
    return T(0.25) * (ms(0, 2 + a) + ms(1, 2 + a) + E(0, a, a) + E(1, a, a));
  }
  __device__ __forceinline__ T cD(int a) const {
    return T(0.25) * (G(a, a) + T(2) * H(a, a, a) + T4(a, a, a, a));
  }
  __device__ __forceinline__ T cG(int a, int b) const {
    return T(0.25) * (G(a, b) + H(a, b, b) + H(b, a, a) + T4(a, a, b, b));
  }
  __device__ __forceinline__ T cP0(int a, int b) const {
    return T(0.25) * (E(0, a, b) + E(0, b, a) + E(1, a, b) + E(1, b, a));
  }
  __device__ __forceinline__ T cH(int a, int b, int c) const {
    return T(0.25) * (H(a, b, c) + H(a, c, b) + T4(a, a, b, c) +
                      T4(a, a, c, b));
  }
  __device__ __forceinline__ T cT(int a, int b, int c, int d) const {
    return ct[(((int64_t)a * q + b) * q + c) * q + d];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(Expanded<T> X, int64_t m, T* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= m) return;
  const int q = X.q;
  const int64_t q2 = (int64_t)q * q, q3 = q2 * q;
  const int64_t oD2 = 1 + q, oSv = oD2 + q2, oSp = oSv + q2, oE2 = oSp + q3,
                oE4 = oE2 + q2, oE6 = oE4 + q3;
  T val = T(0);
  if (idx >= oE6) {
    const int64_t r = idx - oE6;
    const int l = (int)(r % q), k = (int)((r / q) % q),
              j = (int)((r / q2) % q), i = (int)(r / q3);
    if (k < l) {
      if (i < j && j < k)
        val = X.cT(j, k, i, l) - X.cT(i, j, k, l);
      else if (j < i && i < k)
        val = X.cT(i, k, j, l) - X.cT(j, k, i, l);
    }
  } else if (idx >= oE4) {
    const int64_t r = idx - oE4;
    const int k = (int)(r % q), j = (int)((r / q) % q), i = (int)(r / q2);
    if (i != j && k > i && k > j) val = X.cH(k, i, j) - X.cH(i, j, k);
  } else if (idx >= oE2) {
    const int64_t r = idx - oE2;
    const int a = (int)(r / q), b = (int)(r % q);
    if (a < b) val = X.cG(a, b) - X.cP0(a, b);
  } else if (idx >= oSp) {
    const int64_t r = idx - oSp;
    const int c = (int)(r % q), b = (int)((r / q) % q), k = (int)(r / q2);
    if (b < c && k != b && k != c)
      val = T(2) * X.cT(k, b, k, c) - (X.cP0(b, c) + X.cG(b, c));
  } else if (idx >= oSv) {
    const int64_t r = idx - oSv;
    const int k = (int)(r / q), b = (int)(r % q);
    if (k != b) val = T(2) * X.cH(k, k, b) - T(2) * X.cA(b);
  } else if (idx >= oD2) {
    const int64_t r = idx - oD2;
    const int a = (int)(r / q), b = (int)(r % q);
    if (a != b) val = T(0.5) * X.cD(a) - T(0.5) * X.cT(a, b, a, b);
  } else if (idx >= 1) {
    val = T(0.5) * X.c00() - T(0.5) * X.cD((int)(idx - 1));
  } else {
    val = X.c00();
  }
  out[idx] = val;
}

template <typename T>
int launch(const void* M, int q, void* ct, void* out, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  const int n = 2 + q + q * q;
  const int64_t q2 = (int64_t)q * q;
  const int64_t m = 1 + q + 3 * q2 + 2 * q2 * q + q2 * q2;
  const size_t smem = (size_t)q2 * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  ct_kernel<T><<<(unsigned)q2, kThreads, smem, s>>>((const T*)M, q, n,
                                                    (T*)ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Expanded<T> X{(const T*)M, (const T*)ct, n, q, 2 + q};
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  rows_kernel<T><<<blocks, kThreads, 0, s>>>(X, m, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symmom_apply_f64(const void* M, int q, void* ct, void* out,
                     void* stream) {
  return launch<double>(M, q, ct, out, stream);
}

int symmom_apply_f32(const void* M, int q, void* ct, void* out,
                     void* stream) {
  return launch<float>(M, q, ct, out, stream);
}

}  // extern "C"
