// K3: pair dots of two factors over a sparsity pattern (an SDDMM).
//
// Replaces the JAX package's gather / multiply / row-sum chain
//   ops/sparse.py  pair_dots, ConstraintOp.pattern_pair_dots
// which the primal AL runs in every cost, Hessian product and stats call:
//
//   out[e] = sum_r Y[r, i_e] * U[r, j_e]     for every pattern entry e
//
// The pattern is sorted by (column j, row i), so colptr[j] .. colptr[j+1]
// delimits column j's entries.  One warp owns one column: lane l holds
// U[l + 32c, j] (c < NCH) in registers for the whole column, gathers
// Y[:, i_e] for each entry, and the dot is a warp-shuffle sum that lane 0
// writes.  Every out[e] is written by one warp: no atomics, deterministic.
// Factors wider than 32 * NCH rows take several passes; each later pass
// adds its partial dot to out[e] (same warp, program order).
//
// What bounds it on an H100: at the matrix-completion n = 12,000 shape
// (nnzP = 9.0 M, p_pad <= 24) each entry gathers one p-vector of Y,
// p_pad * 8 B in f64; the factor is 2.3 MB and stays in L2, but it is
// row-major (p, n), so the p rows of one gathered column sit n * 8 B apart
// and cost p sectors, not p * 8 / 32.  Output is nnzP * 8 B = 72 MB of
// HBM writes.  The design keeps ENTRIES_IN_FLIGHT independent gathers in
// flight per warp so the L2 latency of one entry overlaps the next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kEntriesInFlight = 4;

template <typename T>
__device__ __forceinline__ T warp_allsum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pattern_dots_kernel(const T* __restrict__ Y, int64_t syr, int64_t syc,
                    const T* __restrict__ U, int64_t sur, int64_t suc,
                    const int* __restrict__ colptr,
                    const int* __restrict__ rows, int p, int n,
                    T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;  // whole warp leaves together
  const int e0 = colptr[j], e1 = colptr[j + 1];
  const int rows_per_pass = 32 * NCH;
  const int npass = (p + rows_per_pass - 1) / rows_per_pass;

  for (int g = 0; g < npass; ++g) {
    const int rbase = g * rows_per_pass + lane;
    T u[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = rbase + 32 * c;
      u[c] = r < p ? U[(int64_t)r * sur + (int64_t)j * suc] : T(0);
    }
    for (int e = e0; e < e1; e += kEntriesInFlight) {
      T s[kEntriesInFlight];
#pragma unroll
      for (int q = 0; q < kEntriesInFlight; ++q) {
        s[q] = T(0);
        if (e + q < e1) {
          const int64_t col = (int64_t)rows[e + q] * syc;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int r = rbase + 32 * c;
            if (r < p) s[q] += Y[(int64_t)r * syr + col] * u[c];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kEntriesInFlight; ++q) {
        const T d = warp_allsum(s[q]);
        if (lane == 0 && e + q < e1) out[e + q] = g == 0 ? d : out[e + q] + d;
      }
    }
  }
}

template <typename T>
int launch(const void* Y, int64_t syr, int64_t syc, const void* U,
           int64_t sur, int64_t suc, const void* colptr, const void* rows,
           int p, int n, void* out, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (p + 31) / 32;
#define K3_ARGS                                                        \
  (const T*)Y, syr, syc, (const T*)U, sur, suc, (const int*)colptr,   \
      (const int*)rows, p, n, (T*)out
  if (nch <= 1)
    pattern_dots_kernel<T, 1><<<grid, block, 0, s>>>(K3_ARGS);
  else if (nch <= 2)
    pattern_dots_kernel<T, 2><<<grid, block, 0, s>>>(K3_ARGS);
  else
    pattern_dots_kernel<T, 4><<<grid, block, 0, s>>>(K3_ARGS);
#undef K3_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pattern_dots_f64(const void* Y, int64_t syr, int64_t syc, const void* U,
                     int64_t sur, int64_t suc, const void* colptr,
                     const void* rows, int p, int n, void* out,
                     void* stream) {
  return launch<double>(Y, syr, syc, U, sur, suc, colptr, rows, p, n, out,
                        stream);
}

int pattern_dots_f32(const void* Y, int64_t syr, int64_t syc, const void* U,
                     int64_t sur, int64_t suc, const void* colptr,
                     const void* rows, int p, int n, void* out,
                     void* stream) {
  return launch<float>(Y, syr, syc, U, sur, suc, colptr, rows, p, n, out,
                       stream);
}

}  // extern "C"
