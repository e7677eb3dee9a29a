// K1: sparse product with a symmetric COO matrix, with fused epilogues.
//
// Replaces the JAX package's gather / scale / segment-sum chains:
//   ops/sparse.py  scatter_cols, SymCOO.matmat, matmat_vals, matvec_block
//   ops/sparse.py  SymCOO.quad_cols / pair_dots (z_j = eG_j, "cost" mode)
//   solvers/maxcut.py make_maxcut_problem cost / hess epilogues
//   ops/eigs_rr.py DeviceCertSolver row matvec V C - z o V ("shift" mode)
//   solvers/primal_al.py _make_problem hess (the AL Hessian, "al_hess")
//
// out[:, j] = sum_{e in colptr[j] .. colptr[j+1]} v_e * A[:, i_e]
// C is symmetric and stored sorted by column, so the column pointer of
// the COO entries is a CSR row pointer of C as well.
//
// Layout: one warp owns one output column j; lane l handles rows
// l, l + 32, ... of that column, NCH chunks of 32 rows per pass, so the
// per-column reductions of the epilogues are warp shuffles.  Every output
// element is written by exactly one lane and summed in entry order:
// no atomics, results are deterministic.  Sums accumulate in T, as the
// segment-sum does in the JAX package.
//
// Modes (runtime int):
//   0 plain : out = A M
//   1 shift : out = A M - z_j A[:, j]
//   2 cost  : out = A M,  w_j = sum_r out[r, j] * A[r, j]
//   3 hess  : out = A M - B[:, j] * sum_r(B[r, j] * (A M)[r, j]) - A[:, j] eG_j
//             (A = U, B = Y; A M never reaches device memory when the
//             column fits in one pass of 32 * NCH rows, otherwise the
//             second pass recomputes it)
//   4 al_hess      : out = H := c1 * A M + c2 * B M2, where M2 has C's
//                    pattern and the values vals2 (one pass over the
//                    column gathers both factors)
//   5 al_hess_diag : out = H - B[:, j] * sum_r(B[r, j] H[r, j]) - A[:, j] eG_j
//                    (the unit-diagonal AL Hessian: A = U, B = Y,
//                    M = mat(es), M2 = mat(A'A vec(Y'U)), c1 = 2,
//                    c2 = 4 sigma, eG = colsum(Y o grad))
//
// What bounds it on an H100: at the G67 shape (n = 10^4, nnz = 5 * 10^4,
// p_pad = 48) one call moves ~nnz * p_pad * 8 B = 19 MB of gathered
// neighbour values (f64) through L2, which holds the whole factor
// (3.8 MB), plus p_pad * n * 8 B = 3.8 MB of output; that is a few
// microseconds, comparable to the ~5 us launch latency, so at this size a
// call is launch-bound.  The factor is row-major (p, n), so the 32 lanes
// of one neighbour load hit 32 different sectors (stride n): 4x (f64) or
// 8x (f32) more sector traffic than an n-major (n, p) factor, whose
// p-vector per neighbour would be contiguous.  Whether the port should
// keep the factor n-major is an open measurement; this kernel takes any
// strides, so it serves both layouts and the V^T views of matvec_block.
//
// Instance mode (B19; replaces the jax.vmap of these products over a
// batch of MaxCut instances, solvers/batch.py:68-98 with the padded
// SymCOO arrays of :52-65): nb instances of one padded size n in one
// launch, blockIdx.y the instance.  A, B and out advance by their
// instance strides, z, eG and w by n, and each instance has its own
// column pointer (row inst of an (nb, n+1) array, local to its entries)
// and its first entry eoff[inst] (int64) in the concatenated rows /
// vals / vals2.  A padding column j >= n_inst has an empty segment, so
// its product is exactly 0.  With nb = 1 and no eoff every pointer is
// where the single-instance call had it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__device__ __forceinline__ T warp_allsum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NCH>
__device__ __forceinline__ void gather_chunk(
    T (&acc)[NCH], const T* __restrict__ A, int64_t sar, int64_t sac,
    const int* __restrict__ rows, const T* __restrict__ vals,
    int e0, int e1, int r0, int p) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = T(0);
  for (int e = e0; e < e1; ++e) {
    const int64_t col = (int64_t)rows[e] * sac;
    const T v = vals[e];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = r0 + 32 * c;
      if (r < p) acc[c] += v * A[(int64_t)r * sar + col];
    }
  }
}

// acc = c1 * (A M)[rows, j] + c2 * (B M2)[rows, j]: both gathers in one
// walk over the column's entries
template <typename T, int NCH>
__device__ __forceinline__ void gather2_chunk(
    T (&acc)[NCH], const T* __restrict__ A, int64_t sar, int64_t sac,
    const T* __restrict__ B, int64_t sbr, int64_t sbc,
    const int* __restrict__ rows, const T* __restrict__ vals,
    const T* __restrict__ vals2, T c1, T c2, int e0, int e1, int r0,
    int p) {
  T acc2[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = acc2[c] = T(0);
  for (int e = e0; e < e1; ++e) {
    const int64_t i = rows[e];
    const T v = vals[e], v2 = vals2[e];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = r0 + 32 * c;
      if (r < p) {
        acc[c] += v * A[(int64_t)r * sar + i * sac];
        acc2[c] += v2 * B[(int64_t)r * sbr + i * sbc];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = c1 * acc[c] + c2 * acc2[c];
}

template <typename T, int NCH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
symcoo_spmm_kernel(const T* __restrict__ A, int64_t sab, int64_t sar,
                   int64_t sac, const int* __restrict__ colptr,
                   const int64_t* __restrict__ eoff,
                   const int* __restrict__ rows,
                   const T* __restrict__ vals, int p, int n, int mode,
                   const T* __restrict__ z,
                   const T* __restrict__ B, int64_t sbb, int64_t sbr,
                   int64_t sbc, const T* __restrict__ eG,
                   const T* __restrict__ vals2, T c1, T c2,
                   T* __restrict__ out, T* __restrict__ w) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;  // whole warp leaves together
  // instance mode: move every pointer to instance blockIdx.y (instance 0
  // and the single-instance call leave them where they are)
  const int64_t inst = blockIdx.y;
  const int64_t eb = eoff != nullptr ? eoff[inst] : 0;
  A += inst * sab;
  colptr += inst * (n + 1);
  rows += eb;
  vals += eb;
  out += inst * p * n;
  if (z != nullptr) z += inst * n;
  if (B != nullptr) B += inst * sbb;
  if (eG != nullptr) eG += inst * n;
  if (vals2 != nullptr) vals2 += eb;
  if (w != nullptr) w += inst * n;
  const int e0 = colptr[j], e1 = colptr[j + 1];
  const int64_t acol = (int64_t)j * sac;
  const int rows_per_pass = 32 * NCH;
  const int npass = (p + rows_per_pass - 1) / rows_per_pass;

  T acc[NCH];
  T part = T(0);
  const bool two = mode >= 4;
  for (int g = 0; g < npass; ++g) {
    const int rbase = g * rows_per_pass + lane;
    if (two)
      gather2_chunk<T, NCH>(acc, A, sar, sac, B, sbr, sbc, rows, vals,
                            vals2, c1, c2, e0, e1, rbase, p);
    else
      gather_chunk<T, NCH>(acc, A, sar, sac, rows, vals, e0, e1, rbase, p);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int r = rbase + 32 * c;
      if (r >= p) continue;
      const int64_t o = (int64_t)r * n + j;
      if (mode == 0 || mode == 4) {
        out[o] = acc[c];
      } else if (mode == 1) {
        out[o] = acc[c] - z[j] * A[(int64_t)r * sar + acol];
      } else if (mode == 2) {
        out[o] = acc[c];
        part += acc[c] * A[(int64_t)r * sar + acol];
      } else {
        part += B[(int64_t)r * sbr + (int64_t)j * sbc] * acc[c];
      }
    }
  }
  if (mode == 2) {
    part = warp_allsum(part);
    if (lane == 0) w[j] = part;
  } else if (mode == 3 || mode == 5) {
    const T s = warp_allsum(part);
    const T eg = eG[j];
    for (int g = 0; g < npass; ++g) {
      const int rbase = g * rows_per_pass + lane;
      // one pass: acc still holds this column's product; otherwise
      // recompute it
      if (npass > 1 && two)
        gather2_chunk<T, NCH>(acc, A, sar, sac, B, sbr, sbc, rows, vals,
                              vals2, c1, c2, e0, e1, rbase, p);
      else if (npass > 1)
        gather_chunk<T, NCH>(acc, A, sar, sac, rows, vals, e0, e1, rbase, p);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int r = rbase + 32 * c;
        if (r >= p) continue;
        const T b = B[(int64_t)r * sbr + (int64_t)j * sbc];
        const T a = A[(int64_t)r * sar + acol];
        out[(int64_t)r * n + j] = acc[c] - b * s - a * eg;
      }
    }
  }
}

template <typename T>
int launch(const void* A, int64_t sab, int64_t sar, int64_t sac,
           const void* colptr, const void* eoff, const void* rows,
           const void* vals, int p, int n, int nb, int mode, const void* z,
           const void* B, int64_t sbb, int64_t sbr, int64_t sbc,
           const void* eG, const void* vals2, double c1, double c2,
           void* out, void* w, void* stream) {
  if (n <= 0 || p <= 0 || nb <= 0) return (int)cudaSuccess;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, nb);
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (p + 31) / 32;
#define K1_ARGS                                                           \
  (const T*)A, sab, sar, sac, (const int*)colptr, (const int64_t*)eoff,   \
      (const int*)rows, (const T*)vals, p, n, mode, (const T*)z,          \
      (const T*)B, sbb, sbr, sbc, (const T*)eG, (const T*)vals2, (T)c1,   \
      (T)c2, (T*)out, (T*)w
  if (nch <= 1)
    symcoo_spmm_kernel<T, 1><<<grid, block, 0, s>>>(K1_ARGS);
  else if (nch <= 2)
    symcoo_spmm_kernel<T, 2><<<grid, block, 0, s>>>(K1_ARGS);
  else
    symcoo_spmm_kernel<T, 4><<<grid, block, 0, s>>>(K1_ARGS);
#undef K1_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define K1_EXPORT(SUF, T)                                                    \
  int symcoo_spmm_##SUF(const void* A, int64_t sab, int64_t sar,            \
                        int64_t sac, const void* colptr, const void* eoff,  \
                        const void* rows, const void* vals, int p, int n,   \
                        int nb, int mode, const void* z, const void* B,     \
                        int64_t sbb, int64_t sbr, int64_t sbc,              \
                        const void* eG, const void* vals2, double c1,       \
                        double c2, void* out, void* w, void* stream) {      \
    return launch<T>(A, sab, sar, sac, colptr, eoff, rows, vals, p, n, nb,  \
                     mode, z, B, sbb, sbr, sbc, eG, vals2, c1, c2, out, w,  \
                     stream);                                               \
  }

K1_EXPORT(f64, double)
K1_EXPORT(f32, float)

#undef K1_EXPORT

}  // extern "C"
