// K4: CSR gather-sum with an optional affine epilogue.
//
//   y[r] = base[r] + alpha * sum_{e in ptr[r] .. ptr[r+1]} val[e] * x[col[e]]
//
// (base absent: y[r] = alpha * sum ...).  Replaces the JAX package's
// scalar gather + segment-sum chains of the constraint operator:
//   ops/sparse.py  ConstraintOp.apply_from_e / apply_factored  (rows =
//                  constraints k, ptr over the k-sorted entries, col = a2p,
//                  x = pattern values e):  A(vec(M)) from M on the pattern
//   ops/sparse.py  ConstraintOp.adjoint_on_pattern / es_vals / s_vals
//                  (rows = pattern entries, ptr over a2p_sorted, col = kp,
//                  val = vp, x = multipliers w; base = c on the pattern and
//                  alpha = sigma or -1 fold es_vals and s_vals in)
// A row whose segment is empty (a pattern entry that only C touches)
// yields base[r] alone.
//
// Mode scatter_pos (``pos`` given): row r is written at position pos[r]
// instead of r,
//   y[pos[r]] = base[pos[r]] + alpha * sum_{e in ptr[r] .. ptr[r+1]} ...
// and y is left as the caller filled it everywhere else.  It replaces the
// scatter-adds of the JAX package's DenseConstraintOp
// (ops/sparse.py:401-409 adjoint_on_pattern, es_vals, s_vals): rows =
// distinct flat positions i*n + j of the A entries, ptr over the entries
// sorted by position, col = constraint k, x = multipliers w, y the dense
// (n, n) array pre-filled with base (C, for es / s) or 0 (the adjoint).
// Each position has one row, so one thread writes it: no atomics.
//
// One thread per row, entries summed in order: no atomics, deterministic.
// What bounds it on an H100: HBM traffic.  At the matrix-completion
// n = 12,000 shape a call reads ~nnzA * (4 + 8) B of col / val plus the
// pointer array and writes 8 B per row (about 0.15 GB for the 4.5 M
// constraints, 0.2 GB for the 9.0 M pattern entries in f64); the gathered
// x (72 MB or 36 MB) mostly misses L2.  Segments are 0-2 entries long
// here, so a warp per row would idle most lanes; adjacent threads read
// adjacent pointers and, in the k-sorted order, adjacent col / val.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_gather_kernel(const T* __restrict__ x, const int* __restrict__ ptr,
                  const int* __restrict__ col, const T* __restrict__ val,
                  const T* __restrict__ base, T alpha,
                  const int* __restrict__ pos, int nrows,
                  T* __restrict__ y) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= nrows) return;
  const int e1 = ptr[r + 1];
  T acc = T(0);
  for (int e = ptr[r]; e < e1; ++e) acc += val[e] * x[col[e]];
  const int at = pos != nullptr ? pos[r] : r;
  y[at] = base != nullptr ? base[at] + alpha * acc : alpha * acc;
}

template <typename T>
int launch(const void* x, const void* ptr, const void* col, const void* val,
           const void* base, double alpha, const void* pos, int nrows,
           void* y, void* stream) {
  if (nrows <= 0) return (int)cudaSuccess;
  const dim3 grid((nrows + kThreads - 1) / kThreads);
  csr_gather_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)ptr, (const int*)col, (const T*)val,
      (const T*)base, (T)alpha, (const int*)pos, nrows, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int csr_gather_f64(const void* x, const void* ptr, const void* col,
                   const void* val, const void* base, double alpha,
                   const void* pos, int nrows, void* y, void* stream) {
  return launch<double>(x, ptr, col, val, base, alpha, pos, nrows, y, stream);
}

int csr_gather_f32(const void* x, const void* ptr, const void* col,
                   const void* val, const void* base, double alpha,
                   const void* pos, int nrows, void* y, void* stream) {
  return launch<float>(x, ptr, col, val, base, alpha, pos, nrows, y, stream);
}

}  // extern "C"
