// K5: the entrywise constraint carrier's elementwise algebra on dense
// row-major (n, n) arrays.
//
//   apply: out = dfac ∘ (aval ∘ E + (aval ∘ E)ᵀ)          A(M), dense rep
//   aat:   out = aval ∘ (dfac ∘ (aval ∘ E + (aval ∘ E)ᵀ))  mat(AᵀA vec(M))
//   axpy:  out = C + alpha · (aval ∘ W)   (C absent: 0)    es_vals, s_vals,
//                                                          adjoint
//
// Replaces the JAX package's EntrywiseConstraintOp algebra
// (manisdp_tpu/ops/sparse.py:551 apply_from_e, :558 adjoint_on_pattern,
// :561-565 es_vals / s_vals), which XLA runs as elementwise passes with a
// transpose; ``aat`` fuses adjoint_on_pattern(apply_from_e(E)), the AL
// Hessian's penalty term, into one pass instead of three.
//
// What bounds it on an H100: HBM bytes.  apply / aat read E, aval and dfac
// once and write out once (4 n² elements; at n = 4,000 in f32, 256 MB,
// ~0.08 ms at 3.35 TB/s).  The transpose is the design point: one CTA owns
// the tile pair (I, J) and (J, I) with I <= J, stages aval ∘ E of both tiles
// in shared memory (rows padded by one element, so the transposed read hits
// distinct banks) and writes both output tiles, so every element of E and
// aval is read once and every global access runs along a row (coalesced).
// axpy has no transpose: one thread per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;          // threads per tile column; 4 rows each
constexpr int kThreads = 256;

enum Mode { kApply = 0, kAat = 1, kAxpy = 2 };

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
masked_sym_tiles(const T* __restrict__ E, const T* __restrict__ aval,
                 const T* __restrict__ dfac, int n, int mode,
                 T* __restrict__ out) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;                   // the pair is owned by (bj, bi)
  __shared__ T ra[kTile][kTile + 1];      // aval ∘ E on tile (bi, bj)
  __shared__ T rb[kTile][kTile + 1];      // aval ∘ E on tile (bj, bi)
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < kTile; k += kRows) {
    int r = bi * kTile + k, c = bj * kTile + tx;
    if (r < n && c < n) {
      const size_t at = (size_t)r * n + c;
      ra[k][tx] = aval[at] * E[at];
    }
    r = bj * kTile + k;
    c = bi * kTile + tx;
    if (r < n && c < n) {
      const size_t at = (size_t)r * n + c;
      rb[k][tx] = aval[at] * E[at];
    }
  }
  __syncthreads();
  for (int k = ty; k < kTile; k += kRows) {
    int r = bi * kTile + k, c = bj * kTile + tx;
    if (r < n && c < n) {                // (r, c) + (c, r) from the pair
      const size_t at = (size_t)r * n + c;
      T v = dfac[at] * (ra[k][tx] + rb[tx][k]);
      out[at] = mode == kAat ? aval[at] * v : v;
    }
    if (bi == bj) continue;
    r = bj * kTile + k;
    c = bi * kTile + tx;
    if (r < n && c < n) {
      const size_t at = (size_t)r * n + c;
      T v = dfac[at] * (rb[k][tx] + ra[tx][k]);
      out[at] = mode == kAat ? aval[at] * v : v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_axpy(const T* __restrict__ W, const T* __restrict__ aval,
            const T* __restrict__ C, T alpha, size_t size,
            T* __restrict__ out) {
  for (size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x; t < size;
       t += (size_t)gridDim.x * kThreads) {
    const T v = alpha * (aval[t] * W[t]);
    out[t] = C != nullptr ? C[t] + v : v;
  }
}

template <typename T>
int launch(const void* E, const void* aval, const void* dfac, const void* C,
           double alpha, int n, int mode, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kAxpy) {
    const size_t size = (size_t)n * n;
    const size_t blocks = (size + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)(blocks < 132 * 32 ? blocks : 132 * 32));
    masked_axpy<T><<<grid, kThreads, 0, s>>>(
        (const T*)E, (const T*)aval, (const T*)C, (T)alpha, size, (T*)out);
  } else {
    const int tiles = (n + kTile - 1) / kTile;
    masked_sym_tiles<T><<<dim3(tiles, tiles), dim3(kTile, kRows), 0, s>>>(
        (const T*)E, (const T*)aval, (const T*)dfac, n, mode, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int masked_sym_f64(const void* E, const void* aval, const void* dfac,
                   const void* C, double alpha, int n, int mode, void* out,
                   void* stream) {
  return launch<double>(E, aval, dfac, C, alpha, n, mode, out, stream);
}

int masked_sym_f32(const void* E, const void* aval, const void* dfac,
                   const void* C, double alpha, int n, int mode, void* out,
                   void* stream) {
  return launch<float>(E, aval, dfac, C, alpha, n, mode, out, stream);
}

}  // extern "C"
