// K3: pair dots of two factors over a sparsity pattern (an SDDMM).
//
// Replaces the JAX package's gather / multiply / row-sum chain
//   ops/sparse.py  pair_dots, ConstraintOp.pattern_pair_dots
// which the primal AL runs in every cost, Hessian product and stats call:
//
//   out[e] = sum_r Y[r, i_e] * U[r, j_e]     for every pattern entry e
//
// The pattern is sorted by (column j, row i), so colptr[j] .. colptr[j+1]
// delimits column j's entries.
//
// Cost model on an H100.  The factors are (p, n) with any strides; at
// matrix completion n = 12,000 (nnzP = 9.0 M, p_pad 8-24) a factor is
// 0.8-2.3 MB and stays in L2.  Each entry gathers one p-vector of Y.  In
// the (p, n) row-major layout the p values of one column sit n * 8 B apart,
// so a gather touches p separate 32-B sectors (16 per entry at p 16, ~4.6
// GB of L2 sector traffic per call in f64); in an N-major (n, p) copy the
// same vector is p * sizeof(T) contiguous bytes: 4 sectors in f64, 2 in
// f32 (~1.2 / 0.6 GB).  HBM traffic is the pattern's row index (4 B) and
// the output (8 / 4 B) per entry: 108 / 72 MB.
//
// Design:
//  1. transpose_pad writes Yᵀ (and Uᵀ when U is not Y, in the same
//     launch) into (n, pp) scratch the wrapper allocates, pp = p rounded
//     up to one 16-B vector, the rows beyond p zero (nmajor.cuh, shared
//     with K1).  It is part of every K3 call.
//  2. pattern_dots_kernel: one warp per column j; its lanes form 32 / G
//     groups of G lanes, and each group takes one entry at a time.  A
//     group loads the entry's Yᵀ row with 16-B vector loads (G = the
//     largest power of two that leaves each lane at least two of the
//     row's pp / vec vectors, at most 32: fewer lanes per entry keep more
//     entries in flight), dots it with the column's Uᵀ row, held in
//     registers for the whole column, and reduces in log2(G) xor shuffles.  EIF entries per group
//     are in flight at once (8 / NCH: a lane holds up to 8 rows' vectors),
//     and consecutive groups take consecutive entries, so each step's
//     outputs are written coalesced.  The row indices of the next step are
//     loaded before this step's rows, so a step waits one L2 round trip
//     and not an index load followed by a row load.
//  3. A row is walked in chunks of 2G vectors (two per lane); NCH <= 4
//     chunks are held in registers per pass, and a later pass (rows of
//     more than 4 chunks: p > 512 in f64 at G = 32) adds its partial dot
//     to out[e] (same thread, program order).
// Column range (the sharded operator's shards): a shard's pattern holds
// the entries of columns c0 .. c0 + nc - 1 only, so the warps cover those
// columns, U's copy holds those columns and Y's the rows r0 .. r0 + nr - 1
// its entries read (when U is Y, one copy over the union of the two).
// Every out[e] has one writer and a fixed summation order: no atomics, a
// call repeats bit for bit, whatever the range.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nmajor.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; };
template <> struct Vec<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ T vdot(typename Vec<T>::type a,
                                  typename Vec<T>::type b);
template <>
__device__ __forceinline__ double vdot<double>(double2 a, double2 b) {
  return a.x * b.x + a.y * b.y;
}
template <>
__device__ __forceinline__ float vdot<float>(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Yt (ny columns of Y) and Ut when U is not Y (nu columns of U, blockIdx.z
// = 1) from the factors
template <typename T>
__global__ void __launch_bounds__(256)
transpose_pad(NmajorCopy<T> y, NmajorCopy<T> u, int p, int ny, int nu,
              int pp) {
  const bool second = blockIdx.z != 0;
  nmajor_tile(nmajor_pick(y, u, second), 0, p, second ? nu : ny, pp);
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pattern_dots_kernel(const T* __restrict__ Yt, const T* __restrict__ Ut,
                    int pp, const int* __restrict__ colptr,
                    const int* __restrict__ rows, int c0, int nc, int yoff,
                    int uoff, T* __restrict__ out) {
  using V = typename Vec<T>::type;
  constexpr int kVec = 16 / sizeof(T);      // scalars per vector
  constexpr int kChunk = 2 * G;             // vectors per chunk
  constexpr int NG = 32 / G;                // entries per warp step
  constexpr int EIF = NCH >= 4 ? 2 : 8 / NCH;
  const int lane = threadIdx.x & 31;
  const int j = c0 + blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= c0 + nc) return;  // whole warp leaves together
  const int grp = lane / G, gl = lane % G;
  const int nvec = pp / kVec;
  const int e0 = colptr[j], e1 = colptr[j + 1];
  const V zero = {};
  const V* __restrict__ yv = reinterpret_cast<const V*>(Yt);
  const V* __restrict__ uv = reinterpret_cast<const V*>(Ut) +
                             (int64_t)(j - uoff) * nvec;

  for (int cb = 0; cb * kChunk < nvec; cb += NCH) {
    // this lane's vectors of the column's U row: c * kChunk + gl (+ G)
    V u[NCH][2];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = (cb + c) * kChunk + gl + h * G;
        u[c][h] = v < nvec ? __ldg(uv + v) : zero;
      }
    // the row indices of the next step are loaded before this step's
    // rows are read
    int ix[EIF];
#pragma unroll
    for (int q = 0; q < EIF; ++q) {
      const int e = e0 + q * NG + grp;
      ix[q] = e < e1 ? __ldg(rows + e) : 0;
    }
    for (int eb = e0; eb < e1; eb += NG * EIF) {
      T s[EIF];
      int cur[EIF];
#pragma unroll
      for (int q = 0; q < EIF; ++q) {
        const int e = eb + NG * EIF + q * NG + grp;
        cur[q] = ix[q];
        ix[q] = e < e1 ? __ldg(rows + e) : 0;
      }
#pragma unroll
      for (int q = 0; q < EIF; ++q) {
        const int e = eb + q * NG + grp;
        s[q] = T(0);
        if (e < e1) {
          const V* __restrict__ row = yv + (int64_t)(cur[q] - yoff) * nvec;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v = (cb + c) * kChunk + gl + h * G;
              if (v < nvec) s[q] += vdot<T>(__ldg(row + v), u[c][h]);
            }
        }
      }
#pragma unroll
      for (int q = 0; q < EIF; ++q) {
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          s[q] += __shfl_xor_sync(kFull, s[q], off);
        const int e = eb + q * NG + grp;
        if (gl == 0 && e < e1) out[e] = cb == 0 ? s[q] : out[e] + s[q];
      }
    }
  }
}

template <typename T, int G>
void launch_g(const T* Yt, const T* Ut, int pp, const int* colptr,
              const int* rows, int c0, int nc, int yoff, int uoff, int nch,
              T* out, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((nc + kWarpsPerBlock - 1) / kWarpsPerBlock);
#define K3_KERNEL_ARGS Yt, Ut, pp, colptr, rows, c0, nc, yoff, uoff, out
  if (nch <= 1)
    pattern_dots_kernel<T, G, 1><<<grid, block, 0, s>>>(K3_KERNEL_ARGS);
  else if (nch <= 2)
    pattern_dots_kernel<T, G, 2><<<grid, block, 0, s>>>(K3_KERNEL_ARGS);
  else
    pattern_dots_kernel<T, G, 4><<<grid, block, 0, s>>>(K3_KERNEL_ARGS);
#undef K3_KERNEL_ARGS
}

// columns c0 .. c0 + nc - 1 of the pattern, whose entries read the rows
// r0 .. r0 + nr - 1 of Y; U null: U is Y (one copy, over the union of the
// two ranges; Ut unused)
template <typename T>
int launch(const void* Y, int64_t syr, int64_t syc, const void* U,
           int64_t sur, int64_t suc, const void* colptr, const void* rows,
           int p, int n, int pp, int group, void* Yt, void* Ut, void* out,
           int c0, int nc, int r0, int nr, void* stream) {
  if (nc <= 0 || p <= 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  if (pp < p || pp % kVec != 0 || c0 < 0 || c0 + nc > n || r0 < 0 ||
      nr < 0 || r0 + nr > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool same = U == nullptr;
  // Y's copy: rows r0 .. of Y (with U, its columns c0 .. too)
  const int yoff = same && nr > 0 ? min(r0, c0) : (same ? c0 : r0);
  const int ny = same ? (nr > 0 ? max(r0 + nr, c0 + nc) : c0 + nc) - yoff
                      : nr;
  const NmajorCopy<T> cy{(const T*)Y, 0, syr, syc, (T*)Yt, yoff};
  const NmajorCopy<T> cu{(const T*)U, 0, sur, suc, (T*)Ut, c0};
  transpose_pad<T><<<nmajor_grid(same ? ny : max(ny, nc), pp, same ? 1 : 2),
                     dim3(32, 8), 0, s>>>(cy, cu, p, ny, nc, pp);
  const T* ut = same ? (const T*)Yt : (const T*)Ut;
  const int uoff = same ? yoff : c0;
  const int nvec = pp / kVec;
  const int nch = (nvec + 2 * group - 1) / (2 * group);
#define K3_ARGS (const T*)Yt, ut, pp, (const int*)colptr, (const int*)rows, \
                c0, nc, yoff, uoff, nch, (T*)out, s
  switch (group) {
    case 1: launch_g<T, 1>(K3_ARGS); break;
    case 2: launch_g<T, 2>(K3_ARGS); break;
    case 4: launch_g<T, 4>(K3_ARGS); break;
    case 8: launch_g<T, 8>(K3_ARGS); break;
    case 16: launch_g<T, 16>(K3_ARGS); break;
    case 32: launch_g<T, 32>(K3_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// U null: U is Y (one transpose, Ut unused)
#define K3_EXPORT(SUF, T)                                                    \
  int pattern_dots_##SUF(const void* Y, int64_t syr, int64_t syc,           \
                         const void* U, int64_t sur, int64_t suc,           \
                         const void* colptr, const void* rows, int p, int n,\
                         int pp, int group, void* Yt, void* Ut, void* out,  \
                         int c0, int nc, int r0, int nr, void* stream) {    \
    return launch<T>(Y, syr, syc, U, sur, suc, colptr, rows, p, n, pp,      \
                     group, Yt, Ut, out, c0, nc, r0, nr, stream);           \
  }

K3_EXPORT(f64, double)
K3_EXPORT(f32, float)

#undef K3_EXPORT

}  // extern "C"
