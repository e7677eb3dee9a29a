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
//     are in flight at once, and consecutive groups take consecutive
//     entries, so each step's outputs are written coalesced.
//  3. A row is walked in chunks of 2G vectors (two per lane); NCH <= 4
//     chunks are held in registers per pass, and a later pass (rows of
//     more than 4 chunks: p > 512 in f64 at G = 32) adds its partial dot
//     to out[e] (same thread, program order).
// Every out[e] has one writer and a fixed summation order: no atomics, a
// call repeats bit for bit.

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

// Yt (and Ut when U is not Y, blockIdx.z = 1) from the factors
template <typename T>
__global__ void __launch_bounds__(256)
transpose_pad(NmajorCopy<T> y, NmajorCopy<T> u, int p, int n, int pp) {
  nmajor_tile(nmajor_pick(y, u, blockIdx.z != 0), 0, p, n, pp);
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pattern_dots_kernel(const T* __restrict__ Yt, const T* __restrict__ Ut,
                    int pp, const int* __restrict__ colptr,
                    const int* __restrict__ rows, int n,
                    T* __restrict__ out) {
  using V = typename Vec<T>::type;
  constexpr int kVec = 16 / sizeof(T);      // scalars per vector
  constexpr int kChunk = 2 * G;             // vectors per chunk
  constexpr int NG = 32 / G;                // entries per warp step
  constexpr int EIF = NCH >= 4 ? 1 : 4 / NCH;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;  // whole warp leaves together
  const int grp = lane / G, gl = lane % G;
  const int nvec = pp / kVec;
  const int e0 = colptr[j], e1 = colptr[j + 1];
  const V zero = {};
  const V* __restrict__ yv = reinterpret_cast<const V*>(Yt);
  const V* __restrict__ uv = reinterpret_cast<const V*>(Ut) +
                             (int64_t)j * nvec;

  for (int c0 = 0; c0 * kChunk < nvec; c0 += NCH) {
    // this lane's vectors of the column's U row: c * kChunk + gl (+ G)
    V u[NCH][2];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = (c0 + c) * kChunk + gl + h * G;
        u[c][h] = v < nvec ? __ldg(uv + v) : zero;
      }
    for (int eb = e0; eb < e1; eb += NG * EIF) {
      T s[EIF];
#pragma unroll
      for (int q = 0; q < EIF; ++q) {
        const int e = eb + q * NG + grp;
        s[q] = T(0);
        if (e < e1) {
          const V* __restrict__ row = yv + (int64_t)__ldg(rows + e) * nvec;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v = (c0 + c) * kChunk + gl + h * G;
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
        if (gl == 0 && e < e1) out[e] = c0 == 0 ? s[q] : out[e] + s[q];
      }
    }
  }
}

template <typename T, int G>
void launch_g(const T* Yt, const T* Ut, int pp, const int* colptr,
              const int* rows, int n, int nch, T* out, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (nch <= 1)
    pattern_dots_kernel<T, G, 1><<<grid, block, 0, s>>>(Yt, Ut, pp, colptr,
                                                        rows, n, out);
  else if (nch <= 2)
    pattern_dots_kernel<T, G, 2><<<grid, block, 0, s>>>(Yt, Ut, pp, colptr,
                                                        rows, n, out);
  else
    pattern_dots_kernel<T, G, 4><<<grid, block, 0, s>>>(Yt, Ut, pp, colptr,
                                                        rows, n, out);
}

template <typename T>
int launch(const void* Y, int64_t syr, int64_t syc, const void* U,
           int64_t sur, int64_t suc, const void* colptr, const void* rows,
           int p, int n, int pp, int group, void* Yt, void* Ut, void* out,
           void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  if (pp < p || pp % kVec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const NmajorCopy<T> cy{(const T*)Y, 0, syr, syc, (T*)Yt};
  const NmajorCopy<T> cu{(const T*)U, 0, sur, suc, (T*)Ut};
  transpose_pad<T><<<nmajor_grid(n, pp, U != nullptr ? 2 : 1), dim3(32, 8),
                     0, s>>>(cy, cu, p, n, pp);
  const T* ut = U != nullptr ? (const T*)Ut : (const T*)Yt;
  const int nvec = pp / kVec;
  const int nch = (nvec + 2 * group - 1) / (2 * group);
#define K3_ARGS (const T*)Yt, ut, pp, (const int*)colptr, (const int*)rows, \
                n, nch, (T*)out, s
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
int pattern_dots_f64(const void* Y, int64_t syr, int64_t syc, const void* U,
                     int64_t sur, int64_t suc, const void* colptr,
                     const void* rows, int p, int n, int pp, int group,
                     void* Yt, void* Ut, void* out, void* stream) {
  return launch<double>(Y, syr, syc, U, sur, suc, colptr, rows, p, n, pp,
                        group, Yt, Ut, out, stream);
}

int pattern_dots_f32(const void* Y, int64_t syr, int64_t syc, const void* U,
                     int64_t sur, int64_t suc, const void* colptr,
                     const void* rows, int p, int n, int pp, int group,
                     void* Yt, void* Ut, void* out, void* stream) {
  return launch<float>(Y, syr, syc, U, sur, suc, colptr, rows, p, n, pp,
                       group, Yt, Ut, out, stream);
}

}  // extern "C"
