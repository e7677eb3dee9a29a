// The column tile that K2 (oblique_cols.cu) and K11's projected step
// (tcg_step.cu) share: TC neighbouring columns of one (p, n) row-major
// factor, staged in shared memory R rows at a time, with one thread per
// column running the column's sum as one sequential chain over rows
// 0 .. p-1 (the order of the earlier one-thread-a-column kernel, so the
// bits are the same), while all threads of the block share the loads
// and stores.
//
// The chains (each multiply-add an explicit fma, as nvcc contracted the
// earlier kernel's `s += a * b`):
//   proj        s = fma(x, u, s);   s = s * mask       out = fma(x, -s, u)
//                                   [- v g: out = fma(-g, v, out)]
//   retr        w = x + u;  s = fma(w, w, s)           out = w / nrm
//   renormalize s = fma(x, x, s)                       out = x / nrm
// with nrm = sqrt(s), or 1 on a column whose mask is 0.  A zero column
// gives 0/0 = NaN, as the JAX expressions do.
//
// Shared memory: sx (R, TC) and su (R, TC), so 2 R TC entries; when R < p
// the sums walk the row chunks in order and the outputs stage each chunk
// again (the last chunk of the sums is still staged and is written first).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileThreads = 256;

// The tile for p rows of T in ``budget`` bytes of shared memory: TC = 32
// columns, or 16 where 32 columns of x and u over p rows pass the budget,
// and R = p rows staged at once, or fewer (the rows in chunks, staged
// again for the outputs) where even 16 columns do not fit.
template <typename T>
inline void tile_plan(int p, size_t budget, int* tc, int* rows) {
  for (int c : {32, 16}) {
    if ((size_t)2 * p * c * sizeof(T) <= budget) {
      *tc = c;
      *rows = p;
      return;
    }
  }
  *tc = 16;
  *rows = std::max(1, (int)(budget / (2 * 16 * sizeof(T))));
}

template <typename T>
__device__ __forceinline__ T tile_sqrt(T v);
template <>
__device__ __forceinline__ double tile_sqrt<double>(double v) {
  return sqrt(v);
}
template <>
__device__ __forceinline__ float tile_sqrt<float>(float v) {
  return sqrtf(v);
}

// IEEE fused multiply-add, never regrouped by the compiler
template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b,
                                                double c) {
  return __fma_rn(a, b, c);
}
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// one element global -> shared, asynchronously (4 or 8 bytes, via L1)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the tile's geometry: columns j0 .. j0 + tc - 1 of a row-major (p, n)
struct Tile {
  int p, n, j0, tc, R;
};

// Stage rows r0 .. r0 + rc - 1 of the tile.  x arrives by cp.async, and
// so does u where ``u`` is given; otherwise u's entries come from
// load_u(offset), so a caller can form them on the fly (K11: r + beta d).
// Ends with every entry in shared memory.
template <typename T, int TC, bool TWO, class LoadU>
__device__ __forceinline__ void tile_stage(const Tile& t, int r0, int rc,
                                           const T* __restrict__ x,
                                           const T* __restrict__ u,
                                           LoadU load_u, T* sx, T* su) {
  for (int idx = threadIdx.x; idx < rc * TC; idx += kTileThreads) {
    const int r = idx / TC, c = idx % TC;
    if (c < t.tc) {
      const int64_t o = (int64_t)(r0 + r) * t.n + t.j0 + c;
      cp_async_elem(sx + idx, x + o);
      if (TWO) {
        if (u != nullptr)
          cp_async_elem(su + idx, u + o);
        else
          su[idx] = load_u(o);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// mode 0 proj, 1 retr, 2 renormalize: the column chain over the staged
// rows, continuing s
template <typename T, int TC>
__device__ __forceinline__ T tile_chain(int mode, int rc, const T* sx,
                                        const T* su, T s) {
  const int c = threadIdx.x;
  if (mode == 0) {
    for (int r = 0; r < rc; ++r)
      s = fma_t(sx[r * TC + c], su[r * TC + c], s);
  } else if (mode == 1) {
    for (int r = 0; r < rc; ++r) {
      const T w = sx[r * TC + c] + su[r * TC + c];
      s = fma_t(w, w, s);
    }
  } else {
    for (int r = 0; r < rc; ++r)
      s = fma_t(sx[r * TC + c], sx[r * TC + c], s);
  }
  return s;
}

// The whole tile: sums, then outputs written through store(offset, value).
// u: the second operand in memory, or null and formed by load_u; v / g:
// proj's - v g term (g indexed by column), or null.
template <typename T, int TC, class LoadU, class Store>
__device__ __forceinline__ void column_tile(const Tile& t, int mode,
                                            const T* __restrict__ x,
                                            const T* __restrict__ u,
                                            LoadU load_u, Store store,
                                            const T* __restrict__ v,
                                            const T* __restrict__ g,
                                            const T* __restrict__ mask,
                                            T* sx, T* su, T* ssum) {
  const int nchunk = (t.p + t.R - 1) / t.R;
  const bool two = mode != 2;
  const int c = threadIdx.x;
  T s = T(0);
  for (int ch = 0; ch < nchunk; ++ch) {
    const int r0 = ch * t.R, rc = min(t.R, t.p - r0);
    if (ch > 0) __syncthreads();  // the previous chunk's sums are done
    if (two)
      tile_stage<T, TC, true>(t, r0, rc, x, u, load_u, sx, su);
    else
      tile_stage<T, TC, false>(t, r0, rc, x, u, load_u, sx, su);
    if (c < t.tc) s = tile_chain<T, TC>(mode, rc, sx, su, s);
  }
  if (c < t.tc) {
    const int j = t.j0 + c;
    if (mode == 0) {
      ssum[c] = mask != nullptr ? s * mask[j] : s;
    } else {
      const bool skip = mask != nullptr && !(mask[j] > T(0));
      ssum[c] = skip ? T(1) : tile_sqrt<T>(s);
    }
  }
  __syncthreads();
  for (int k = 0; k < nchunk; ++k) {
    const int ch = k == 0 ? nchunk - 1 : k - 1;
    const int r0 = ch * t.R, rc = min(t.R, t.p - r0);
    if (k > 0) {
      __syncthreads();  // every output of the previous chunk is written
      if (two)
        tile_stage<T, TC, true>(t, r0, rc, x, u, load_u, sx, su);
      else
        tile_stage<T, TC, false>(t, r0, rc, x, u, load_u, sx, su);
    }
    for (int idx = threadIdx.x; idx < rc * TC; idx += kTileThreads) {
      const int r = idx / TC, cc = idx % TC;
      if (cc >= t.tc) continue;
      const int64_t o = (int64_t)(r0 + r) * t.n + t.j0 + cc;
      const T xv = sx[idx];
      T out;
      if (mode == 0) {
        out = fma_t(xv, -ssum[cc], su[idx]);
        if (v != nullptr) out = fma_t(-g[t.j0 + cc], v[o], out);
      } else if (mode == 1) {
        out = (xv + su[idx]) / ssum[cc];
      } else {
        out = xv / ssum[cc];
      }
      store(o, out);
    }
  }
}

}  // namespace
