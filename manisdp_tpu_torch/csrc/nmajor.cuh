// The N-major copy that K1 (symcoo_spmm.cu) and K3 (pattern_dots.cu)
// gather from: columns off .. off + cnt - 1 of a (p, n) factor X with
// strides (sr, sc), instance b at X + b * sb, written to Xt (cnt, pp) at
// Xt + b * cnt * pp (row j of Xt is column off + j of X), rows p .. pp
// zero (pp: p rounded up to one 16-B vector); a sharded operator's
// kernels copy only the columns their entries read.  A block copies one 32 x 32
// tile through shared memory, reading along n and writing along p; each
// kernel that includes this wraps nmajor_tile in a __global__ of its own
// name and picks its factor and instance from blockIdx.z.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct NmajorCopy {
  const T* x;
  int64_t sb, sr, sc;
  T* xt;
  int off;
};

// a or b, field by field: a ternary between the two structs would take
// the address of a kernel parameter and put both on the stack
template <typename T>
__device__ __forceinline__ NmajorCopy<T> nmajor_pick(const NmajorCopy<T>& a,
                                                     const NmajorCopy<T>& b,
                                                     bool second) {
  return {second ? b.x : a.x,   second ? b.sb : a.sb,
          second ? b.sr : a.sr, second ? b.sc : a.sc,
          second ? b.xt : a.xt, second ? b.off : a.off};
}

// launch with 32 x 8 threads on nmajor_grid(n, pp, z); n: the columns
// copied (cnt)
template <typename T>
__device__ __forceinline__ void nmajor_tile(const NmajorCopy<T> c,
                                            int64_t inst, int p, int n,
                                            int pp) {
  __shared__ T tile[32][33];
  const T* X = c.x + inst * c.sb + (int64_t)c.off * c.sc;
  T* Xt = c.xt + inst * n * pp;
  const int j0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < 32; k += 8) {
    const int r = r0 + k, j = j0 + tx;
    tile[k][tx] = (r < p && j < n) ? X[(int64_t)r * c.sr + (int64_t)j * c.sc]
                                   : T(0);
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int j = j0 + k, r = r0 + tx;
    if (j < n && r < pp) Xt[(int64_t)j * pp + r] = tile[tx][k];
  }
}

inline dim3 nmajor_grid(int n, int pp, int z) {
  return dim3((n + 31) / 32, (pp + 31) / 32, z);
}

}  // namespace
