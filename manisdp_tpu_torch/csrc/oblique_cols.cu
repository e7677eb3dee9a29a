// K2: column operations of the oblique manifold on a (p, n) factor.
//
// Replaces manifolds/oblique.py Oblique.proj / tangent / transp / retr /
// renormalize of the JAX package (each a per-column reduction over the
// p rows followed by an elementwise pass):
//   mode 0 proj        : out = u - x o colsum(x o u)
//                        [- v o g]   (v (p, n), g (n,) given: the oblique
//                        Hessian epilogue eH - Y o colsum(Y o eH) - U o YeG
//                        of solvers/dual_al.py:123-124)
//   mode 1 retr        : out = (x + u) / ||x + u||_col
//   mode 2 renormalize : out = x / ||x||_col
// Masked mode (a 0/1 column mask given; replaces manifolds/product.py
// MaskedProduct.proj / retr / renormalize, the multiblock drivers'
// product geometry, and their masked Hessian epilogue
// eH - Y o (colsum(Y o eH) o mask) - U o YeG, solvers/multiblock.py:59-63,
// dual_multiblock.py:71-75): a column with mask 0 skips the projection
// (its colsum is multiplied by 0) and the normalization (divided by 1),
// as the JAX expressions do.  Without a mask every mode computes exactly
// what it did before.
// Instance mode (nb > 1; the batched MaxCut driver's (B, p, n) factor,
// replacing the jax.vmap of these ops in solvers/batch.py:78-87):
// blockIdx.y is the instance, x, u, v and out advance by p * n per
// instance and g by n; the mask, when given, is shared.
// Zero padding rows stay zero.  A zero column gives 0/0 = NaN, exactly
// as the JAX expressions do.
//
// Layout: x, u, out are contiguous row-major (p, n).  A block owns a tile
// of TC neighbouring columns of one instance (oblique_tile.cuh): its 256
// threads stage the tile's rows of x and u in shared memory by cp.async
// (a warp reads TC neighbouring entries of a row, so every load is
// coalesced along n), one thread per column runs the column's sum as a
// sequential chain over rows 0 .. p-1, and all threads write the outputs
// from the staged rows, so x and u are read from HBM once.  The sums keep
// the order of the earlier one-thread-a-column kernel and its bits.  The
// launcher picks TC (32, or 16 when 32 columns of p rows do not fit) and
// the rows R staged at a time (p, unless the tile would pass 64 KB: then
// the rows are staged in chunks and staged again for the outputs), so at
// least three blocks fit on an SM.  The grid is ceil(n / TC) x nb blocks:
// 313 at G67, 768 in the batch, against 40 and 96 for n / 256.
//
// What bounds it on an H100: bytes.  At n = 10^4, p_pad = 40 in f32 a
// call reads 2 * 1.6 MB and writes 1.6 MB, about 1.4 us at 3.35 TB/s, so
// at G67 a call costs its latency (the launch, one staged load, the
// chain, the stores) rather than its bytes; at p = 192 (the dual Hessian
// epilogue) the tile also reads v once, and the 115-229 tiles of
// n = 3,662 keep most SMs busy where n / 256 threads kept 15.

#include <cuda_runtime.h>
#include <stdint.h>

#include "oblique_tile.cuh"

namespace {

template <typename T, int TC>
__global__ void __launch_bounds__(kTileThreads)
oblique_tiles_kernel(const T* __restrict__ x, const T* __restrict__ u,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const T* __restrict__ mask, int p, int n, int rows,
                     int mode, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T ssum[TC];
  T* sx = reinterpret_cast<T*>(smem);
  T* su = sx + (int64_t)rows * TC;
  const int64_t inst = blockIdx.y, at = inst * p * (int64_t)n;
  x += at;
  out += at;
  if (u != nullptr) u += at;
  if (v != nullptr) v += at;
  if (g != nullptr) g += inst * n;
  const int j0 = blockIdx.x * TC;
  const Tile t{p, n, j0, min(TC, n - j0), rows};
  column_tile<T, TC>(
      t, mode, x, u, [](int64_t) { return T(0); },
      [out](int64_t o, T val) { out[o] = val; }, v, g, mask, sx, su, ssum);
}

template <typename T, int TC>
int launch_tiles(const void* x, const void* u, const void* v, const void* g,
                 const void* mask, int p, int n, int nb, int mode, int rows,
                 void* out, cudaStream_t stream) {
  auto kern = oblique_tiles_kernel<T, TC>;
  const size_t smem = (size_t)(mode == 2 ? 1 : 2) * rows * TC * sizeof(T);
  // the dynamic size allowed so far (the static ssum counts against the
  // 48 KB a launch gets without the attribute)
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((n + TC - 1) / TC, nb);
  kern<<<grid, kTileThreads, smem, stream>>>(
      (const T*)x, (const T*)u, (const T*)v, (const T*)g, (const T*)mask, p,
      n, rows, mode, (T*)out);
  return (int)cudaGetLastError();
}

// the shared memory a tile may take: at least three blocks an SM
constexpr size_t kTileBytes = 64 << 10;

template <typename T>
int launch(const void* x, const void* u, const void* v, const void* g,
           const void* mask, int p, int n, int nb, int mode, void* out,
           void* stream) {
  if (n <= 0 || p <= 0 || nb <= 0) return (int)cudaSuccess;
  int tc = 0, rows = 0;
  tile_plan<T>(p, kTileBytes, &tc, &rows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (tc == 16)
    return launch_tiles<T, 16>(x, u, v, g, mask, p, n, nb, mode, rows, out,
                               s);
  return launch_tiles<T, 32>(x, u, v, g, mask, p, n, nb, mode, rows, out, s);
}

}  // namespace

extern "C" {

int oblique_cols_f64(const void* x, const void* u, const void* v,
                     const void* g, const void* mask, int p, int n, int nb,
                     int mode, void* out, void* stream) {
  return launch<double>(x, u, v, g, mask, p, n, nb, mode, out, stream);
}

int oblique_cols_f32(const void* x, const void* u, const void* v,
                     const void* g, const void* mask, int p, int n, int nb,
                     int mode, void* out, void* stream) {
  return launch<float>(x, u, v, g, mask, p, n, nb, mode, out, stream);
}

}  // extern "C"
