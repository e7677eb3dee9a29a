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
// Modes (runtime int):
//   0 plain : out = A M
//   1 shift : out = A M - z_j A[:, j]
//   2 cost  : out = A M,  w_j = sum_r out[r, j] * A[r, j]
//   3 hess  : out = A M - B[:, j] * sum_r(B[r, j] * (A M)[r, j]) - A[:, j] eG_j
//             (A = U, B = Y)
//   4 al_hess      : out = H := c1 * A M + c2 * B M2, where M2 has C's
//                    pattern and the values vals2 (one walk over the
//                    column gathers both factors)
//   5 al_hess_diag : out = H - B[:, j] * sum_r(B[r, j] H[r, j]) - A[:, j] eG_j
//                    (the unit-diagonal AL Hessian: A = U, B = Y,
//                    M = mat(es), M2 = mat(A'A vec(Y'U)), c1 = 2,
//                    c2 = 4 sigma, eG = colsum(Y o grad))
//
// Design (an N-major gather):
//  1. spmm_nmajor writes each gathered factor whose stride along p is not
//     1 (A, and B in modes 4-5) into an (n, pp) scratch the wrapper
//     allocates, pp = p rounded up to one 16-B vector, rows p .. pp zero
//     (nmajor.cuh, shared with K3); per instance in instance mode, both
//     factors in one launch.  A factor
//     that is N-major already (the V^T views of matvec_block) is gathered
//     where it lies, with 16-B loads where its rows allow and scalar loads
//     otherwise (kernels.symcoo_spmm_layout picks, in Python).
//  2. symcoo_spmm_kernel: a block owns 16 consecutive output columns; its
//     threads are (column, vector) pairs, the column's threads reading
//     consecutive 16-B vectors of each entry's row of the copy, so one
//     entry costs ceil(p * size / 32) sectors instead of p, and no lane of
//     a narrow factor idles (a warp serves 32 / nvec columns).  Each
//     thread walks its column's entries with four rows in flight (two in
//     the shallow two-factor walk, item 4).  Rows are taken in chunks of
//     32 vectors (32, 64 or 128 rows).
//  3. The chunk's products go to a shared-memory tile of the 16 columns;
//     the epilogue and the stores run from the tile with consecutive
//     threads on consecutive columns, so the (p, n) output is written in
//     runs of 16 columns, not a sector per element.  The epilogue's tiles
//     of A and B are copied to shared memory asynchronously (cp.async)
//     before the gather starts, so their loads overlap it.
//  4. Columns of more than 8 entries on average (mc-12000: ~750) take the
//     deep walk: the next four entries' indices and values are loaded
//     before the current four rows are used, up to 128 registers a thread.
//     Short columns (G67, the batch: ~5) take the shallow one; its
//     one-factor walk is capped at 64 registers so that two blocks share
//     an SM.
//
// Exact order (bit-equal to the warp-per-column kernel it replaces):
// every output element (r, j) is one fma chain acc += v_e * x[i_e, r]
// over e = colptr[j] .. colptr[j+1]-1 in entry order from acc = 0, and
// al_hess takes c1 * acc + c2 * acc2.  The epilogue column sums keep
// that kernel's tree: the partial x_l over rows l, l + 32, l + 64, ... in
// row order (an fma chain from 0), then the xor butterfly over the 32
// partials (offsets 16, 8, 4, 2, 1), here unrolled on one thread per
// column from the partials staged in shared memory.  A column of more than
// one chunk continues its partials across chunks (chunks are multiples of
// 32 rows), and the Hessian epilogues' second pass gathers each chunk
// again, as the old second pass did.  No atomics: a call repeats bit for
// bit.
//
// What bounds it on an H100 (bytes; the factor and the pattern stay in
// the 50 MB L2, so the gathers are L2 sector traffic):
//  - G67 (n = 10^4, nnz = 5 * 10^4, p_pad 40, f64): bound 2.1 us (the
//    factor, C's arrays, the output).  An entry's p-major gather touched
//    40 sectors (64 MB a call); the copy's row is 320 B, 10 sectors (16 MB),
//    plus the transpose's 3.2 MB read and write.  Launch latency dominates.
//  - mc-12000 al_hess (nnz 9,000,440, p 16): two factors gathered a
//    entry, 2 x 16 sectors before (9.2 GB of L2 sectors a call), now
//    2 x 2 (f32, 1.15 GB) or 2 x 4 (f64, 2.3 GB), against the bound's
//    HBM bytes (the pattern's rows and two value arrays, 108 / 144 MB):
//    the L2 rate, not HBM, sets the floor.
//  - the sparse batch (8 instances of n 3,072, ~5 entries a column, p 40 /
//    48, f64): 10 / 12 sectors an entry instead of 40 / 48; a few
//    microseconds of transpose and gather, launch-bound like G67.
//
// Instance mode (B19; replaces the jax.vmap of these products over a
// batch of MaxCut instances, solvers/batch.py:68-98 with the padded
// SymCOO arrays of :52-65): nb instances of one padded size n in one
// launch sequence, blockIdx.y the instance.  A, B, their copies and out
// advance by their instance strides, z, eG and w by n, and each instance
// has its own column pointer (row inst of an (nb, n+1) array, local to
// its entries) and its first entry eoff[inst] (int64) in the concatenated
// rows / vals / vals2.  A padding column j >= n_inst has an empty
// segment, so its product is exactly 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nmajor.cuh"

namespace {

constexpr int kCols = 16;    // output columns per block
constexpr int kLd = kCols + 1;  // row stride of the shared-memory tiles
constexpr int kChunk = 32;   // vectors per row chunk (the threads of a column)

// a gathered factor: row i of instance b at x + b * sb + i * ld (N-major)
template <typename T>
struct Gather {
  const T* x;
  int64_t sb, ld;
};

template <typename T>
struct Args {
  const T* A;  // (p, n) factor, strides (sab, sar, sac): the epilogue's reads
  int64_t sab, sar, sac;
  Gather<T> ga;
  const int* colptr;
  const int64_t* eoff;
  const int* rows;
  const T* vals;
  int p, n, pp, mode;
  const T* z;
  const T* B;
  int64_t sbb, sbr, sbc;
  Gather<T> gb;
  const T* eG;
  const T* vals2;
  T c1, c2;
  T* out;
  T* w;
};

template <typename T, int VW>
__device__ __forceinline__ void load_vec(T (&x)[VW], const T* __restrict__ p) {
  if constexpr (VW == 1) {
    x[0] = __ldg(p);
  } else if constexpr (VW == 2) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
}

// acc (+ acc2) over the column's entries e0 .. e1 in entry order, the
// rows of the copies at ag (+ bg), AHEAD entries' rows in flight; DEEP
// (long columns) loads the next AHEAD entries' indices and values before
// the current rows are used
template <typename T, int VW, bool TWO, bool DEEP, int AHEAD>
__device__ __forceinline__ void gather(
    T (&acc)[VW], T (&acc2)[VW], const T* __restrict__ ag, int64_t lda,
    const T* __restrict__ bg, int64_t ldb, const int* __restrict__ rows,
    const T* __restrict__ vals, const T* __restrict__ vals2, int e0,
    int e1) {
#pragma unroll
  for (int k = 0; k < VW; ++k) acc[k] = acc2[k] = T(0);
  int ii[AHEAD] = {};
  T vv[AHEAD] = {}, vv2[AHEAD] = {};
  auto entries = [&](int e) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (e + u < e1) {
        ii[u] = __ldg(rows + e + u);
        vv[u] = __ldg(vals + e + u);
        if (TWO) vv2[u] = __ldg(vals2 + e + u);
      }
  };
  if (DEEP) entries(e0);
  for (int e = e0; e < e1; e += AHEAD) {
    if (!DEEP) entries(e);
    T x[AHEAD][VW], y[AHEAD][VW], v[AHEAD], v2[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (e + u < e1) {
        load_vec<T, VW>(x[u], ag + (int64_t)ii[u] * lda);
        if (TWO) load_vec<T, VW>(y[u], bg + (int64_t)ii[u] * ldb);
        v[u] = vv[u];
        if (TWO) v2[u] = vv2[u];
      }
    if (DEEP) entries(e + AHEAD);
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (e + u < e1) {
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          acc[k] = fma(v[u], x[u][k], acc[k]);
          if (TWO) acc2[k] = fma(v2[u], y[u][k], acc2[k]);
        }
      }
  }
}

// the 32-lane xor butterfly (offsets 16, 8, 4, 2, 1) of the partials
// xs[0..31][jj], unrolled on one thread: every lane of the butterfly ends
// with this value
template <typename T>
__device__ __forceinline__ T butterfly32(const T* xs, int jj) {
  T y[16];
#pragma unroll
  for (int l = 0; l < 16; ++l)
    y[l] = xs[l * kLd + jj] + xs[(l + 16) * kLd + jj];
#pragma unroll
  for (int l = 0; l < 8; ++l) y[l] = y[l] + y[l + 8];
#pragma unroll
  for (int l = 0; l < 4; ++l) y[l] = y[l] + y[l + 4];
  y[0] = y[0] + y[2];
  y[1] = y[1] + y[3];
  return y[0] + y[1];
}

// the shallow one-factor walk: two blocks an SM (64 registers a thread);
// the others may take 128 (the shallow two-factor walk keeps two entries
// in flight)
template <typename T, int VW, bool TWO, bool DEEP>
__global__ void __launch_bounds__(kCols * kChunk, DEEP || TWO ? 1 : 2)
symcoo_spmm_kernel(Args<T> g) {
  constexpr int kAhead = DEEP || !TWO ? 4 : 2;
  const int nt = blockDim.x;
  const int cv = nt / kCols;               // vectors of this call's chunks
  const int rc = cv * VW;                  // rows of a chunk
  const int t = threadIdx.x;
  const int jj = t / cv, v = t - jj * cv;  // gather role
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + jj;
  const int n = g.n, p = g.p, mode = g.mode;
  const int nvec = g.pp / VW;
  const int nchunk = (nvec + cv - 1) / cv;

  // instance mode: move every pointer to instance blockIdx.y
  const int64_t inst = blockIdx.y;
  const int64_t eb = g.eoff != nullptr ? g.eoff[inst] : 0;
  const T* A = g.A + inst * g.sab;
  const T* ag = g.ga.x + inst * g.ga.sb;
  const int* colptr = g.colptr + inst * (n + 1);
  const int* rows = g.rows + eb;
  const T* vals = g.vals + eb;
  T* out = g.out + inst * p * n;
  const T* z = g.z != nullptr ? g.z + inst * n : nullptr;
  const T* B = g.B != nullptr ? g.B + inst * g.sbb : nullptr;
  const T* bg = TWO ? g.gb.x + inst * g.gb.sb : nullptr;
  const T* eG = g.eG != nullptr ? g.eG + inst * n : nullptr;
  const T* vals2 = TWO ? g.vals2 + eb : nullptr;
  T* w = g.w != nullptr ? g.w + inst * n : nullptr;
  const int e0 = j < n ? colptr[j] : 0, e1 = j < n ? colptr[j + 1] : 0;
  const bool need_a = mode == 1 || mode == 2 || mode == 3 || mode == 5;
  const bool need_b = mode == 3 || mode == 5;
  const bool reduce = mode == 2 || mode == 3 || mode == 5;

  // shared memory (smem_bytes): the chunk's products, A's and B's tiles
  // where the epilogue reads them (rc x kLd each), the 32 partials of the
  // 16 columns and their sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* sa = tile + rc * kLd;
  T* sb = sa + (need_a ? rc * kLd : 0);
  T* xs = sb + (need_b ? rc * kLd : 0);
  T* ssum = xs + 32 * kLd;

  // chunk c's products -> tile[row][column]
  auto compute = [&](int c) {
    T acc[VW], acc2[VW];
    const int vg = c * cv + v;
    if (vg < nvec) {
      gather<T, VW, TWO, DEEP, kAhead>(acc, acc2, ag + vg * VW, g.ga.ld,
                         TWO ? bg + vg * VW : nullptr, g.gb.ld, rows, vals,
                         vals2, e0, e1);
      if (TWO) {
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[k] = g.c1 * acc[k] + g.c2 * acc2[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k) acc[k] = T(0);
    }
#pragma unroll
    for (int k = 0; k < VW; ++k) tile[(v * VW + k) * kLd + jj] = acc[k];
  };

  // chunk c's tiles of A (modes 1, 2, 3, 5) and B (3, 5) for the
  // epilogue: asynchronous copies issued before the gather, so their
  // latency hides behind it
  auto stage = [&](int c) {
    const int r0 = c * rc, rend = min(p, r0 + rc);
    if (need_a || need_b)
      for (int i = t; i < rc * kCols; i += nt) {
        const int rl = i / kCols, jc = i % kCols, r = r0 + rl, jo = j0 + jc;
        if (r >= rend || jo >= n) continue;
        if (need_a)
          __pipeline_memcpy_async(
              sa + rl * kLd + jc, A + (int64_t)r * g.sar + (int64_t)jo * g.sac,
              sizeof(T));
        if (need_b)
          __pipeline_memcpy_async(
              sb + rl * kLd + jc, B + (int64_t)r * g.sbr + (int64_t)jo * g.sbc,
              sizeof(T));
      }
    __pipeline_commit();
  };

  if (reduce)
    for (int i = t; i < 32 * kCols; i += nt)
      xs[i / kCols * kLd + i % kCols] = T(0);

  for (int c = 0; c < nchunk; ++c) {
    stage(c);
    compute(c);
    __pipeline_wait_prior(0);
    __syncthreads();
    const int r0 = c * rc, rend = min(p, r0 + rc);
    if (mode == 0 || mode == 1 || mode == 2 || mode == 4) {
      for (int i = t; i < rc * kCols; i += nt) {
        const int rl = i / kCols, jc = i % kCols, r = r0 + rl,
                  jo = j0 + jc;
        if (r >= rend || jo >= n) continue;
        const T h = tile[rl * kLd + jc];
        out[(int64_t)r * n + jo] =
            mode == 1 ? h - z[jo] * sa[rl * kLd + jc] : h;
      }
    }
    if (reduce) {
      // the partials x_l continue over rows l, l + 32, ... of this chunk
      for (int i = t; i < 32 * kCols; i += nt) {
        const int l = i / kCols, jc = i % kCols, jo = j0 + jc;
        if (jo >= n) continue;
        T x = xs[l * kLd + jc];
        for (int r = r0 + l; r < rend; r += 32) {
          const int o = (r - r0) * kLd + jc;
          if (mode == 2)
            x = fma(tile[o], sa[o], x);
          else
            x = fma(sb[o], tile[o], x);
        }
        xs[l * kLd + jc] = x;
      }
    }
    __syncthreads();
  }
  if (!reduce) return;
  if (t < kCols && j0 + t < n) {
    const T s = butterfly32<T>(xs, t);
    if (mode == 2)
      w[j0 + t] = s;
    else
      ssum[t] = s;
  }
  if (mode == 2) return;
  __syncthreads();
  // the Hessian epilogues: a column of one chunk still has its tile;
  // otherwise each chunk is gathered again
  for (int c = 0; c < nchunk; ++c) {
    if (nchunk > 1) {
      stage(c);
      compute(c);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    const int r0 = c * rc, rend = min(p, r0 + rc);
    for (int i = t; i < rc * kCols; i += nt) {
      const int rl = i / kCols, jc = i % kCols, r = r0 + rl, jo = j0 + jc;
      if (r >= rend || jo >= n) continue;
      const T b = sb[rl * kLd + jc];
      const T a = sa[rl * kLd + jc];
      const T s = ssum[jc];
      const T eg = eG[jo];
      out[(int64_t)r * n + jo] = tile[rl * kLd + jc] - b * s - a * eg;
    }
    if (nchunk > 1) __syncthreads();
  }
}

// the N-major copies (nmajor.cuh): blockIdx.z = factor * nb + instance
template <typename T>
__global__ void __launch_bounds__(256)
spmm_nmajor(NmajorCopy<T> c0, NmajorCopy<T> c1, int p, int n, int pp,
            int nb) {
  const int op = blockIdx.z / nb;
  nmajor_tile(nmajor_pick(c0, c1, op != 0), blockIdx.z - (int64_t)op * nb, p,
              n, pp);
}

template <typename T, int VW, bool DEEP>
cudaError_t launch_vw(const Args<T>& g, int nb, cudaStream_t s) {
  const int nvec = g.pp / VW;
  const int cv = nvec < kChunk ? nvec : kChunk;
  const int m = g.mode;
  const int tiles = 1 + (m == 1 || m == 2 || m == 3 || m == 5) +
                    (m == 3 || m == 5);
  const bool reduce = m == 2 || m == 3 || m == 5;
  const size_t smem_bytes =
      ((size_t)tiles * cv * VW * kLd + (reduce ? 32 * kLd + kCols : 0)) *
      sizeof(T);
  const dim3 block(kCols * cv);
  const dim3 grid((g.n + kCols - 1) / kCols, nb);
  if (m >= 4)
    symcoo_spmm_kernel<T, VW, true, DEEP><<<grid, block, smem_bytes, s>>>(g);
  else
    symcoo_spmm_kernel<T, VW, false, DEEP><<<grid, block, smem_bytes, s>>>(g);
  return cudaGetLastError();
}

// At / Bt null: gather A / B where they lie (stride 1 along p, rows sac /
// sbc apart); otherwise transpose into them first.  vw: 1 or one 16-B
// vector; pp: the gathered rows' length, a multiple of vw, >= p; deep: the
// long-column walk (kernels.symcoo_spmm picks it from nnz / n).
template <typename T>
int launch(const void* A, int64_t sab, int64_t sar, int64_t sac,
           const void* colptr, const void* eoff, const void* rows,
           const void* vals, int p, int n, int nb, int mode, const void* z,
           const void* B, int64_t sbb, int64_t sbr, int64_t sbc,
           const void* eG, const void* vals2, double c1, double c2,
           void* out, void* w, void* At, void* Bt, int pp, int vw, int deep,
           void* stream) {
  if (n <= 0 || p <= 0 || nb <= 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const bool two = mode >= 4;
  if ((vw != 1 && vw != kVec) || pp < p || pp % vw != 0 ||
      (two && B == nullptr) || mode < 0 || mode > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* Ap = (const T*)A;
  const T* Bp = (const T*)B;
  NmajorCopy<T> copies[2];
  int ncopy = 0;
  if (At != nullptr)
    copies[ncopy++] = NmajorCopy<T>{Ap, sab, sar, sac, (T*)At};
  if (two && Bt != nullptr)
    copies[ncopy++] = NmajorCopy<T>{Bp, sbb, sbr, sbc, (T*)Bt};
  if (ncopy > 0) {
    spmm_nmajor<T><<<nmajor_grid(n, pp, ncopy * nb), dim3(32, 8), 0, s>>>(
        copies[0], copies[ncopy - 1], p, n, pp, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t npp = (int64_t)n * pp;
  Args<T> g;
  g.A = Ap;
  g.sab = sab;
  g.sar = sar;
  g.sac = sac;
  g.ga = At != nullptr ? Gather<T>{(const T*)At, npp, pp}
                       : Gather<T>{Ap, sab, sac};
  g.colptr = (const int*)colptr;
  g.eoff = (const int64_t*)eoff;
  g.rows = (const int*)rows;
  g.vals = (const T*)vals;
  g.p = p;
  g.n = n;
  g.pp = pp;
  g.mode = mode;
  g.z = (const T*)z;
  g.B = Bp;
  g.sbb = sbb;
  g.sbr = sbr;
  g.sbc = sbc;
  g.gb = !two ? Gather<T>{nullptr, 0, 0}
              : Bt != nullptr ? Gather<T>{(const T*)Bt, npp, pp}
                              : Gather<T>{Bp, sbb, sbc};
  g.eG = (const T*)eG;
  g.vals2 = (const T*)vals2;
  g.c1 = (T)c1;
  g.c2 = (T)c2;
  g.out = (T*)out;
  g.w = (T*)w;
  cudaError_t err;
  if (deep)
    err = vw == 1 ? launch_vw<T, 1, true>(g, nb, s)
                  : launch_vw<T, kVec, true>(g, nb, s);
  else
    err = vw == 1 ? launch_vw<T, 1, false>(g, nb, s)
                  : launch_vw<T, kVec, false>(g, nb, s);
  return (int)err;
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
                        double c2, void* out, void* w, void* At, void* Bt,  \
                        int pp, int vw, int deep, void* stream) {           \
    return launch<T>(A, sab, sar, sac, colptr, eoff, rows, vals, p, n, nb,  \
                     mode, z, B, sbb, sbr, sbc, eG, vals2, c1, c2, out, w,  \
                     At, Bt, pp, vw, deep, stream);                         \
  }

K1_EXPORT(f64, double)
K1_EXPORT(f32, float)

#undef K1_EXPORT

}  // extern "C"
