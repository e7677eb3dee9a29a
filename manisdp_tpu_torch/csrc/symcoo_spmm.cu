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
//     1 (A, and B in modes 4-5) into an (nr, pp) scratch the wrapper
//     allocates (nr: the rows r0 .. r0 + nr - 1 the entries read, all n but
//     on a shard's pattern), pp = p rounded up to one 16-B vector, rows
//     p .. pp zero (nmajor.cuh, shared with K3); per instance in instance
//     mode, both factors in one launch.  A factor
//     that is N-major already (the V^T views of matvec_block) is gathered
//     where it lies, with 16-B loads where its rows allow and scalar loads
//     otherwise (kernels.symcoo_spmm_layout picks, in Python).
//  2. symcoo_spmm_kernel: a block owns 16 consecutive output columns; its
//     threads are (column, vector) pairs, the column's threads reading
//     consecutive 16-B vectors of each entry's row of the copy, so one
//     entry costs ceil(p * size / 32) sectors instead of p, and no lane of
//     a narrow factor idles (a warp serves 32 / nvec columns).  Each
//     thread walks its column's entries (item 4).  Rows are taken in
//     chunks of 32 vectors (32, 64 or 128 rows).
//  3. The chunk's products go to a shared-memory tile of the 16 columns;
//     the epilogue and the stores run from the tile with consecutive
//     threads on consecutive columns, so the (p, n) output is written in
//     runs of 16 columns, not a sector per element.  The epilogue's tiles
//     of A and B are copied to shared memory asynchronously (cp.async)
//     before the gather starts, so their loads overlap it.
//  4. Columns of more than 8 entries on average (mc-12000: ~750) take the
//     deep walk (gather_async, gather_ring): each thread copies its own
//     16-B vector of the next batch's rows (8 entries) with cp.async into a
//     ring of its own in shared memory while it consumes the current batch
//     from another slot, so no thread waits for another and no row is held
//     in registers; the indices of the batch it issues next are loaded one
//     batch ahead.  Two slots (one batch in flight, the values in
//     registers), or in f32, where an SM holds at most three of the call's
//     blocks (a sharded operator's shard), three slots (two batches in
//     flight, the values copied into the ring beside the rows).  The walk
//     it replaces kept four rows in flight in registers: each step then
//     waited a full L2 round trip, and a shard, whose columns are as long
//     as the whole pattern's, took as long as the whole pattern.  Short
//     columns (G67, the batch: ~5) take the shallow walk, four (two-factor:
//     two) rows in flight in registers; its one-factor walk is capped at
//     64 registers so that two blocks share an SM.
//  5. Column range (a sharded operator's shard, kernels.SymCOO.span): the
//     grid covers the columns c0 .. c0 + nc - 1 only, the output is their
//     (p, nc) block, and z and eG stay indexed by the global column.
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
//    the L2 rate, not HBM, sets the floor.  The register walk peaked near
//    4 TB/s of these gathers; the ring reaches ~6 TB/s in f64 (PERF.md).
//    A shard (half or a quarter of the entries, as many per column) is
//    bound by its threads' walk latency, which the ring hides.
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
// shared memory the deep walk's row rings may take (three blocks an SM)
constexpr size_t kRingBudget = 64 * 1024;

// a gathered factor: row i of instance b at x + b * sb + (i - r0) * ld
// (N-major; a copy of rows r0 .. holds only the rows the entries read)
template <typename T>
struct Gather {
  const T* x;
  int64_t sb, ld;
  int r0;
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
  int c0, nc;  // output columns c0 .. c0 + nc - 1, stored at 0 .. nc - 1
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

// one 16-B vector (or one scalar) from shared memory
template <typename T, int VW>
__device__ __forceinline__ void load_shared(T (&x)[VW], const T* p) {
  if constexpr (VW == 1) {
    x[0] = *p;
  } else if constexpr (VW == 2) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
}

// cp.async of one vector (or scalar) of a gathered row into shared memory;
// 16-B copies skip L1 (.cg), the rows are read once from L2
template <int BYTES>
__device__ __forceinline__ void cp_row(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

// The deep walk (columns of more than SPMM_DEEP_MEAN entries): acc (+ acc2)
// over the column's entries e0 .. e1 in entry order, in batches of NB.
// Each thread copies its own vector of batch b + 1's rows into its own
// two-slot ring in shared memory (cp.async, no registers held) while it
// consumes batch b from the other slot; batch b + 2's indices and b + 1's
// values are loaded into registers meanwhile.  No thread waits for
// another: the ring is the thread's own, so only cp.async.wait_group
// orders it.  ring: this thread's first vector; slots NB * F * nt vectors
// apart, entries F * nt, factors nt.
template <typename T, int VW, bool TWO, int NB>
__device__ __forceinline__ void gather_async(
    T (&acc)[VW], T (&acc2)[VW], const T* __restrict__ ag, int64_t lda,
    int ra, const T* __restrict__ bg, int64_t ldb, int rb,
    const int* __restrict__ rows, const T* __restrict__ vals,
    const T* __restrict__ vals2, int e0, int e1, T* ring, int nt) {
  constexpr int F = TWO ? 2 : 1;
  constexpr int kBytes = VW * sizeof(T);
#pragma unroll
  for (int k = 0; k < VW; ++k) acc[k] = acc2[k] = T(0);
  if (e0 >= e1) return;
  const int ent = F * nt * VW, slot = NB * ent;
  int ix[NB];
  T ve[NB], ve2[NB], vo[NB], vo2[NB];
  auto load_idx = [&](int e) {
#pragma unroll
    for (int u = 0; u < NB; ++u) ix[u] = e + u < e1 ? __ldg(rows + e + u) : 0;
  };
  auto load_vals = [&](T (&v)[NB], T (&v2)[NB], int e) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      v[u] = e + u < e1 ? __ldg(vals + e + u) : T(0);
      if (TWO) v2[u] = e + u < e1 ? __ldg(vals2 + e + u) : T(0);
    }
  };
  auto issue = [&](int e, T* d) {
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (e + u < e1) {
        cp_row<kBytes>(d + u * ent, ag + (int64_t)(ix[u] - ra) * lda);
        if (TWO)
          cp_row<kBytes>(d + u * ent + nt * VW,
                         bg + (int64_t)(ix[u] - rb) * ldb);
      }
    __pipeline_commit();
  };
  auto consume = [&](int e, const T* d, const T (&v)[NB], const T (&v2)[NB]) {
    __pipeline_wait_prior(1);
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (e + u < e1) {
        T x[VW];
        load_shared<T, VW>(x, d + u * ent);
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[k] = fma(v[u], x[k], acc[k]);
        if (TWO) {
          load_shared<T, VW>(x, d + u * ent + nt * VW);
#pragma unroll
          for (int k = 0; k < VW; ++k) acc2[k] = fma(v2[u], x[k], acc2[k]);
        }
      }
  };
  load_idx(e0);
  load_vals(ve, ve2, e0);
  issue(e0, ring);
  load_idx(e0 + NB);
  for (int e = e0; e < e1; e += 2 * NB) {
    // batch e (slot 0, values ve); then batch e + NB (slot 1, values vo)
    issue(e + NB, ring + slot);
    load_vals(vo, vo2, e + NB);
    load_idx(e + 2 * NB);
    consume(e, ring, ve, ve2);
    if (e + NB >= e1) break;
    issue(e + 2 * NB, ring);
    load_vals(ve, ve2, e + 2 * NB);
    load_idx(e + 3 * NB);
    consume(e + NB, ring + slot, vo, vo2);
  }
  __pipeline_wait_prior(0);
}

// The deep walk with S ring slots: S - 1 batches of NB entries in flight.
// Each thread copies its own vector of a batch's rows, and the batch's
// values, into its own ring (cp.async) S - 1 batches ahead of their use;
// the indices of the batch it issues next are loaded into registers one
// batch ahead.  vring: this thread's first value, slots NB * F * nt
// values apart, entries F * nt, factors nt.
template <typename T, int VW, bool TWO, int NB, int S>
__device__ __forceinline__ void gather_ring(
    T (&acc)[VW], T (&acc2)[VW], const T* __restrict__ ag, int64_t lda,
    int ra, const T* __restrict__ bg, int64_t ldb, int rb,
    const int* __restrict__ rows, const T* __restrict__ vals,
    const T* __restrict__ vals2, int e0, int e1, T* ring, T* vring,
    int nt) {
  constexpr int F = TWO ? 2 : 1;
  constexpr int kBytes = VW * sizeof(T);
#pragma unroll
  for (int k = 0; k < VW; ++k) acc[k] = acc2[k] = T(0);
  if (e0 >= e1) return;
  const int ent = F * nt * VW, slot = NB * ent;
  const int vent = F * nt, vslot = NB * vent;
  int ix[NB];
  auto load_idx = [&](int e) {
#pragma unroll
    for (int u = 0; u < NB; ++u) ix[u] = e + u < e1 ? __ldg(rows + e + u) : 0;
  };
  auto issue = [&](int e, int sl) {
    T* d = ring + sl * slot;
    T* dv = vring + sl * vslot;
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (e + u < e1) {
        cp_row<kBytes>(d + u * ent, ag + (int64_t)(ix[u] - ra) * lda);
        cp_row<sizeof(T)>(dv + u * vent, vals + e + u);
        if (TWO) {
          cp_row<kBytes>(d + u * ent + nt * VW,
                         bg + (int64_t)(ix[u] - rb) * ldb);
          cp_row<sizeof(T)>(dv + u * vent + nt, vals2 + e + u);
        }
      }
    __pipeline_commit();
  };
  load_idx(e0);
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    issue(e0 + k * NB, k);
    load_idx(e0 + (k + 1) * NB);
  }
  int cs = 0, is = S - 1;
  for (int e = e0; e < e1; e += NB) {
    issue(e + (S - 1) * NB, is);
    load_idx(e + S * NB);
    __pipeline_wait_prior(S - 1);
    const T* d = ring + cs * slot;
    const T* dv = vring + cs * vslot;
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (e + u < e1) {
        T x[VW];
        load_shared<T, VW>(x, d + u * ent);
        const T v = dv[u * vent];
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[k] = fma(v, x[k], acc[k]);
        if (TWO) {
          load_shared<T, VW>(x, d + u * ent + nt * VW);
          const T v2 = dv[u * vent + nt];
#pragma unroll
          for (int k = 0; k < VW; ++k) acc2[k] = fma(v2, x[k], acc2[k]);
        }
      }
    cs = cs + 1 == S ? 0 : cs + 1;
    is = is + 1 == S ? 0 : is + 1;
  }
  __pipeline_wait_prior(0);
}

// the shallow walk: acc (+ acc2) over the column's entries e0 .. e1 in
// entry order, the rows of the copies at ag (+ bg; their first rows ra,
// rb), AHEAD entries' rows in flight
template <typename T, int VW, bool TWO, int AHEAD>
__device__ __forceinline__ void gather(
    T (&acc)[VW], T (&acc2)[VW], const T* __restrict__ ag, int64_t lda,
    int ra, const T* __restrict__ bg, int64_t ldb, int rb,
    const int* __restrict__ rows, const T* __restrict__ vals,
    const T* __restrict__ vals2, int e0, int e1) {
#pragma unroll
  for (int k = 0; k < VW; ++k) acc[k] = acc2[k] = T(0);
  for (int e = e0; e < e1; e += AHEAD) {
    int ii[AHEAD];
    T x[AHEAD][VW], y[AHEAD][VW], v[AHEAD], v2[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (e + u < e1) {
        ii[u] = __ldg(rows + e + u);
        v[u] = __ldg(vals + e + u);
        if (TWO) v2[u] = __ldg(vals2 + e + u);
      }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      if (e + u < e1) {
        load_vec<T, VW>(x[u], ag + (int64_t)(ii[u] - ra) * lda);
        if (TWO) load_vec<T, VW>(y[u], bg + (int64_t)(ii[u] - rb) * ldb);
      }
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

// bytes of the shared-memory tiles, rounded to 16 (the deep walk's rings
// follow them)
template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int rc, int mode) {
  const int tiles = 1 + (mode == 1 || mode == 2 || mode == 3 || mode == 5) +
                    (mode == 3 || mode == 5);
  const bool reduce = mode == 2 || mode == 3 || mode == 5;
  return (((size_t)tiles * rc * kLd + (reduce ? 32 * kLd + kCols : 0)) *
              sizeof(T) + 15) / 16 * 16;
}

// Blocks of 16 output columns; the shallow one-factor walk at two blocks
// an SM (64 registers a thread).  NB > 0: the deep walk, batches of NB
// through a ring of S slots in shared memory after the tiles (S = 2:
// gather_async, else gather_ring).
template <typename T, int VW, bool TWO, int NB, int S>
__global__ void __launch_bounds__(kCols * kChunk, NB || TWO ? 1 : 2)
symcoo_spmm_kernel(Args<T> g) {
  constexpr int kAhead = !TWO ? 4 : 2;
  const int nt = blockDim.x;
  const int cv = nt / kCols;               // vectors of this call's chunks
  const int rc = cv * VW;                  // rows of a chunk
  const int t = threadIdx.x;
  const int jj = t / cv, v = t - jj * cv;  // gather role
  const int cend = g.c0 + g.nc;
  const int j0 = g.c0 + blockIdx.x * kCols;
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
  T* out = g.out + inst * p * g.nc;
  const T* z = g.z != nullptr ? g.z + inst * n : nullptr;
  const T* B = g.B != nullptr ? g.B + inst * g.sbb : nullptr;
  const T* bg = TWO ? g.gb.x + inst * g.gb.sb : nullptr;
  const T* eG = g.eG != nullptr ? g.eG + inst * n : nullptr;
  const T* vals2 = TWO ? g.vals2 + eb : nullptr;
  T* w = g.w != nullptr ? g.w + inst * g.nc : nullptr;
  const int e0 = j < cend ? colptr[j] : 0, e1 = j < cend ? colptr[j + 1] : 0;
  const bool need_a = mode == 1 || mode == 2 || mode == 3 || mode == 5;
  const bool need_b = mode == 3 || mode == 5;
  const bool reduce = mode == 2 || mode == 3 || mode == 5;

  // shared memory (launch_vw): the chunk's products, A's and B's tiles
  // where the epilogue reads them (rc x kLd each), the 32 partials of the
  // 16 columns and their sums; then the deep walk's rings
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* sa = tile + rc * kLd;
  T* sb = sa + (need_a ? rc * kLd : 0);
  T* xs = sb + (need_b ? rc * kLd : 0);
  T* ssum = xs + 32 * kLd;
  T* ring0 = reinterpret_cast<T*>(smem_raw + tile_bytes<T>(rc, mode));
  T* ring = ring0 + t * VW;
  // S > 2: the values' ring after the rows' (S slots of NB entries)
  T* vring = ring0 + (size_t)S * NB * (TWO ? 2 : 1) * nt * VW + t;

  // chunk c's products -> tile[row][column]
  auto compute = [&](int c) {
    T acc[VW], acc2[VW];
    const int vg = c * cv + v;
    if (vg < nvec) {
      if constexpr (NB > 0 && S == 2)
        gather_async<T, VW, TWO, NB>(
            acc, acc2, ag + vg * VW, g.ga.ld, g.ga.r0,
            TWO ? bg + vg * VW : nullptr, g.gb.ld, g.gb.r0, rows, vals,
            vals2, e0, e1, ring, nt);
      else if constexpr (NB > 0)
        gather_ring<T, VW, TWO, NB, S>(
            acc, acc2, ag + vg * VW, g.ga.ld, g.ga.r0,
            TWO ? bg + vg * VW : nullptr, g.gb.ld, g.gb.r0, rows, vals,
            vals2, e0, e1, ring, vring, nt);
      else
        gather<T, VW, TWO, kAhead>(acc, acc2, ag + vg * VW, g.ga.ld,
                                   g.ga.r0, TWO ? bg + vg * VW : nullptr,
                                   g.gb.ld, g.gb.r0, rows, vals, vals2, e0,
                                   e1);
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
        if (r >= rend || jo >= cend) continue;
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
        if (r >= rend || jo >= cend) continue;
        const T h = tile[rl * kLd + jc];
        out[(int64_t)r * g.nc + (jo - g.c0)] =
            mode == 1 ? h - z[jo] * sa[rl * kLd + jc] : h;
      }
    }
    if (reduce) {
      // the partials x_l continue over rows l, l + 32, ... of this chunk
      for (int i = t; i < 32 * kCols; i += nt) {
        const int l = i / kCols, jc = i % kCols, jo = j0 + jc;
        if (jo >= cend) continue;
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
  if (t < kCols && j0 + t < cend) {
    const T s = butterfly32<T>(xs, t);
    if (mode == 2)
      w[j0 + t - g.c0] = s;
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
      if (r >= rend || jo >= cend) continue;
      const T b = sb[rl * kLd + jc];
      const T a = sa[rl * kLd + jc];
      const T s = ssum[jc];
      const T eg = eG[jo];
      out[(int64_t)r * g.nc + (jo - g.c0)] =
          tile[rl * kLd + jc] - b * s - a * eg;
    }
    if (nchunk > 1) __syncthreads();
  }
}

// the N-major copies (nmajor.cuh): blockIdx.z = factor * nb + instance
template <typename T>
__global__ void __launch_bounds__(256)
spmm_nmajor(NmajorCopy<T> c0, NmajorCopy<T> c1, int p, int nr, int pp,
            int nb) {
  const int op = blockIdx.z / nb;
  nmajor_tile(nmajor_pick(c0, c1, op != 0), blockIdx.z - (int64_t)op * nb, p,
              nr, pp);
}

template <typename T, int VW, bool TWO, int NB, int S>
cudaError_t launch_kernel(const Args<T>& g, dim3 grid, dim3 block,
                          size_t smem, cudaStream_t s) {
  auto* kern = symcoo_spmm_kernel<T, VW, TWO, NB, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, s>>>(g);
  return cudaGetLastError();
}

// the deep walk of a call: batches of NB entries, S ring slots (NB 0: the
// shallow walk)
struct Walk {
  int batch, slots;
};

// shared-memory bytes of a walk's rings: S slots of NB entries, F
// factors, one vector (and with S > 2 one value of each factor) a thread
template <typename T, int VW>
size_t walk_bytes(Walk w, int nt, bool two) {
  if (w.batch == 0) return 0;
  const size_t per = (size_t)w.slots * w.batch * (two ? 2 : 1) * nt;
  return per * VW * sizeof(T) + (w.slots > 2 ? per * sizeof(T) : 0);
}

// the card's SM count (cached per device)
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

// The deep walk of a call of `blocks` blocks: batches of 8, two slots; in
// f32, where an SM holds at most kFewBlocks of the call's blocks (a
// shard's columns: too few warps to hide the walk's latency), three
// slots, two batches in flight.  (An f64 ring of three slots of 8 would
// not fit the budget.)
constexpr int kFewBlocks = 3;

template <typename T>
Walk deep_walk(int64_t blocks) {
  return sizeof(T) == 4 && blocks <= (int64_t)kFewBlocks * sm_count()
             ? Walk{8, 3}
             : Walk{8, 2};
}

template <typename T, int VW, bool TWO>
cudaError_t launch_walk(const Args<T>& g, Walk w, dim3 grid, dim3 block,
                        size_t smem, cudaStream_t s) {
#define K1_WALK(NB, S)                                                   \
  if (w.batch == NB && w.slots == S)                                     \
    return launch_kernel<T, VW, TWO, NB, S>(g, grid, block, smem, s);
  K1_WALK(8, 2)
  K1_WALK(4, 2)
  K1_WALK(2, 2)
  K1_WALK(8, 3)
  K1_WALK(4, 3)
  K1_WALK(2, 3)
#undef K1_WALK
  return launch_kernel<T, VW, TWO, 0, 2>(g, grid, block, smem, s);
}

template <typename T, int VW>
cudaError_t launch_vw(const Args<T>& g, int nb, bool deep, cudaStream_t s) {
  const int nvec = g.pp / VW;
  const int cv = nvec < kChunk ? nvec : kChunk;
  const int m = g.mode;
  const bool two = m >= 4;
  const int nt = kCols * cv;
  size_t smem = tile_bytes<T>(cv * VW, m);
  const dim3 block(nt);
  const dim3 grid((g.nc + kCols - 1) / kCols, nb);
  Walk walk{0, 2};
  if (deep) {
    walk = deep_walk<T>((int64_t)grid.x * grid.y);
    // the largest batch whose rings fit the budget
    while (walk.batch > 2 && walk_bytes<T, VW>(walk, nt, two) > kRingBudget)
      walk.batch /= 2;
    smem += walk_bytes<T, VW>(walk, nt, two);
  }
  if (two) return launch_walk<T, VW, true>(g, walk, grid, block, smem, s);
  return launch_walk<T, VW, false>(g, walk, grid, block, smem, s);
}

// At / Bt null: gather A / B where they lie (stride 1 along p, rows sac /
// sbc apart); otherwise transpose columns r0 .. r0 + nr - 1 into them
// first.  vw: 1 or one 16-B vector; pp: the gathered rows' length, a
// multiple of vw, >= p; deep: the long-column walk (kernels.symcoo_spmm
// picks it from nnz / n); c0, nc: the output columns.
template <typename T>
int launch(const void* A, int64_t sab, int64_t sar, int64_t sac,
           const void* colptr, const void* eoff, const void* rows,
           const void* vals, int p, int n, int nb, int mode, const void* z,
           const void* B, int64_t sbb, int64_t sbr, int64_t sbc,
           const void* eG, const void* vals2, double c1, double c2,
           void* out, void* w, void* At, void* Bt, int pp, int vw, int deep,
           int c0, int nc, int r0, int nr, void* stream) {
  if (nc <= 0 || p <= 0 || nb <= 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const bool two = mode >= 4;
  if ((vw != 1 && vw != kVec) || pp < p || pp % vw != 0 ||
      (two && B == nullptr) || mode < 0 || mode > 5 || c0 < 0 ||
      c0 + nc > n || r0 < 0 || nr < 0 || r0 + nr > n ||
      (nb > 1 && (c0 != 0 || nc != n || r0 != 0 || nr != n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* Ap = (const T*)A;
  const T* Bp = (const T*)B;
  NmajorCopy<T> copies[2];
  int ncopy = 0;
  if (At != nullptr)
    copies[ncopy++] = NmajorCopy<T>{Ap, sab, sar, sac, (T*)At, r0};
  if (two && Bt != nullptr)
    copies[ncopy++] = NmajorCopy<T>{Bp, sbb, sbr, sbc, (T*)Bt, r0};
  if (ncopy > 0 && nr > 0) {
    spmm_nmajor<T><<<nmajor_grid(nr, pp, ncopy * nb), dim3(32, 8), 0, s>>>(
        copies[0], copies[ncopy - 1], p, nr, pp, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t npp = (int64_t)nr * pp;
  Args<T> g;
  g.A = Ap;
  g.sab = sab;
  g.sar = sar;
  g.sac = sac;
  g.ga = At != nullptr ? Gather<T>{(const T*)At, npp, pp, r0}
                       : Gather<T>{Ap, sab, sac, 0};
  g.colptr = (const int*)colptr;
  g.eoff = (const int64_t*)eoff;
  g.rows = (const int*)rows;
  g.vals = (const T*)vals;
  g.p = p;
  g.n = n;
  g.pp = pp;
  g.mode = mode;
  g.c0 = c0;
  g.nc = nc;
  g.z = (const T*)z;
  g.B = Bp;
  g.sbb = sbb;
  g.sbr = sbr;
  g.sbc = sbc;
  g.gb = !two ? Gather<T>{nullptr, 0, 0, 0}
              : Bt != nullptr ? Gather<T>{(const T*)Bt, npp, pp, r0}
                              : Gather<T>{Bp, sbb, sbc, 0};
  g.eG = (const T*)eG;
  g.vals2 = (const T*)vals2;
  g.c1 = (T)c1;
  g.c2 = (T)c2;
  g.out = (T*)out;
  g.w = (T*)w;
  const cudaError_t err = vw == 1 ? launch_vw<T, 1>(g, nb, deep != 0, s)
                                  : launch_vw<T, kVec>(g, nb, deep != 0, s);
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
                        int pp, int vw, int deep, int c0, int nc, int r0,   \
                        int nr, void* stream) {                             \
    return launch<T>(A, sab, sar, sac, colptr, eoff, rows, vals, p, n, nb,  \
                     mode, z, B, sbb, sbr, sbc, eG, vals2, c1, c2, out, w,  \
                     At, Bt, pp, vw, deep, c0, nc, r0, nr, stream);         \
  }

K1_EXPORT(f64, double)
K1_EXPORT(f32, float)

#undef K1_EXPORT

}  // extern "C"
