// K11: the vector step of truncated CG (Steihaug-Toint), one scalar set
// per instance, in one cooperative launch per tCG iteration.
//
// Replaces the body of the inner lax.while_loop of the JAX package's
// core/trustregions.py _make_tcg (:102-160), and its jax.vmap over the
// instance axis in solvers/batch.py:78.  Around one Hessian-vector
// product Hd = H[d] an iteration needs <d, Hd>, <d, r>, the step length
// (alpha, or the exact boundary root tau), the masked updates of eta,
// H eta, r and the model value, ||r_new||^2, beta and the next direction
// r_new + beta d, re-projected onto the tangent space.  On the oblique
// and masked-product manifolds that projection is K2's proj
// (oblique_cols.cu), and it runs here as the last phase (Y given).
//
// One launch (cudaLaunchCooperativeKernel), three phases separated by
// grid-wide barriers:
//   1 dots   : partial <d, Hd>, <d, r> of every virtual block -> part
//   2 update : every virtual block sums its instance's partials in a
//              fixed order, evaluates the scalar logic of the reference
//              (alpha, e_Pe, boundary, tau, step, model value, stop codes
//              1 / 2 / 6), updates eta, Heta (unless the model increased:
//              stop 6 keeps the previous iterate) and r <- r - alpha Hd,
//              and writes partial ||r||^2 -> part2; virtual block 0 of an
//              instance writes its step scalars -> xs (B, 4)
//   3 finish : sums part2 the same way, sets stop codes 3 / 4 (kappa /
//              theta target), beta, e_Pd, d_Pd, and d <- r + beta d in
//              place, or with Y d <- proj_Y(r + beta d) by column tiles
//              (oblique_tile.cuh, K2's chain: s = sum_rows Y w in row
//              order, times the mask where there is one, then w - Y s);
//              the instance's first virtual block (or tile) writes the
//              next scalar state (sc_next, st_next).
// Scalar state sc (B, 8): e_Pe, e_Pd, d_Pd, z_r (= <r, r>), model value,
// Delta^2, kappa target, linear (1: stop code 3 on the target, 0: 4);
// st (B, 2) int32: completed iterations j and the stop code (0 = active).
// An instance whose stop code is not 0 is left untouched: its iteration
// is a no-op, as in the vmapped while_loop (its direction is never read
// again, so the projected phase skips it too).
//
// Bits independent of the grid: the work is cut into virtual blocks, the
// (instance, blk) pairs of the earlier three-launch kernels (blk < nblk,
// nblk = kernels.tcg_blocks(L)), and each persistent block takes a
// contiguous range of them (and, in the projected phase, of the column
// tiles), so its items mostly share one instance, whose scalars it then
// computes once.  A virtual block's partial uses that kernel's
// thread-to-element map (grid stride nblk * 256) and its block_sum tree,
// the partials are summed in block order, and every multiply-add is an
// explicit fma where that kernel's were contracted, so every sum has the
// earlier order whatever grid the occupancy API allows.  No float
// atomics.
//
// The model-sharded RTR (parallel/mesh.py, the JAX package's
// parallel/mesh.py:55-75): each of D ranks holds a column block of every
// vector, and every sum must cover all ranks.  Two modes:
//
// Peer mode (NCCL groups whose cards reach each other's memory): still
// the one cooperative launch a step, with both cross-rank sums made on
// the device.  Each rank owns one receive buffer (cudaMalloc'd once per
// (group, B, nblk, dtype) by tcg_peer_alloc: a persistent communication
// buffer, not per-launch scratch, exported with cudaIpcGetMemHandle and
// mapped by every peer with cudaIpcOpenMemHandle): D flags (u64), a fault
// record, and D slots of part and of part2.  Phase 1 writes each virtual
// block's partials into slot `me` of every rank's buffer (its own, and the
// peers' over NVLink through the mapped pointers), then
// __threadfence_system() and grid.sync(); block 0 stores the epoch into
// flag `me` of every peer (st.release.sys) and spins until each peer's
// flag in its own buffer reaches the epoch (ld.acquire.sys); grid.sync().
// Phase 2 sums, for each virtual block in block order, the D slots in
// rank order 0 .. D-1 (so at D = 2 the sum a + b of an all-reduce, and
// every rank the same bits), then the same barrier at epoch + 1 for
// part2.  At D = 1 there are no peers: the barrier is grid.sync() alone
// and the launch is the plain one launch, bit for bit.
//   Reuse without a reset: the host passes the epoch, 2 more each step,
// and every rank makes the same calls (host decisions are bit-equal).
// Slot `me` of part on rank q is written again in step k+1 only after
// barrier 2 of step k, which rank q passes only after every rank has read
// its part (phase 2 precedes its flag); part2 is written again only after
// barrier 1 of step k+1, whose flag each rank stores in a launch that
// follows, on its stream, the launch that read part2 in phase 3.  Flags
// only grow, so one slot a peer serves both barriers.
//   No hang: the spin is bounded by %globaltimer (kSpinNs).  On expiry
// block 0 writes the fault record (epoch, peer) and every block gives up:
// the state is copied with stop code kTimeoutStop, which no other path
// writes, on every instance; a launch that finds that code in its input
// returns at once.  The tCG loop reads the stop codes on the host every
// _TCG_CHUNK iterations and raises, naming the rank and the epoch.
//   The Hessian's all_gather (NCCL) precedes K11 on each rank's stream:
// a rank spinning in step k has completed its own part of that gather,
// and a peer's gather of step k needs nothing more from it, so no peer
// waits on a rank that waits on it.
//
// Split mode (gloo, ranks sharing one card, cards without peer access):
// the three phases as three ordinary launches of the same device
// functions, a block per virtual block (per column tile in a projected
// phase 3).  Between them the caller sums the partials part (phase 1) and
// part2 (phase 2) over the ranks, entry by entry; the next launch then
// sums them in block order as phase 2 / 3 of the one launch do.  At one
// rank that is the one launch's arithmetic, so its bits.
//
// What bounds it on an H100: bytes.  One read of each input (d, Hd, r,
// eta, Heta) and one write of each output (eta, Heta, r, d): 9 vectors of
// L entries, 10 with Y.  A thread walks its entries kChunk at a time,
// every load of a chunk in flight before any entry is used or stored (the
// updates are in place, so loads may not pass stores); phases 2 and 3
// re-read d, Hd and r, mostly from L2.  At the sparse batch's shape (8 x
// 48 x 3,072, f64) the 9 vectors are 85 MB, 25 us at 3.35 TB/s; at G67
// (40 x 10^4, f32) 14 MB, 4.3 us, below the cost of one launch and two
// grid barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "oblique_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = kTileThreads;
constexpr int kWarps = kThreads / 32;
// entries of one thread's walk loaded before any is used or stored
constexpr int kChunk = 4;
// peer mode: the longest wait for a peer's flag (ns of %globaltimer), and
// the stop code written when it runs out (kernels.TCG_TIMEOUT_STOP)
constexpr unsigned long long kSpinNs = 10000000000ull;
constexpr int kTimeoutStop = 8;

// A rank's receive buffer for D ranks, nb instances and nblk virtual
// blocks: D flags and the fault record (epoch, peer) in a 256-B head,
// then part (D, nb, nblk, 2) and part2 (D, nb, nblk) in T.
__host__ __device__ inline int64_t peer_head(int world) {
  return ((int64_t)(world + 2) * 8 + 255) / 256 * 256;
}
__host__ __device__ inline int64_t peer_slot(int nb, int nblk) {
  return (int64_t)nb * nblk;
}

template <typename T>
struct StepArgs {
  const T* Hd;
  T* d;
  T* eta;
  T* Heta;
  T* r;
  const T* sc;
  const int* st;
  const T* Y;     // (nb, p, n) or null: no projection
  const T* mask;  // (n,) or null
  int64_t L;
  int nb, nblk, p, n, rows, mininner;
  T* part;   // (nb, nblk, 2); peer mode: slot 0 of this rank's buffer
  T* part2;  // (nb, nblk); the same
  T* xs;     // (nb, 4)
  T* sc_next;
  int* st_next;
  // peer mode: every rank's receive buffer mapped here (bufs[me] is this
  // rank's), or null; the rank, the ranks and this step's epoch
  unsigned char* const* bufs;
  int me, world;
  unsigned long long epoch;
};

// ------------------------------------------------------- peer mode --
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ unsigned long long* peer_flags(const StepArgs<T>& a,
                                                          int q) {
  return reinterpret_cast<unsigned long long*>(a.bufs[q]);
}

// A partial: entry i of part (which 0) or part2 (1); in peer mode into
// slot `me` of every rank's buffer.  Called by one thread.
template <typename T>
__device__ __forceinline__ void put_part(const StepArgs<T>& a, int which,
                                         int64_t i, T val) {
  if (a.bufs == nullptr) {
    (which == 0 ? a.part : a.part2)[i] = val;
    return;
  }
  const int64_t slot = peer_slot(a.nb, a.nblk);
  const int64_t at = peer_head(a.world) +
                     (which == 0 ? 0 : (int64_t)a.world * 2 * slot) *
                         (int64_t)sizeof(T);
  const int64_t k = (int64_t)a.me * (which == 0 ? 2 * slot : slot) + i;
  for (int q = 0; q < a.world; ++q)
    reinterpret_cast<T*>(a.bufs[q] + at)[k] = val;
}

// The grid barrier between two phases; in peer mode also the barrier
// across the ranks at `epoch`.  False (in every block) when a peer's flag
// did not come within kSpinNs.
template <typename T>
__device__ bool rank_barrier(const StepArgs<T>& a, unsigned long long epoch,
                             cg::grid_group& grid) {
  if (a.bufs == nullptr || a.world == 1) {
    grid.sync();
    return true;
  }
  // thread 0 wrote the block's partials (put_part): on every rank before
  // the flags
  if (threadIdx.x == 0) __threadfence_system();
  grid.sync();
  unsigned long long* mine = peer_flags(a, a.me);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    __threadfence_system();
    for (int q = 0; q < a.world; ++q)
      if (q != a.me) store_release_sys(peer_flags(a, q) + a.me, epoch);
    const unsigned long long t0 = global_ns();
    int late = -1;
    for (int q = 0; q < a.world && late < 0; ++q) {
      if (q == a.me) continue;
      while (load_acquire_sys(mine + q) < epoch) {
        if (global_ns() - t0 > kSpinNs) {
          late = q;
          break;
        }
      }
    }
    if (late >= 0) {
      mine[a.world] = epoch;
      mine[a.world + 1] = (unsigned long long)late;
    }
  }
  grid.sync();
  return *reinterpret_cast<volatile unsigned long long*>(mine + a.world) !=
         epoch;
}

// Give up the step: the state copied with the time-out code on every
// instance (block 0 writes it).
template <typename T>
__device__ void give_up(const StepArgs<T>& a) {
  if (blockIdx.x != 0) return;
  for (int b = threadIdx.x; b < a.nb; b += kThreads) {
    for (int k = 0; k < 8; ++k) a.sc_next[8 * b + k] = a.sc[8 * b + k];
    a.st_next[2 * b] = a.st[2 * b];
    a.st_next[2 * b + 1] = kTimeoutStop;
  }
}

// Sum of v over the block in a fixed order; every thread gets the total.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // sh may still be read from a previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  T s = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w];
  return s;
}

// Sum of the instance's nblk partials (stride `stride`) in a fixed order,
// each partial first summed over the `ranks` slots (`rank_stride` apart)
// in rank order; read through L2, since other blocks (or ranks) wrote
// them in this launch.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* part, int nblk, int stride,
                                       int ranks, int64_t rank_stride,
                                       T* sh) {
  T v = T(0);
  for (int k = threadIdx.x; k < nblk; k += kThreads) {
    T s = __ldcg(part + k * stride);
    for (int q = 1; q < ranks; ++q)
      s += __ldcg(part + q * rank_stride + k * stride);
    v += s;
  }
  return block_sum(v, sh);
}

// This block's share [lo, hi) of `count` work items: contiguous, so the
// virtual blocks of a block mostly share an instance (and its scalars).
__device__ __forceinline__ void my_range(int64_t count, int64_t& lo,
                                         int64_t& hi) {
  lo = count * blockIdx.x / gridDim.x;
  hi = count * (blockIdx.x + 1) / gridDim.x;
}

// One thread's walk of a virtual block: entries e0, e0 + stride, ... < L,
// kChunk at a time; f(k, o, ok) is called twice per chunk, first to load
// (stage 0) and then to use (stage 1), so every load of a chunk is in
// flight before any of its entries is used or stored.
template <class F>
__device__ __forceinline__ void walk(int64_t base, int64_t e0, int64_t L,
                                     int64_t stride, F f) {
  for (int64_t e = e0; e < L; e += kChunk * stride) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      f(0, k, base + e + k * stride, e + k * stride < L);
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      f(1, k, base + e + k * stride, e + k * stride < L);
  }
}

// ---------------------------------------------------------- phase 1 --
template <typename T>
__device__ __forceinline__ void dots_vblock(const StepArgs<T>& a, int64_t v,
                                            T* sh) {
  const int b = (int)(v / a.nblk), blk = (int)(v % a.nblk);
  if (a.st[2 * b + 1] != 0) {
    if (threadIdx.x == 0) {
      put_part(a, 0, v * 2, T(0));
      put_part(a, 0, v * 2 + 1, T(0));
    }
    return;  // the whole block leaves together
  }
  const T* __restrict__ d = a.d;
  const T* __restrict__ Hd = a.Hd;
  const T* __restrict__ r = a.r;
  T a1 = T(0), a2 = T(0);
  T dv[kChunk], hv[kChunk], rv[kChunk];
  walk((int64_t)b * a.L, (int64_t)blk * kThreads + threadIdx.x, a.L,
       (int64_t)a.nblk * kThreads, [&](int stage, int k, int64_t o, bool ok) {
         if (!ok) return;
         if (stage == 0) {
           dv[k] = d[o];
           hv[k] = Hd[o];
           rv[k] = r[o];
         } else {
           a1 = fma_t(dv[k], hv[k], a1);
           a2 = fma_t(dv[k], rv[k], a2);
         }
       });
  a1 = block_sum(a1, sh);
  a2 = block_sum(a2, sh);
  if (threadIdx.x == 0) {
    put_part(a, 0, v * 2, a1);
    put_part(a, 0, v * 2 + 1, a2);
  }
}

// ---------------------------------------------------------- phase 2 --
// An instance's step scalars, from phase 1's partials and sc.
template <typename T>
struct Step {
  T alpha, step, e_Pe_next, mv_next;
  bool keep;
  int stop;
};

template <typename T>
__device__ __forceinline__ Step<T> step_scalars(const StepArgs<T>& a, int b,
                                                T* sh) {
  const T* pb = a.part + (int64_t)b * a.nblk * 2;
  const int64_t rs = 2 * peer_slot(a.nb, a.nblk);
  const T d_Hd = sum_parts(pb, a.nblk, 2, a.world, rs, sh);
  const T d_r = sum_parts(pb + 1, a.nblk, 2, a.world, rs, sh);
  const T* s = a.sc + 8 * b;
  const T e_Pe = s[0], e_Pd = s[1], d_Pd = s[2], z_r = s[3], mv = s[4],
          DD = s[5];
  Step<T> x;
  x.alpha = z_r / d_Hd;
  const T e_Pe_new =
      fma_t(x.alpha * x.alpha, d_Pd, fma_t(T(2) * x.alpha, e_Pd, e_Pe));
  const bool boundary = (d_Hd <= T(0)) || (e_Pe_new >= DD);
  // exact boundary solve (tCG.m:188); not read unless boundary
  const T tau =
      (-e_Pd + tile_sqrt<T>(fma_t(e_Pd, e_Pd, d_Pd * (DD - e_Pe)))) / d_Pd;
  x.step = boundary ? tau : x.alpha;
  // incremental model value m(eta - t d) = m(eta) - t<d, r> + t^2/2 <d, Hd>
  const T new_mv =
      fma_t(T(0.5) * x.step * x.step, d_Hd, fma_t(-x.step, d_r, mv));
  x.keep = !boundary && (new_mv >= mv);  // model increase
  x.stop = boundary ? (d_Hd <= T(0) ? 1 : 2) : (x.keep ? 6 : 0);
  x.e_Pe_next = boundary ? e_Pe : e_Pe_new;
  x.mv_next = x.keep ? mv : new_mv;
  return x;
}

template <typename T>
__device__ __forceinline__ void update_vblock(const StepArgs<T>& a,
                                              int64_t v, const Step<T>& x,
                                              T* sh) {
  const int b = (int)(v / a.nblk), blk = (int)(v % a.nblk);
  const T* __restrict__ d = a.d;
  const T* __restrict__ Hd = a.Hd;
  T* __restrict__ eta = a.eta;
  T* __restrict__ Heta = a.Heta;
  T* __restrict__ r = a.r;
  const T step = x.step, alpha = x.alpha;
  const bool keep = x.keep;
  T acc = T(0);
  T dv[kChunk], hv[kChunk], rv[kChunk], ev[kChunk], Hv[kChunk];
  walk((int64_t)b * a.L, (int64_t)blk * kThreads + threadIdx.x, a.L,
       (int64_t)a.nblk * kThreads, [&](int stage, int k, int64_t o, bool ok) {
         if (!ok) return;
         if (stage == 0) {
           hv[k] = Hd[o];
           rv[k] = r[o];
           if (!keep) {
             dv[k] = d[o];
             ev[k] = eta[o];
             Hv[k] = Heta[o];
           }
         } else {
           if (!keep) {
             eta[o] = fma_t(-step, dv[k], ev[k]);
             Heta[o] = fma_t(-step, hv[k], Hv[k]);
           }
           const T rn = fma_t(-alpha, hv[k], rv[k]);
           r[o] = rn;
           acc = fma_t(rn, rn, acc);
         }
       });
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    put_part(a, 1, v, acc);
    if (blk == 0) {
      T* xo = a.xs + 4 * b;
      xo[0] = alpha;
      xo[1] = x.e_Pe_next;
      xo[2] = x.mv_next;
      xo[3] = T(x.stop);
    }
  }
}

// ---------------------------------------------------------- phase 3 --
// The instance's finishing scalars: beta, and with `lead` the next scalar
// state.  False for a stopped instance, whose state `lead` copies.
template <typename T>
__device__ __forceinline__ bool finish_scalars(const StepArgs<T>& a, int b,
                                               bool lead, T* sh, T& beta) {
  const T* s = a.sc + 8 * b;
  if (a.st[2 * b + 1] != 0) {
    if (lead) {
      for (int k = 0; k < 8; ++k) a.sc_next[8 * b + k] = s[k];
      a.st_next[2 * b] = a.st[2 * b];
      a.st_next[2 * b + 1] = a.st[2 * b + 1];
    }
    return false;
  }
  const T r_r = sum_parts(a.part2 + (int64_t)b * a.nblk, a.nblk, 1, a.world,
                          peer_slot(a.nb, a.nblk), sh);
  const T* x = a.xs + 4 * b;
  const T alpha = __ldcg(x), x1 = __ldcg(x + 1), x2 = __ldcg(x + 2);
  const int j = a.st[2 * b];
  int stop = (int)__ldcg(x + 3);
  if (stop == 0 && j + 1 >= a.mininner && tile_sqrt<T>(r_r) <= s[6])
    stop = s[7] > T(0) ? 3 : 4;
  beta = r_r / s[3];
  if (lead) {
    T* n = a.sc_next + 8 * b;
    n[0] = x1;
    n[1] = beta * fma_t(alpha, s[2], s[1]);
    n[2] = fma_t(beta * beta, s[2], r_r);
    n[3] = r_r;
    n[4] = x2;
    n[5] = s[5];
    n[6] = s[6];
    n[7] = s[7];
    a.st_next[2 * b] = j + 1;
    a.st_next[2 * b + 1] = stop;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ void finish_vblock(const StepArgs<T>& a,
                                              int64_t v, T beta) {
  const int b = (int)(v / a.nblk), blk = (int)(v % a.nblk);
  T* __restrict__ d = a.d;
  const T* __restrict__ r = a.r;
  T dv[kChunk], rv[kChunk];
  walk((int64_t)b * a.L, (int64_t)blk * kThreads + threadIdx.x, a.L,
       (int64_t)a.nblk * kThreads, [&](int stage, int k, int64_t o, bool ok) {
         if (!ok) return;
         if (stage == 0) {
           dv[k] = d[o];
           rv[k] = __ldcg(r + o);
         } else {
           d[o] = fma_t(beta, dv[k], rv[k]);
         }
       });
}

// d <- proj_Y(r + beta d) on the column tile `tile` of instance b
template <typename T, int TC>
__device__ __forceinline__ void finish_tile(const StepArgs<T>& a, int b,
                                            int tile, T beta, T* sx, T* su,
                                            T* ssum) {
  const int64_t at = (int64_t)b * a.L;
  T* d = a.d + at;
  const T* r = a.r + at;
  const int j0 = tile * TC;
  const Tile t{a.p, a.n, j0, min(TC, a.n - j0), a.rows};
  column_tile<T, TC>(
      t, 0, a.Y + at, nullptr,
      [d, r, beta](int64_t o) {
        return fma_t(beta, __ldcg(d + o), __ldcg(r + o));
      },
      [d](int64_t o, T val) { d[o] = val; }, nullptr, nullptr, a.mask, sx,
      su, ssum);
  __syncthreads();  // the tile's shared rows are free again
}

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
tcg_step_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[kWarps];
  __shared__ T ssum[TC];
  cg::grid_group grid = cg::this_grid();
  int64_t lo, hi;

  if (a.bufs != nullptr) {
    // an earlier step gave up: every instance carries the time-out code
    for (int b = 0; b < a.nb; ++b)
      if (a.st[2 * b + 1] == kTimeoutStop) {
        give_up(a);
        return;
      }
  }
  my_range((int64_t)a.nb * a.nblk, lo, hi);
  for (int64_t v = lo; v < hi; ++v) dots_vblock(a, v, sh);
  if (!rank_barrier(a, a.epoch, grid)) {
    give_up(a);
    return;
  }

  // the instance's scalars, recomputed where the instance changes
  int cur = -1;
  Step<T> x;
  for (int64_t v = lo; v < hi; ++v) {
    const int b = (int)(v / a.nblk);
    if (a.st[2 * b + 1] != 0) {
      if (threadIdx.x == 0) put_part(a, 1, v, T(0));
      continue;
    }
    if (b != cur) {
      x = step_scalars(a, b, sh);
      cur = b;
    }
    update_vblock(a, v, x, sh);
  }
  if (!rank_barrier(a, a.epoch + 1, grid)) {
    give_up(a);
    return;
  }

  // the next direction: by virtual blocks, or by column tiles with Y; the
  // instance's first item (blk or tile 0) writes its next scalar state
  const int per = a.Y == nullptr ? a.nblk : (a.n + TC - 1) / TC;
  my_range((int64_t)a.nb * per, lo, hi);
  T* sx = reinterpret_cast<T*>(smem);
  T* su = sx + (int64_t)a.rows * TC;
  cur = -1;
  bool active = false;
  T beta = T(0);
  for (int64_t item = lo; item < hi; ++item) {
    const int b = (int)(item / per), k = (int)(item % per);
    if (b != cur || k == 0) {
      active = finish_scalars(a, b, k == 0 && threadIdx.x == 0, sh, beta);
      cur = b;
    }
    if (!active) continue;
    if (a.Y == nullptr)
      finish_vblock(a, item, beta);
    else
      finish_tile<T, TC>(a, b, k, beta, sx, su, ssum);
  }
}

// ------------------------------------------------------ split mode --
template <typename T>
__global__ void __launch_bounds__(kThreads)
tcg_split_dots(const StepArgs<T> a) {
  __shared__ T sh[kWarps];
  dots_vblock(a, blockIdx.x, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tcg_split_update(const StepArgs<T> a) {
  __shared__ T sh[kWarps];
  const int64_t v = blockIdx.x;
  const int b = (int)(v / a.nblk);
  if (a.st[2 * b + 1] != 0) {
    if (threadIdx.x == 0) a.part2[v] = T(0);
    return;
  }
  const Step<T> x = step_scalars(a, b, sh);
  update_vblock(a, v, x, sh);
}

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
tcg_split_finish(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sh[kWarps];
  __shared__ T ssum[TC];
  const int per = a.Y == nullptr ? a.nblk : (a.n + TC - 1) / TC;
  const int64_t item = blockIdx.x;
  const int b = (int)(item / per), k = (int)(item % per);
  T beta = T(0);
  if (!finish_scalars(a, b, k == 0 && threadIdx.x == 0, sh, beta)) return;
  if (a.Y == nullptr) {
    finish_vblock(a, item, beta);
  } else {
    T* sx = reinterpret_cast<T*>(smem);
    finish_tile<T, TC>(a, b, k, beta, sx, sx + (int64_t)a.rows * TC, ssum);
  }
}

template <typename T, int TC>
int launch_split(const StepArgs<T>& a, int phase, cudaStream_t stream) {
  const unsigned nv = (unsigned)((int64_t)a.nb * a.nblk);
  if (phase == 0) {
    tcg_split_dots<T><<<nv, kThreads, 0, stream>>>(a);
  } else if (phase == 1) {
    tcg_split_update<T><<<nv, kThreads, 0, stream>>>(a);
  } else {
    size_t smem = 0;
    unsigned grid = nv;
    if (a.Y != nullptr) {
      smem = (size_t)2 * a.rows * TC * sizeof(T);
      static size_t allowed = 0;
      if (smem > allowed) {
        const cudaError_t e = cudaFuncSetAttribute(
            tcg_split_finish<T, TC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        allowed = smem;
      }
      grid = (unsigned)((int64_t)a.nb * ((a.n + TC - 1) / TC));
    }
    tcg_split_finish<T, TC><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// persistent blocks that fit on the card at once, per kernel and dynamic
// shared memory (cached: the occupancy query is a host call)
template <typename T, int TC>
int resident_blocks(size_t smem, int* out) {
  static int dev_sms = -1;
  static size_t cached_smem = (size_t)-1;
  static int cached_blocks = 0;
  auto kern = tcg_step_kernel<T, TC>;
  if (dev_sms < 0) {
    int dev = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&dev_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) {
      dev_sms = -1;
      return (int)e;
    }
  }
  if (smem != cached_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_smem = smem;
    cached_blocks = per_sm * dev_sms;
  }
  *out = cached_blocks;
  return (int)cudaSuccess;
}

template <typename T, int TC>
int launch_step(const StepArgs<T>& a, cudaStream_t stream) {
  const size_t smem =
      a.Y != nullptr ? (size_t)2 * a.rows * TC * sizeof(T) : 0;
  int cap = 0;
  const int err = resident_blocks<T, TC>(smem, &cap);
  if (err != (int)cudaSuccess) return err;
  int64_t work = (int64_t)a.nb * a.nblk;
  if (a.Y != nullptr)
    work = std::max(work, (int64_t)a.nb * ((a.n + TC - 1) / TC));
  const int grid = (int)std::min<int64_t>(cap, work);
  StepArgs<T> args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)tcg_step_kernel<T, TC>, dim3(grid), dim3(kThreads),
      params, smem, stream);
  return (int)e;
}

// the shared memory the projected phase may stage a column tile in (half
// of K2's, so that enough persistent blocks stay resident)
constexpr size_t kTcgTileBytes = 32 << 10;

// phase < 0: the one cooperative launch; 0 / 1 / 2: that phase of the
// split mode
template <typename T>
int launch(const void* d, const void* Hd, void* eta, void* Heta, void* r,
           const void* sc, const void* st, const void* Y, const void* mask,
           int64_t L, int nb, int nblk, int p, int n, int mininner,
           void* part, void* part2, void* xs, void* sc_next, void* st_next,
           int phase, const void* bufs, int me, int world,
           unsigned long long epoch, void* stream) {
  if (nb <= 0 || nblk <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (Y != nullptr && (p <= 0 || (int64_t)p * n != L))
    return (int)cudaErrorInvalidValue;
  if (bufs != nullptr &&
      (phase >= 0 || world < 1 || me < 0 || me >= world || epoch == 0))
    return (int)cudaErrorInvalidValue;
  int tc = 32, rows = 0;
  if (Y != nullptr) tile_plan<T>(p, kTcgTileBytes, &tc, &rows);
  StepArgs<T> a{(const T*)Hd, (T*)d,  (T*)eta, (T*)Heta,
                (T*)r,        (const T*)sc, (const int*)st,
                (const T*)Y,  (const T*)mask, L, nb, nblk, p, n, rows,
                mininner,     (T*)part, (T*)part2, (T*)xs,
                (T*)sc_next,  (int*)st_next, nullptr, 0, 1, 0};
  if (bufs != nullptr) {
    // the partials' slots in this rank's own buffer; the kernel reads
    // bufs (a device array) for every rank's
    a.bufs = (unsigned char* const*)bufs;
    a.me = me;
    a.world = world;
    a.epoch = epoch;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (phase >= 0)
    return tc == 16 ? launch_split<T, 16>(a, phase, s)
                    : launch_split<T, 32>(a, phase, s);
  if (tc == 16) return launch_step<T, 16>(a, s);
  return launch_step<T, 32>(a, s);
}

}  // namespace

extern "C" {

// phase -1: the one cooperative launch; 0 dots, 1 update, 2 finish: that
// launch of the split mode.  bufs (a device array of `world` pointers, one
// receive buffer a rank, mapped here) selects the peer mode of the one
// launch: part / part2 are then this rank's slots 0 (tcg_peer_layout) and
// epoch (> 0) the step's; null: a plain launch (me, world, epoch unread).
int tcg_step_f64(const void* d, const void* Hd, void* eta, void* Heta,
                 void* r, const void* sc, const void* st, const void* Y,
                 const void* mask, int64_t L, int nb, int nblk, int p, int n,
                 int mininner, void* part, void* part2, void* xs,
                 void* sc_next, void* st_next, int phase, const void* bufs,
                 int me, int world, unsigned long long epoch, void* stream) {
  if (phase < -1 || phase > 2) return (int)cudaErrorInvalidValue;
  return launch<double>(d, Hd, eta, Heta, r, sc, st, Y, mask, L, nb, nblk, p,
                        n, mininner, part, part2, xs, sc_next, st_next, phase,
                        bufs, me, world, epoch, stream);
}

int tcg_step_f32(const void* d, const void* Hd, void* eta, void* Heta,
                 void* r, const void* sc, const void* st, const void* Y,
                 const void* mask, int64_t L, int nb, int nblk, int p, int n,
                 int mininner, void* part, void* part2, void* xs,
                 void* sc_next, void* st_next, int phase, const void* bufs,
                 int me, int world, unsigned long long epoch, void* stream) {
  if (phase < -1 || phase > 2) return (int)cudaErrorInvalidValue;
  return launch<float>(d, Hd, eta, Heta, r, sc, st, Y, mask, L, nb, nblk, p,
                       n, mininner, part, part2, xs, sc_next, st_next, phase,
                       bufs, me, world, epoch, stream);
}

// The peer mode's receive buffer for `world` ranks, nb instances, nblk
// virtual blocks and `elem`-byte entries: out = (bytes, byte offset of
// part's slot 0, of part2's slot 0).
void tcg_peer_layout(int world, int nb, int nblk, int elem, int64_t* out) {
  const int64_t slot = peer_slot(nb, nblk);
  out[0] = peer_head(world) + (int64_t)world * 3 * slot * elem;
  out[1] = peer_head(world);
  out[2] = peer_head(world) + (int64_t)world * 2 * slot * elem;
}

// A receive buffer of `bytes` on the current device, zeroed (flags 0),
// and its IPC handle (64 bytes) for the peers.
int tcg_peer_alloc(int64_t bytes, void** ptr, void* handle) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)e;
}

// A peer's buffer mapped into this process from its handle.
int tcg_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int tcg_peer_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int tcg_peer_free(void* ptr) { return (int)cudaFree(ptr); }

// `bytes` of device memory at src into host memory at dst (the fault
// record), after the device's work so far.
int tcg_peer_read(const void* src, void* dst, int64_t bytes) {
  return (int)cudaMemcpy(dst, src, (size_t)bytes, cudaMemcpyDeviceToHost);
}

}  // extern "C"
