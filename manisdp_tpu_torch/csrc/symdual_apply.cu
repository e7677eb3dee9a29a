// K7: the SOS-dual tensor operator's forward map on the expanded pair
// basis (the class sums of an (n~, n~) matrix, every degree at once).
//
// Replaces ops/symdual.py _apply_tensor of the JAX package (its einsum /
// transpose chain, called by SymDualOp.apply and y_step).  Basis layout
// (n~ = 2 + q + q^2, o = 2 + q): columns 0, 1 = the two copies of the
// constant; 2 + a = x_a; o + i*q + j = x_i x_j for i != j and the second
// copy of x_a at i = j = a.  Blocks of M (row-major, leading dim n~):
//   T[i,j,k,l] = M[o+iq+j, o+kq+l]   H[b,i,j] = M[2+b, o+iq+j]
//   K[i,j,b]   = M[o+iq+j, 2+b]      E[s,i,j] = M[s, o+iq+j]
//   F[i,j,s]   = M[o+iq+j, s]        G[a,b]   = M[2+a, 2+b]
// The output is the flat per-degree layout y = [y0, y1 (q), Y2 (q,q),
// Y3 (q,q,q), Y4 (q,q,q,q)]; slots with a repeated index (don't-care in
// the JAX function: never read by the adjoint, zero in b) are written 0.
// Optional epilogue (y_step): y0 <- (y0 - shift) * scale[0] and every
// degree-d slot times scale[d].
//
// The JAX grouping read as matrix algebra on A = T as a (q^2, q^2) matrix
// (rows (i, j), columns (k, l); r~ = (j, i) is the pair swap of r):
//   P2[r, c] = S[r, c] + S[r, c~],  S[r, .] = A[r, .] + A[r~, .]
//   P3 = P2 + P2^T
//   Y4[i,j,k,l] = P3[i,j,k,l] + P3[i,k,j,l] + P3[j,k,i,l]   (distinct)
//   Y2[a,b] = sum_{c != a,b} P3[a,c,c,b] + 16 single entries
//   Y3[a,b,c] = S3[a,b,c] + S3[b,a,c] + S3[c,a,b],
//     S3[e,f,g] = hk[f,g] + hk[g,f],
//     hk[f,g] = H[e,f,g] + T[e,e,f,g] + K[f,g,e] + T[f,g,e,e]
// P3 is symmetric within each pair and under the swap of the pairs, so
// every P3 read above runs along l.  P2 and P3 are symmetric in the row
// pair, so one q^4 workspace holds both: for each pair i < j, P2's row at
// row (i, j) and P3's at row (j, i).  Three launches, each output written
// by one thread in a fixed order (no atomics):
//   symdual_stage  a block per e: S3[e] through shared memory; a warp per
//                  row of y0's partial sums and per slot of y1; a block per
//                  pair i < j: S's row through shared memory, P2's row
//                  (the (k, l) swap read transposed) into the workspace.
//   symdual_sym    P3 = P2 + P2^T, a block per pair of 32 x 32 tiles
//                  through shared memory, reading P2's rows and writing
//                  P3's, so no block reads what another writes; a block per
//                  a: Y3[a] (S3[c, a, :] staged and read transposed); y0.
//   symdual_y4     a block per (i, j), threads along (k, l): Y4[i, j] from
//                  three row-contiguous reads of P3, blocks in i-major
//                  order so the i-slabs of P3 are reused from L2; Y2, a
//                  thread per slot, reads P3[a, c, c, :] along b.
//
// Row-block mode: replaces parallel/symdual_sharded.py apply_sharded
// (ShardedSymDualOp.apply) of the JAX package.  A rank holds ``top`` =
// M's first o rows (replicated) and ``rowsQ`` = its Q rows (i, j) for i in
// [off, off + ql) (ql = q / D), and returns y0 .. Y3 whole and Y4's rows
// [off, off + ql).  At D > 1 three launches around the caller's two
// all-to-alls (equal splits over the D ranks); at D = 1 the last two
// launches and no all-to-all; then one all-reduce:
//   rows_pack   (D > 1) a block per local row (i, j) copying T's row, by
//               16-byte vectors where aligned, into the send buffer's chunk
//               j / ql: send1 (D, ql, ql, q^2).
//   all_to_all  recv1[s, a, b] = T[s ql + a, off + b]: the rows (j, i).
//   rows_pair   a warp per row of y0's partial sums and per slot of y1
//               (the replicated rows' terms on the rank with off = 0 only);
//               a block per (e, tile pair): the partial S3[e]; S's row T[i,
//               j] + T[j, i] and P2's row S + S^T by 32 x 32 tile pairs.
//               D = 1: a block per pair i <= j, both T rows read from
//               rowsQ, P2's row stored once (P2 is symmetric in the row
//               pair); D > 1: a block per local row, T[j, i] from recv1,
//               P2's row into send2 (D, ql, q, ql, q) by column blocks.
//   all_to_all  recv2 = P2's rows (i, j) at the columns (k, l) of this
//               rank's rows, a (q^2, ql q) matrix.
//   rows_final  Y3's partial by tiles, y0, Y2's partial a thread a slot;
//               Y4 by 8^3 cubes of (j, k, l), each P3 term formed there
//               as P2's own run plus the received one, P3[i, z, x, y] =
//               P2[i, z, x, y] + P2[x, y, i, z] (both from P2's buffer at
//               D = 1): a block per (i, tile triple), i-major, stages the
//               three sub-cubes that every order of the triple reads and
//               writes every order.
//   all-reduce  of the flat (1 + q + q^2 + q^3) partial: y0 .. Y3.
// Don't-care slots are written 0, as in the full mode.  Each value is a
// fixed chain of additions (S, P2, P3 = P2own + P2^T, Y4 = (P3a + P3b) +
// P3c, Y2's partial over c in order) whatever the work map, so Y4 does not
// depend on D.  No launch stages a q-dependent slab: q has no ceiling.
//
// What bounds it on an H100: bytes.  The function reads T and writes Y4,
// 2 q^4 / D entries: at q = 120 in f64, 3.3 GB, 1.0 ms at 3.35 TB/s.  At
// D = 1 the pair pass reads T once and writes half of P2 (q^4 / 2); the
// final pass loads about q^4 entries of that half (each stored entry about
// twice, the second often from L2) and writes Y4: 3 to 3.5 q^4 entries in
// all.  At D > 1 the pack copies T's q^4 / D and the exchanges come on top.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "oblique_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

template <typename T>
struct Blocks {
  const T* M;
  int64_t n;  // n~
  int q, o;
  __device__ __forceinline__ T at(int64_t u, int64_t v) const {
    return M[u * n + v];
  }
  __device__ __forceinline__ T Tq(int i, int j, int k, int l) const {
    return at(o + (int64_t)i * q + j, o + (int64_t)k * q + l);
  }
  __device__ __forceinline__ T H(int b, int i, int j) const {
    return at(2 + b, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T K(int i, int j, int b) const {
    return at(o + (int64_t)i * q + j, 2 + b);
  }
  __device__ __forceinline__ T E(int s, int i, int j) const {
    return at(s, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T F(int i, int j, int s) const {
    return at(o + (int64_t)i * q + j, s);
  }
  __device__ __forceinline__ T G(int a, int b) const { return at(2 + a, 2 + b); }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// The workspace holds, for each pair i < j, P2's row at row (i, j) and
// P3's row at row (j, i) (both are symmetric in the row pair); rows
// (i, i) are never needed.  lo / hi: the storage row of P2 / P3 for the
// logical row r = (a, b).
__device__ __forceinline__ int lo_row(int r, int q) {
  const int a = r / q, b = r - a * q;
  return a < b ? r : b * q + a;
}
__device__ __forceinline__ int hi_row(int a, int b, int q) {
  return a > b ? a * q + b : b * q + a;
}

// (I, J), I <= J, of entry p of the upper triangle taken column by column
__device__ __forceinline__ void tri(int64_t p, int& I, int& J) {
  int64_t j = (int64_t)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  J = (int)j;
  I = (int)(p - j * (j + 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symdual_stage(Blocks<T> B, const T* __restrict__ scale, T* __restrict__ y,
              T* __restrict__ P, T* __restrict__ S3, T* __restrict__ y0part) {
  const int q = B.q, qp = q + 1;
  const int64_t q2 = (int64_t)q * q;
  const int64_t nwarp = (2 * q + kWarps - 1) / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* s = smem<T>();
  int64_t bid = blockIdx.x;
  // the short roles first, so their strided reads overlap the pair rows
  if (bid < q) {
    // S3[e, :, :]: rows e of H and (e, e) of T along (f, g), columns e of K
    // and (e, e) of T down the rows (f, g)
    const int e = (int)bid;
    const T* rh = B.M + (int64_t)(2 + e) * B.n + B.o;
    const T* rd = B.M + (B.o + (int64_t)e * q + e) * B.n + B.o;
    const T* ck = B.M + (int64_t)B.o * B.n + 2 + e;
    const T* cd = B.M + (int64_t)B.o * B.n + B.o + (int64_t)e * q + e;
#pragma unroll 4
    for (int f = warp; f < q; f += kWarps)
      for (int g = lane; g < q; g += 32) {
        const int t = f * q + g;
        s[f * qp + g] = rh[t] + rd[t] + ck[t * B.n] + cd[t * B.n];
      }
    __syncthreads();
    for (int f = warp; f < q; f += kWarps)
      for (int g = lane; g < q; g += 32)
        S3[e * q2 + f * q + g] = s[f * qp + g] + s[g * qp + f];
    return;
  }
  bid -= q;
  if (bid < nwarp) {
    // a warp per row i of y0's partial sums, then per slot of y1
    const int64_t w = bid * kWarps + warp;
    if (w >= 2 * q) return;                            // warp-uniform
    if (w < q) {
      const int i = (int)w;
      T acc = T(0);
      for (int j = lane; j < q; j += 32) {
        if (i == j)
          acc += B.G(i, i) + B.H(i, i, i) + B.K(i, i, i) + B.Tq(i, i, i, i);
        else
          acc += B.Tq(i, j, i, j) + B.Tq(i, j, j, i);
      }
      acc = warp_sum(acc);
      if (lane == 0) y0part[i] = acc;
      return;
    }
    // y1[a]: (const, x_a) over all copies and the (x_c, x_c x_a) patterns
    const int a = (int)(w - q);
    T acc = T(0);
    for (int i = lane; i < q; i += 32) {
      if (i == a) continue;
      acc += B.H(i, i, a) + B.H(i, a, i) + B.K(i, a, i) + B.K(a, i, i) +
             B.Tq(i, i, i, a) + B.Tq(i, i, a, i) + B.Tq(i, a, i, i) +
             B.Tq(a, i, i, i);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      acc += B.at(0, 2 + a) + B.at(1, 2 + a) + B.at(2 + a, 0) +
             B.at(2 + a, 1) + B.E(0, a, a) + B.E(1, a, a) + B.F(a, a, 0) +
             B.F(a, a, 1);
      y[1 + a] = scale != nullptr ? acc * scale[1] : acc;
    }
    return;
  }
  bid -= nwarp;
  // the P2 row of the pair i < j, at its row (i, j): S's row staged with a
  // padded stride so the transposed read s[l][k] is free of bank
  // conflicts; a warp per k, the lanes along l
  int i, j;
  tri(bid, i, j);
  ++j;
  const T* ra = B.M + (B.o + (int64_t)i * q + j) * B.n + B.o;
  const T* rb = B.M + (B.o + (int64_t)j * q + i) * B.n + B.o;
#pragma unroll 4
  for (int k = warp; k < q; k += kWarps)
    for (int l = lane; l < q; l += 32)
      s[k * qp + l] = ra[k * q + l] + rb[k * q + l];
  __syncthreads();
  T* pa = P + ((int64_t)i * q + j) * q2;
  for (int k = warp; k < q; k += kWarps)
    for (int l = lane; l < q; l += 32)
      pa[k * q + l] = s[k * qp + l] + s[l * qp + k];
}

// 8 blocks an SM (32 registers): the tile pass is latency-bound, and
// this kernel keeps within 32 registers without spilling
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
symdual_sym(Blocks<T> B, const T* __restrict__ scale,
            const T* __restrict__ shift, T* __restrict__ y,
            T* __restrict__ P, const T* __restrict__ S3,
            const T* __restrict__ y0part) {
  const int q = B.q, qp = q + 1;
  const int64_t q2 = (int64_t)q * q;
  T* s = smem<T>();
  int64_t bid = blockIdx.x;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  // the Y3 blocks and y0's first, the tiles after them
  if (bid > q) {
    bid -= q + 1;
    // P3 = P2 + P2^T on the tile pair (I, J), (J, I): P2 read from the
    // rows (i, j), i < j, P3 written to the rows (j, i), so no block reads
    // what another writes
    int I, J;
    tri(bid, I, J);
    T* a = s;
    T* b = s + kTile * (kTile + 1);
    const int n2 = (int)q2;
    // the tiles' rows, one division each: where P2's row is read (-1 past
    // the end) and where P3's is written (-1 unless i < j)
    __shared__ int src[2 * kTile], dst[2 * kTile];
    if (threadIdx.x < 2 * kTile) {
      const int row = (threadIdx.x < kTile ? I : J) * kTile + threadIdx.x % kTile;
      const int i = row / q, j = row - i * q;
      src[threadIdx.x] = row >= n2 ? -1 : lo_row(row, q);
      dst[threadIdx.x] = row < n2 && i < j ? j * q + i : -1;
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kThreads / kTile) {
      const int col = J * kTile + tx, col2 = I * kTile + tx;
      if (src[r] >= 0 && col < n2)
        a[r * (kTile + 1) + tx] = P[(int64_t)src[r] * n2 + col];
      if (I != J && src[kTile + r] >= 0 && col2 < n2)
        b[r * (kTile + 1) + tx] = P[(int64_t)src[kTile + r] * n2 + col2];
    }
    __syncthreads();
    const T* bt = I == J ? a : b;
    for (int r = ty; r < kTile; r += kThreads / kTile) {
      const int col = J * kTile + tx, col2 = I * kTile + tx;
      if (dst[r] >= 0 && col < n2)
        P[(int64_t)dst[r] * n2 + col] =
            a[r * (kTile + 1) + tx] + bt[tx * (kTile + 1) + r];
      if (I != J && dst[kTile + r] >= 0 && col2 < n2)
        P[(int64_t)dst[kTile + r] * n2 + col2] =
            b[r * (kTile + 1) + tx] + a[tx * (kTile + 1) + r];
    }
    return;
  }
  if (bid < q) {
    // Y3[a, :, :]; S3[c, a, b] (= S3[c, b, a]) staged, read transposed
    const int a = (int)bid;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < q; c += kWarps)
      for (int b = lane; b < q; b += 32)
        s[c * qp + b] = S3[((int64_t)c * q + a) * q + b];
    __syncthreads();
    T* y3 = y + 1 + q + q2 + a * q2;
    const T s3 = scale != nullptr ? scale[3] : T(1);
    for (int b = warp; b < q; b += kWarps)
      for (int c = lane; c < q; c += 32) {
        T v = T(0);
        if (a != b && a != c && b != c) {
          v = S3[((int64_t)a * q + b) * q + c] +
              S3[((int64_t)b * q + a) * q + c] + s[c * qp + b];
          if (scale != nullptr) v = v * s3;
        }
        y3[b * q + c] = v;
      }
    return;
  }
  // y0: the partial rows in order, then the constant block
  if (threadIdx.x >= 32) return;
  T acc = T(0);
  for (int i = threadIdx.x; i < q; i += 32) acc += y0part[i];
  acc = warp_sum(acc);
  if (threadIdx.x == 0) {
    T y0 = acc + B.at(0, 0) + B.at(0, 1) + B.at(1, 0) + B.at(1, 1);
    if (shift != nullptr) y0 = y0 - shift[0];
    if (scale != nullptr) y0 = y0 * scale[0];
    y[0] = y0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symdual_y4(Blocks<T> B, const T* __restrict__ scale, T* __restrict__ y,
           const T* __restrict__ P) {
  const int q = B.q;
  const int64_t q2 = (int64_t)q * q;
  const int64_t ny2 = (q2 + kThreads - 1) / kThreads;
  int64_t bid = blockIdx.x;
  // the Y2 blocks first (their O(q) sums), then a block per (i, j)
  if (bid >= ny2) {
    bid -= ny2;
    const int i = (int)(bid / q), j = (int)(bid % q);
    const T* p_ij = P + (int64_t)hi_row(i, j, q) * q2;          // P3[i,j,k,l]
    T* y4 = y + 1 + q + q2 + q2 * q + bid * q2;
    const T s4 = scale != nullptr ? scale[4] : T(1);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // a warp per k, the lanes along l; a k that repeats i or j skips its
    // reads warp-wide
#pragma unroll 2
    for (int k = warp; k < q; k += kWarps) {
      const T* p_ik = P + (int64_t)hi_row(i, k, q) * q2 + j * q;  // P3[i,k,j,l]
      const T* p_jk = P + (int64_t)hi_row(j, k, q) * q2 + i * q;  // P3[j,k,i,l]
      const bool ok = i != j && k != i && k != j;
      for (int l = lane; l < q; l += 32) {
        T v = T(0);
        if (ok && l != i && l != j && l != k)
          v = p_ij[k * q + l] + p_ik[l] + p_jk[l];
        y4[k * q + l] = scale != nullptr ? v * s4 : v;
      }
    }
    return;
  }
  // Y2[a, b], a != b: the shared-index pairs from P3's rows (a, c) at
  // columns (c, b), then the single entries
  const int64_t t = bid * kThreads + threadIdx.x;
  if (t >= q2) return;
  const int a = (int)(t / q), b = (int)(t % q);
  T acc = T(0);
  if (a != b) {
#pragma unroll 8
    for (int c = 0; c < q; ++c)
      if (c != a && c != b) acc += P[(int64_t)hi_row(a, c, q) * q2 + c * q + b];
    acc += B.G(a, b) + B.G(b, a) + B.E(0, a, b) + B.E(1, a, b) +
           B.E(0, b, a) + B.E(1, b, a) + B.F(a, b, 0) + B.F(a, b, 1) +
           B.F(b, a, 0) + B.F(b, a, 1) + B.H(a, b, b) + B.H(b, a, a) +
           B.K(b, b, a) + B.K(a, a, b) + B.Tq(a, a, b, b) + B.Tq(b, b, a, a);
    if (scale != nullptr) acc = acc * scale[2];
  }
  y[1 + q + t] = acc;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const void* M, int q, const void* scale, const void* shift,
           void* y, void* ws, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  Blocks<T> B{(const T*)M, 2 + q + (int64_t)q * q, q, 2 + q};
  const int64_t q2 = (int64_t)q * q;
  cudaStream_t s = (cudaStream_t)stream;
  T* P = (T*)ws;                       // q^4: P2 and P3, a half each
  T* S3 = P + q2 * q2;                 // q^3
  T* y0part = S3 + q2 * q;             // q
  const T* sc = (const T*)scale;
  T* out = (T*)y;
  const size_t slab = sizeof(T) * (size_t)q * (q + 1);
  const size_t tiles = sizeof(T) * 2 * kTile * (kTile + 1);
  const size_t smem_sym = slab > tiles ? slab : tiles;
  cudaError_t err = allow_smem(symdual_stage<T>, slab);
  if (err == cudaSuccess) err = allow_smem(symdual_sym<T>, smem_sym);
  if (err != cudaSuccess) return (int)err;

  const int64_t npair = (int64_t)q * (q - 1) / 2;
  const unsigned g1 = (unsigned)(q + (2 * q + kWarps - 1) / kWarps + npair);
  symdual_stage<T><<<g1, kThreads, slab, s>>>(B, sc, out, P, S3, y0part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t nt = (q2 + kTile - 1) / kTile;
  const unsigned g2 = (unsigned)(nt * (nt + 1) / 2 + q + 1);
  symdual_sym<T><<<g2, kThreads, smem_sym, s>>>(B, sc, (const T*)shift, out,
                                                P, S3, y0part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const unsigned g3 = (unsigned)(q2 + (q2 + kThreads - 1) / kThreads);
  symdual_y4<T><<<g3, kThreads, 0, s>>>(B, sc, out, P);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- row blocks --

// This rank's rows: top (o, n~) and the Q rows (i, j), off <= i < off + ql;
// rep: this rank adds the terms of the replicated rows
template <typename T>
struct RowBlocks {
  const T* top;
  const T* rows;
  int64_t n;
  int q, o, off, ql;
  bool rep;
  __device__ __forceinline__ bool local(int i) const {
    return i >= off && i < off + ql;
  }
  __device__ __forceinline__ T at(int u, int64_t v) const {
    return top[(int64_t)u * n + v];
  }
  __device__ __forceinline__ T atq(int i, int j, int64_t v) const {
    return rows[((int64_t)(i - off) * q + j) * n + v];
  }
  __device__ __forceinline__ T Tq(int i, int j, int k, int l) const {
    return atq(i, j, o + (int64_t)k * q + l);
  }
  __device__ __forceinline__ T H(int b, int i, int j) const {
    return at(2 + b, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T K(int i, int j, int b) const {
    return atq(i, j, 2 + b);
  }
  __device__ __forceinline__ T E(int s, int i, int j) const {
    return at(s, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T F(int i, int j, int s) const {
    return atq(i, j, s);
  }
  __device__ __forceinline__ T G(int a, int b) const { return at(2 + a, 2 + b); }
};

// P2's two reads in the final pass: own_run(ip, z, x) is the run
// P2[off + ip, z, x, :] (this rank's rows), tr_run(x, y, ip) the run
// P2[x, y, off + ip, :] (every row at this rank's columns).  At one rank
// a single (q^2, q^2) buffer holds P2's rows (a, b), a <= b, and both
// read it; otherwise own is send2 (D, ql, q, ql, q) and tr is recv2
// (q^2, ql q).
template <typename T>
struct P2Runs {
  const T* own;
  const T* tr;
  int q, ql;
  __device__ __forceinline__ int64_t pair_row(int a, int b) const {
    return a <= b ? (int64_t)a * q + b : (int64_t)b * q + a;
  }
  __device__ __forceinline__ const T* own_run(int ip, int z, int x) const {
    if (ql == q) return own + pair_row(ip, z) * q * q + (int64_t)x * q;
    const int d = x / ql, xb = x - d * ql;
    return own + ((((int64_t)d * ql + ip) * q + z) * ql + xb) * q;
  }
  __device__ __forceinline__ const T* tr_run(int x, int y, int ip) const {
    const int64_t ld = (int64_t)(ql == q ? q : ql) * q;
    return tr + (ql == q ? pair_row(x, y) : (int64_t)x * q + y) * ld +
           (int64_t)ip * q;
  }
};

// T's local row (ip, j) into chunk j / ql of send1 (D, ql, ql, q^2), a
// block a row, by 16-byte vectors where the row's start and q^2 allow
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_pack(RowBlocks<T> A, T* __restrict__ send) {
  constexpr int V = 16 / sizeof(T);
  const int q = A.q;
  const int64_t q2 = (int64_t)q * q;
  const int ip = (int)(blockIdx.x / q), j = (int)(blockIdx.x % q);
  const int d = j / A.ql, jb = j - d * A.ql;
  const T* src = A.rows + ((int64_t)ip * q + j) * A.n + A.o;
  T* dst = send + (((int64_t)d * A.ql + ip) * A.ql + jb) * q2;
  if (q2 % V == 0 && ((uintptr_t)src | (uintptr_t)dst) % 16 == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int64_t t = threadIdx.x; t < q2 / V; t += kThreads) d4[t] = s4[t];
  } else {
    for (int64_t t = threadIdx.x; t < q2; t += kThreads) dst[t] = src[t];
  }
}

// the partial S3[e, f, g] before its (f, g) symmetrization: H's row e
// (replicated), T's row (e, e), and the column e of K and of T's (e, e)
// at this rank's row (f, g)
template <typename T>
__device__ __forceinline__ T s3_term(const RowBlocks<T>& A, int e, bool le,
                                     int f, int g) {
  T v = T(0);
  if (A.rep) v += A.H(e, f, g);
  if (le) v += A.Tq(e, e, f, g);
  if (A.local(f)) v += A.K(f, g, e) + A.Tq(f, g, e, e);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_pair(RowBlocks<T> A, const T* __restrict__ recv, T* __restrict__ P2,
          T* __restrict__ S3, T* __restrict__ flat, T* __restrict__ y0part) {
  __shared__ T ta[kTile][kTile + 1], tb[kTile][kTile + 1];
  const int q = A.q;
  const int64_t q2 = (int64_t)q * q;
  const int nt = (q + kTile - 1) / kTile, ntp = nt * (nt + 1) / 2;
  const int64_t nwarp = (2 * q + kWarps - 1) / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  constexpr int kRows = kThreads / kTile;
  int64_t bid = blockIdx.x;
  if (bid < nwarp) {
    const int64_t w = bid * kWarps + warp;
    if (w >= 2 * q) return;                            // warp-uniform
    if (w < q) {
      // y0's partial row i: the pairs (i, j) of this rank's row i
      const int i = (int)w;
      T acc = T(0);
      if (A.local(i))
        for (int j = lane; j < q; j += 32)
          acc += i == j ? A.K(i, i, i) + A.Tq(i, i, i, i)
                        : A.Tq(i, j, i, j) + A.Tq(i, j, j, i);
      acc = warp_sum(acc);
      if (lane == 0) y0part[i] = A.rep ? acc + A.G(i, i) + A.H(i, i, i) : acc;
      return;
    }
    const int a = (int)(w - q);
    const bool la = A.local(a);
    T acc = T(0);
    for (int i = lane; i < q; i += 32) {
      if (i == a) continue;
      if (A.rep) acc += A.H(i, i, a) + A.H(i, a, i);
      if (A.local(i))
        acc += A.K(i, a, i) + A.Tq(i, i, i, a) + A.Tq(i, i, a, i) +
               A.Tq(i, a, i, i);
      if (la) acc += A.K(a, i, i) + A.Tq(a, i, i, i);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (A.rep)
        acc += A.at(0, 2 + a) + A.at(1, 2 + a) + A.at(2 + a, 0) +
               A.at(2 + a, 1) + A.E(0, a, a) + A.E(1, a, a);
      if (la) acc += A.F(a, a, 0) + A.F(a, a, 1);
      flat[1 + a] = acc;
    }
    return;
  }
  bid -= nwarp;
  if (bid < (int64_t)q * ntp) {
    // the partial S3[e] on the tile pair (F, G), (G, F), F <= G:
    // S3[e, f, g] = v[f][g] + v[g][f]
    const int e = (int)(bid / ntp);
    int F, G;
    tri(bid % ntp, F, G);
    const bool le = A.local(e);
    const int f0 = F * kTile, g0 = G * kTile;
    for (int r = ty; r < kTile; r += kRows) {
      if (f0 + r < q && g0 + tx < q)
        ta[r][tx] = s3_term(A, e, le, f0 + r, g0 + tx);
      if (F != G && g0 + r < q && f0 + tx < q)
        tb[r][tx] = s3_term(A, e, le, g0 + r, f0 + tx);
    }
    __syncthreads();
    const T(*tbt)[kTile + 1] = F == G ? ta : tb;
    T* s3 = S3 + e * q2;
    for (int r = ty; r < kTile; r += kRows) {
      if (f0 + r < q && g0 + tx < q)
        s3[(int64_t)(f0 + r) * q + g0 + tx] = ta[r][tx] + tbt[tx][r];
      if (F != G && g0 + r < q && f0 + tx < q)
        s3[(int64_t)(g0 + r) * q + f0 + tx] = tb[r][tx] + ta[tx][r];
    }
    return;
  }
  bid -= (int64_t)q * ntp;
  // S's row T[i, j] + T[j, i] and P2's row S + S^T by 32 x 32 tile pairs.
  // One rank: a block per pair i <= j, both T rows read from ``rows``,
  // P2's row stored once, at row (i, j) of the (q^2, q^2) buffer.  Several:
  // a block per local row (i, j), i = off + ip, T[j, i] received in recv
  // (D, ql, ql, q^2) at [j / ql, j % ql, ip], P2's row stored by column
  // blocks into send2 (D, ql, q, ql, q)
  const bool one = A.ql == q;
  int ip, j;
  const T* rb;
  if (one) {
    tri(bid, ip, j);
    rb = A.rows + ((int64_t)j * q + ip) * A.n + A.o;
  } else {
    ip = (int)(bid / q);
    j = (int)(bid % q);
    const int sr = j / A.ql, jb = j - sr * A.ql;
    rb = recv + (((int64_t)sr * A.ql + jb) * A.ql + ip) * q2;
  }
  const T* ra = A.rows + ((int64_t)ip * q + j) * A.n + A.o;
  auto dst = [&](int k, int l) -> T* {
    if (one) return P2 + ((int64_t)ip * q + j) * q2 + (int64_t)k * q + l;
    const int d = k / A.ql, kb = k - d * A.ql;
    return P2 + ((((int64_t)d * A.ql + ip) * q + j) * A.ql + kb) * q + l;
  };
  for (int p = 0; p < ntp; ++p) {
    int KT, LT;
    tri(p, KT, LT);
    const int k0 = KT * kTile, l0 = LT * kTile;
    for (int r = ty; r < kTile; r += kRows) {
      if (k0 + r < q && l0 + tx < q) {
        const int64_t t = (int64_t)(k0 + r) * q + l0 + tx;
        ta[r][tx] = ra[t] + rb[t];
      }
      if (KT != LT && l0 + r < q && k0 + tx < q) {
        const int64_t t = (int64_t)(l0 + r) * q + k0 + tx;
        tb[r][tx] = ra[t] + rb[t];
      }
    }
    __syncthreads();
    const T(*tbt)[kTile + 1] = KT == LT ? ta : tb;
    for (int r = ty; r < kTile; r += kRows) {
      if (k0 + r < q && l0 + tx < q)
        *dst(k0 + r, l0 + tx) = ta[r][tx] + tbt[tx][r];
      if (KT != LT && l0 + r < q && k0 + tx < q)
        *dst(l0 + r, k0 + tx) = tb[r][tx] + ta[tx][r];
    }
    __syncthreads();
  }
}

// Y4's cubes: kCube^3 entries (j, k, l) of one i; sub-cubes staged with
// padded strides (kC2, kC1, 1) against bank conflicts
constexpr int kCube = 8;
constexpr int kC1 = kCube + 1, kC2 = kCube * kC1 + 1, kSub = kCube * kC2;
static_assert(kCube * kCube * kCube == 2 * kThreads,
              "two cube entries a thread");

// (A, B, C), A <= B <= C, of entry t of the tile triples taken C-major
__device__ __forceinline__ void tet(int64_t t, int& A, int& B, int& C) {
  int64_t c = (int64_t)cbrt(6.0 * (double)t);
  while (c > 0 && c * (c + 1) * (c + 2) / 6 > t) --c;
  while ((c + 1) * (c + 2) * (c + 3) / 6 <= t) ++c;
  C = (int)c;
  tri(t - c * (c + 1) * (c + 2) / 6, A, B);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_final(RowBlocks<T> A, P2Runs<T> P, const T* __restrict__ S3,
           const T* __restrict__ y0part, T* __restrict__ flat,
           T* __restrict__ y4) {
  __shared__ T sm[6 * kSub];
  const int q = A.q;
  const int64_t q2 = (int64_t)q * q;
  const int nt = (q + kTile - 1) / kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  constexpr int kRows = kThreads / kTile;
  int64_t bid = blockIdx.x;
  // the short roles first: Y3 by tiles, y0, Y2's partial
  if (bid < (int64_t)q * nt * nt) {
    // Y3[a, b, c] on the tile (B, C); S3[c, a, b] staged, read transposed
    T(*t)[kTile + 1] = reinterpret_cast<T(*)[kTile + 1]>(sm);
    const int a = (int)(bid / (nt * nt)), bc = (int)(bid % (nt * nt));
    const int b0 = bc / nt * kTile, c0 = bc % nt * kTile;
    for (int r = ty; r < kTile; r += kRows)
      if (c0 + r < q && b0 + tx < q)
        t[r][tx] = S3[((int64_t)(c0 + r) * q + a) * q + b0 + tx];
    __syncthreads();
    T* y3 = flat + 1 + q + q2 + a * q2;
    for (int r = ty; r < kTile; r += kRows) {
      const int b = b0 + r, c = c0 + tx;
      if (b >= q || c >= q) continue;
      T v = T(0);
      if (a != b && a != c && b != c)
        v = S3[((int64_t)a * q + b) * q + c] +
            S3[((int64_t)b * q + a) * q + c] + t[tx][r];
      y3[(int64_t)b * q + c] = v;
    }
    return;
  }
  bid -= (int64_t)q * nt * nt;
  if (bid == 0) {
    // y0: the partial rows in order, then the constant block
    if (threadIdx.x >= 32) return;
    T acc = T(0);
    for (int i = threadIdx.x; i < q; i += 32) acc += y0part[i];
    acc = warp_sum(acc);
    if (threadIdx.x == 0)
      flat[0] = A.rep ? acc + A.at(0, 0) + A.at(0, 1) + A.at(1, 0) + A.at(1, 1)
                      : acc;
    return;
  }
  --bid;
  const int64_t ny2 = (q2 + kThreads - 1) / kThreads;
  if (bid < ny2) {
    // Y2[a, b]'s partial, a thread a slot: P3[a, c, c, b] = P2[a, c, c, b]
    // + P2[c, b, a, c] over c, then the single entries of this rank's rows
    const int64_t t = bid * kThreads + threadIdx.x;
    if (t >= q2) return;
    const int a = (int)(t / q), b = (int)(t % q);
    T acc = T(0);
    if (a != b) {
      if (A.local(a)) {
        const int ip = a - A.off;
#pragma unroll 8
        for (int c = 0; c < q; ++c)
          if (c != a && c != b)
            acc += P.own_run(ip, c, c)[b] + P.tr_run(c, b, ip)[c];
        acc += A.F(a, b, 0) + A.F(a, b, 1) + A.K(a, a, b) + A.Tq(a, a, b, b);
      }
      if (A.local(b))
        acc += A.F(b, a, 0) + A.F(b, a, 1) + A.K(b, b, a) + A.Tq(b, b, a, a);
      if (A.rep)
        acc += A.G(a, b) + A.G(b, a) + A.E(0, a, b) + A.E(1, a, b) +
               A.E(0, b, a) + A.E(1, b, a) + A.H(a, b, b) + A.H(b, a, a);
    }
    flat[1 + q + t] = acc;
    return;
  }
  bid -= ny2;
  // Y4[i] (i = off + ip) by cubes: a block per ip and tile triple A <= B
  // <= C, blocks i-major.  With U[z; x, y] = P3[i, z, x, y] = P2[i, z, x,
  // y] + P2[x, y, i, z] (symmetric in x, y), Y4[i, j, k, l] = (U[j; k, l] +
  // U[k; j, l]) + U[l; k, j], and every order of the triple reads the same
  // three sub-cubes U[Z; X, Y] (Z one tile, X < Y the other two roles).
  // Their P2 runs (own along y, tr along z) are staged by cp.async, U is
  // formed once in place, and every distinct order of the triple is
  // written from it.
  const int nc = (q + kCube - 1) / kCube;
  const int64_t ntri = (int64_t)nc * (nc + 1) * (nc + 2) / 6;
  const int ip = (int)(bid / ntri), i = A.off + ip;
  int tl[3];
  tet(bid % ntri, tl[0], tl[1], tl[2]);
  T* sR = sm;                      // [s][z][x][y]: P2[i, z, x, y]
  T* sC = sm + 3 * kSub;           // [s][x][y][z]: P2[x, y, i, z]
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int z0 = tl[s] * kCube, x0 = tl[s == 0 ? 1 : 0] * kCube,
              y0 = tl[s == 2 ? 1 : 2] * kCube;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * kThreads;
      const int c = e % kCube, b = e / kCube % kCube, a = e / (kCube * kCube);
      const int at = s * kSub + a * kC2 + b * kC1 + c;
      if (z0 + a < q && x0 + b < q && y0 + c < q)
        cp_async_elem(sR + at, P.own_run(ip, z0 + a, x0 + b) + y0 + c);
      else
        sR[at] = T(0);
      if (x0 + a < q && y0 + b < q && z0 + c < q)
        cp_async_elem(sC + at, P.tr_run(x0 + a, y0 + b, ip) + z0 + c);
      else
        sC[at] = T(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // U[z; x, y] = P2[i, z, x, y] + P2[x, y, i, z] once, in place of sR
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * kThreads;
      const int z = e / (kCube * kCube), x = e / kCube % kCube,
                y = e % kCube;
      sR[s * kSub + z * kC2 + x * kC1 + y] +=
          sC[s * kSub + x * kC2 + y * kC1 + z];
    }
  __syncthreads();
  // U[z; .,.] from sub-cube s, the pair's roles r1, r2 at offsets c1, c2
  auto U = [&](int s, int z, int r1, int c1, int r2, int c2) -> T {
    const int x = r1 < r2 ? c1 : c2, y = r1 < r2 ? c2 : c1;
    return sR[s * kSub + z * kC2 + x * kC1 + y];
  };
  constexpr int perm[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                              {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int pj = perm[p][0], pk = perm[p][1], pl = perm[p][2];
    bool dup = false;                   // an earlier order's tiles
#pragma unroll
    for (int p2 = 0; p2 < p; ++p2)
      dup |= tl[perm[p2][0]] == tl[pj] && tl[perm[p2][1]] == tl[pk] &&
             tl[perm[p2][2]] == tl[pl];
    if (dup) continue;                  // block-uniform
    const int j0 = tl[pj] * kCube, k0 = tl[pk] * kCube, l0 = tl[pl] * kCube;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * kThreads;
      const int ll = e % kCube, kk = e / kCube % kCube,
                jj = e / (kCube * kCube);
      const int j = j0 + jj, k = k0 + kk, l = l0 + ll;
      if (j >= q || k >= q || l >= q) continue;
      T v = T(0);
      if (i != j && i != k && i != l && j != k && j != l && k != l)
        v = U(pj, jj, pk, kk, pl, ll) + U(pk, kk, pj, jj, pl, ll) +
            U(pl, ll, pk, kk, pj, jj);
      y4[(((int64_t)ip * q + j) * q + k) * q + l] = v;
    }
  }
}

// one stage of the row-block mode: 0 rows_pack (several ranks only), 1
// rows_pair, 2 rows_final.  ws: S3 (q^3), y0part (q), then P2 (ql q^3:
// the (q^2, q^2) buffer at one rank, send1 / send2 otherwise) and, with
// several ranks, recv1 / recv2 (ql q^3).
template <typename T>
int launch_rows(const void* top, const void* rows, int q, int off, int ql,
                int rep, int stage, void* flat, void* y4, void* ws,
                void* stream) {
  if (q <= 0 || ql <= 0 || q % ql != 0 || off % ql != 0 || off + ql > q)
    return (int)cudaErrorInvalidValue;
  RowBlocks<T> A{(const T*)top, (const T*)rows, 2 + q + (int64_t)q * q, q,
                 2 + q, off, ql, rep != 0};
  const int64_t q2 = (int64_t)q * q, blk = (int64_t)ql * q * q2;
  const bool one = ql == q;
  T* S3 = (T*)ws;
  T* y0part = S3 + q2 * q;
  T* bufA = y0part + q;
  T* bufB = one ? nullptr : bufA + blk;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nrow = (int64_t)ql * q;
  const int nt = (q + kTile - 1) / kTile;
  if (stage == 0) {
    if (one) return (int)cudaErrorInvalidValue;      // nothing to exchange
    rows_pack<T><<<(unsigned)nrow, kThreads, 0, s>>>(A, bufA);
  } else if (stage == 1) {
    const int64_t nwarp = (2 * q + kWarps - 1) / kWarps;
    const int64_t tasks = one ? (int64_t)q * (q + 1) / 2 : nrow;
    const unsigned g =
        (unsigned)(nwarp + (int64_t)q * (nt * (nt + 1) / 2) + tasks);
    rows_pair<T><<<g, kThreads, 0, s>>>(A, bufB, bufA, S3, (T*)flat, y0part);
  } else if (stage == 2) {
    P2Runs<T> P{bufA, one ? bufA : bufB, q, ql};
    const int64_t nc = (q + kCube - 1) / kCube;
    const int64_t ntri = nc * (nc + 1) * (nc + 2) / 6;
    const unsigned g = (unsigned)((int64_t)q * nt * nt + 1 +
                                  (q2 + kThreads - 1) / kThreads + ql * ntri);
    rows_final<T><<<g, kThreads, 0, s>>>(A, P, S3, y0part, (T*)flat, (T*)y4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symdual_apply_rows_f64(const void* top, const void* rows, int q, int off,
                           int ql, int rep, int stage, void* flat, void* y4,
                           void* ws, void* stream) {
  return launch_rows<double>(top, rows, q, off, ql, rep, stage, flat, y4, ws,
                             stream);
}

int symdual_apply_rows_f32(const void* top, const void* rows, int q, int off,
                           int ql, int rep, int stage, void* flat, void* y4,
                           void* ws, void* stream) {
  return launch_rows<float>(top, rows, q, off, ql, rep, stage, flat, y4, ws,
                            stream);
}


int symdual_apply_f64(const void* M, int q, const void* scale,
                      const void* shift, void* y, void* ws, void* stream) {
  return launch<double>(M, q, scale, shift, y, ws, stream);
}

int symdual_apply_f32(const void* M, int q, const void* scale,
                      const void* shift, void* y, void* ws, void* stream) {
  return launch<float>(M, q, scale, shift, y, ws, stream);
}

}  // extern "C"
