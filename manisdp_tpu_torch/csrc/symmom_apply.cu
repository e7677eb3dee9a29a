// K9: the BQP moment-SDP operator A(M) on the expanded pair basis
// (n~ = 2 + q + q^2, o = 2 + q: columns 0, 1 the two copies of the
// constant, 2 + a the first copy of x_a, o + i q + j the grid slot
// x_i x_j, whose diagonal o + a q + a is the second copy of x_a).
//
// Replaces ops/symmom.py _apply_jit of the JAX package (_compress_entries
// and _rows_from_entries on Ms = (M + M^T) / 2): the copy-averaged
// original-entry tensors c00, cA, cD, cG, cP0, cH, cT, then the bqpmom row
// families written into the flat layout
//   [r0 (1), D1 (q), D2 (q^2), SUBv (q^2), SUBp (q^3), EQ2 (q^2),
//    EQ4 (q^3), EQ6 (q^4)]
// with every don't-care slot exactly 0 (the JAX function's where-chain).
//
// cT[a,b,c,d] is 1/8 of the eight entries of M at (ab|ba, cd|dc) and
// their transposes, and the rows read it only at a != b, c != d.  With
// V[{ab},{cd}] = (M[ab,cd] + M[ba,cd]) + (M[ab,dc] + M[ba,dc]), cT =
// (V + V^T) / 8.  Unordered pairs {a < b} are numbered row-major,
// pi(a, b) = a (2q - a - 1) / 2 + b - a - 1 (P = q (q - 1) / 2 of them),
// so pi(c, d) runs along d.
//
// Three launches; no pass reads a column of M's T block:
//   mom_stage   a block per pair a < b: rows ab and ba of the T block
//               (coalesced) summed into a q x (q + 1) slab in shared
//               memory, V's row pi(a, b) written from it (the (c, d) swap
//               read transposed in shared memory).  Blocks before them
//               (first in the grid) take the border copy: for the rows
//               u in 0 .. o - 1 and the q diagonal-pair rows o + a (q + 1),
//               Bs[k(u), v] = Ms[u, v], the columns M[:, u] read by 32-row
//               tiles.  Every Ms entry the O(q^3) families read has one
//               index in that border, so they read Bs along rows.
//   mom_sym     cT = (V + V^T) / 8 in place, a block per pair of 32 x 32
//               tiles (I, J), (J, I): both read into shared memory, then
//               cT[{ab},{cd}] written once, at (pi(ab), pi(cd)) when {ab}
//               comes first in (max, min) order and at (pi(cd), pi(ab))
//               otherwise.  Per-block tables hold the 64 tile rows' keys.
//   mom_rows    the O(q^3) families a thread per slot, in the first
//               blocks; then EQ6 a block per (i, j), its q^2 slots
//               contiguous, warps along k and lanes along l.  An EQ6 read
//               cT(x, y, z, l) has l > x, y, z, so it lies at
//               (pi(x, y), pi(z, l)): consecutive l, consecutive words.
// The 8-term sum is grouped as above, not as the JAX package's
// ((M + M^T) / 2 then P + P^T), so the result may differ from the plain
// twin in the last bits; it is fixed, so a call repeats bit for bit.
//
// Workspace: P^2 (V, then cT in its ordered half) + (o + q) n~ (Bs)
// entries: 3.58 M at q = 60 (14.3 / 28.6 MB f32 / f64), 26.5 M at
// q = 100, against q^4 (13.0 M, 100 M) before.
//
// What bounds it on an H100: bytes.  At q = 60 the function must read M
// (n~^2 = 13.4 M entries) and write the m = 13.4 M slots: 32 / 64 us at
// 3.35 TB/s in f32 / f64.  This design reads the T block once (by rows),
// writes and re-reads V (q^4 / 4 entries, L2-resident at q = 60) and
// writes the slots: about 1.3x the bound's bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

template <typename T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// p -> (I <= J) with p = J (J + 1) / 2 + I
__device__ __forceinline__ void tri(int64_t p, int& I, int& J) {
  int64_t j = (int64_t)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  J = (int)j;
  I = (int)(p - j * (j + 1) / 2);
}

// the row-major pair number pi(a, b) of a < b, and its inverse
__device__ __forceinline__ int64_t pidx(int a, int b, int q) {
  return (int64_t)a * (2 * q - a - 1) / 2 + (b - a - 1);
}
__device__ __forceinline__ void pair_of(int64_t pi, int q, int& a, int& b) {
  const double t = 2.0 * q - 1.0;
  int64_t x = (int64_t)((t - sqrt(t * t - 8.0 * (double)pi)) * 0.5);
  if (x < 0) x = 0;
  while (x > 0 && pidx((int)x, (int)x + 1, q) > pi) --x;
  while (x + 1 < q - 1 && pidx((int)x + 1, (int)x + 2, q) <= pi) ++x;
  a = (int)x;
  b = (int)(pi - pidx(a, a + 1, q)) + a + 1;
}

template <typename T>
struct Mom {
  const T* M;
  int64_t n;   // n~
  int q, o;
  int64_t P;   // unordered pairs
  T* ct;       // P x P: V, then cT
  T* bs;       // (o + q) x n~: the border rows of Ms
  int nbt;     // border tiles (blocks before the pair blocks of mom_stage)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mom_stage(Mom<T> X) {
  const int q = X.q, o = X.o, qp = q + 1;
  const int64_t n = X.n;
  T* s = smem<T>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((int)blockIdx.x < X.nbt) {
    // Bs[k, v] = (M[u_k, v] + M[v, u_k]) / 2 for v in this 32-column tile
    const int nk = o + q;
    const int64_t v0 = (int64_t)blockIdx.x * kTile;
    for (int r = warp; r < kTile; r += kWarps) {
      const int64_t v = v0 + r;
      if (v >= n) break;
      const T* row = X.M + v * n;
      for (int k = lane; k < o; k += 32) s[k * (kTile + 1) + r] = row[k];
      for (int a = lane; a < q; a += 32)
        s[(o + a) * (kTile + 1) + r] = row[o + (int64_t)a * qp];
    }
    __syncthreads();
    const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
    const int64_t v = v0 + tx;
    if (v >= n) return;
    for (int k = ty; k < nk; k += kThreads / kTile) {
      const int64_t u = k < o ? k : o + (int64_t)(k - o) * qp;
      X.bs[k * n + v] = T(0.5) * (X.M[u * n + v] + s[k * (kTile + 1) + tx]);
    }
    return;
  }
  // V's row pi(a, b): rows ab and ba of the T block summed into the slab
  int a, b;
  tri(blockIdx.x - X.nbt, a, b);
  ++b;
  const T* ra = X.M + (o + (int64_t)a * q + b) * n + o;
  const T* rb = X.M + (o + (int64_t)b * q + a) * n + o;
#pragma unroll 4
  for (int c = warp; c < q; c += kWarps)
    for (int d = lane; d < q; d += 32)
      s[c * qp + d] = ra[c * q + d] + rb[c * q + d];
  __syncthreads();
  T* vrow = X.ct + pidx(a, b, q) * X.P;
  for (int c = warp; c < q - 1; c += kWarps) {
    T* out = vrow + pidx(c, c + 1, q) - (c + 1);
    for (int d = c + 1 + lane; d < q; d += 32)
      out[d] = s[c * qp + d] + s[d * qp + c];
  }
}

// cT = (V + V^T) / 8 on the tile pair (I, J), (J, I), stored once per
// unordered pair of pairs: at (R, C) when key(R) <= key(C), key = (max,
// min) of the pair, so an EQ6 read (second pair holding the largest
// index) always finds it there
template <typename T>
__global__ void __launch_bounds__(kThreads)
mom_sym(Mom<T> X) {
  __shared__ T ta[kTile][kTile + 1], tb[kTile][kTile + 1];
  __shared__ int key[2 * kTile];
  int I, J;
  tri(blockIdx.x, I, J);
  const int64_t P = X.P;
  const int q = X.q;
  if (threadIdx.x < 2 * kTile) {
    const int64_t pi = (threadIdx.x < kTile ? I : J) * (int64_t)kTile +
                       threadIdx.x % kTile;
    int a = 0, b = 0;
    if (pi < P) pair_of(pi, q, a, b);
    key[threadIdx.x] = pi < P ? b * q + a : -1;
  }
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int64_t rI = (int64_t)I * kTile, rJ = (int64_t)J * kTile;
  for (int r = ty; r < kTile; r += kThreads / kTile) {
    if (rI + r < P && rJ + tx < P) ta[r][tx] = X.ct[(rI + r) * P + rJ + tx];
    if (I != J && rJ + r < P && rI + tx < P)
      tb[r][tx] = X.ct[(rJ + r) * P + rI + tx];
  }
  __syncthreads();
  T (*vt)[kTile + 1] = I == J ? ta : tb;
  // tile (I, J): element (R, C) = (rI + r, rJ + c)
  for (int r = ty; r < kTile; r += kThreads / kTile) {
    const int kr = key[r], kc = key[kTile + tx];
    if (kr >= 0 && kc >= 0 && kr <= kc)
      X.ct[(rI + r) * P + rJ + tx] = T(0.125) * (ta[r][tx] + vt[tx][r]);
  }
  if (I == J) return;
  // tile (J, I): element (C, R) = (rJ + c, rI + r), C first in order
  for (int c = ty; c < kTile; c += kThreads / kTile) {
    const int kc = key[kTile + c], kr = key[tx];
    if (kr >= 0 && kc >= 0 && kc < kr)
      X.ct[(rJ + c) * P + rI + tx] = T(0.125) * (tb[c][tx] + ta[tx][c]);
  }
}

// the Ms entries of the border rows (Bs) and cT, by basis block
template <typename T>
struct Rows {
  const T* bs;
  const T* ct;
  int64_t n, P;
  int q, o;
  __device__ __forceinline__ T ms(int k, int64_t v) const {
    return bs[k * n + v];
  }
  __device__ __forceinline__ T G(int a, int b) const { return ms(2 + a, 2 + b); }
  __device__ __forceinline__ T H(int a, int i, int j) const {
    return ms(2 + a, o + (int64_t)i * q + j);
  }
  // T4(a, a, c, d): the diagonal-pair row a of the border
  __device__ __forceinline__ T T4(int a, int c, int d) const {
    return ms(o + a, o + (int64_t)c * q + d);
  }
  __device__ __forceinline__ T E(int s, int i, int j) const {
    return ms(s, o + (int64_t)i * q + j);
  }
  __device__ __forceinline__ T c00() const {
    return T(0.25) * (ms(0, 0) + ms(0, 1) + ms(1, 0) + ms(1, 1));
  }
  __device__ __forceinline__ T cA(int a) const {
    return T(0.25) * (ms(0, 2 + a) + ms(1, 2 + a) + E(0, a, a) + E(1, a, a));
  }
  __device__ __forceinline__ T cD(int a) const {
    return T(0.25) * (G(a, a) + T(2) * H(a, a, a) + T4(a, a, a));
  }
  __device__ __forceinline__ T cG(int a, int b) const {
    return T(0.25) * (G(a, b) + H(a, b, b) + H(b, a, a) + T4(a, b, b));
  }
  __device__ __forceinline__ T cP0(int a, int b) const {
    return T(0.25) * (E(0, a, b) + E(0, b, a) + E(1, a, b) + E(1, b, a));
  }
  __device__ __forceinline__ T cH(int a, int b, int c) const {
    return T(0.25) * (H(a, b, c) + H(a, c, b) + T4(a, b, c) + T4(a, c, b));
  }
  // cT(a, b, c, d), a != b, c != d: each pair through (min, max), the
  // stored one of (R, C) / (C, R)
  __device__ __forceinline__ T cT(int a, int b, int c, int d) const {
    const int a0 = min(a, b), b0 = max(a, b), c0 = min(c, d), d0 = max(c, d);
    int64_t R = pidx(a0, b0, q), C = pidx(c0, d0, q);
    if (b0 * q + a0 > d0 * q + c0) {
      const int64_t t = R;
      R = C;
      C = t;
    }
    return ct[R * P + C];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mom_rows(Rows<T> X, int nsmall_blocks, T* __restrict__ out) {
  const int q = X.q;
  const int q2 = q * q;
  const int oD2 = 1 + q, oSv = oD2 + q2, oSp = oSv + q2, oE2 = oSp + q2 * q,
            oE4 = oE2 + q2, oE6 = oE4 + q2 * q;
  if ((int)blockIdx.x >= nsmall_blocks) {
    // EQ6: a block per (i, j) (q^2 contiguous slots), warps along k,
    // lanes along l
    const int ij = blockIdx.x - nsmall_blocks;
    const int i = ij / q, j = ij - i * q;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool one = i < j;
    const int64_t P = X.P;
    T* o6 = out + oE6 + (int64_t)ij * q2;
    for (int k = warp; k < q; k += kWarps) {
      const bool valid = i != j && k > max(i, j);
      // cT(j, k, i, l) and cT(i, j, k, l) (row 1) / cT(i, k, j, l) (row 2):
      // the first pairs' rows of cT, the second pair (x, l) at pi(x, l)
      const T* rjk = X.ct + (valid ? pidx(j, k, q) * P : 0);
      const T* rX =
          X.ct + (valid ? (one ? pidx(i, j, q) : pidx(i, k, q)) * P : 0);
      // pi(x, l) = bx + l for the second pair's x
      const int64_t bi = pidx(i, i + 1, q) - i - 1,
                    bx = one ? pidx(k, k + 1, q) - k - 1
                             : pidx(j, j + 1, q) - j - 1;
      for (int l = lane; l < q; l += 32) {
        T val = T(0);
        if (valid && l > k) {
          const T w1 = rjk[bi + l];
          const T other = rX[bx + l];
          val = one ? w1 - other : other - w1;
        }
        o6[k * q + l] = val;
      }
    }
    return;
  }
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= oE6) return;
  T val = T(0);
  if (idx >= oE4) {
    const int r = idx - oE4;
    const int k = r % q, j = (r / q) % q, i = r / q2;
    if (i != j && k > i && k > j) val = X.cH(k, i, j) - X.cH(i, j, k);
  } else if (idx >= oE2) {
    const int r = idx - oE2;
    const int a = r / q, b = r % q;
    if (a < b) val = X.cG(a, b) - X.cP0(a, b);
  } else if (idx >= oSp) {
    const int r = idx - oSp;
    const int c = r % q, b = (r / q) % q, k = r / q2;
    if (b < c && k != b && k != c)
      val = T(2) * X.cT(k, b, k, c) - (X.cP0(b, c) + X.cG(b, c));
  } else if (idx >= oSv) {
    const int r = idx - oSv;
    const int k = r / q, b = r % q;
    if (k != b) val = T(2) * X.cH(k, k, b) - T(2) * X.cA(b);
  } else if (idx >= oD2) {
    const int r = idx - oD2;
    const int a = r / q, b = r % q;
    if (a != b) val = T(0.5) * X.cD(a) - T(0.5) * X.cT(a, b, a, b);
  } else if (idx >= 1) {
    val = T(0.5) * X.c00() - T(0.5) * X.cD(idx - 1);
  } else {
    val = X.c00();
  }
  out[idx] = val;
}

template <typename T>
int launch(const void* M, int q, void* ws, void* out, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  const int o = 2 + q;
  const int64_t n = o + (int64_t)q * q;
  const int64_t P = (int64_t)q * (q - 1) / 2;
  const int64_t q2 = (int64_t)q * q;
  Mom<T> X{(const T*)M, n, q, o, P, (T*)ws, (T*)ws + P * P,
           (int)((n + kTile - 1) / kTile)};
  const size_t slab = (size_t)q * (q + 1) * sizeof(T);
  const size_t border = (size_t)(o + q) * (kTile + 1) * sizeof(T);
  const size_t smem = slab > border ? slab : border;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mom_stage<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  mom_stage<T><<<(unsigned)(X.nbt + P), kThreads, smem, s>>>(X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t tp = (P + kTile - 1) / kTile;
  if (tp > 0) {
    mom_sym<T><<<(unsigned)(tp * (tp + 1) / 2), kThreads, 0, s>>>(X);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t nsmall = 1 + q + 3 * q2 + 2 * q2 * q;
  const int nsb = (int)((nsmall + kThreads - 1) / kThreads);
  const int64_t neq6 = q2;
  Rows<T> R{X.bs, X.ct, n, P, q, o};
  mom_rows<T><<<(unsigned)(nsb + neq6), kThreads, 0, s>>>(R, nsb, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int symmom_apply_f64(const void* M, int q, void* ws, void* out,
                     void* stream) {
  return launch<double>(M, q, ws, out, stream);
}

int symmom_apply_f32(const void* M, int q, void* ws, void* out,
                     void* stream) {
  return launch<float>(M, q, ws, out, stream);
}

}  // extern "C"
