// K4: CSR gather-sum with an optional affine epilogue.
//
//   y[r] = base[r] + alpha * sum_{e in ptr[r] .. ptr[r+1]} val[e] * x[col[e]]
//
// (base absent: y[r] = alpha * sum ...).  Replaces the JAX package's
// scalar gather + segment-sum chains of the constraint operators:
//   ops/sparse.py  ConstraintOp.apply_from_e / apply_factored  (rows =
//                  constraints k, ptr over the k-sorted entries, col = a2p,
//                  x = pattern values e):  A(vec(M)) from M on the pattern
//   ops/sparse.py  ConstraintOp.adjoint_on_pattern / es_vals / s_vals
//                  (rows = pattern entries, ptr over a2p_sorted, col = kp,
//                  val = vp, x = multipliers w; base = c on the pattern and
//                  alpha = sigma or -1 fold es_vals and s_vals in)
//   ops/dualops.py DualOp apply / y_step (rows = constraints of the BQP
//                  SOS dual, col = flat positions of mat(M)) and the iAB
//                  pair of the general dual (row and column CSR)
//   ConstraintOp.colsum_pattern (rows = pattern columns, x = ones)
// A row whose segment is empty (a pattern entry that only C touches)
// yields base[r] alone.
//
// Mode scatter_pos (``pos`` given): row r is written at position pos[r]
// instead of r,
//   y[pos[r]] = base[pos[r]] + alpha * sum_{e in ptr[r] .. ptr[r+1]} ...
// and y is left as the caller filled it everywhere else.  It replaces the
// scatter-adds of the JAX package's DenseConstraintOp
// (ops/sparse.py:401-409 adjoint_on_pattern, es_vals, s_vals) and of the
// DualOp adjoint (ops/dualops.py:185): rows = distinct flat positions, ptr
// over the entries sorted by position, col = constraint k, x = multipliers
// w.  Each position has one row, so one writer: no atomics.
//
// Row lengths differ by three orders of magnitude between call sites and
// inside one operator: 0-2 entries at matrix completion (9.0 M rows),
// ~6 with one row of n and n - 1 rows of 2q in the q-variable BQP DualOp
// (q = 60: one row of 1,831 entries, 1,830 of 120, 521,855 of 6; the long
// rows are rows 0-1,830), ~120 in the iAB column CSR (497 rows at d = 30),
// ~750 in colsum_pattern at n = 12,000.  With one thread per row and its
// loads in sequence, the longest row set the time: a 1,831-entry row is
// ~1,831 dependent L2 gathers (~0.14 ms).
//
// Every row is summed in entry order, acc = fma(val[e], x[col[e]], acc)
// from acc = 0, as a sequential loop does.  The dual and AL drivers'
// trajectories follow the last bits of these sums (on the card a q = 30
// BQP dual that certifies at its 13th outer iteration with this order
// ends in a rank-1 stall with a pairwise order, and with the plain twin),
// so K4 keeps the order and makes the loads, not the sum, parallel.
// Three kernels:
//   rows:  a thread per row (mean row length nnz / rows <= 16, known on
//          the host without reading ptr): two rows per thread, 2 loads per
//          row at a time, for a mean up to 2 (matrix completion, the
//          scatters); one row, 4 loads at a time, above (the DualOp's
//          rows of 6).  No shared memory and few registers, so the
//          latency-bound short rows keep the SM full.  It skips every
//          row longer than long_row, a launch argument; the wrapper
//          passes the list of exactly those rows, built from the same
//          ptr and threshold (host numpy, once per ptr tensor).
//   long:  a warp per listed long row.  It runs first and lets `rows`
//          start at once (programmatic dependent launch: it triggers its
//          dependents on entry), so the long rows, like the DualOp's
//          1,831, overlap the short ones; block 0 of `rows` waits for it
//          before exiting, so the pair completes together.
//   warps: a warp per row (mean > 16: colsum_pattern, the iAB columns).
// A warp walk loads a round of 32 * kWalk entries (coalesced col / val,
// the gathers of x in flight together) into shared memory, and lane 0
// adds them in order while the gathers of the next two rounds and the
// col / val loads of the one after are in flight: a row of L entries
// costs ~L dependent fmas.
// No float atomics; a call repeats bit for bit and gives the sums of a
// sequential loop.  What bounds it on an H100: HBM traffic, the col / val
// arrays (12 B per entry in f64, 8 B in f32) plus ptr and the output; the
// gathered x (at most 72 MB at n = 12,000) is partly L2 resident.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWalk = 4;         // entries per lane per warp round
constexpr int kLongWarps = 8;    // warps per block of the long kernel
constexpr int kChain = 8;        // staged pairs lane 0 reads at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T v, g;
};

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ y,
                                      const T* __restrict__ base, T alpha,
                                      const int* __restrict__ pos, int r,
                                      T acc) {
  const int at = pos != nullptr ? pos[r] : r;
  y[at] = base != nullptr ? base[at] + alpha * acc : alpha * acc;
}

// lane loads col and val of entries e0 + lane + 32 u (u < KB) below b
// (col -1 past b)
template <typename T, int KB>
__device__ __forceinline__ void load_cv(const int* __restrict__ col,
                                        const T* __restrict__ val, int e0,
                                        int b, int lane, int (&c)[KB],
                                        T (&v)[KB]) {
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const int i = e0 + lane + 32 * u;
    c[u] = i < b ? col[i] : -1;
    v[u] = i < b ? val[i] : T(0);
  }
}

template <typename T, int KB>
__device__ __forceinline__ void gather(const T* __restrict__ x,
                                       const int (&c)[KB], T (&g)[KB]) {
#pragma unroll
  for (int u = 0; u < KB; ++u) g[u] = c[u] >= 0 ? x[c[u]] : T(0);
}

// the whole warp, entries a .. b (warp-uniform) summed in order by lane 0,
// which returns the sum; rounds of 32 * kWalk entries pass through buf
template <typename T>
__device__ __forceinline__ T warp_sum(const T* __restrict__ x,
                                      const int* __restrict__ col,
                                      const T* __restrict__ val, int a,
                                      int b, int lane, Pair<T>* buf) {
  constexpr int KB = kWalk, W = 32 * KB;
  const int rounds = (b - a + W - 1) / W;
  int c[KB];
  T v0[KB], g0[KB], v1[KB], g1[KB], v2[KB];
  load_cv<T, KB>(col, val, a, b, lane, c, v0);
  gather<T, KB>(x, c, g0);
  load_cv<T, KB>(col, val, a + W, b, lane, c, v1);
  gather<T, KB>(x, c, g1);
  load_cv<T, KB>(col, val, a + 2 * W, b, lane, c, v2);
  T acc = T(0);
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int u = 0; u < KB; ++u) buf[lane + 32 * u] = Pair<T>{v0[u], g0[u]};
    __syncwarp();
    T g2[KB], v3[KB];
    gather<T, KB>(x, c, g2);
    load_cv<T, KB>(col, val, a + (k + 3) * W, b, lane, c, v3);
    if (lane == 0) {
      // groups of kChain pairs: the next group is read while this one is
      // added
      const int n = b - (a + k * W) < W ? b - (a + k * W) : W;
      int j = 0;
      if (n >= kChain) {
        Pair<T> q[kChain];
#pragma unroll
        for (int t = 0; t < kChain; ++t) q[t] = buf[t];
        for (; j + 2 * kChain <= n; j += kChain) {
          Pair<T> nq[kChain];
#pragma unroll
          for (int t = 0; t < kChain; ++t) nq[t] = buf[j + kChain + t];
#pragma unroll
          for (int t = 0; t < kChain; ++t) acc += q[t].v * q[t].g;
#pragma unroll
          for (int t = 0; t < kChain; ++t) q[t] = nq[t];
        }
#pragma unroll
        for (int t = 0; t < kChain; ++t) acc += q[t].v * q[t].g;
        j += kChain;
      }
      for (; j < n; ++j) acc += buf[j].v * buf[j].g;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      v0[u] = v1[u];
      g0[u] = g1[u];
      v1[u] = v2[u];
      g1[u] = g2[u];
      v2[u] = v3[u];
    }
  }
  return acc;
}

// a thread per row: rows (chunk * kRows + q) * 32 + lane (q < kRows) of
// chunk blockIdx.x * kWarps + warp, their entries in order, kBatch loads
// per row at a time; rows longer than long_row are skipped (the long
// kernel sums them)
template <typename T, int kRows, int kBatch>
__global__ void __launch_bounds__(kThreads)
csr_gather_rows(const T* __restrict__ x, const int* __restrict__ ptr,
                const int* __restrict__ col, const T* __restrict__ val,
                const T* __restrict__ base, T alpha,
                const int* __restrict__ pos, int nrows, int long_row,
                T* __restrict__ y) {
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r[kRows], a[kRows], b[kRows];
  int len = 0;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    r[q] = (chunk * kRows + q) * 32 + (threadIdx.x & 31);
    a[q] = b[q] = 0;
    if (r[q] < nrows) {
      a[q] = ptr[r[q]];
      b[q] = ptr[r[q] + 1];
    }
    if (b[q] - a[q] > long_row) r[q] = nrows;  // the long kernel's
    if (r[q] >= nrows) b[q] = a[q];
    len = max(len, b[q] - a[q]);
  }
  T acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = T(0);
  for (int o = 0; o < len; o += kBatch) {
    int c[kRows][kBatch];
    T v[kRows][kBatch], g[kRows][kBatch];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = a[q] + o + u;
        c[q][u] = e < b[q] ? col[e] : 0;
        v[q][u] = e < b[q] ? val[e] : T(0);
      }
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        g[q][u] = a[q] + o + u < b[q] ? x[c[q][u]] : T(0);
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (a[q] + o + u < b[q]) acc[q] += v[q][u] * g[q][u];
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    if (r[q] < nrows) store(y, base, alpha, pos, r[q], acc[q]);
  // the long kernel, if any, must be done before this grid counts as
  // complete (a no-op without a prerequisite grid)
  if (blockIdx.x == 0 && threadIdx.x == 0)
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// a warp per listed row (rows[i], i < nlong), kLongWarps warps a block
template <typename T>
__global__ void __launch_bounds__(32 * kLongWarps)
csr_gather_long(const T* __restrict__ x, const int* __restrict__ ptr,
                const int* __restrict__ col, const T* __restrict__ val,
                const T* __restrict__ base, T alpha,
                const int* __restrict__ pos, const int* __restrict__ rows,
                int nlong, T* __restrict__ y) {
  // let the rows kernel start now: it touches none of these rows
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __shared__ Pair<T> s_buf[kLongWarps][32 * kWalk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kLongWarps + warp;
  if (i >= nlong) return;  // whole warp leaves together
  const int r = rows[i];
  const T acc = warp_sum(x, col, val, ptr[r], ptr[r + 1], lane, s_buf[warp]);
  if (lane == 0) store(y, base, alpha, pos, r, acc);
}

// a warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_gather_warps(const T* __restrict__ x, const int* __restrict__ ptr,
                 const int* __restrict__ col, const T* __restrict__ val,
                 const T* __restrict__ base, T alpha,
                 const int* __restrict__ pos, int nrows,
                 T* __restrict__ y) {
  __shared__ Pair<T> s_buf[kWarps][32 * kWalk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= nrows) return;  // whole warp leaves together
  const T acc = warp_sum(x, col, val, ptr[r], ptr[r + 1], lane, s_buf[warp]);
  if (lane == 0) store(y, base, alpha, pos, r, acc);
}

template <typename T, int kRows, int kBatch>
int launch_rows(const T* x, const int* ptr, const int* col, const T* val,
                const T* base, T alpha, const int* pos, int nrows,
                int long_row, const int* long_rows, int nlong, T* y,
                cudaStream_t s) {
  if (nlong > 0) {
    csr_gather_long<T><<<(nlong + kLongWarps - 1) / kLongWarps,
                         32 * kLongWarps, 0, s>>>(
        x, ptr, col, val, base, alpha, pos, long_rows, nlong, y);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int chunks = (nrows + 32 * kRows - 1) / (32 * kRows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((chunks + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nlong > 0 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, csr_gather_rows<T, kRows, kBatch>,
                                 x, ptr, col, val, base, alpha, pos, nrows,
                                 long_row, y);
}

// plan: 0 = a thread per row, two rows per thread, 2 loads per row at a
// time (mean row length <= 2); 1 = a thread per row, 4 loads at a time;
// 2 = a warp per row
template <typename T>
int launch(const void* x, const void* ptr, const void* col, const void* val,
           const void* base, double alpha, const void* pos, int nrows,
           int plan, int long_row, const void* long_rows, int nlong, void* y,
           void* stream) {
  if (nrows <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xt = (const T*)x;
  const int* pt = (const int*)ptr;
  const int* ct = (const int*)col;
  const T* vt = (const T*)val;
  const T* bt = (const T*)base;
  const int* qt = (const int*)pos;
  const int* lt = (const int*)long_rows;
  T* yt = (T*)y;
  switch (plan) {
    case 0:
      return launch_rows<T, 2, 2>(xt, pt, ct, vt, bt, (T)alpha, qt, nrows,
                                  long_row, lt, nlong, yt, s);
    case 1:
      return launch_rows<T, 1, 4>(xt, pt, ct, vt, bt, (T)alpha, qt, nrows,
                                  long_row, lt, nlong, yt, s);
    case 2:
      csr_gather_warps<T><<<(nrows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          xt, pt, ct, vt, bt, (T)alpha, qt, nrows, yt);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// plan: see launch; for a thread per row (plans 0, 1), long_rows lists
// all nlong rows of ptr longer than long_row, which the warps sum
int csr_gather_f64(const void* x, const void* ptr, const void* col,
                   const void* val, const void* base, double alpha,
                   const void* pos, int nrows, int plan, int long_row,
                   const void* long_rows, int nlong, void* y, void* stream) {
  return launch<double>(x, ptr, col, val, base, alpha, pos, nrows, plan,
                        long_row, long_rows, nlong, y, stream);
}

int csr_gather_f32(const void* x, const void* ptr, const void* col,
                   const void* val, const void* base, double alpha,
                   const void* pos, int nrows, int plan, int long_row,
                   const void* long_rows, int nlong, void* y, void* stream) {
  return launch<float>(x, ptr, col, val, base, alpha, pos, nrows, plan,
                       long_row, long_rows, nlong, y, stream);
}

}  // extern "C"
