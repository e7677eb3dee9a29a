// A probe, not a kernel of the solver: the time one flag takes to go from
// one rank to another and back through memory mapped with CUDA IPC, and
// the time of one launch that meets the other rank at a flag barrier (K11's
// peer mode does two such barriers inside one launch a step).
// tools/peer_probe.py builds it on its own (nvcc, plain C interface),
// runs it on two ranks (two cards, or two processes on one card) and
// prints what it measured.  What bounds it: the latency of a store and a
// load across NVLink (or, two contexts on one card, the time slice of
// each), not bytes.
//
// Each rank's buffer (kBufBytes, zeroed): flag 0 (ping-pong) at byte 0,
// flag 1 (barrier) at byte 64; the results at byte 128 (this rank's).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr size_t kBufBytes = 4096;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void put(unsigned long long* p,
                                    unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long get(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// true if *p reached v before the deadline
__device__ __forceinline__ bool wait_for(const unsigned long long* p,
                                         unsigned long long v,
                                         unsigned long long deadline) {
  while (get(p) < v)
    if (now_ns() > deadline) return false;
  return true;
}

// Round trips 1 .. iters of flag 0: rank 0 stores i in the peer's flag and
// waits for the peer's echo in its own; rank 1 waits for i and echoes it.
// out: round trips done, ns from the end of round trip 1 to the last
// (round trip 1 waits for the other rank's launch).
__global__ void pingpong(unsigned long long* mine, unsigned long long* peer,
                         int me, int iters, unsigned long long base,
                         unsigned long long timeout_ns,
                         unsigned long long* out) {
  const unsigned long long deadline = now_ns() + timeout_ns;
  unsigned long long t1 = 0, done = 0;
  for (int i = 1; i <= iters; ++i) {
    const unsigned long long v = base + i;
    if (me == 0) {
      put(peer, v);
      if (!wait_for(mine, v, deadline)) break;
    } else {
      if (!wait_for(mine, v, deadline)) break;
      put(peer, v);
    }
    if (i == 1) t1 = now_ns();
    done = i;
  }
  out[0] = done;
  out[1] = done > 1 ? now_ns() - t1 : 0;
}

// One barrier at `epoch` on flag 1: store it in the peer's, wait for the
// peer's in this rank's.  out: 1 if met, and the ns waited.  After a
// barrier that was not met the later launches return at once (out[0]
// stays 0).
__global__ void barrier(unsigned long long* mine, unsigned long long* peer,
                        unsigned long long epoch,
                        unsigned long long timeout_ns,
                        unsigned long long* out) {
  if (epoch > 1 && out[0] == 0) return;
  const unsigned long long t0 = now_ns();
  __threadfence_system();
  put(peer + 8, epoch);
  const bool met = wait_for(mine + 8, epoch, t0 + timeout_ns);
  out[0] = met;
  out[1] = now_ns() - t0;
}

}  // namespace

extern "C" {

int probe_alloc(void** ptr, void* handle) {
  cudaError_t e = cudaMalloc(ptr, kBufBytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, kBufBytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
  return (int)e;
}

int probe_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int probe_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int probe_free(void* ptr) { return (int)cudaFree(ptr); }

// mine / peer: the two ranks' buffers as this rank maps them
int probe_pingpong(void* mine, void* peer, int me, int iters,
                   unsigned long long base, unsigned long long timeout_ns,
                   void* stream) {
  auto* m = (unsigned long long*)mine;
  pingpong<<<1, 1, 0, (cudaStream_t)stream>>>(
      m, (unsigned long long*)peer, me, iters, base, timeout_ns, m + 16);
  return (int)cudaGetLastError();
}

int probe_barrier(void* mine, void* peer, unsigned long long epoch,
                  unsigned long long timeout_ns, void* stream) {
  auto* m = (unsigned long long*)mine;
  barrier<<<1, 1, 0, (cudaStream_t)stream>>>(
      m, (unsigned long long*)peer, epoch, timeout_ns, m + 18);
  return (int)cudaGetLastError();
}

// this rank's results: pingpong's (done, ns) then the last barrier's
// (met, ns)
int probe_results(const void* mine, unsigned long long* out) {
  return (int)cudaMemcpy(out, (const unsigned long long*)mine + 16,
                         4 * sizeof(unsigned long long),
                         cudaMemcpyDeviceToHost);
}

}  // extern "C"
