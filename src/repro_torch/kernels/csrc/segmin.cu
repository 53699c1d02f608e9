// tile_min_neighbor: per queue entry u, the minimum key over u's CSR
// segment key[indptr[u] : indptr[u+1]] and the smallest arc attaining it.
//
// Replaces the Pallas TPU kernel repro/kernels/segmin.py
// (tile_min_neighbor, bodies _kernel / _dense_kernel / _reduce_segment).
// Contract, bit for bit: (INF = 2^30, A) when u >= n, the segment is
// empty or every key is >= INF; avq == NULL is the dense form, where the
// entry index itself is the vertex (avq == arange(n)).
//
// Bound on an H100 (3.35 TB/s): memory.  The AVQ form must read avq and
// two indptr words per entry and write two outputs (20 bytes per entry)
// plus the frontier's keys (4 bytes per frontier arc); the dense form
// reads indptr and every key once and writes 8 bytes per vertex.  It does
// no arithmetic worth counting.
//
// Design: one warp per queue entry, the paper's own CUDA mapping.  The
// lanes stride over the segment (neighbouring lanes read neighbouring
// keys, so loads coalesce) and each keeps the minimum of a packed 64-bit
// (biased key << 32 | arc): the unsigned minimum is the smallest key and,
// among equal keys, the smallest arc — the reference's tie-break — with
// no second pass.  The key is biased by 2^31 so that the unsigned order
// is the signed order.  Five __shfl_down_sync steps reduce the warp and
// lane 0 writes the normalised pair.  blockIdx.y is the batch row, so a
// (B, Q) call is one launch.  Segments of a few arcs leave most lanes
// idle; packing several entries per warp is left to a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ unsigned long long pack(int key, int arc) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(arc);
}

__global__ void tile_min_neighbor_kernel(const int* __restrict__ avq,
                                         const int* __restrict__ indptr,
                                         const int* __restrict__ key,
                                         int* __restrict__ minh,
                                         int* __restrict__ argarc, int q,
                                         int n, int a) {
  const int entry = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (entry >= q) return;  // uniform across the warp
  const long long b = blockIdx.y;
  const int* ip = indptr + b * (n + 1);
  const int* k = key + b * a;
  const int u = avq ? avq[b * q + entry] : entry;
  const bool valid = u >= 0 && u < n;
  // starts at (INF, A): keys >= INF never win, as in the reference
  unsigned long long best = pack(kInf, a);
  if (valid) {
    const int end = ip[u + 1];
    for (int i = ip[u] + lane; i < end; i += 32) {
      best = min(best, pack(k[i], i));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best = min(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  if (lane == 0) {
    const int m = static_cast<int>(static_cast<unsigned>(best >> 32) ^
                                   0x80000000u);
    const bool found = valid && m < kInf;
    minh[b * q + entry] = found ? m : kInf;
    argarc[b * q + entry] = found ? static_cast<int>(best & 0xffffffffu) : a;
  }
}

}  // namespace

// avq: (batch, q) or NULL for the dense form (then q == n); indptr:
// (batch, n+1); key: (batch, a); minh, argarc: (batch, q).  All int32,
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int tile_min_neighbor_launch(const int* avq, const int* indptr,
                                        const int* key, int* minh,
                                        int* argarc, int batch, int q, int n,
                                        int a, void* stream) {
  if (batch > 0 && q > 0) {
    const dim3 grid((q + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    tile_min_neighbor_kernel<<<grid, kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        avq, indptr, key, minh, argarc, q, n, a);
  }
  return static_cast<int>(cudaGetLastError());
}
