// bcsr_rev_search: for each push arc a = (u -> v), the reverse arc v -> u,
// found by binary search for u in v's head-sorted BCSR segment.
//
// Replaces the Pallas TPU kernel repro/kernels/revsearch.py
// (bcsr_rev_search, body _kernel), bit for bit: the search itself is
// revsearch.cuh's, whose note states the contract.  No solver path
// launches this entry: the paper-faithful cycle folds the same search into
// the min search (segmin.cu, tile_min_neighbor_gather_rev_launch).  It
// stays as the TPU kernel's own function and the yardstick of that fold.
//
// Bound on an H100 (3.35 TB/s): memory.  Every lane reads its arc and
// writes its result (8 bytes); a push also reads its tail and head, two
// indptr words and its probes of v's segment.  On the solver's queues most
// lanes hold no push (the sentinel A), so the bound is mostly the pass
// over the lanes, and the pushes add a chain of dependent loads.
//
// Design.  One lane a thread, a block of 256 lanes, blockIdx.y the batch
// row, so a (B, P) call is one launch; row offsets are 64-bit.  A warp
// ballots its lanes' valid arcs: a warp with none writes A and exits; the
// others run the shared warp search, one push a thread, so each push's
// chain of loads runs beside its warp's others.  Four lanes a thread with
// 16-byte accesses on a grid of 4 blocks a SM measured 19-24 % slower:
// a thread's four searches made one longer chain.
#include <cuda_runtime.h>

#include "revsearch.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bcsr_rev_search_kernel(const int* __restrict__ arcs,
                           const int* __restrict__ indptr,
                           const int* __restrict__ heads,
                           const int* __restrict__ tails,
                           int* __restrict__ out, int p, int n, int a,
                           int steps) {
  const long long b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // lanes past p stay for the warp's search, with no arc
  const int arc = i < p ? __ldg(arcs + b * p + i) : -1;
  const int r = revsearch::warp_rev_search(
      arc >= 0 && arc < a, arc, indptr + b * (n + 1), heads + b * a,
      tails + b * a, a, steps);
  if (i < p) out[b * p + i] = r;
}

}  // namespace

// arcs, out: (batch, p); indptr: (batch, n+1); heads, tails: (batch, a).
// All int32, contiguous, on the current device.  Returns
// cudaGetLastError().
extern "C" int bcsr_rev_search_launch(const int* arcs, const int* indptr,
                                      const int* heads, const int* tails,
                                      int* out, int batch, int p, int n,
                                      int a, int steps, void* stream) {
  if (batch > 0 && p > 0) {
    const dim3 grid((p + kThreads - 1) / kThreads, batch);
    bcsr_rev_search_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        arcs, indptr, heads, tails, out, p, n, a, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
