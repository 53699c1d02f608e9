// bcsr_rev_search: for each push arc a = (u -> v), the reverse arc v -> u,
// found by binary search for u in v's head-sorted BCSR segment.
//
// Replaces the Pallas TPU kernel repro/kernels/revsearch.py
// (bcsr_rev_search, body _kernel).  Contract, bit for bit: the same
// `steps` = max(1, bit_length(deg_max)) lock-step halvings of a
// lower-bound search over [indptr[v], indptr[v+1]), each probe index
// clamped to A-1; the result is A where a >= A or u is not found.
//
// Bound on an H100 (3.35 TB/s): memory, and latency in practice.  Per
// push it must read the arc id, its tail and head, two indptr words and
// one head per halving, and write the result: 4 * (7 + steps) bytes.
// The probes are dependent random loads.
//
// Design: one thread per push arc, running the reference's search as it
// stands (no early exit, so the probe sequence is the reference's).  The
// probes hit v's segment, which for the degrees this solver sees is one
// or two cache lines, so the halvings after the first mostly hit L1/L2.
// blockIdx.y is the batch row, so a (B, P) call is one launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bcsr_rev_search_kernel(const int* __restrict__ arcs,
                                       const int* __restrict__ indptr,
                                       const int* __restrict__ heads,
                                       const int* __restrict__ tails,
                                       int* __restrict__ out, int p, int n,
                                       int a, int steps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const long long b = blockIdx.y;
  const int* ip = indptr + b * (n + 1);
  const int* hd = heads + b * a;
  const int arc = arcs[b * p + i];
  int result = a;
  if (arc >= 0 && arc < a) {
    const int u = tails[b * a + arc];  // push tail
    const int v = hd[arc];             // the reverse arc lives in v's segment
    int lo = ip[v];
    int hi = ip[v + 1];
    const int end = hi;
    for (int s = 0; s < steps; ++s) {
      const int mid = (lo + hi) / 2;
      const bool right = hd[min(mid, a - 1)] < u;
      lo = right ? mid + 1 : lo;
      hi = right ? hi : mid;
    }
    if (lo < end && hd[min(lo, a - 1)] == u) result = lo;
  }
  out[b * p + i] = result;
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
