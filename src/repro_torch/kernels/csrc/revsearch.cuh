// The reverse-arc search of one warp, shared by csrc/revsearch.cu
// (bcsr_rev_search, the TPU kernel's function) and csrc/segmin.cu (the
// min search's rev entry, which the paper-faithful BCSR cycle runs).
//
// Contract, bit for bit the TPU kernel's (repro/kernels/revsearch.py,
// body _kernel): for a push arc `arc` = (u -> v), u = tails[arc] and
// v = heads[arc], the same `steps` lock-step halvings of a lower-bound
// search for u over [indptr[v], indptr[v+1]), each probe index clamped to
// A-1, with no early exit; the result is the final `lo` where lo <
// indptr[v+1] and heads[min(lo, A-1)] == u, else A.  That equals a lower
// bound only where the segment is sorted, so the probe sequence itself is
// kept: the result is the reference's on any input (unsorted or duplicate
// heads, a missing reverse arc, a segment longer than 2^steps - 1).
//
// Design.  Every lane of a warp runs its search at once and branch-free,
// so that a warp waits on one chain of dependent loads, not one a push:
// the tails and heads of its arcs, then their segments' indptr words, then
// the halvings.  The probes read global memory through L1: a segment's
// first probe brings its 32-byte sector in, and a segment of the solver's
// graphs (six arcs on average) spans one or two, so the later halvings
// mostly hit L1.  Nothing is staged in shared memory: a kernel that
// reserves it gets a smaller L1, and its probes miss.
#pragma once

#include <cuda_runtime.h>

namespace revsearch {

constexpr unsigned kFull = 0xffffffffu;

// Every lane of the warp calls this together.  Returns the reverse arc of
// `arc` (which must lie in [0, a)) where `want`, else a.  ip, hd, tl: the
// row's indptr (n+1), heads and tails (a).
__device__ __forceinline__ int warp_rev_search(bool want, int arc,
                                               const int* __restrict__ ip,
                                               const int* __restrict__ hd,
                                               const int* __restrict__ tl,
                                               int a, int steps) {
  if (!__any_sync(kFull, want)) return a;
  // every load is issued by every lane, from a safe address where it has
  // no search (arc 0, vertex 0), so that no branch waits on one; a lane
  // with no search keeps lo = hi = 0 and probes heads[0]
  const int u = __ldg(tl + (want ? arc : 0));  // push tail
  const int v = __ldg(hd + (want ? arc : 0));  // v's segment holds the rev
  const int first = __ldg(ip + (want ? v : 0));
  const int end = __ldg(ip + (want ? v : 0) + 1);
  int lo = want ? first : 0;
  int hi = want ? end : 0;
  for (int s = 0; s < steps; ++s) {
    const int mid = (lo + hi) / 2;
    const bool right = __ldg(hd + min(mid, a - 1)) < u;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  const int x = __ldg(hd + min(lo, a - 1));
  return want && lo < end && x == u ? lo : a;
}

}  // namespace revsearch
