// tile_min_neighbor: per queue entry u, the minimum key over u's CSR
// segment key[indptr[u] : indptr[u+1]] and the smallest arc attaining it.
//
// Replaces the Pallas TPU kernel repro/kernels/segmin.py
// (tile_min_neighbor, bodies _kernel / _dense_kernel / _reduce_segment).
// Contract, bit for bit: (INF = 2^30, A) when u < 0 or u >= n, the segment
// is empty or every key is >= INF; avq == NULL is the dense form, where the
// entry index itself is the vertex (avq == arange(n)).  Three entry points
// share every body: tile_min_neighbor_launch reads the key from an array
// (the TPU kernel's own function), tile_min_neighbor_gather_launch forms it
// in registers, key = res[i] > 0 ? h[clamp(heads[i], 0, n-1)] : INF, so
// the A-word key array is never written, and
// tile_min_neighbor_gather_rev_launch (AVQ form only) adds a third output:
// for each entry that pushes (valid, minh < INF and h[u] > minh, the
// solver's push decision) the reverse arc of its push arc argarc, by the
// TPU kernel repro/kernels/revsearch.py (bcsr_rev_search)'s search
// (revsearch.cuh), and A for every other slot.  That is the
// paper-faithful BCSR cycle's whole search in one launch.
//
// Bound on an H100 (3.35 TB/s): memory.  Dense form: indptr once, every
// key once (gather: every res, heads only where res > 0, and h once for
// each distinct head among those) and 8 bytes of output per vertex.  AVQ
// form: the queue and two outputs per slot (12 bytes), two indptr words
// per live entry and the live entries' frontier keys (gather: their res,
// heads where res > 0, h once per distinct such head).  The rev entry adds
// 4 bytes of rev a slot, h[u] of each entry with a key below INF, and per
// push its tail, two indptr words and the distinct heads its search
// probes (its head is read already).  No arithmetic worth counting.
//
// Every minimum is the unsigned minimum of a packed 64-bit (biased key <<
// 32 | arc): the smallest key and, among equal keys, the smallest arc —
// the reference's tie-break — in any order of reduction, so shared-memory
// atomics stay bit-exact.  The key is biased by 2^31 so that the unsigned
// order is the signed order.  Keys >= INF never win and are skipped.
//
// Design.  Most segments hold a few arcs (six on average on the DIMACS
// Washington graphs) and most slots of a padded queue hold no entry, so a
// warp per entry would leave most lanes idle.  Instead:
// * dense form: a block owns kTile consecutive vertices.  Their arcs are
//   one contiguous range (CSR), so the block loads the tile's kTile + 1
//   indptr words into shared memory and its threads stride that range,
//   kArcsPerThread consecutive arcs each; a thread finds its first arc's
//   vertex by a binary search over the shared indptr, walks on from there,
//   and folds each vertex's minimum into a shared 64-bit slot with
//   atomicMin.  The block then writes its kTile results coalesced.  A hub
//   only lengthens its tile's loop.  indptr must be nondecreasing (a CSR).
// * AVQ form: a warp takes 32 consecutive queue slots (one coalesced
//   load), ballots the valid entries and writes (INF, A) for the others; a
//   warp with none does nothing more.  Neighbouring warps' slots fall on
//   different SMs, since an AVQ holds its entries in a prefix.  A valid
//   entry's lane walks a segment of up to 32 arcs itself; the whole warp
//   strides each longer segment, found by a second ballot, and reduces it
//   with shuffles.  Valid entries need not form a prefix.  In the rev
//   entry the same warp then decides its lanes' pushes from the minimum it
//   holds in registers (h[u] loaded during the walk) and runs the shared
//   warp search over them: the push arcs never go through memory, and no
//   second launch or n-lane select is needed.
// blockIdx.y is the batch row, so a (B, Q) call is one launch; row offsets
// b * a, b * n, b * (n + 1), b * q are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "revsearch.cuh"

namespace {

constexpr int kInf = 1 << 30;
constexpr int kTile = 256;          // dense form: vertices and threads a block
constexpr int kArcsPerThread = 4;   // dense form: consecutive arcs a thread
constexpr int kAvqThreads = 256;    // AVQ form: threads a block (8 warps)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long pack(int key, int arc) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(arc);
}

__device__ __forceinline__ void store(const unsigned long long best,
                                      const unsigned long long none,
                                      int* minh, int* argarc, long long out,
                                      int a) {
  // best == none: no key below INF was folded in
  const bool found = best != none;
  minh[out] = found ? static_cast<int>(static_cast<unsigned>(best >> 32) ^
                                       0x80000000u)
                    : kInf;
  argarc[out] = found ? static_cast<int>(best & 0xffffffffu) : a;
}

// the rev entry's own operands: heads, tails and heights to decide a push
// and find its reverse arc, the rev output and the search's halvings (all
// NULL, and unused, in the other entries)
struct Rev {
  const int* heads;
  const int* tails;
  const int* h;
  int* rev;
  int steps;
};

// the key of arc i of one row, read from an array
struct KeyIn {
  const int* key;
  __device__ KeyIn row(long long b, int n, int a) const {
    return {key + b * a};
  }
  __device__ int operator()(int i) const { return __ldg(key + i); }
};

// the key of arc i of one row, formed from res, heads and h
struct KeyGather {
  const int* res;
  const int* heads;
  const int* h;
  int n;
  __device__ KeyGather row(long long b, int n_, int a) const {
    return {res + b * a, heads + b * a, h + b * n_, n_};
  }
  __device__ int operator()(int i) const {
    if (__ldg(res + i) <= 0) return kInf;
    return __ldg(h + min(max(__ldg(heads + i), 0), n - 1));
  }
};

template <class Key>
__global__ void __launch_bounds__(kTile)
    dense_kernel(const int* __restrict__ indptr, const Key key_rows,
                 int* __restrict__ minh, int* __restrict__ argarc, int n,
                 int a) {
  __shared__ int s_ip[kTile + 1];
  __shared__ unsigned long long s_best[kTile];
  const long long b = blockIdx.y;
  const int v0 = blockIdx.x * kTile;
  const int cnt = min(kTile, n - v0);
  const int* ip = indptr + b * (n + 1) + v0;
  const Key key = key_rows.row(b, n, a);
  const unsigned long long none = pack(kInf, a);
  for (int j = threadIdx.x; j <= cnt; j += kTile) s_ip[j] = __ldg(ip + j);
  s_best[threadIdx.x] = none;
  __syncthreads();
  const int hi = s_ip[cnt];
  for (int base = s_ip[0] + threadIdx.x * kArcsPerThread; base < hi;
       base += kTile * kArcsPerThread) {
    int k[kArcsPerThread];
#pragma unroll
    for (int j = 0; j < kArcsPerThread; ++j) {
      k[j] = base + j < hi ? key(base + j) : kInf;
    }
    // the vertex owning arc base: s_ip[l] <= base < s_ip[r] throughout
    int l = 0, r = cnt;
    while (r - l > 1) {
      const int m = (l + r) >> 1;
      if (s_ip[m] <= base) l = m; else r = m;
    }
    int v = l, next = s_ip[l + 1];
    unsigned long long best = none;
#pragma unroll
    for (int j = 0; j < kArcsPerThread; ++j) {
      const int i = base + j;
      if (i < hi) {
        while (i >= next) {  // arc i belongs to a later vertex
          if (best != none) atomicMin(&s_best[v], best);
          best = none;
          next = s_ip[++v + 1];
        }
        if (k[j] < kInf) best = min(best, pack(k[j], i));
      }
    }
    if (best != none) atomicMin(&s_best[v], best);
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    store(s_best[threadIdx.x], none, minh, argarc,
          b * n + v0 + threadIdx.x, a);
  }
}

template <class Key, bool kRev>
__global__ void __launch_bounds__(kAvqThreads)
    avq_kernel(const int* __restrict__ avq, const int* __restrict__ indptr,
               const Key key_rows, const Rev rv, int* __restrict__ minh,
               int* __restrict__ argarc, int q, int n, int a) {
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  // warp g of the grid takes slots 32g..32g+31, g counting blocks first,
  // so that a queue's valid prefix is spread over every SM
  const int slot = ((threadIdx.x / 32) * gridDim.x + blockIdx.x) * 32 + lane;
  const long long out = b * q + slot;
  const bool in = slot < q;
  const int u = in ? __ldg(avq + out) : -1;
  const bool valid = u >= 0 && u < n;
  const unsigned long long none = pack(kInf, a);
  if (__ballot_sync(kFull, valid) == 0) {
    if (in) {
      store(none, none, minh, argarc, out, a);
      if constexpr (kRev) rv.rev[out] = a;
    }
    return;  // uniform across the warp
  }
  const int* ip = indptr + b * (n + 1);
  const Key key = key_rows.row(b, n, a);
  int lo = 0, hi = 0;
  if (valid) {
    lo = __ldg(ip + u);
    hi = __ldg(ip + u + 1);
  }
  // the rev entry's h[u], in flight during the segment walk
  int hu = 0;
  if constexpr (kRev) hu = valid ? __ldg(rv.h + b * n + u) : 0;
  const bool wide = hi - lo > 32;
  unsigned long long best = none;
  if (!wide) {
    for (int i = lo; i < hi; ++i) {
      const int k = key(i);
      if (k < kInf) best = min(best, pack(k, i));
    }
  }
  for (unsigned wides = __ballot_sync(kFull, wide); wides;
       wides &= wides - 1) {
    const int src = __ffs(wides) - 1;
    const int wlo = __shfl_sync(kFull, lo, src);
    const int whi = __shfl_sync(kFull, hi, src);
    unsigned long long w = none;
    for (int i = wlo + lane; i < whi; i += 32) {
      const int k = key(i);
      if (k < kInf) w = min(w, pack(k, i));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      w = min(w, __shfl_xor_sync(kFull, w, off));
    }
    if (lane == src) best = w;
  }
  if (in) store(best, none, minh, argarc, out, a);
  if constexpr (kRev) {
    // best != none: u is valid and minh < INF; then a push if h[u] > minh
    const int mh = static_cast<int>(static_cast<unsigned>(best >> 32) ^
                                    0x80000000u);
    const int r = revsearch::warp_rev_search(
        best != none && hu > mh, static_cast<int>(best & 0xffffffffu), ip,
        rv.heads + b * a, rv.tails + b * a, a, rv.steps);
    if (in) rv.rev[out] = r;
  }
}

template <bool kRev = false, class Key>
int launch(const int* avq, const int* indptr, const Key& key, const Rev& rv,
           int* minh, int* argarc, int batch, int q, int n, int a,
           void* stream) {
  if (batch > 0 && q > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (avq == nullptr) {
      const dim3 grid((n + kTile - 1) / kTile, batch);
      dense_kernel<Key><<<grid, kTile, 0, st>>>(indptr, key, minh, argarc,
                                                n, a);
    } else {
      const dim3 grid((q + kAvqThreads - 1) / kAvqThreads, batch);
      avq_kernel<Key, kRev><<<grid, kAvqThreads, 0, st>>>(
          avq, indptr, key, rv, minh, argarc, q, n, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// avq: (batch, q) or NULL for the dense form (then q == n); indptr:
// (batch, n+1); key: (batch, a); minh, argarc: (batch, q).  All int32,
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int tile_min_neighbor_launch(const int* avq, const int* indptr,
                                        const int* key, int* minh,
                                        int* argarc, int batch, int q, int n,
                                        int a, void* stream) {
  return launch(avq, indptr, KeyIn{key}, Rev{}, minh, argarc, batch, q, n,
                a, stream);
}

// As tile_min_neighbor_launch with the key formed from res, heads: (batch,
// a) and h: (batch, n).
extern "C" int tile_min_neighbor_gather_launch(
    const int* avq, const int* indptr, const int* heads, const int* res,
    const int* h, int* minh, int* argarc, int batch, int q, int n, int a,
    void* stream) {
  return launch(avq, indptr, KeyGather{res, heads, h, n}, Rev{}, minh,
                argarc, batch, q, n, a, stream);
}

// As tile_min_neighbor_gather_launch in the AVQ form (avq must not be
// NULL), with tails: (batch, a) and a third output rev: (batch, q), the
// reverse arc of each entry's push arc (A where it does not push or the
// arc is not found), by `steps` halvings.
extern "C" int tile_min_neighbor_gather_rev_launch(
    const int* avq, const int* indptr, const int* heads, const int* tails,
    const int* res, const int* h, int* minh, int* argarc, int* rev,
    int batch, int q, int n, int a, int steps, void* stream) {
  if (avq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(avq, indptr, KeyGather{res, heads, h, n},
                      Rev{heads, tails, h, rev, steps}, minh, argarc, batch,
                      q, n, a, stream);
}
