// fused_discharge_batched: k whole vc_step cycles of push-relabel per
// launch, for B instances at once, in place under a device gate.
//
// Replaces the Pallas TPU kernel repro/kernels/discharge.py
// (fused_discharge_batched, body _kernel).  Contract, bit for bit: in
// each cycle an active vertex u (e > 0, h < n, u not s or t) finds the
// minimum height over its residual arcs (res > 0) in the state the cycle
// started from, and the smallest arc attaining it; if that height is
// below h[u] it pushes d = min(e[u], res[arc]) along the arc (res[arc] -=
// d, res[rev[arc]] += d, e[u] -= d, e[head] += d), else it relabels h[u]
// to min + 1, or to n when it has no residual arc.  res/h/e are updated
// in place, as the TPU kernel does under input/output aliasing.  Outputs:
// live[b] = the cycles that began with an active vertex, pushed[b] = 1
// iff any cycle pushed, and per (b, cycle) the active, push, frontier-arc
// and max active degree counts (zero once an instance has converged).
// A 0-d gate on the device (NULL = open) is read at entry: closed, every
// block returns before the first grid barrier, res/h/e stay as they are
// and the outputs are 0, which is what the solver's loop needs of a step
// whose condition has gone false.
//
// Bound on an H100 (3.35 TB/s): memory.  Per cycle the work must read e
// of every vertex and h of each with e > 0 (membership needs it only
// there), two indptr words of each active one, res of each frontier arc,
// the head of each with res > 0 and the height of each distinct such head
// once, and for each push rev of its arc and its four updates, for each
// relabel its height.
//
// Design.  A direct translation of the TPU kernel copies the whole state
// into a snapshot every cycle (8 (A + 2n) bytes, 67 MB a cycle at a
// million vertices), writes new outputs that the solver's gate then
// selects against the old state, and has each warp serve the active
// vertices among its own 32 consecutive ones, so the warp with the most
// sets every cycle's length.
// Here a cycle is three phases of one cooperative launch, a grid-wide
// barrier between them:
//   1. compact: each warp loads e of 4 x 32 vertices (h only where e > 0),
//      ballots the active ones and appends them to the row's active-vertex
//      queue (AVQ) with one atomicAdd a warp;
//   2. decide: tiles of kTile threads (cg::tiled_partition) take queue
//      entries grid-stride, stride the entry's segment for the packed
//      minimum of (key << 32 | arc) (the unsigned minimum is the smallest
//      key, then the smallest arc: the reference's tie-break), and write
//      the decision into the entry's slot: (arc, d) for a push, (-1, new
//      height) for a relabel.  Nothing writes res/h/e in this phase, so the
//      live state is the cycle's snapshot and no copy is made;
//   3. apply: one thread a queue slot adds d through rev with atomics
//      (integer adds commute, so the result is exact in any order) or
//      stores the new height, which only the vertex's slot writes.
// The work of a cycle is then spread over the grid by queue entry, not by
// where the active vertices lie.  Phase 3 of a cycle and phase 1 of the
// next keep their barrier: whether a vertex's excess passes through 0
// during the adds depends on their order, so membership cannot be decided
// from an atomic's return value.  A cycle takes 3 barriers, a launch
// 3k - 1.  A row whose queue is empty is a fixpoint: its later cycles
// skip their work and only cross the barriers.
// The grid is (blocks per row, rows at a time): at most kBlocksPerSm
// blocks of kThreads on each SM, and no more blocks per row than cover
// its vertices once in phase 1.  Barrier time grows with the number of
// blocks and phase 1 wants many loads in flight, so the default is one
// block of 1024 threads a SM (132 blocks, 32 warps a SM), and the decide
// tile is 8 wide (an active vertex has some 6.6 arcs on the main path).
// tools/discharge_sweep.py times builds with other values of kTile,
// kThreads and kBlocksPerSm.  A batch with more rows than resident blocks
// runs its rows in rounds, every block crossing the same barriers.  Per row the scratch holds four
// accumulators (queue length, pushes, frontier, max degree) ahead of the
// queue, and one int2 decision a queue slot; the kernel allocates
// nothing, and the row's first block returns the accumulators to 0 once
// it has read them, so a scratch that starts zeroed stays so between
// launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;
constexpr int kTile = 8;          // threads deciding one queue entry
constexpr int kThreads = 1024;    // threads a block
constexpr int kBlocksPerSm = 1;   // most blocks resident on a SM
constexpr int kVerts = 4;  // vertices a lane takes per step of phase 1
constexpr int kAcc = 4;    // accumulators ahead of each row's queue
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile == 8 || kTile == 16 || kTile == 32, "tile of 8/16/32");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

struct Params {
  const int* s;
  const int* t;
  const int* indptr;         // (batch, n + 1)
  const int* heads;          // (batch, a)
  const int* rev;            // (batch, a)
  int* res;                  // (batch, a), updated in place
  int* h;                    // (batch, n), updated in place
  int* e;                    // (batch, n), updated in place
  const unsigned char* gate; // 0-d bool, NULL = open
  int* queue;                // (batch, kAcc + n): accumulators, then AVQ
  int2* dec;                 // (batch, n): a decision per queue slot
  int* live;                 // (batch,)
  int* pushed;               // (batch,)
  int* cnt;                  // (4, batch, k): active, pushes, frontier, maxdeg
  int batch, n, a, k;
};

__device__ __forceinline__ unsigned long long pack(int key, int arc) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(arc);
}

__global__ void __launch_bounds__(kThreads)
fused_discharge_kernel(Params p) {
  const int rounds = (p.batch + gridDim.y - 1) / gridDim.y;
  const long long plane = static_cast<long long>(p.batch) * p.k;
  if (p.gate != nullptr && *p.gate == 0) {
    // closed gate: the same byte for every block, so none reaches a barrier
    for (int r = 0; blockIdx.x == 0 && r < rounds; ++r) {
      const int b = r * gridDim.y + blockIdx.y;
      if (b >= p.batch) break;
      for (int i = threadIdx.x; i < 4 * p.k; i += blockDim.x) {
        p.cnt[(i / p.k) * plane + static_cast<long long>(b) * p.k +
              i % p.k] = 0;
      }
      if (threadIdx.x == 0) p.live[b] = p.pushed[b] = 0;
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  cg::thread_block_tile<kTile> tile =
      cg::tiled_partition<kTile>(cg::this_thread_block());
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int tile_id = tid / kTile;
  const int ntiles = nthreads / kTile;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;  // of the row
  __shared__ int blk[3];  // this block's pushes, frontier, max degree

  for (int r = 0; r < rounds; ++r) {
    const int b = r * gridDim.y + blockIdx.y;
    const bool row = b < p.batch;
    const long long bb = row ? b : 0;  // keeps an idle block's pointers in
    const long long vo = bb * p.n;     // the arrays
    const long long ao = bb * p.a;
    const int s = p.s[bb], t = p.t[bb];
    const int* ip = p.indptr + bb * (p.n + 1);
    const int* hd = p.heads + ao;
    const int* rv = p.rev + ao;
    int* res = p.res + ao;
    int* h = p.h + vo;
    int* e = p.e + vo;
    int* acc = p.queue + bb * (kAcc + p.n);
    int* q = acc + kAcc;
    int2* dec = p.dec + vo;
    bool done = !row;  // a row with an empty queue is a fixpoint
    int live = 0, any_push = 0;  // kept by the leader

    for (int c = 0; c < p.k; ++c) {
      // 1. compact the active vertices into the queue
      if (threadIdx.x < 3) blk[threadIdx.x] = 0;
      for (int base = warp * 32 * kVerts; !done && base < p.n;
           base += nwarps * 32 * kVerts) {
        int ev[kVerts];
#pragma unroll
        for (int j = 0; j < kVerts; ++j) {
          const int u = base + 32 * j + lane;
          ev[j] = u < p.n ? e[u] : 0;
        }
        unsigned m[kVerts];
        int total = 0;
#pragma unroll
        for (int j = 0; j < kVerts; ++j) {
          const int u = base + 32 * j + lane;
          m[j] = __ballot_sync(kFull,
                               ev[j] > 0 && u != s && u != t && h[u] < p.n);
          total += __popc(m[j]);
        }
        if (total == 0) continue;  // uniform across the warp
        int slot = 0;
        if (lane == 0) slot = atomicAdd(&acc[0], total);
        slot = __shfl_sync(kFull, slot, 0);
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int j = 0; j < kVerts; ++j) {
          if ((m[j] >> lane) & 1u) {
            q[slot + __popc(m[j] & below)] = base + 32 * j + lane;
          }
          slot += __popc(m[j]);
        }
      }
      grid.sync();

      // 2. decide each queue entry against the unchanged state
      const int qlen = row ? acc[0] : 0;
      done = qlen == 0;
      for (int i = tile_id; i < qlen; i += ntiles) {
        const int u = q[i];
        const int start = __ldg(ip + u), end = __ldg(ip + u + 1);
        const int hu = h[u], eu = e[u];
        unsigned long long best = pack(kInf, p.a);
        for (int j = start + static_cast<int>(tile.thread_rank()); j < end;
             j += kTile) {
          const int rj = res[j], head = __ldg(hd + j);
          best = min(best, pack(rj > 0 ? h[head] : kInf, j));
        }
#pragma unroll
        for (int off = kTile / 2; off > 0; off >>= 1) {
          best = min(best, tile.shfl_down(best, off));
        }
        if (tile.thread_rank() == 0) {
          const int m = static_cast<int>(
              static_cast<unsigned>(best >> 32) ^ 0x80000000u);
          const int arg = static_cast<int>(best & 0xffffffffu);
          const bool can = m < kInf;
          if (can && hu > m) {
            dec[i] = make_int2(arg, min(eu, res[arg]));
            atomicAdd(&blk[0], 1);
          } else {
            dec[i] = make_int2(-1, can ? m + 1 : p.n);  // dead end -> n
          }
          atomicAdd(&blk[1], end - start);
          atomicMax(&blk[2], end - start);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && qlen > 0) {
        if (blk[0] > 0) atomicAdd(&acc[1], blk[0]);
        if (blk[1] > 0) atomicAdd(&acc[2], blk[1]);
        if (blk[2] > 0) atomicMax(&acc[3], blk[2]);
      }
      grid.sync();

      // 3. apply: pushes through rev by atomic adds, relabels by store
      for (int i = tid; i < qlen; i += nthreads) {
        const int u = q[i];
        const int2 d = dec[i];
        if (d.x >= 0) {
          atomicAdd(&res[d.x], -d.y);
          atomicAdd(&res[__ldg(rv + d.x)], d.y);
          atomicAdd(&e[u], -d.y);
          atomicAdd(&e[__ldg(hd + d.x)], d.y);
        } else {
          h[u] = d.y;
        }
      }
      if (leader && row) {
        // every block read the accumulators before the last barrier
        const int pushes = acc[1];
        int* slot = p.cnt + bb * p.k + c;
        slot[0] = qlen;
        slot[plane] = pushes;
        slot[2 * plane] = acc[2];
        slot[3 * plane] = acc[3];
        acc[0] = acc[1] = acc[2] = acc[3] = 0;
        live += qlen > 0;
        any_push |= pushes > 0;
      }
      if (c + 1 < p.k) grid.sync();
    }
    if (leader && row) {
      p.live[b] = live;
      p.pushed[b] = any_push;
    }
  }
}

}  // namespace

// All arrays int32 (gate: one byte, or NULL for an open gate), contiguous,
// on the current device; shapes as in Params.  One cooperative launch on
// `stream`: every block must be resident at once, so the grid is (x, y)
// with y = min(batch, resident blocks) rows at a time (more rows take
// further rounds) and x = min(resident / y, blocks that cover n in phase
// 1), resident = min(occupancy, kBlocksPerSm) blocks a SM.  Returns the
// launch's cudaError_t (a refused cooperative launch included), else
// cudaGetLastError().
extern "C" int fused_discharge_launch(
    const int* s, const int* t, const int* indptr, const int* heads,
    const int* rev, int* res, int* h, int* e, const unsigned char* gate,
    int* queue, int* dec, int* live, int* pushed, int* cnt, int batch, int n,
    int a, int k, void* stream) {
  if (batch <= 0 || k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_discharge_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const int y = static_cast<int>(batch < resident ? batch : resident);
  const long long cover = (static_cast<long long>(n) + kThreads * kVerts - 1)
                          / (kThreads * kVerts);
  const int x = static_cast<int>(
      resident / y < cover ? resident / y : cover);
  Params p{s,     t,     indptr, heads, rev,   res,   h,     e,
           gate,  queue, reinterpret_cast<int2*>(dec), live, pushed, cnt,
           batch, n,     a,      k};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_discharge_kernel), dim3(x, y),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
