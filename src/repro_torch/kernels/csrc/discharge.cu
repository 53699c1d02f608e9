// fused_discharge_batched: k whole vc_step cycles of push-relabel per
// launch, for B instances at once.
//
// Replaces the Pallas TPU kernel repro/kernels/discharge.py
// (fused_discharge_batched, body _kernel).  Contract, bit for bit: each
// cycle snapshots res/h/e; an active vertex u (e > 0, h < n, u not s or t)
// finds the minimum snapshot height over its residual arcs (res > 0) and
// the smallest arc attaining it; if that height is below h[u] it pushes
// d = min(e[u], res[arc]) along the arc (res[arc] -= d, res[rev[arc]] += d,
// e[u] -= d, e[head] += d), else it relabels h[u] to min + 1, or to n
// when it has no residual arc.  Outputs: the new res/h/e, live[b] = the
// cycles that began with an active vertex, pushed[b] = 1 iff any cycle
// pushed, and per (b, cycle) the active, push, frontier-arc and max
// active degree counts (zero once an instance has converged).
//
// Bound on an H100 (3.35 TB/s): memory.  Per cycle the work must read
// e, h and indptr of every vertex, 12 bytes per frontier arc (head, res,
// the head's height) and write each push's four updates and each
// relabel's height.  This first design also copies the whole state into
// the snapshot every cycle (8 bytes per arc and per vertex read and
// written), which is more than the work needs.
//
// Design: the TPU kernel walks the vertices in order inside one program
// per instance and keeps the snapshot in VMEM.  Here one cooperative
// launch holds every block resident (grid (CTAs per instance, rows at a
// time), sized from the occupancy calculator; a batch with more rows than
// resident blocks runs its rows in rounds) and a grid-wide barrier
// separates the phases of each cycle: (1) copy the current state into
// the snapshot scratch, barrier, (2) vertex pass, barrier.  In the vertex pass each
// warp takes 32 consecutive vertices, one a lane, and ballots which are
// active; for each active one the whole warp strides its segment, keyed
// by the snapshot (res_old > 0 ? h_old[head] : INF), and keeps the
// minimum of a packed 64-bit (biased key << 32 | arc): the unsigned
// minimum is the smallest key and, among equal keys, the smallest arc,
// the reference's tie-break.  Lane 0 applies the push with atomic adds
// through the rev table, or writes h[u], which only u's owner writes.
// Integer adds commute, so the result is exact whatever the order.
// Counters go to shared memory, then once per block to global memory.
// Inputs are never written: the solver's loop keeps the old state where
// its gate has closed, so the wrapper allocates the outputs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;
constexpr int kThreads = 256;

struct Params {
  const int* s;
  const int* t;
  const int* indptr;  // (batch, n + 1)
  const int* heads;   // (batch, a)
  const int* rev;     // (batch, a)
  const int* res_in;  // (batch, a)
  const int* h_in;    // (batch, n)
  const int* e_in;    // (batch, n)
  int* res;           // outputs, same shapes as the inputs
  int* h;
  int* e;
  int* live;          // (batch,)
  int* pushed;        // (batch,)
  int* cnt;           // (4, batch, k): active, pushes, frontier, maxdeg
  int* res_old;       // snapshot scratch, same shapes as res/h/e
  int* h_old;
  int* e_old;
  int batch, n, a, k;
};

__device__ __forceinline__ unsigned long long pack(int key, int arc) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(arc);
}

__global__ void __launch_bounds__(kThreads)
fused_discharge_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  __shared__ int blk[4];
  // rows stride over grid.y: every block runs the same number of rounds
  // (and so of grid barriers), a block past the last row idling in them
  const int rounds = (p.batch + gridDim.y - 1) / gridDim.y;

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
    int* res_old = p.res_old + ao;
    int* h_old = p.h_old + vo;
    int* e_old = p.e_old + vo;

    for (int c = 0; c < p.k; ++c) {
      // 1. snapshot the state the cycle starts from; the first cycle also
      //    initialises the outputs from the inputs and zeroes the counters
      if (row) {
        const int* rsrc = c == 0 ? p.res_in + ao : res;
        const int* hsrc = c == 0 ? p.h_in + vo : h;
        const int* esrc = c == 0 ? p.e_in + vo : e;
        for (int i = tid; i < p.a; i += nthreads) {
          const int v = rsrc[i];
          res_old[i] = v;
          if (c == 0) res[i] = v;
        }
        for (int i = tid; i < p.n; i += nthreads) {
          const int hv = hsrc[i], ev = esrc[i];
          h_old[i] = hv;
          e_old[i] = ev;
          if (c == 0) {
            h[i] = hv;
            e[i] = ev;
          }
        }
        if (c == 0 && blockIdx.x == 0) {
          for (int i = threadIdx.x; i < 4 * p.k; i += blockDim.x) {
            p.cnt[(static_cast<long long>(i / p.k) * p.batch + b) * p.k +
                  i % p.k] = 0;
          }
        }
      }
      if (threadIdx.x < 4) blk[threadIdx.x] = 0;
      grid.sync();

      // 2. vertex pass: decisions read the snapshot, updates go to res/h/e
      int n_act = 0, n_push = 0, fr = 0, md = 0;  // kept by lane 0
      for (int base = warp * 32; row && base < p.n; base += nwarps * 32) {
        const int u = base + lane;
        const bool active = u < p.n && e_old[u] > 0 && h_old[u] < p.n &&
                            u != s && u != t;
        unsigned mask = __ballot_sync(0xffffffffu, active);
        while (mask) {  // uniform across the warp
          const int v = base + __ffs(mask) - 1;
          mask &= mask - 1;
          const int start = ip[v], end = ip[v + 1];
          unsigned long long best = pack(kInf, p.a);
          for (int i = start + lane; i < end; i += 32) {
            best = min(best, pack(res_old[i] > 0 ? h_old[hd[i]] : kInf, i));
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            best = min(best, __shfl_down_sync(0xffffffffu, best, off));
          }
          if (lane == 0) {
            const int m = static_cast<int>(
                static_cast<unsigned>(best >> 32) ^ 0x80000000u);
            const int arg = static_cast<int>(best & 0xffffffffu);
            const bool can = m < kInf;
            const bool push = can && h_old[v] > m;
            if (push) {
              const int d = min(e_old[v], res_old[arg]);
              atomicAdd(&res[arg], -d);
              atomicAdd(&res[rv[arg]], d);
              atomicAdd(&e[v], -d);
              atomicAdd(&e[hd[arg]], d);
            } else {
              h[v] = can ? m + 1 : p.n;  // dead end -> deactivate
            }
            n_act += 1;
            n_push += push;
            fr += end - start;
            md = max(md, end - start);
          }
        }
      }
      if (lane == 0 && n_act > 0) {
        atomicAdd(&blk[0], n_act);
        atomicAdd(&blk[1], n_push);
        atomicAdd(&blk[2], fr);
        atomicMax(&blk[3], md);
      }
      __syncthreads();
      if (threadIdx.x == 0 && blk[0] > 0) {
        int* slot = p.cnt + static_cast<long long>(b) * p.k + c;
        const long long plane = static_cast<long long>(p.batch) * p.k;
        atomicAdd(slot, blk[0]);
        atomicAdd(slot + plane, blk[1]);
        atomicAdd(slot + 2 * plane, blk[2]);
        atomicMax(slot + 3 * plane, blk[3]);
      }
      grid.sync();
    }

    // 3. live cycles and the any-push flag, from the per-cycle counts
    if (row && blockIdx.x == 0 && threadIdx.x == 0) {
      const int* act = p.cnt + static_cast<long long>(b) * p.k;
      const int* psh = act + static_cast<long long>(p.batch) * p.k;
      int live = 0, any = 0;
      for (int c = 0; c < p.k; ++c) {
        live += act[c] > 0;
        any |= psh[c] > 0;
      }
      p.live[b] = live;
      p.pushed[b] = any;
    }
  }
}

}  // namespace

// All arrays int32, contiguous, on the current device; shapes as in
// Params.  One cooperative launch on `stream`: every block must be
// resident at once, so the grid is (x, y) with y = min(batch, resident
// blocks) rows at a time (more rows take further rounds) and x =
// min(resident / y, blocks that cover n).  Returns the launch's
// cudaError_t (a refused cooperative launch included), else
// cudaGetLastError().
extern "C" int fused_discharge_launch(
    const int* s, const int* t, const int* indptr, const int* heads,
    const int* rev, const int* res_in, const int* h_in, const int* e_in,
    int* res, int* h, int* e, int* live, int* pushed, int* cnt,
    int* res_old, int* h_old, int* e_old, int batch, int n, int a, int k,
    void* stream) {
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
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const int y = static_cast<int>(batch < resident ? batch : resident);
  const long long cover = (static_cast<long long>(n) + kThreads - 1) /
                          kThreads;
  const int x = static_cast<int>(
      resident / y < cover ? resident / y : cover);
  Params p{s,     t,      indptr,  heads, rev,   res_in, h_in, e_in,
           res,   h,      e,       live,  pushed, cnt,   res_old,
           h_old, e_old,  batch,   n,     a,     k};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_discharge_kernel), dim3(x, y),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
