"""Distributed vertex-centric push-relabel on ``torch.distributed`` (port
of the JAX package's ``repro.core.distributed``).

Vertices are range-partitioned into per-rank slabs; each rank owns its
slab's CSR arc segment (contiguous because arcs are tail-sorted).  One BSP
superstep = each rank runs the vertex-centric push/relabel decision for
its local active vertices, then the state deltas are combined
collectively.  Where the reference has a mesh axis of P devices, the port
has a process group of P ranks: mesh axis index ``w`` is rank ``w``.  NCCL
carries CUDA tensors, gloo CPU tensors.

Three exchange strategies for the residual:

* ``replicated``: ``res``/``h``/``e`` replicated on every rank; the
  per-arc deltas are a dense ``(A,)`` all-reduce.
* ``sharded``: each rank keeps only its own arc slab's residuals; the
  reverse-arc deltas travel through a reduce-scatter.
* ``sparse``: the pushes' ``(arc, delta)`` pairs are bucketed by owner
  rank and exchanged through an all-to-all.

``h``/``e`` stay replicated in every mode: their ``(n,)`` deltas are
all-reduced (as one ``(2n,)`` buffer, which is the reference's two sums).
The global relabel is Bellman-Ford sweeps over the same partition, each
rank's candidates combined by an all-reduce of MIN.

Every rank issues the same collectives in the same order: the engine's
gated chunks run their steps even once the gate is shut, and every loop
condition is read from replicated tensors only.  Every step is int32 and
bit for bit the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import engine
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import INF
from repro_torch.kernels.runtime import resolve_device

_I32 = torch.int32
MODES = ("replicated", "sharded", "sparse")
#: the process-group backend that carries each device type's tensors
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class DistMeta:
    n: int          # global vertices (padded to P * vs)
    num_arcs: int   # global arcs (sum of padded slabs)
    vs: int         # vertices per shard
    amax: int       # arc slots per shard (padded)
    nshards: int
    s: int
    t: int
    mode: str       # replicated | sharded | sparse


class DistGraph(NamedTuple):
    """One rank's slab.  Its arc slot ``k`` has global id ``w*amax + k``."""
    indptr: torch.Tensor      # (vs+1,) int32 — local, relative offsets
    heads: torch.Tensor       # (amax,) int32 — global head vertex (n = pad)
    rev: torch.Tensor         # (amax,) int32 — global reverse-arc id
    tail_local: torch.Tensor  # (amax,) int32 — local tail index (vs = pad)

    def to(self, device) -> DistGraph:
        """The slab's host rows as int32 tensors on ``device``."""
        return DistGraph(*(torch.as_tensor(x, dtype=_I32).to(device)
                           for x in self))


def partition_graph(r: ResidualCSR, nshards: int, s: int, t: int,
                    mode: str = "replicated"):
    """Host-side partitioning: pad vertices to P*vs and arcs to P*amax.
    Arc global ids are re-indexed slab-major: shard w, slot k -> w*amax+k.
    Returns ``(slabs, meta, res0)``: a ``DistGraph`` of numpy rows per
    rank, byte for byte the rows of the reference's ``(P, ·)`` arrays,
    and the ``(P*amax,)`` int32 initial residual.  Capacities the int32
    state cannot hold raise first (``pushrelabel.check_capacity_range``)."""
    if mode not in MODES:
        raise ValueError(f"unknown exchange mode {mode!r}; expected one of "
                         f"{MODES}")
    pr.check_capacity_range(r, s)
    n0 = r.n
    vs = -(-n0 // nshards)
    n = vs * nshards
    deg = np.diff(r.indptr)
    slab_arcs = [int(deg[w * vs:(w + 1) * vs].sum()) for w in range(nshards)]
    amax = max(1, max(slab_arcs))
    indptr = np.zeros((nshards, vs + 1), np.int32)
    heads = np.full((nshards, amax), n, np.int32)
    tail_local = np.full((nshards, amax), vs, np.int32)
    res0 = np.zeros((nshards, amax), np.int64)
    newid = np.full(r.num_arcs, -1, np.int64)  # old arc id -> new global id
    bounds = []
    for w in range(nshards):
        lo = w * vs
        hi = min((w + 1) * vs, n0)
        a0 = r.indptr[lo] if lo < n0 else r.indptr[-1]
        a1 = r.indptr[hi] if hi <= n0 else r.indptr[-1]
        bounds.append((a0, a1))
        cnt = a1 - a0
        d = np.diff(r.indptr[lo:hi + 1]) if hi > lo else np.zeros(0, int)
        indptr[w, 1:1 + len(d)] = np.cumsum(d)
        indptr[w, 1 + len(d):] = indptr[w, len(d)] if len(d) else 0
        heads[w, :cnt] = r.heads[a0:a1]
        tail_local[w, :cnt] = r.tails[a0:a1] - lo
        res0[w, :cnt] = r.res0[a0:a1]
        newid[a0:a1] = w * amax + np.arange(cnt)
    rev = np.full((nshards, amax), nshards * amax, np.int64)
    old_rev_new = newid[r.rev]
    for w, (a0, a1) in enumerate(bounds):
        rev[w, : a1 - a0] = old_rev_new[a0:a1]
    rev = rev.astype(np.int32)
    slabs = [DistGraph(indptr[w], heads[w], rev[w], tail_local[w])
             for w in range(nshards)]
    meta = DistMeta(n=n, num_arcs=nshards * amax, vs=vs, amax=amax,
                    nshards=nshards, s=s, t=t, mode=mode)
    return slabs, meta, pr.as_int32(res0, "res0").reshape(-1)


def host_preflow(slabs, meta: DistMeta, res0: np.ndarray):
    """The reference's host-side preflow: saturate every arc out of ``s``
    on the global slab-major arrays.  Returns ``(res, h, e)``, the
    ``(P*amax,)`` residual and the ``(n,)`` heights and excess, int32."""
    s = meta.s
    res = np.asarray(res0).copy()
    heads = np.concatenate([g.heads for g in slabs])
    rev = np.concatenate([g.rev for g in slabs])
    e = np.zeros(meta.n, np.int32)
    h = np.zeros(meta.n, np.int32)
    h[s] = meta.n
    w0, lo = s // meta.vs, s % meta.vs
    ip = slabs[w0].indptr
    for k in range(ip[lo], ip[lo + 1]):
        a = w0 * meta.amax + k
        d = res[a]
        res[a] = 0
        res[rev[a]] += d
        e[heads[a]] += d
    e[s] = 0
    return res, h, e


def initial_state(slabs, meta: DistMeta, res0: np.ndarray, w: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank ``w``'s ``(res, h, e)`` after the host preflow, on ``device``:
    the whole residual in the replicated mode, else the rank's slab."""
    res, h, e = host_preflow(slabs, meta, res0)
    if meta.mode != "replicated":
        res = res[w * meta.amax:(w + 1) * meta.amax]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (res, h, e))


# ---------------------------------------------------------------------------
# local superstep body (each rank's own slab)
# ---------------------------------------------------------------------------

def _local_decide(meta: DistMeta, indptr, heads, res_key, h, e, v0: int):
    """Vertex-centric decision for this slab.  ``res_key`` is the per-local-
    arc residual (length amax).  Returns (u_q, q_valid, do_push,
    do_relabel, d, k_arc, newh)."""
    vs, amax, n = meta.vs, meta.amax, meta.n
    u_gl = v0 + torch.arange(vs, dtype=_I32, device=h.device)
    act = ((e[u_gl] > 0) & (h[u_gl] < n) & (u_gl != meta.s)
           & (u_gl != meta.t))
    avq = torch.nonzero_static(act, size=vs, fill_value=vs).view(-1).to(_I32)
    q_valid = avq < vs
    avq_c = torch.clamp(avq, max=vs - 1)
    key = torch.where(res_key > 0, h[torch.clamp(heads, max=n - 1)], INF)
    minh, argk = kref.min_neighbor_ref(avq, indptr, key, n=vs)
    u_q = v0 + avq_c  # global vertex per queue row
    u_c = torch.clamp(u_q, max=n - 1)
    can = q_valid & (minh < INF)
    do_push = can & (h[u_c] > minh)
    k_arc = torch.clamp(argk, 0, amax - 1)
    d = torch.where(do_push, torch.minimum(e[u_c], res_key[k_arc]), 0)
    do_relabel = q_valid & ~do_push
    newh = torch.where(can, minh + 1, n)
    return u_q, q_valid, do_push, do_relabel, d, k_arc, newh


def _slab_res(meta: DistMeta, res: torch.Tensor, w: int) -> torch.Tensor:
    """This rank's arc residuals: its slab of a replicated ``(A,)`` residual,
    or the ``(amax,)`` slab itself."""
    if meta.mode == "replicated":
        return res[w * meta.amax:(w + 1) * meta.amax]
    return res


def make_dist_step(meta: DistMeta, g: DistGraph, group=None):
    """One BSP superstep of this rank: ``step(res, h, e) -> (res, h, e)``.

    A scatter the reference drops (``mode="drop"``) adds a zero here:
    each idle lane adds it at a slot of its own, which leaves the same
    result without every idle lane's atomic add contending for one
    sentinel address.  The sparse buffers are written, not added to:
    their dropped lanes go to a sentinel row that is sliced off."""
    n, A, vs, amax, P = (meta.n, meta.num_arcs, meta.vs, meta.amax,
                         meta.nshards)
    w = dist.get_rank(group)
    v0 = w * vs
    dev = g.heads.device
    lane = torch.arange(vs, dtype=_I32, device=dev)
    idle_a, idle_slab = lane % A, lane % amax
    idle_recv = torch.arange(P * vs, dtype=_I32, device=dev) % amax

    def step(res, h, e):
        res_key = _slab_res(meta, res, w)
        u_q, _, do_push, do_relabel, d, k_arc, newh = _local_decide(
            meta, g.indptr, g.heads, res_key, h, e, v0)
        u_c = torch.clamp(u_q, max=n - 1)
        hd = torch.clamp(g.heads[k_arc], max=n - 1)
        g_rev = torch.where(do_push, g.rev[k_arc], idle_a)
        dh = torch.where(do_relabel, newh - h[u_c], 0)
        # e's and h's deltas, in one buffer after the replicated mode's
        # arc deltas: one all-reduce a step
        buf = torch.zeros((A if meta.mode == "replicated" else 0) + 2 * n,
                          dtype=_I32, device=dev)
        dv = buf[buf.shape[0] - 2 * n:]
        dv.index_add_(0, torch.cat([torch.where(do_push, u_c, lane),
                                    torch.where(do_push, hd, lane),
                                    torch.where(do_relabel, u_c, lane) + n]),
                      torch.cat([-d, d, dh]))
        if meta.mode == "replicated":
            buf[:A].index_add_(0, torch.cat([
                torch.where(do_push, w * amax + k_arc, idle_a), g_rev]),
                torch.cat([-d, d]))
            dist.all_reduce(buf, group=group)
            return res + buf[:A], h + dv[n:], e + dv[:n]
        dist.all_reduce(dv, group=group)
        res_l = res.index_add(0, torch.where(do_push, k_arc, idle_slab), -d)
        if meta.mode == "sharded":
            drev = torch.zeros(A, dtype=_I32, device=dev).index_add_(
                0, g_rev, d)
            drev_l = torch.empty(amax, dtype=_I32, device=dev)
            dist.reduce_scatter_tensor(drev_l, drev, group=group)
            return res_l + drev_l, h + dv[n:], e + dv[:n]
        # 'sparse': pushes are <= vs per shard, so exchange (arc, delta)
        # pairs through one bucketed all-to-all instead of a dense (A,)
        # reduction: O(P*vs) wire instead of O(A)
        dest = torch.where(do_push, g_rev // amax, P)  # owner shard
        order = torch.argsort(dest, stable=True)
        dest_s = dest[order]
        shards = torch.arange(P, dtype=_I32, device=dev)
        first = torch.where(dest_s[None, :] == shards[:, None],
                            lane[None, :], vs).amin(dim=1)  # (P,)
        first_s = torch.where(dest_s < P,
                              first[torch.clamp(dest_s, max=P - 1)], 0)
        rank = lane - first_s
        # (P + 1, 2, vs): per owner its arcs, then its deltas; row P is
        # the sentinel of the lanes that do not push
        send = torch.zeros((P + 1) * 2 * vs, dtype=_I32, device=dev)
        send[:P * vs * 2].view(P, 2, vs)[:, 0].fill_(A)
        slot = (dest_s * 2) * vs + rank
        send[torch.cat([slot, slot + vs])] = torch.cat([g_rev[order],
                                                        d[order]])
        send = send[:P * 2 * vs]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        recv = recv.view(P, 2, vs)
        recv_arc, recv_d = recv[:, 0].reshape(-1), recv[:, 1].reshape(-1)
        mine = (recv_arc >= w * amax) & (recv_arc < (w + 1) * amax)
        res_l = res_l.index_add_(0, torch.where(mine, recv_arc - w * amax,
                                                idle_recv),
                                 torch.where(mine, recv_d, 0))
        return res_l, h + dv[n:], e + dv[:n]

    return step


def make_gr_sweep(meta: DistMeta, g: DistGraph, group=None):
    """A single distributed Bellman sweep of the global relabel:
    ``sweep(res, dist) -> dist``, each rank's scatter-min over its slab's
    tails combined by an all-reduce of MIN."""
    n, vs = meta.n, meta.vs
    w = dist.get_rank(group)
    tails_g = torch.clamp(w * vs + g.tail_local, max=n - 1).long()
    hd = torch.clamp(g.heads, max=n - 1)
    real = g.tail_local < vs

    def sweep(res, dist_):
        dd = dist_[hd]
        key = torch.where((_slab_res(meta, res, w) > 0) & (dd < INF) & real,
                          dd + 1, INF)
        cand = torch.full((n,), INF, dtype=_I32, device=dd.device)
        cand.scatter_reduce_(0, tails_g, key, "amin")
        # combine shards' sweep fronts
        dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
        return engine.fill_at(torch.minimum(dist_, cand), meta.t, 0)

    return sweep


def make_dist_global_relabel(meta: DistMeta, g: DistGraph, group=None):
    """Distributed backward BFS (MIN-reduced sweeps to a fixpoint) +
    deactivation: ``gr(res, h, e) -> (h, nact, sweeps)``, ``nact`` the
    active vertices left and ``sweeps`` the sweeps run (0-d int32)."""
    n, s, t = meta.n, meta.s, meta.t
    sweep = make_gr_sweep(meta, g, group)

    def gr(res, h, e):
        dist0 = torch.full((n,), INF, dtype=_I32, device=h.device)
        dist_, sweeps = engine.run_to_fixpoint(
            lambda x: sweep(res, x), engine.fill_at(dist0, t, 0), cap=n)
        hn = engine.fill_at(torch.where(dist_ < INF, dist_, n), s, n)
        act = engine.fill_at(engine.fill_at((e > 0) & (hn < n), s, False),
                             t, False)
        return hn, act.sum(dtype=_I32), sweeps

    return gr


def make_superstep(meta: DistMeta, g: DistGraph, group=None,
                   cycles: int = 64):
    """``cycles`` x dist_step + one distributed global relabel:
    ``superstep(res, h, e) -> (res, h, e, nact, sweeps)``."""
    step = make_dist_step(meta, g, group)
    gr = make_dist_global_relabel(meta, g, group)

    def body(carry):
        res, h, e, i = carry
        return (*step(res, h, e), i + 1)

    def superstep(res, h, e):
        # counter-only cond: exactly ``cycles`` steps with no early exit,
        # as the reference's loop runs them
        zero = torch.zeros((), dtype=_I32, device=h.device)
        res, h, e, _ = engine.run_bulk_loop(
            body, (res, h, e, zero), cond_fn=lambda c: c[3] < cycles,
            chunk=engine.normalize_chunk(None, cycles))
        h, nact, sweeps = gr(res, h, e)
        return res, h, e, nact, sweeps

    return superstep


def check_group(group, device) -> torch.device:
    """The device this rank solves on, once ``group`` (``None``: the
    default group) exists and its backend carries that device's tensors:
    NCCL for the card, gloo for the CPU.  Raises otherwise."""
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the distributed solve needs a torch.distributed process group: "
            "launch under torchrun, or call "
            "torch.distributed.init_process_group first")
    backend = str(dist.get_backend(group))
    # 'gloo', or per device type as 'cpu:gloo,cuda:nccl'
    by_type = dict(p.split(":") for p in backend.split(",")) \
        if ":" in backend else {dev.type: backend}
    want = BACKENDS[dev.type]
    if by_type.get(dev.type) != want:
        raise ValueError(
            f"the process group's backend {backend!r} does not carry "
            f"{dev.type} tensors; use {want!r} for device {dev.type!r}")
    return dev


class DistSolveResult(NamedTuple):
    value: int
    res: torch.Tensor   # (A,) replicated, or this rank's (amax,) slab
    h: torch.Tensor     # (n,) replicated
    e: torch.Tensor     # (n,) replicated
    supersteps: int
    gr_sweeps: int
    meta: DistMeta


def distributed_solve_impl(r: ResidualCSR, s: int, t: int, group=None,
                           mode: str = "replicated", cycles: int = 64,
                           max_rounds: int = 10000,
                           device=None) -> DistSolveResult:
    """Full distributed solve on this rank, one of ``group``'s (every rank
    calls it with the same arguments): the host preflow, then supersteps
    until no vertex is active, one host read of ``nact`` a superstep."""
    dev = check_group(group, device)
    slabs, meta, res0 = partition_graph(r, dist.get_world_size(group), s, t,
                                        mode)
    w = dist.get_rank(group)
    g = slabs[w].to(dev)
    res, h, e = initial_state(slabs, meta, res0, w, dev)
    superstep = make_superstep(meta, g, group, cycles)
    sweeps = torch.zeros((), dtype=_I32, device=dev)
    for rnd in range(max_rounds):
        res, h, e, nact, sw = superstep(res, h, e)
        sweeps = sweeps + sw
        if int(nact) == 0:
            break
    else:
        raise RuntimeError("distributed push-relabel did not converge")
    return DistSolveResult(int(e[t]), res, h, e, rnd + 1, int(sweeps), meta)


def solve_distributed(r: ResidualCSR, s: int, t: int, group=None,
                      mode: str = "replicated", cycles: int = 64,
                      max_rounds: int = 10000, device=None) -> int:
    """Full distributed solve on this rank of ``group``: the max-flow
    value."""
    return distributed_solve_impl(r, s, t, group, mode, cycles, max_rounds,
                                  device).value


def gather_res(res: torch.Tensor, meta: DistMeta, group=None
               ) -> torch.Tensor:
    """The whole ``(A,)`` residual of a solve: replicated as it is, the
    sharded and sparse modes' slabs gathered from every rank."""
    if meta.mode == "replicated":
        return res
    out = torch.empty(meta.num_arcs, dtype=res.dtype, device=res.device)
    dist.all_gather_into_tensor(out, res, group=group)
    return out
