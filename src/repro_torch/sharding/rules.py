"""Logical-axis sharding rules for the production meshes (port of the
JAX package's ``repro.sharding.rules``).

Every parameter/activation dim is tagged with a *logical* axis name; the
rules below map logical names to mesh axes.  Defaults implement
TP-over-``model`` + FSDP-over-``data`` (and ``pod``), i.e. 2-D sharded
parameters with ZeRO-3-style optimizer-state sharding (states inherit the
param specs).

A dim is sharded only if divisible by the mapped axis size — otherwise it is
replicated (e.g. qwen1.5's kv=20 on model=16).

The reference returns a ``PartitionSpec``; here :func:`spec_for` returns
a plain tuple with the same entries (``None``, an axis name, or a tuple
of names), and :func:`placements` turns it into the DTensor placements of
a ``DeviceMesh`` (one ``Shard(d)`` or ``Replicate()`` a mesh dim).  A
mesh is a ``launch.mesh.Mesh`` (``shape`` a tuple beside ``axis_names``),
a ``DeviceMesh`` (``mesh_dim_names``) or anything whose ``shape`` maps
axis names to sizes, as a JAX mesh does.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, NamedTuple

# logical axis -> mesh axes (tuple = composed axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),   # weight non-model dim (ZeRO-3)
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": None,           # flipped to ("model",) when expert_parallel
    "d_inner": ("model",),     # mamba inner channels
    "rwkv_heads": ("model",),
    "seq": None,               # activations: sequence usually unsharded
    "seq_kv": ("model",),      # decode KV-cache sequence dim
    "seq_kv_wide": ("data", "model"),  # long-context (batch=1) cache seq
    "embed": None,
    "stage": ("pod",),         # pipeline stages (optional feature)
    None: None,
}


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order, of any of the meshes above."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):  # a JAX mesh
        return dict(shape)
    return dict(zip(mesh.axis_names, shape))


def _axes_in_mesh(sizes: dict, axes):
    if axes is None:
        return None
    present = tuple(a for a in axes if a in sizes)
    return present or None


def _axis_size(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in axes) if axes else 1


def spec_for(mesh, logical: tuple, shape: tuple, rules=None) -> tuple:
    """The spec of a tensor whose dims carry ``logical`` names: one entry
    a dim, ``None``, a mesh axis or a tuple of them.

    A mesh axis is assigned to at most one dim (first logical dim wins);
    non-divisible dims are replicated instead of padded."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    sizes = mesh_sizes(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axes = _axes_in_mesh(sizes, rules.get(name))
        if axes:
            axes = tuple(a for a in axes if a not in used)
        if axes and dim % _axis_size(sizes, axes) == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


class Sharding(NamedTuple):
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    mesh: object
    spec: tuple


def sharding_for(mesh, logical: tuple, shape: tuple, rules=None) -> Sharding:
    return Sharding(mesh, spec_for(mesh, logical, shape, rules))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """The shape of one rank's shard: each dim divided by the sizes of
    the axes its entry names (every such dim divides, by
    :func:`spec_for`)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axis_size(sizes, _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where dim ``d``'s entry names it, else ``Replicate()``.

    DTensor orders the shards of one tensor dim over several mesh dims
    by mesh dim, JAX by the entry's tuple; so an entry whose axes are
    not in mesh order is refused, not reordered."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_sizes(mesh))
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = []
        for a in axes:
            if a not in order:
                raise ValueError(f"axis {a!r} is not in the mesh {order}")
            idx.append(order.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"the entry {entry!r} of dim {d} is not in mesh order "
                f"{order}: DTensor would shard it in another order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def rules_for_config(cfg) -> dict:
    r = {}
    if getattr(cfg, "expert_parallel", False):
        r["experts"] = ("model",)
        # with EP the ffn dim stays local to the expert
        r["ffn"] = None
    return r


# ---------------------------------------------------------------------------
# DTensors from full or local tensors, with no collective
# ---------------------------------------------------------------------------

def local_chunk(t, dmesh, placements_):
    """This rank's shard of the full tensor ``t`` under ``placements_`` on
    the ``DeviceMesh`` ``dmesh``: chunked mesh dim after mesh dim, so a
    dim sharded over two mesh dims takes the reference's tuple order."""
    from torch.distributed.tensor import Shard

    coord = dmesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            t = t.chunk(dmesh.size(i), dim=p.dim)[coord[i]]
    return t


def from_local(local, dmesh, placements_, shape):
    """A DTensor of global ``shape`` whose shard on this rank is ``local``
    (contiguous global strides; no check, no collective)."""
    import torch
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, dmesh, placements_, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def from_full(t, dmesh, placements_):
    """``t``, held whole by every rank, as a DTensor: each rank keeps its
    own shard (``distribute_tensor`` would send rank 0's copy)."""
    return from_local(local_chunk(t, dmesh, placements_).contiguous(),
                      dmesh, placements_, tuple(t.shape))


@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication()`` that restores the flag it found (the
    library's sets it False on exit, which ends an outer one early)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def shard_index(mesh, mesh_dims) -> int:
    """This rank's shard of a tensor dim split over ``mesh_dims`` (mesh
    dim indices, in mesh order, as DTensor orders the chunks)."""
    coord = mesh.get_coordinate()
    out = 0
    for i in mesh_dims:
        out = out * mesh.size(i) + coord[i]
    return out


def rank_generator(dmesh, seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded by ``seed`` and this
    rank's coordinate on ``dmesh``: each rank draws its own shards."""
    import torch

    coord = dmesh.get_coordinate() or []
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + sum(
        c * 7919 ** i for i, c in enumerate(coord)))
    return gen


def on_mesh(*xs):
    """Implicit replication (this thread only) when any of ``xs``
    (tensors or trees of dicts of them) holds a DTensor, else a null
    context: on a mesh, the plain tensors a step makes (positions, masks,
    the optimizer's bias corrections) count as replicated.  A backward
    runs on other threads on the card, so what it saves must be a
    DTensor already (:func:`replicated`)."""
    from torch.distributed.tensor import DTensor

    def has(x):
        if isinstance(x, dict):
            return any(has(v) for v in x.values())
        return isinstance(x, DTensor)
    return _implicit_replication() if any(has(x) for x in xs) else \
        contextlib.nullcontext()


def replicated(t, like):
    """``t`` as a DTensor replicated over ``like``'s mesh when ``like`` is
    a DTensor (and ``t`` is not); else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` on each rank's shards of its DTensor arguments (the
    reference's ``shard_map``, as ``local_map``): ``in_specs`` one spec a
    positional argument (``None``: not a DTensor, passed as it is), each
    DTensor redistributed to its spec first; ``out_specs`` one spec a
    result.  A mesh dim that some input is sharded over splits the work,
    so the gradient of an input whole over it is a partial sum over it
    (``Partial``), as ``shard_map``'s transpose gives."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    ins = [None if sp is None else placements(mesh, sp) for sp in in_specs]
    outs = tuple(placements(mesh, sp) for sp in out_specs)
    split = [any(pl is not None and pl[i] != Replicate() for pl in ins)
             for i in range(mesh.ndim)]
    grads = [None if pl is None else tuple(
        Partial() if q == Replicate() and split[i] else q
        for i, q in enumerate(pl)) for pl in ins]
    return local_map(fn, out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)


def vocab_gather(table, index, logical_index):
    """``table[index]`` along a table's first dim on DTensors, the table
    (V, ...) sharded over its first dim by the rules' ``vocab`` and
    ``index`` over ``logical_index``: under ``local_map`` each rank looks
    up the indices that fall in its rows (zero elsewhere), so the result
    is a partial sum over the mesh dims that shard the table; the
    table's gradient is a scatter-add into each rank's own rows (a
    partial sum over the dims that split the indices).  ``index`` may
    have more dims than the result takes: ``table`` (V,) gives one value
    an index."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tspec = spec_for(mesh, ("vocab",) + (None,) * (table.ndim - 1),
                     tuple(table.shape))
    ispec = spec_for(mesh, logical_index, tuple(index.shape))
    if not isinstance(index, DTensor):
        index = from_full(index, mesh, placements(mesh, ispec))
    tpl, ipl = placements(mesh, tspec), placements(mesh, ispec)
    vdims = [i for i, p in enumerate(tpl) if p != Replicate()]
    out = tuple(Partial() if i in vdims else p for i, p in enumerate(ipl))
    tgrad = tuple(Partial() if p == Replicate() and ipl[i] != Replicate()
                  else p for i, p in enumerate(tpl))
    shard = shard_index(mesh, vdims)

    def local(t, idx):
        v = t.shape[0]
        off = idx.long() - shard * v
        here = (off >= 0) & (off < v)
        got = t[off.clamp(0, v - 1)]
        here = here.reshape(here.shape + (1,) * (got.ndim - here.ndim))
        return torch.where(here, got, torch.zeros((), dtype=got.dtype,
                                                  device=got.device))

    return local_map(local, out_placements=(out,),
                     in_placements=(tpl, ipl), in_grad_placements=(tgrad, ipl),
                     device_mesh=mesh, redistribute_inputs=True)(table, index)


def sum_over(t, group):
    """``t`` summed over ``group`` (an all-reduce), as an autograd op whose
    backward passes the gradient through: every rank holds the sum and
    the same cotangent of it, which is each term's (``psum``'s transpose
    under ``shard_map``)."""
    import torch

    class _SumOver(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            import torch.distributed as dist

            x = x.clone()
            dist.all_reduce(x, group=group)
            return x

        @staticmethod
        def backward(ctx, g):
            return g

    return _SumOver.apply(t)


def fsdp_gather(w):
    """A weight DTensor gathered whole over the FSDP axes and left as it
    is over the others (ZeRO-3's gather before a layer's products), so
    that a product with a batch-sharded activation needs no other
    redistribution; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    fsdp = _entry_axes(spec_for(w.device_mesh, ("fsdp",), (0,))[0])
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in fsdp else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def reduce_partial(t):
    """A DTensor's partial sums all-reduced (``Partial`` -> ``Replicate``):
    the all-reduce after a row-parallel product, made where the
    reference's GSPMD makes it rather than where the propagation would
    choose a reduce-scatter; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))
