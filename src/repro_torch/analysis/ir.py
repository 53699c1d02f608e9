"""The op census of the port: what one call of a dispatch surface asks of
the device, recorded under a ``TorchDispatchMode``.

The JAX package censuses a jaxpr, an abstract trace that nothing runs.
Eager PyTorch has no such trace: :func:`census` RUNS ``fn`` once, on
whatever device its tensors are, and records every aten op the call
dispatches.  So the census is of one execution: data-dependent loops show
the steps they took, and a loop that never ran is not in it.  Where the
reference counts a program's loop shells and its ``pallas_call``
equations, the port counts the engine loops, steps and kernel launches
that ran.

What it records (:class:`OpCensus`):

* ``op_counts`` — aten op -> dispatches, outside kernel brackets.  Each
  kernel entry brackets its launch, or on the CPU its plain version, in
  ``kernels.runtime.census_launch``; the ops inside count as the
  kernel's body (``kernel_op_count``), the counterpart of the
  reference's ``enter_pallas_body=False``.
* ``kernel_calls`` — one :class:`KernelLaunch` a bracket.
* ``loops`` — one :class:`EngineLoop` a run of ``engine.run_bulk_loop``
  (reported by ``census_loop``/``census_step``): its chunk, steps, host
  reads and the kernel launches of each step.
* ``casts`` — every dtype change: the cast ops (``_to_copy``, ``copy_``)
  and any other op that returns int64 from narrower integers (an int32
  ``sum()`` without ``dtype``), each with whether its int64 result was
  used only as an index operand (followed through index arithmetic) and,
  for a narrowing, whether its source came from an index-producing op.
* ``host_calls`` — ops that synchronise with the host on the card
  (:data:`SYNC_OPS` and the conditional ones in :func:`_sync_reason`),
  each with its origin: the innermost frame outside PyTorch.
* ``collectives`` — every ``c10d`` op, and every functional collective
  that DTensor's redistributions issue (``_c10d_functional.*``), with
  its bytes and group size.

An op on DTensors is not recorded as such: the census lets DTensor run
it first and records the rank's local ops and collectives it turns into.

On the card the census also lets the engine's one read per chunk through
``torch.cuda.set_sync_debug_mode("error")``, so that every other
synchronisation raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from collections import Counter
from typing import Any, Callable, Iterator, Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import runtime

__all__ = [
    "SYNC_OPS", "INDEX_OPS", "CAST_OPS", "COLLECTIVE_KINDS", "Site",
    "KernelLaunch", "DtypeCast", "HostCall", "Collective", "EngineLoop",
    "OpCensus", "LoopCounts", "record", "census", "loop_counts",
    "is_engine_read",
]

#: ops that always wait for the device: a read into Python, a result whose
#: shape is data-dependent, a comparison returned to the host, and a host
#: value copied into the device program (``torch.tensor(...)``, ``x[i] =
#: 3``: on the card a synchronous host-to-device copy)
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
    "aten.equal", "aten.lift_fresh", "aten.lift_fresh_copy",
})

#: ops whose int64 results are positions, not state: their narrowing to
#: int32 is sound, and their widening of int32 inputs is not state's
INDEX_OPS = frozenset({
    "aten.arange", "aten.nonzero", "aten.nonzero_static", "aten.argsort",
    "aten.sort", "aten.argmin", "aten.argmax", "aten.topk",
    "aten.searchsorted", "aten.bucketize", "aten.randperm",
    "aten.nonzero_numpy",
})

#: the ops that change a tensor's dtype as such
CAST_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten.copy",
                      "aten._to_dtype"})

#: ``c10d`` op -> the collective kind the reference's HLO backend names
COLLECTIVE_KINDS = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}
# DTensor's redistributions issue the functional collectives
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    COLLECTIVE_KINDS.update({
        f"{_ns}.all_reduce": "all-reduce",
        f"{_ns}.all_reduce_": "all-reduce",
        f"{_ns}.all_reduce_coalesced": "all-reduce",
        f"{_ns}.all_reduce_coalesced_": "all-reduce",
        f"{_ns}.all_gather_into_tensor": "all-gather",
        f"{_ns}.all_gather_into_tensor_out": "all-gather",
        f"{_ns}.all_gather_into_tensor_coalesced": "all-gather",
        f"{_ns}.reduce_scatter_tensor": "reduce-scatter",
        f"{_ns}.reduce_scatter_tensor_coalesced": "reduce-scatter",
        f"{_ns}.all_to_all_single": "all-to-all",
    })

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_THIS = os.path.abspath(__file__)
_PKG = os.sep + "repro_torch" + os.sep
_INDEX_ARGS = frozenset({"index", "indices"})


class Site(NamedTuple):
    """Where an op came from: a file (under ``repro_torch/`` relative to
    the package, else its base name), a line and a function."""

    path: str
    line: int
    function: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line} ({self.function})"


def _rel(filename: str) -> str | None:
    """``filename`` as a census path; ``None`` for frames to skip
    (PyTorch's own, this module's, the standard library's
    ``contextlib``)."""
    if (filename.startswith(_TORCH_DIR) or os.path.abspath(filename) == _THIS
            or filename.endswith(os.sep + "contextlib.py")):
        return None
    i = filename.rfind(_PKG)
    return filename[i + len(_PKG):].replace(os.sep, "/") if i >= 0 else \
        os.path.basename(filename)


def _sites(skip: tuple[str, ...] = ()) -> Iterator[Site]:
    """The call stack's sites from the innermost out, past PyTorch's and
    this module's frames and any whose path starts with one of ``skip``."""
    f = sys._getframe(1)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None and not rel.startswith(skip):
            yield Site(rel, f.f_lineno, f.f_code.co_name)
        f = f.f_back


def _site(skip: tuple[str, ...] = ()) -> Site:
    return next(_sites(skip), Site("<unknown>", 0, "<unknown>"))


def is_engine_read(site: Site) -> bool:
    """The engine's one host read per chunk (``engine.run_bulk_loop``)."""
    return site.path == "core/engine.py" and site.function == "run_bulk_loop"


# ---------------------------------------------------------------------------
# census records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One kernel launch (on the CPU: one call of its plain version): the
    entry's name, the instances of the launch, its queue length
    (``None``: the dense form) and where it was called from."""

    kernel: str
    rows: int
    q: int | None
    origin: Site


@dataclasses.dataclass(frozen=True)
class DtypeCast:
    """One dtype change: the op, source and target dtypes, origin; for a
    widening to int64 whether its result was only ever an index operand,
    for a narrowing whether its source came from an index-producing op."""

    op: str
    src: str
    dst: str
    origin: Site
    index_only: bool
    index_source: bool


@dataclasses.dataclass(frozen=True)
class HostCall:
    """One op that synchronises with the host on the card."""

    op: str
    origin: Site
    reason: str


@dataclasses.dataclass(frozen=True)
class Collective:
    """One ``c10d`` op: its kind (:data:`COLLECTIVE_KINDS`, ``None`` for
    one the wire accounting does not count), the bytes of the tensor the
    HLO backend would size it by, the group's size (``None`` when
    unknown) and its origin."""

    op: str
    kind: str | None
    nbytes: int
    group_size: int | None
    origin: Site


@dataclasses.dataclass(frozen=True)
class EngineLoop:
    """One run of ``engine.run_bulk_loop`` (``chunk=None``: steps run by
    ``engine.run_chunk`` outside any loop).  ``shell`` is the call path
    that entered it, the same on every run of one loop in the program;
    ``step_launches`` holds each step's own kernel launches (those of
    loops nested in the step are theirs); ``nested`` says whether a loop
    ran inside one of its steps."""

    shell: tuple[tuple[str, int], ...]
    site: Site
    chunk: int | None
    steps: int
    reads: int
    step_launches: tuple[int, ...]
    launches_outside_steps: int
    nested: bool


class LoopCounts(NamedTuple):
    """``(host_reads, steps, kernel_calls)`` of one census."""

    host_reads: int
    steps: int
    kernel_calls: int


@dataclasses.dataclass(frozen=True)
class OpCensus:
    """The op census of one call (see the module docstring).  Counts
    treat a kernel bracket as one launch; its ops are summarised in
    ``kernel_op_count``.  ``capturable`` is filled by the analyzer on the
    card (whether one chunk of the surface's loop replays from a CUDA
    graph); no rule reads it."""

    op_counts: Mapping[str, int]
    ops: tuple[tuple[str, Site], ...]
    kernel_calls: tuple[KernelLaunch, ...]
    kernel_op_count: int
    casts: tuple[DtypeCast, ...]
    host_calls: tuple[HostCall, ...]
    collectives: tuple[Collective, ...]
    loops: tuple[EngineLoop, ...]
    capturable: bool | None = None
    capture_error: str | None = None
    #: ``(step_fn, cond_fn, carry, chunk, pass_gate)`` of the first
    #: engine loop that nested none, its carry as the loop began (kept by
    #: ``record(..., keep_chunk=True)``)
    chunk_loop: tuple | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @property
    def op_count(self) -> int:
        """Aten ops outside kernel brackets."""
        return sum(self.op_counts.values())

    @property
    def steps(self) -> int:
        return sum(loop.steps for loop in self.loops)

    @property
    def host_reads(self) -> int:
        return len(self.host_calls)

    @property
    def kernel_call_count(self) -> int:
        return len(self.kernel_calls)

    @property
    def loop_shells(self) -> int:
        """Distinct engine loops of the program that ran (a loop nested
        in another's step counts once, however often it ran)."""
        return len({loop.shell for loop in self.loops
                    if loop.chunk is not None})

    @property
    def chunked_shells(self) -> int:
        """Of :attr:`loop_shells`, those run in chunks of more than one
        step (the reference's scanned bodies)."""
        return len({loop.shell for loop in self.loops
                    if loop.chunk is not None and loop.chunk > 1})

    def ops_per_step(self) -> float:
        """Aten ops outside kernel brackets per engine step (all ops when
        no step ran): the host's dispatch cost of a step."""
        return self.op_count / max(1, self.steps)

    def launches_by_kernel(self) -> dict[str, int]:
        return dict(Counter(k.kernel for k in self.kernel_calls))

    def count(self, op: str) -> int:
        """Dispatches of ``op`` (``"aten.index"``: every overload)."""
        return self.op_counts.get(op, 0)

    def count_ops(self, pred: Callable[[str], bool]) -> int:
        """Dispatches outside kernel brackets whose op name satisfies
        ``pred``."""
        return sum(n for op, n in self.op_counts.items() if pred(op))

    def iter_ops(self) -> Iterator[tuple[str, Site]]:
        """``(op, origin)`` of every dispatch outside kernel brackets, in
        order."""
        return iter(self.ops)

    def loop_counts(self) -> LoopCounts:
        return LoopCounts(self.host_reads, self.steps,
                          self.kernel_call_count)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class _Node:
    """An int64 tensor's provenance: whether all of it came from
    index-producing ops, whether it was used as a value (anything but an
    index operand or further index arithmetic), and the int64 tensors
    derived from it."""

    __slots__ = ("index_source", "value_use", "children")

    def __init__(self, index_source: bool):
        self.index_source = index_source
        self.value_use = False
        self.children: list[_Node] = []

    def index_only(self) -> bool:
        todo, seen = [self], set()
        while todo:
            node = todo.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if node.value_use:
                return False
            todo.extend(node.children)
        return True


class _Loop:
    __slots__ = ("shell", "site", "chunk", "steps", "reads", "launches",
                 "outside", "nested", "kept")

    def __init__(self, shell, site, chunk, kept=None):
        self.shell, self.site, self.chunk = shell, site, chunk
        self.steps = self.reads = self.outside = 0
        self.launches: list[int] = []
        self.nested = False
        self.kept = kept

    def freeze(self) -> EngineLoop:
        return EngineLoop(self.shell, self.site, self.chunk, self.steps,
                          self.reads, tuple(self.launches), self.outside,
                          self.nested)


def _packet(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _is_int(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def _bits(dt: torch.dtype) -> int:
    return torch.iinfo(dt).bits


def _named_args(func, args, kwargs):
    """``(name, value)`` of every argument of one dispatch."""
    names = [a.name for a in func._schema.arguments]
    yield from zip(names, args)
    yield from kwargs.items()


def _tensors(value) -> list[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(value)
            if isinstance(x, torch.Tensor)]


def _sync_reason(op: str, func, args, kwargs) -> str | None:
    """Why this dispatch synchronises on the card, or ``None``."""
    if op in SYNC_OPS:
        return {"aten._local_scalar_dense": "read into Python",
                "aten.equal": "comparison returned to the host",
                "aten.lift_fresh": "host value copied in",
                "aten.lift_fresh_copy": "host value copied in",
                }.get(op, "data-dependent output shape")
    if op in ("aten.index", "aten.index_put", "aten.index_put_",
              "aten._index_put_impl_"):
        named = dict(_named_args(func, args, kwargs))
        if any(t.dtype in (torch.bool, torch.uint8)
               for t in _tensors(named.get("indices"))):
            return "boolean-mask index"
    if op == "aten.repeat_interleave":
        named = dict(_named_args(func, args, kwargs))
        if "repeats" in named and isinstance(named["repeats"], torch.Tensor) \
                and named.get("output_size") is None:
            return "repeat_interleave without output_size"
    if op == "aten._to_copy":
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu" \
                and args[0].device.type != "cpu":
            return "copy to the host"
    return None


def _group_size(args) -> int | None:
    from torch._C._distributed_c10d import ProcessGroup

    if args and isinstance(args[-1], str):  # a functional op's group name
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            return int(_resolve_process_group(args[-1]).size())
        except (RuntimeError, ValueError, KeyError):
            return None
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            try:
                return int(ProcessGroup.unbox(a).size())
            except (RuntimeError, TypeError):
                return None
    return None


def _collective_bytes(args) -> int:
    """Bytes of the tensor(s) the HLO backend sizes a collective by: the
    result (the gathered or scattered output, the reduced buffer)."""
    first = _tensors(args[0]) if args else []
    return sum(t.numel() * t.element_size() for t in first)


class _Recorder(TorchDispatchMode):
    """The dispatch mode behind :func:`record`; also the target of the
    ``kernels.runtime`` census hooks while it records."""

    def __init__(self, keep_chunk: bool = False):
        super().__init__()
        self.keep_chunk = keep_chunk
        self.chunk_loop = None
        self.ops: list[tuple[str, Site]] = []
        self.kernel_ops = 0
        self.depth = 0
        self.kernel_calls: list[KernelLaunch] = []
        self.casts: list[tuple[str, str, str, Site, _Node | None, bool]] = []
        self.host_calls: list[HostCall] = []
        self.collectives: list[Collective] = []
        self.root = _Loop((), Site("<top>", 0, "<top>"), None)
        self.stack: list[_Loop] = []
        self.loops: list[EngineLoop] = []
        self.nodes = WeakIdKeyDictionary()

    # -- hooks called by kernels.runtime ---------------------------------

    @contextlib.contextmanager
    def launch(self, symbol: str, rows: int, q: int | None):
        if self.depth == 0:
            self.kernel_calls.append(KernelLaunch(
                symbol, int(rows), None if q is None else int(q),
                _site(("kernels/",))))
            top = self.stack[-1] if self.stack else self.root
            if top.launches:
                top.launches[-1] += 1
            else:
                top.outside += 1
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    @contextlib.contextmanager
    def loop(self, chunk: int, step_fn, cond_fn, carry, pass_gate: bool):
        site = _site(("core/engine.py",))
        shell = tuple((s.path, s.line) for s in _sites()
                      if "/" in s.path and not s.path.startswith("analysis/"))
        if self.stack:
            self.stack[-1].nested = True
        kept = None
        if self.keep_chunk and self.chunk_loop is None:
            with _disable_current_modes():
                kept = (step_fn, cond_fn, _pytree.tree_map_only(
                    torch.Tensor, torch.clone, carry), int(chunk), pass_gate)
        self.stack.append(_Loop(shell, site, int(chunk), kept))
        try:
            yield
        finally:
            loop = self.stack.pop()
            if loop.kept and not loop.nested and loop.steps and \
                    self.chunk_loop is None:
                self.chunk_loop = loop.kept
            self.loops.append(loop.freeze())

    def step(self) -> None:
        top = self.stack[-1] if self.stack else self.root
        top.steps += 1
        top.launches.append(0)

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: the census sees the rank's local ops
            # and the collectives its redistributions issue
            return NotImplemented
        kwargs = kwargs or {}
        if self.depth:
            self.kernel_ops += 1
            return func(*args, **kwargs)
        op = _packet(func)
        site = _site()
        self.ops.append((op, site))
        reason = _sync_reason(op, func, args, kwargs)
        if reason is not None:
            self.host_calls.append(HostCall(op, site, reason))
        if op == "aten._local_scalar_dense" and is_engine_read(site):
            if self.stack:
                self.stack[-1].reads += 1
            out = self._engine_read(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self.collectives.append(Collective(
                op, COLLECTIVE_KINDS.get(op), _collective_bytes(args),
                _group_size(args), site))
        elif op in COLLECTIVE_KINDS:  # functional: its result is the buffer
            self.collectives.append(Collective(
                op, COLLECTIVE_KINDS[op], _collective_bytes((out,)),
                _group_size(args), site))
        else:
            self._track(op, func, args, kwargs, out, site)
        return out

    @staticmethod
    def _engine_read(func, args, kwargs):
        """Run the engine's read with the card's sync check relaxed: it is
        the one read per chunk the contract allows."""
        if not (torch.cuda.is_available() and args[0].is_cuda):
            return func(*args, **kwargs)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return func(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def _track(self, op, func, args, kwargs, out, site):
        """Follow int64 tensors: where they come from and how they are
        used, and record every dtype change."""
        ins = []  # (argument name, tensor)
        for name, value in _named_args(func, args, kwargs):
            ins += [(name, t) for t in _tensors(value)]
        outs = _tensors(out)
        out64 = [t for t in outs if t.dtype == torch.int64]
        is_cast = op in CAST_OPS
        # a tracked int64 input used as an index operand is fine; one that
        # feeds an op with an int64 result derives that result; any other
        # use (a narrowing cast's source among them) is a use as a value
        parents = []
        for name, t in ins:
            node = self.nodes.get(t)
            if node is None or name in _INDEX_ARGS:
                continue
            if out64 and not is_cast:
                parents.append(node)
            elif not any(t is o for o in outs):
                node.value_use = True
        if is_cast:
            self._cast(op, args, outs, site)
            return
        if not out64:
            return
        narrow = [t.dtype for name, t in ins if name not in _INDEX_ARGS
                  and _is_int(t.dtype) and _bits(t.dtype) <= 32]
        if op in INDEX_OPS:
            src = True
        else:
            src = bool(parents) and not narrow and all(
                p.index_source for p in parents)
            if narrow:
                # int64 made from narrower integers by a non-cast op (an
                # int32 sum without dtype): never an index-only cast
                self.casts.append((op, str(narrow[0]).split(".")[-1],
                                   "int64", site, None, False))
        for t in out64:
            node = self.nodes.get(t)
            if node is None:
                node = self.nodes[t] = _Node(src)
            else:  # updated in place: it keeps its provenance, and more
                node.index_source = node.index_source and src
            for p in parents:
                if p is not node:
                    p.children.append(node)

    def _cast(self, op, args, outs, site):
        if op == "aten.copy_":
            dst_t, src_t = args[0], args[1]
        else:
            src_t, dst_t = args[0], (outs[0] if outs else None)
        if dst_t is None or not isinstance(src_t, torch.Tensor) or \
                src_t.dtype == dst_t.dtype:
            return
        src_node = self.nodes.get(src_t)
        node = None
        if dst_t.dtype == torch.int64:
            node = _Node(False)
            self.nodes[dst_t] = node
        self.casts.append((op, str(src_t.dtype).split(".")[-1],
                           str(dst_t.dtype).split(".")[-1], site, node,
                           src_node is not None and src_node.index_source))

    # -- result ------------------------------------------------------------

    def finish(self, result) -> OpCensus:
        for t in _tensors(result):
            node = self.nodes.get(t)
            if node is not None:
                node.value_use = True  # returned: used as a value
        loops = list(self.loops)
        if self.root.steps or self.root.outside:
            loops.append(self.root.freeze())
        casts = tuple(DtypeCast(op, src, dst, site,
                                node is not None and node.index_only(),
                                index_source)
                      for op, src, dst, site, node, index_source
                      in self.casts)
        return OpCensus(
            op_counts=dict(Counter(op for op, _ in self.ops)),
            ops=tuple(self.ops), kernel_calls=tuple(self.kernel_calls),
            kernel_op_count=self.kernel_ops, casts=casts,
            host_calls=tuple(self.host_calls),
            collectives=tuple(self.collectives), loops=tuple(loops),
            chunk_loop=self.chunk_loop)


def record(fn: Callable, *args: Any, keep_chunk: bool = False,
           **kwargs: Any) -> tuple[Any, OpCensus]:
    """Run ``fn(*args, **kwargs)`` once under the recorder; returns its
    result and its :class:`OpCensus`.  ``keep_chunk`` keeps the first
    engine loop that nests none as ``OpCensus.chunk_loop``.  Censuses do
    not nest."""
    if runtime._census is not None:
        raise RuntimeError("a census is already recording")
    rec = _Recorder(keep_chunk)
    runtime._census = rec
    try:
        with rec:
            out = fn(*args, **kwargs)
    finally:
        runtime._census = None
    return out, rec.finish(out)


def census(fn: Callable, *args: Any, **kwargs: Any) -> OpCensus:
    """The :class:`OpCensus` of one run of ``fn(*args, **kwargs)``: the
    call runs, on its tensors' device (eager PyTorch has no abstract
    trace to census instead)."""
    return record(fn, *args, **kwargs)[1]


def loop_counts(fn: Callable, *args: Any, **kwargs: Any) -> LoopCounts:
    """``(host_reads, steps, kernel_calls)`` of one run of ``fn``."""
    return census(fn, *args, **kwargs).loop_counts()
