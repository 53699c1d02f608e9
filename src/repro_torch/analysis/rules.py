"""The contract rules over an :class:`~repro_torch.analysis.ir.OpCensus`:
the JAX package's six rules (``repro.analysis.rules``), each stated for
eager PyTorch.

Each rule checks one structural property the paper's performance rests
on and reports typed :class:`Violation` records instead of asserting.
Which rules hold on which dispatch surface is the registry's business
(:mod:`repro_torch.analysis.surfaces`).

=====================  ==========================  ==========================
reference rule         port rule                   checks
=====================  ==========================  ==========================
NoVmappedPallasCall    ``no-per-row-launch``       every kernel launch spans
                                                   all ``B`` rows of the
                                                   surface, never one row
LaunchBudget(n)        ``launch-budget``           kernel launches per engine
                                                   step <= n, none outside
                                                   a step
NoHostSync             ``no-host-sync``            no op that syncs on the
                                                   card but the engine's one
                                                   read per chunk
ScanChunkShape         ``chunk-shape``             every host read is the
                                                   engine's, one per chunk
                                                   plus the last; the
                                                   expected engine loops;
                                                   n launches per step
Int32Lattice           ``int32-lattice``           no int64 from int32 state
                                                   but an index-only cast; no
                                                   narrowing of int64 that
                                                   is not an index
TraceBudget            ``op-budget``               aten ops per engine step
                                                   <= a ceiling
=====================  ==========================  ==========================
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.analysis.ir import OpCensus, is_engine_read

__all__ = [
    "Violation", "Rule", "NoPerRowLaunch", "LaunchBudget", "NoHostSync",
    "ChunkShape", "Int32Lattice", "OpBudget", "check_rules",
]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract: which rule, on which dispatch surface, and an
    account precise enough to act on."""

    rule: str
    surface: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.surface}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base contract rule: ``check(census, surface)`` -> violations."""

    name = "rule"

    def check(self, census: OpCensus,
              surface: str = "<anon>") -> list[Violation]:
        raise NotImplementedError

    def _v(self, surface: str, message: str) -> Violation:
        return Violation(rule=self.name, surface=surface, message=message)


class NoPerRowLaunch(Rule):
    """A batched surface launches each kernel once a step over all its
    ``rows`` instances (``grid.y`` is the batch), never once per row: the
    per-instance dispatch the batched core exists to avoid (the
    reference's vmapped ``pallas_call``)."""

    name = "no-per-row-launch"

    def __init__(self, rows: int):
        self.rows = int(rows)

    def check(self, census, surface="<anon>"):
        return [self._v(surface,
                        f"{k.kernel} launched over {k.rows} row(s) at "
                        f"{k.origin}, not the surface's {self.rows}: launch "
                        "the batch as one grid")
                for k in census.kernel_calls if k.rows != self.rows]


class LaunchBudget(Rule):
    """At most ``budget`` kernel launches per engine step, and none
    outside a step: the paper's per-cycle cost model assumes one
    workload-balanced launch a step."""

    name = "launch-budget"

    def __init__(self, budget: int):
        self.budget = int(budget)

    def check(self, census, surface="<anon>"):
        out = []
        for loop in census.loops:
            worst = max(loop.step_launches, default=0)
            if worst > self.budget:
                out.append(self._v(
                    surface, f"a step of the loop at {loop.site} launched "
                    f"{worst} kernels, over the budget of {self.budget}"))
            if loop.launches_outside_steps:
                out.append(self._v(
                    surface, f"{loop.launches_outside_steps} kernel "
                    f"launch(es) outside any engine step at {loop.site}"))
        return out


class NoHostSync(Rule):
    """No op that synchronises with the host on the card inside a
    surface, except the engine's one read per chunk: each is a round trip
    the bulk-synchronous loops exist to avoid.  ``allow`` lists op names
    a surface may carry (none does)."""

    name = "no-host-sync"

    def __init__(self, allow: Iterable[str] = ()):
        self.allow = frozenset(allow)

    def check(self, census, surface="<anon>"):
        return [self._v(surface, f"{c.op} ({c.reason}) at {c.origin}")
                for c in census.host_calls
                if c.op not in self.allow
                and not (c.op == "aten._local_scalar_dense"
                         and is_engine_read(c.origin))]


class ChunkShape(Rule):
    """The sweep engine's shape (``engine.run_bulk_loop``): every host
    read is the engine's, one per chunk plus the final one of each loop
    run; the surface runs ``loops`` distinct engine loops; each step of a
    loop that nests none launches ``launches`` kernels, and a step that
    nests loops launches none itself."""

    name = "chunk-shape"

    def __init__(self, loops: int = 1, launches: int = 0):
        self.loops = int(loops)
        self.launches = int(launches)

    def check(self, census, surface="<anon>"):
        out = []
        for c in census.host_calls:
            if not is_engine_read(c.origin):
                out.append(self._v(surface, f"host read {c.op} at "
                                   f"{c.origin} is not the engine's"))
        if census.loop_shells != self.loops:
            out.append(self._v(surface, f"expected {self.loops} engine "
                               f"loop(s), ran {census.loop_shells}"))
        for loop in census.loops:
            if loop.chunk is None:
                out.append(self._v(surface, f"{loop.steps} step(s) outside "
                                   "any engine loop"))
                continue
            chunks, rest = divmod(loop.steps, loop.chunk)
            if rest or loop.reads != chunks + 1:
                out.append(self._v(
                    surface, f"the loop at {loop.site} ran {loop.steps} "
                    f"step(s) in chunks of {loop.chunk} with {loop.reads} "
                    f"host read(s); one a chunk plus the last is "
                    f"{chunks + 1}"))
            want = 0 if loop.nested else self.launches
            bad = sorted({n for n in loop.step_launches if n != want})
            if bad:
                out.append(self._v(
                    surface, f"steps of the loop at {loop.site} launched "
                    f"{bad} kernel(s), expected {want}"))
        return out


def _bits(dtype: str) -> int | None:
    """Bits of an integer dtype name; ``None`` for bool and floats."""
    if dtype.startswith(("int", "uint")):
        return int(dtype.removeprefix("u").removeprefix("int"))
    return None


class Int32Lattice(Rule):
    """The dtype contract: device state is int32 end to end.

    * No int64 result from integer state, except a cast (``_to_copy``,
      ``copy_``) whose result is only ever an index operand (followed
      through index arithmetic): ``.long()`` before ``gather`` is an
      index, not state.  Any other widening (an int32 ``sum()`` without
      ``dtype``) is a violation.
    * No narrowing of an integer, except of values that came from an
      index-producing op (``nonzero_static``, ``argsort``, ``arange``,
      ...): it would wrap silently where ``as_state_dtype`` raises.

    Casts to or from bool and floats are exempt (predicates and
    telemetry are not state)."""

    name = "int32-lattice"

    def __init__(self, max_int_bits: int = 32):
        self.max_int_bits = int(max_int_bits)

    def check(self, census, surface="<anon>"):
        out = []
        for c in census.casts:
            src, dst = _bits(c.src), _bits(c.dst)
            if src is None or dst is None:
                continue
            if dst > self.max_int_bits and dst > src:
                if c.op == "aten.copy_" or c.op == "aten._to_copy":
                    if c.index_only:
                        continue
                    why = "its result is used as a value, not an index"
                else:
                    why = "a non-cast op widened it (pass dtype=)"
                out.append(self._v(surface, f"int64 from {c.src} by {c.op} "
                                   f"at {c.origin}: {why}"))
            elif dst < src and not c.index_source:
                out.append(self._v(
                    surface, f"narrowing {c.src} -> {c.dst} by {c.op} at "
                    f"{c.origin} of a value no index op produced: it wraps "
                    "silently where as_state_dtype would raise"))
        return out


class OpBudget(Rule):
    """Aten ops dispatched outside kernel brackets per engine step, at
    most ``max_ops``: the host's cost of a step (the reference's trace
    size).  Ceilings are seeded from measured counts with headroom, so
    crossing one is a structural change, not noise."""

    name = "op-budget"

    def __init__(self, max_ops: float):
        self.max_ops = float(max_ops)

    def check(self, census, surface="<anon>"):
        got = census.ops_per_step()
        if got <= self.max_ops:
            return []
        return [self._v(surface,
                        f"{got:.1f} aten ops a step ({census.op_count} over "
                        f"{census.steps} steps), over the budget of "
                        f"{self.max_ops:g}: find the ops that were added, or "
                        "re-baseline deliberately")]


def check_rules(census: OpCensus, rules: Iterable[Rule],
                surface: str = "<anon>") -> list[Violation]:
    """Run every rule against one census; concatenated violations."""
    out: list[Violation] = []
    for rule in rules:
        out.extend(rule.check(census, surface))
    return out
