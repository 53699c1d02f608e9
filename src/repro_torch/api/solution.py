"""Solve results (port of the JAX package's ``repro.api.solution``): one
``Solution`` type for every backend, with lazily computed views (per-edge
flows, min cut, matched pairs) and a ``WarmStartHandle`` for incremental
re-solves.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core import batched
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels.runtime import resolve_device

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.mincut import MinCut


@dataclasses.dataclass
class SolveStats:
    """Execution counters, uniform across backends."""

    cycles: int = 0  # push-relabel iterations spent
    rounds: int = 0  # [cycles -> global relabel] rounds
    global_relabels: int = 0
    backend: str = "single"
    mode: str = "vc"
    layout: str = "bcsr"
    warm: bool = False  # entered from a WarmStartHandle
    rerouted: bool = False  # the updates held a capacity decrease
    batch_size: int = 1  # instances in the call that solved this
    # device-side workload counters (SolverOptions(telemetry=True) only;
    # see repro_torch.obs.solvercounters for definitions)
    pushes: int = 0
    relabels: int = 0
    gr_sweeps: int = 0  # Bellman-Ford sweeps across all global relabels
    # per-cycle series, single backend only (np.int64, length == cycles)
    active_history: np.ndarray | None = None
    frontier_history: np.ndarray | None = None
    maxdeg_history: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class CapacityUpdate:
    """One ``cap(u -> v) += delta`` edit.  ``delta`` may be negative; the
    arc must already exist."""

    u: int
    v: int
    delta: int


def _normalize_updates(updates) -> list[tuple[int, int, int]]:
    if isinstance(updates, CapacityUpdate):
        updates = [updates]
    out = []
    for upd in updates:
        if isinstance(upd, CapacityUpdate):
            out.append((int(upd.u), int(upd.v), int(upd.delta)))
        else:
            u, v, d = upd
            out.append((int(u), int(v), int(d)))
    if not out:
        raise ValueError("empty capacity-update set")
    return out


class WarmStartHandle:
    """Opaque capture of a finished solve, sufficient to re-enter the
    solver incrementally.

    Semantics:

    * owns the ``ResidualCSR`` the solve ran on (``res0`` reflects the
      capacities that were solved) plus host int32 copies of the final
      residual occupancies ``res`` and excess ``e``, and the device of the
      solve that made it;
    * the solver terminates with a maximum *preflow* (stranded excess at
      deactivated vertices); :meth:`arrays` applies the phase-2
      preflow->flow conversion lazily, exactly once, on that device (a
      handle from a card solve corrects on the card, on the min-search
      kernel in the kernel modes); batched solves hand the handle an
      already-corrected residual (``corrected=True``) and serving
      handles carry a pooled ``corrector`` that fixes whole microbatches
      in one device dispatch;
    * :meth:`apply` turns a set of signed ``CapacityUpdate``s into the
      inputs of the next solve, warm for *both* signs: increases yield
      budgeted warm-start arrays (only the new capacity gets routed —
      the solved flow is kept), decreases reroute the overflowed flow on
      the handle's device (``repro_torch.streaming.reroute``, on the
      min-search kernel in the kernel modes) and re-enter with the
      drained value as budget.

    Handles are value-caches, not live views: editing the graph elsewhere
    does not invalidate them.
    """

    __slots__ = ("residual", "s", "t", "device", "_res", "_e", "_corrected",
                 "_corrector", "_use_kernel", "__weakref__")

    def __init__(self, residual: ResidualCSR, s: int, t: int,
                 res: np.ndarray, e: np.ndarray, corrected: bool = False,
                 corrector=None, use_kernel: bool = False, device=None):
        self.residual = residual
        self.s = int(s)
        self.t = int(t)
        # where the lazy phase 2 runs: the solve's device (None = the card)
        self.device = resolve_device(device)
        # the one state dtype, end-to-end: handles hold int32 (raising on
        # values that do not fit — see ``batched.as_state_dtype``), so a
        # later ``pack_states`` re-entry can never truncate
        self._res = batched.as_state_dtype(res, "handle res")
        self._e = batched.as_state_dtype(e, "handle excess")
        self._corrected = bool(corrected)
        # the kernel modes hand out use_kernel=True so the correction runs
        # on the min-search kernel (results are bit for bit the plain's)
        self._use_kernel = bool(use_kernel)
        # optional group hook: a no-arg callable that phase-2-corrects this
        # handle *and its batch-mates* in one device dispatch (it must call
        # _install_corrected on every member).  Lets the serving path defer
        # the correction of a whole flushed microbatch until any one entry
        # first needs it.
        self._corrector = corrector

    @property
    def corrected(self) -> bool:
        """Whether phase-2 preflow->flow conversion has run yet."""
        return self._corrected

    def validate(self) -> None:
        """Cheap O(V + A) invariant checks on the cached solver state;
        raises ``repro_torch.errors.HandleCorrupted`` listing every
        violation.

        Valid for both the preflow a solve hands out and the corrected
        flow phase 2 installs (both satisfy the same conservation
        identity).  Checks:

        * shapes match the owning residual;
        * residual occupancies are non-negative and every arc pair
          conserves its total capacity (``res[a] + res[rev[a]] ==
          res0[a] + res0[rev[a]]``);
        * excess is non-negative off the source;
        * flow conservation: for every vertex ``u != s``, the net flow
          out of ``u`` equals ``-e[u]`` (exact int64 segment sums).

        Heights are not checked — handles do not retain them (re-entry
        always starts from a fresh global relabel).
        """
        from repro_torch.errors import HandleCorrupted

        r = self.residual
        res = np.asarray(self._res, np.int64)
        e = np.asarray(self._e, np.int64)
        shape_bad = []
        if res.shape != (r.num_arcs,):
            shape_bad.append(
                f"res shape {res.shape} != ({r.num_arcs},)")
        if e.shape != (r.n,):
            shape_bad.append(f"excess shape {e.shape} != ({r.n},)")
        if shape_bad:  # nothing below is meaningful on wrong shapes
            raise HandleCorrupted(shape_bad)
        reasons = []
        if (res < 0).any():
            reasons.append(
                f"negative residual on {int((res < 0).sum())} arc(s)")
        res0 = np.asarray(r.res0, np.int64)
        rev = np.asarray(r.rev)
        bad_pair = (res + res[rev]) != (res0 + res0[rev])
        if bad_pair.any():
            reasons.append(
                f"pair capacity not conserved on {int(bad_pair.sum())} "
                "arc(s)")
        neg_e = e < 0
        neg_e[self.s] = False
        if neg_e.any():
            reasons.append(
                f"negative excess at {int(neg_e.sum())} non-source "
                "vertex(es)")
        # exact int64 per-vertex net outflow via prefix sums (reduceat
        # misbehaves on empty segments)
        f = res0 - res
        cs = np.concatenate([[np.int64(0)], np.cumsum(f)])
        indptr = np.asarray(r.indptr, np.int64)
        netout = cs[indptr[1:]] - cs[indptr[:-1]]
        violated = netout + e != 0
        violated[self.s] = False
        if violated.any():
            reasons.append(
                f"flow conservation violated at {int(violated.sum())} "
                "vertex(es)")
        if reasons:
            raise HandleCorrupted(reasons)

    @property
    def maxflow(self) -> int:
        return int(self._e[self.t])

    def _install_corrected(self, res: np.ndarray, e: np.ndarray) -> None:
        """Accept an externally computed phase-2 correction (the batched
        group dispatch installs results on every member handle).  A handle
        that already corrected itself keeps its cached arrays — phase-2
        results are only unique up to cancellation-path choice, and
        ``arrays()`` promises a stable value."""
        if not self._corrected:
            self._res = batched.as_state_dtype(res, "corrected res")
            self._e = batched.as_state_dtype(e, "corrected excess")
            self._corrected = True
        self._corrector = None

    def arrays(self, reference: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Phase-2-corrected ``(res, e)`` — a genuine max flow, where the
        only remaining excess is ``e[t] == maxflow``.  A handle with a
        ``corrector`` calls it once, first (one pooled dispatch corrects
        its whole group), unless ``reference=True``; otherwise the
        correction runs on the handle's device, or with ``reference=True``
        the host-BFS phase 2 (only relevant on the first call — the result
        is cached)."""
        if not self._corrected and self._corrector is not None \
                and not reference:
            corrector, self._corrector = self._corrector, None
            corrector()  # one batched dispatch corrects the whole group
        if not self._corrected:
            state = pr.PRState(res=self._res,
                               h=np.zeros(self.residual.n, np.int32),
                               e=self._e)
            self._res = batched.as_state_dtype(
                pr.convert_preflow_to_flow(
                    self.residual, state, self.s, self.t,
                    reference=reference, use_kernel=self._use_kernel,
                    device=self.device),
                "corrected residual")
            e = np.zeros(self.residual.n, batched.STATE_DTYPE)
            e[self.t] = self.maxflow
            self._e = e
            self._corrected = True
            self._corrector = None
        return self._res, self._e

    def apply(self, updates) -> tuple[ResidualCSR, tuple | None]:
        """Apply signed capacity updates; returns ``(updated_residual,
        warm)``.

        Both signs stay warm: increases grow the residual and budget the
        injected excess by the update total; decreases cancel the
        overflowed flow and drain the imbalance on the handle's device
        (``repro_torch.streaming.reroute``), budgeting by the drained
        value.  ``warm`` is the ``(res, h, e)`` warm-start triple — a
        warm start that injects no excess means the flow is *already*
        maximal and callers may answer without a solve — or ``None`` in
        the defensive case that the drain stalls (the handle did not hold
        a corrected flow); callers then cold-solve.  Raises ``KeyError``
        for a missing arc (structural changes are the streaming tier's
        ``rebuild_with_state``) and ``ValueError`` for a capacity driven
        below zero."""
        from repro_torch.streaming import reroute

        rr = reroute.drain_prepared([self.prepare_updates(updates)],
                                    use_kernel=self._use_kernel,
                                    device=self.device)[0]
        return self.finish_updates(rr)

    def prepare_updates(self, updates):
        """The host half of :meth:`apply`: phase-2-correct this handle's
        state and fold the signed updates into a
        ``reroute.PreparedReroute`` — no drain.  Preparations from many
        independent handles can be pooled into one device drain
        (``reroute.drain_prepared``); :meth:`finish_updates` turns each
        drained result back into the ``(residual, warm)`` pair ``apply``
        returns.  Raises exactly what ``apply`` raises (missing arc,
        capacity below zero)."""
        ups = _normalize_updates(updates)
        from repro_torch.streaming import reroute

        res, e = self.arrays()
        return reroute.prepare_signed(self.residual, res, e, self.s,
                                      self.t, ups)

    def finish_updates(self, rr) -> tuple[ResidualCSR, tuple | None]:
        """Fold a drained ``reroute.RerouteResult`` back into the
        ``(updated_residual, warm)`` pair :meth:`apply` returns (``warm``
        is ``None`` where the drain stalled)."""
        if not rr.ok:
            return rr.residual, None
        warm = batched.warm_start_arrays(rr.residual, rr.res, rr.e,
                                         self.s, budget=rr.budget)
        return rr.residual, warm

    def __repr__(self) -> str:  # opaque but debuggable
        return (f"WarmStartHandle(n={self.residual.n}, "
                f"arcs={self.residual.num_arcs}, s={self.s}, t={self.t}, "
                f"maxflow={self.maxflow}, corrected={self._corrected}, "
                f"device={self.device})")


class Solution:
    """The result of one solve, whatever executed it.

    ``value`` is the max-flow value (== matching size for matching
    problems, == cut capacity for min-cut problems).  Derived views are
    computed lazily from the warm-start handle's corrected residual and
    cached.  The ``distributed`` backend captures no final state: its
    Solution has ``warm_start=None`` and ``state=None``, and the views
    raise.

    ``state`` is a ``PRState`` on the solve's device: for a single solve
    the final maximum *preflow* (with stranded excess at deactivated
    vertices, before phase 2); for ``solve_many`` the instance's unpadded
    row of the batch's phase-2-corrected state (a genuine flow; ``h`` the
    final heights).
    """

    def __init__(self, problem, value: int, stats: SolveStats,
                 warm_start: WarmStartHandle | None,
                 state: pr.PRState | None):
        self.problem = problem
        self.value = int(value)
        self.stats = stats
        self.warm_start = warm_start
        self.state = state
        self._flows: np.ndarray | None = None
        self._cut = None
        self._matching: np.ndarray | None = None

    def _handle(self) -> WarmStartHandle:
        if self.warm_start is None:
            raise RuntimeError(
                f"the {self.stats.backend!r} backend does not capture final "
                "solver state; flows/cut/matching views are unavailable")
        return self.warm_start

    def _corrected_state(self) -> tuple[WarmStartHandle, pr.PRState]:
        """The handle plus its phase-2-corrected state as a ``PRState``."""
        h = self._handle()
        res, e = h.arrays()
        return h, pr.PRState(res=res, h=np.zeros(h.residual.n, np.int32),
                             e=e)

    def flows(self) -> np.ndarray:
        """Net flow per coalesced edge pair (phase-2 corrected): entry i
        is the flow carried u->v by ``residual.pair_arc[i]``."""
        if self._flows is None:
            h, state = self._corrected_state()
            self._flows = pr.flows_from_state(h.residual, state)
        return self._flows

    def min_cut(self) -> MinCut:
        """The dual certificate: a saturated s-t cut of capacity ``value``,
        its source side found on the handle's device."""
        if self._cut is None:
            from repro_torch.core import mincut

            h, state = self._corrected_state()
            self._cut = mincut.min_cut(h.residual, state, h.s, h.t,
                                       corrected=True,
                                       use_kernel=h._use_kernel,
                                       device=h.device)
        return self._cut

    def matching(self) -> np.ndarray:
        """Matched ``(left, right)`` pairs (matching problems only)."""
        if self._matching is None:
            from repro_torch.api.problem import MatchingProblem
            from repro_torch.core import bipartite

            if not isinstance(self.problem, MatchingProblem):
                raise TypeError(
                    "matching() is only defined for MatchingProblem "
                    f"solutions, not {type(self.problem).__name__}")
            h, state = self._corrected_state()
            self._matching = bipartite.extract_matching(
                self.problem.bipartite, h.residual, state, corrected=True)
        return self._matching

    def __repr__(self) -> str:
        return (f"Solution(value={self.value}, backend="
                f"{self.stats.backend!r}, mode={self.stats.mode!r}, "
                f"cycles={self.stats.cycles}, warm={self.stats.warm})")
