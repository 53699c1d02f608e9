"""Faults planted in the program under test, and the controls, by name.

The check that decides ``correct`` has to come out false under each of
them.  Each is a context manager that patches the program's classes or
modules for the length of a run and restores them after.

The controls break one guarantee that a configuration states, as a
later change could be tempted to:

* ``preflow_flows`` (max flow): the ``flows`` view reads the solver's
  maximum preflow as it stands, phase 2 skipped;
* ``greedy_matching`` (matching): the ``matching`` view answers with a
  greedy maximal matching instead of the maximum one.

The faults each cell can have:

* ``stalled_step``: the cycles return the state unchanged and the solve
  stops at once, as if converged;
* ``value_altered``: the answer's value is one more than the solve
  found;
* ``flow_altered``, ``pair_altered``: one flow (one unit more on a
  saturated pair), or one matched pair, is changed where the view
  produces it.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def preflow_flows():
    from repro_torch.api.solution import Solution
    from repro_torch.core import pushrelabel as pr

    def flows(self):
        h = self._handle()
        return pr.flows_from_state(h.residual, self.state)
    return _patched(Solution, "flows", flows)


def greedy_matching():
    from repro_torch.api.solution import Solution

    def matching(self):
        bp = self.problem.bipartite
        used_l = np.zeros(bp.n_left, bool)
        used_r = np.zeros(bp.n_right, bool)
        pairs = []
        for u, v in bp.lr_edges.tolist():
            if not used_l[u] and not used_r[v - bp.n_left]:
                used_l[u] = used_r[v - bp.n_left] = True
                pairs.append((u, v))
        return np.array(pairs, np.int64).reshape(-1, 2)
    return _patched(Solution, "matching", matching)


@contextlib.contextmanager
def stalled_step():
    from repro_torch.core import globalrelabel, pushrelabel

    relabel = globalrelabel.global_relabel_impl
    rounds = []

    def run_cycles(g, meta, state, *a, **kw):
        rounds.append(1)
        out = (state, 0)
        return out + (None,) if kw.get("telemetry") else out

    def global_relabel(*a, **kw):
        state, nact, sweeps = relabel(*a, **kw)
        return state, (0 if rounds else nact), sweeps

    with _patched(pushrelabel, "run_cycles", run_cycles), \
            _patched(globalrelabel, "global_relabel_impl", global_relabel):
        yield


def value_altered():
    from repro_torch.api.solution import Solution

    init = Solution.__init__

    def __init__(self, problem, value, *a, **kw):
        init(self, problem, int(value) + 1, *a, **kw)
    return _patched(Solution, "__init__", __init__)


def flow_altered():
    from repro_torch.api.solution import Solution

    flows = Solution.flows

    def altered(self):  # one more unit on a saturated pair where one is
        f = flows(self).copy()
        r = self._handle().residual
        full = np.flatnonzero((f > 0) & (f == r.res0[r.pair_arc]))
        f[full[0] if full.size else len(f) // 2] += 1
        return f
    return _patched(Solution, "flows", altered)


def pair_altered():
    from repro_torch.api.solution import Solution

    matching = Solution.matching

    def altered(self):
        pairs = matching(self).copy()
        pairs[len(pairs) // 2, 1] = pairs[0, 1]
        return pairs
    return _patched(Solution, "matching", altered)


#: the controls and faults by name; a request kind names those its check
#: has to catch in ``bench/drivers/<kind>.py`` (``CONTROL``, ``FAULTS``)
INJECT = {f.__name__: f for f in (
    preflow_flows, greedy_matching, stalled_step, value_altered,
    flow_altered, pair_altered)}
