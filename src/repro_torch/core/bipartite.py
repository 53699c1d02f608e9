"""Maximum bipartite matching via unit-capacity max-flow (paper Table 2);
port of the JAX package's ``repro.core.bipartite``.

The super-source/super-sink construction is done by the generator
(``repro_torch.graphs.generators.bipartite_random``) exactly as the paper
does for the KONECT graphs; matching size == max-flow value, and the
matched pairs are recovered from the saturated left->right arcs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pushrelabel
from repro_torch.core.csr import build_residual
from repro_torch.graphs.generators import BipartiteProblem


def max_matching_impl(problem: BipartiteProblem, layout: str = "bcsr",
                      mode: str = "vc", **solve_kw):
    """Solve the matching max-flow.  The returned ``SolveStats`` carries
    the final ``PRState``, so the matched pairs can be recovered with
    ``extract_matching(problem, r, stats.state)`` on the same residual."""
    r = build_residual(problem.graph, layout)
    return pushrelabel.solve_impl(r, problem.s, problem.t, mode=mode,
                                  **solve_kw)


def extract_matching(problem: BipartiteProblem, r, state,
                     corrected: bool = False, device=None) -> np.ndarray:
    """Matched (left, right) pairs from the final residual state (phase-2
    preflow->flow conversion on ``device`` included unless ``corrected``
    says the state already holds a genuine flow)."""
    if corrected:
        flows = pushrelabel.flows_from_state(r, state)
    else:
        flows = pushrelabel.flows_from_state(r, state, problem.s, problem.t,
                                             device=device)
    pu = np.asarray(r.pair_u)
    heads = np.asarray(r.heads)
    arc = np.asarray(r.pair_arc)
    pv = heads[arc]
    sel = (flows > 0) & (pu < problem.n_left) & \
          (pv >= problem.n_left) & (pv < problem.n_left + problem.n_right)
    neg = (flows < 0) & (pv < problem.n_left) & \
          (pu >= problem.n_left) & (pu < problem.n_left + problem.n_right)
    pairs = np.concatenate([
        np.stack([pu[sel], pv[sel]], 1),
        np.stack([pv[neg], pu[neg]], 1),
    ])
    return pairs
