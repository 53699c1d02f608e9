"""Sequential max-flow oracle (Dinic's algorithm) used to validate the
parallel push-relabel implementations.  Pure numpy/python, O(V^2 E) worst
case — plenty for test-scale graphs."""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.csr import Graph, ResidualCSR, build_residual


def dinic_maxflow(g: Graph, s: int, t: int) -> int:
    r = build_residual(g, "bcsr")
    return dinic_on_residual(r, s, t)


def dinic_on_residual(r: ResidualCSR, s: int, t: int) -> int:
    return dinic_residual_flow(r, s, t)[0]


def dinic_residual_flow(r: ResidualCSR, s: int,
                        t: int) -> tuple[int, np.ndarray]:
    """Dinic's max-flow returning ``(flow, final_residual)``.

    The residual array is per-arc in ``r``'s layout, i.e. directly usable
    as the corrected residual of a ``WarmStartHandle`` (zero excess
    everywhere except ``flow`` at ``t``) — this is the host-reference
    fallback the serving degradation ladder bottoms out on.
    """
    n = r.n
    indptr, heads, rev = r.indptr, r.heads, r.rev
    res = r.res0.copy()
    if s == t:
        return 0, res

    def bfs_levels():
        level = np.full(n, -1, np.int64)
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for a in range(indptr[u], indptr[u + 1]):
                v = heads[a]
                if res[a] > 0 and level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        return level if level[t] >= 0 else None

    flow = 0
    while True:
        level = bfs_levels()
        if level is None:
            return int(flow), res
        it = indptr[:-1].copy()  # current-arc optimisation

        # iterative DFS for blocking flow
        def dfs(u, pushed):
            if u == t:
                return pushed
            while it[u] < indptr[u + 1]:
                a = it[u]
                v = heads[a]
                if res[a] > 0 and level[v] == level[u] + 1:
                    d = dfs(v, min(pushed, res[a]))
                    if d > 0:
                        res[a] -= d
                        res[rev[a]] += d
                        return d
                it[u] += 1
            return 0

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, n + 100))
        try:
            while True:
                d = dfs(s, np.iinfo(np.int64).max)
                if d == 0:
                    break
                flow += d
        finally:
            sys.setrecursionlimit(old)
