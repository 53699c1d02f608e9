"""Quickstart on the PyTorch/CUDA port: Problem -> Solver(backend) ->
Solution with the workload-balanced push-relabel (the paper's algorithm),
verified against the Dinic oracle.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it fails rather than falling back to the CPU.
"""
import argparse

import numpy as np

from repro_torch.api import CapacityUpdate, MaxflowProblem, Solver
from repro_torch.core.ref_maxflow import dinic_maxflow

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="cpu to run the plain PyTorch path (default: the card)")
device = ap.parse_args().device

# a small capacitated network
edges = np.array([
    [0, 1], [0, 2], [1, 2], [1, 3], [2, 4], [3, 5], [4, 3], [4, 5],
], np.int64)
caps = np.array([16, 13, 10, 12, 14, 20, 7, 4], np.int64)
problem = MaxflowProblem.from_arrays(6, edges, caps, s=0, t=5)

# 1. the problem owns graph construction — the paper's enhanced CSR
#    (BCSR: aggregated, head-sorted, O(V+E)) is built and cached on demand
r = problem.residual("bcsr")
print(f"graph: V={problem.n} E={r.m}; residual arcs={r.num_arcs} "
      f"({r.memory_bytes()} bytes vs {r.adjacency_matrix_bytes()} "
      f"for an adjacency matrix)")

# 2. run the vertex-centric WBPR solver
solver = Solver(mode="vc", layout="bcsr", device=device)
sol = solver.solve(problem)
print(f"max flow = {sol.value} on {sol.state.res.device} "
      f"(cycles={sol.stats.cycles}, "
      f"global relabels={sol.stats.global_relabels})")

# 3. same, through the min-search kernel: the CUDA gather entry on the
#    card, its plain PyTorch version on the CPU
sol_k = Solver(mode="vc_kernel", device=device).solve(problem)
print(f"max flow via the min-search kernel path = {sol_k.value}")

# 4. lazy views: per-edge flows and the min-cut certificate
cut = sol.min_cut()
print(f"min cut = {cut.value} across {len(cut.cut_arcs)} saturated arcs; "
      f"nonzero edge flows: {int((sol.flows() != 0).sum())}")

# 5. incremental re-solve: bump a capacity and warm-start from the handle
sol2 = solver.resolve(sol.warm_start, CapacityUpdate(2, 4, 5))
print(f"after cap(2->4) += 5: max flow = {sol2.value} "
      f"(warm={sol2.stats.warm}, {sol2.stats.cycles} cycles)")

# 6. verify
want = dinic_maxflow(problem.graph, 0, 5)
assert sol.value == sol_k.value == cut.value == want
caps2 = caps.copy()
caps2[4] += 5
assert sol2.value == dinic_maxflow(
    MaxflowProblem.from_arrays(6, edges, caps2, 0, 5).graph, 0, 5)
print(f"verified against Dinic: {want}")
