"""Maximum bipartite matching with WBPR (paper Table 2 task) on the
PyTorch/CUDA port, through the ``repro_torch.api`` facade, including
matched-pair extraction.

    PYTHONPATH=src python examples/bipartite_matching_torch.py               # the card
    PYTHONPATH=src python examples/bipartite_matching_torch.py --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it fails rather than falling back to the CPU.
"""
import argparse

from repro_torch.api import MatchingProblem, Solver
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.graphs.generators import bipartite_random

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="cpu to run the plain PyTorch path (default: the card)")
device = ap.parse_args().device

bp = bipartite_random(n_left=300, n_right=200, avg_deg=4.0, seed=42)
problem = MatchingProblem(bp)
print(f"bipartite graph: L={problem.n_left} R={problem.n_right} "
      f"E={len(bp.lr_edges)}")

# paper: RCSR often wins on matching workloads
sol = Solver(layout="rcsr", mode="vc", device=device).solve(problem)
pairs = sol.matching()
print(f"matching size = {sol.value} (solver rounds: {sol.stats.rounds}, "
      f"on {sol.state.res.device})")
print(f"first pairs: {pairs[:5].tolist()}")
assert len(pairs) == sol.value
assert sol.value == dinic_maxflow(bp.graph, bp.s, bp.t)
print("verified against Dinic oracle")
