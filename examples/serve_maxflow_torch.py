"""Serving max-flow queries on the PyTorch/CUDA port: batching, caching,
and warm re-solves, every answer verified against the Dinic oracle.

    PYTHONPATH=src python examples/serve_maxflow_torch.py               # the card
    PYTHONPATH=src python examples/serve_maxflow_torch.py --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it fails rather than falling back to the CPU.
"""
import argparse

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.graphs import generators as G
from repro_torch.serving import MaxflowService, ServiceConfig

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="cpu to run the plain PyTorch path (default: the card)")
device = ap.parse_args().device

service = MaxflowService(ServiceConfig(max_batch=4, cycle_chunk=16,
                                       device=device))
print(f"service on {service.device}")

# -- submit a few instances; same-shape graphs share one batched dispatch ---
futures = []
for seed in range(4):
    g, s, t = G.random_sparse(80, 320, max_cap=20, seed=seed)
    futures.append((seed, g, s, t, service.submit(g, s, t)))

for seed, g, s, t, fut in futures:
    res = fut.result()  # forces the microbatch to flush
    print(f"graph seed={seed}: maxflow={res.maxflow} "
          f"(solved in a batch of {res.batch_size})")
    assert res.maxflow == dinic_maxflow(g, s, t)

# -- an identical repeat is served from the result cache -------------------
g, s, t = G.random_sparse(80, 320, max_cap=20, seed=0)
res = service.submit(g, s, t).result()
print(f"repeat: maxflow={res.maxflow} cached={res.cached}")
assert res.cached and res.maxflow == dinic_maxflow(g, s, t)

# -- edit capacities and re-solve warm from the cached residual ------------
base = futures[0][4].result()
arc = int(np.where(g.edges[:, 0] == s)[0][0])
bump = [(s, int(g.edges[arc, 1]), 5)]
warm = service.resubmit(base.graph_id, bump).result()
print(f"after capacity bump {bump}: maxflow={warm.maxflow} "
      f"(warm={warm.warm}, {warm.cycles} cycles vs {base.cycles} cold)")
cap = g.cap.copy()
cap[arc] += 5  # the edge's coalesced pair grows by 5 either way
assert warm.maxflow == dinic_maxflow(Graph(g.n, g.edges, cap), s, t)

# -- bipartite matching rides the same service -----------------------------
bp = G.bipartite_random(30, 20, 3.0, seed=7)
match = service.submit_matching(bp).result()
print(f"matching size: {match.maxflow}")
assert match.maxflow == dinic_maxflow(bp.graph, bp.s, bp.t)

print("\nservice stats:", service.stats())
print("verified against Dinic oracle")
