"""The plain reference agrees with the program's plain ``vc`` solve on
small graphs, and refuses answers that are not optimal."""
from __future__ import annotations

import numpy as np
import pytest

from bench.gen import graphs
from bench.lib.request import seed_seq
from bench.reference import certify
from bench.reference.pairs import PairTable


def solve(inst, mode="vc"):
    from repro_torch.api import MaxflowProblem, Solver
    from repro_torch.core.csr import Graph

    sol = Solver(mode=mode, device="cpu").solve(
        MaxflowProblem(Graph(inst.n, inst.edges, inst.cap), inst.s, inst.t))
    return sol.value, sol.flows(), sol.min_cut().source_side


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_program_flows_certify(seed):
    inst = graphs.make("washington_rlg", seed_seq(seed, 0, 0),
                       {"rows": 12, "cols": 10})
    table = PairTable.from_edges(inst.n, inst.edges, inst.cap)
    value, flows, side = solve(inst)
    got = certify.maxflow(table, inst.s, inst.t, value, flows, side)
    assert got == dict.fromkeys(got, 0)
    # the reference's own cut: what the source reaches in the residual
    f = flows.astype(np.int64)
    up, down = table.fwd - f > 0, table.bwd + f > 0
    reach = certify.reachable(
        inst.n, np.concatenate([table.lo[up], table.hi[down]]),
        np.concatenate([table.hi[up], table.lo[down]]), np.array([inst.s]))
    cross = (table.fwd * (reach[table.lo] & ~reach[table.hi])
             + table.bwd * (reach[table.hi] & ~reach[table.lo])).sum()
    assert cross == value


def test_pair_order_is_the_programs():
    from repro_torch.core.csr import Graph, build_residual

    inst = graphs.make("washington_rlg", seed_seq(9, 0, 0),
                       {"rows": 8, "cols": 6})
    edges = np.concatenate([inst.edges, inst.edges[:5, ::-1],
                            inst.edges[:3]])  # reverse and parallel edges
    cap = np.concatenate([inst.cap, inst.cap[:5], inst.cap[:3]])
    table = PairTable.from_edges(inst.n, edges, cap)
    r = build_residual(Graph(inst.n, edges, cap))
    assert np.array_equal(table.lo, r.pair_u)
    assert np.array_equal(table.hi, r.heads[r.pair_arc])
    assert np.array_equal(table.fwd, r.res0[r.pair_arc])
    assert np.array_equal(table.bwd, r.res0[r.rev[r.pair_arc]])


def test_non_optimal_answers_are_refused():
    inst = graphs.make("washington_rlg", seed_seq(4, 0, 0),
                       {"rows": 12, "cols": 10})
    table = PairTable.from_edges(inst.n, inst.edges, inst.cap)
    value, flows, side = solve(inst)
    zero = certify.maxflow(table, inst.s, inst.t, 0, np.zeros_like(flows),
                           np.arange(inst.n) == inst.s)
    assert zero["augmenting_path"] == 1 and zero["cut_gap"] > 0
    over = flows.copy()
    i = int(np.argmax(table.fwd - flows))
    over[i] = table.fwd[i] + 1
    assert certify.maxflow(table, inst.s, inst.t, value, over,
                           side)["over_capacity"] == 1
    assert certify.maxflow(table, inst.s, inst.t, value + 1, flows,
                           side)["value_gap"] == 2


@pytest.mark.parametrize("seed", [1, 2])
def test_program_matching_certifies(seed):
    from repro_torch.api import MatchingProblem, Solver
    from repro_torch.core.csr import Graph
    from repro_torch.graphs.generators import BipartiteProblem

    b = graphs.make("bipartite_random", seed_seq(seed, 0, 0),
                    {"n_left": 120, "n_right": 90, "avg_deg": 4})
    lr = b.edges[: len(b.edges) - b.n_left - b.n_right]
    sol = Solver(mode="vc", device="cpu").solve(MatchingProblem(
        BipartiteProblem(Graph(b.n, b.edges, b.cap), b.s, b.t, b.n_left,
                         b.n_right, lr)))
    pairs = sol.matching()
    got = certify.matching(b.n_left, b.n_right, lr, sol.value, pairs)
    assert got == dict.fromkeys(got, 0)
    # one pair fewer is a matching that can be augmented
    short = certify.matching(b.n_left, b.n_right, lr, sol.value - 1,
                             pairs[1:])
    assert short["augmenting_path"] == 1 and short["value_gap"] == 0
