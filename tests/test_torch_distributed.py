"""The port's distributed backend (``repro_torch.core.distributed``)
against the JAX package's ``repro.core.distributed``, superstep by
superstep, bit for bit.

The reference runs in one subprocess per mesh size P with
``XLA_FLAGS=--xla_force_host_platform_device_count=P`` (as
``tests/test_distributed.py`` runs it); the port runs as P gloo rank
processes that rendezvous through a ``file://`` under the test's
temporary directory.  All of them start together, and they hand their
states across as ``.npz``.  Every value is also held against Dinic.

Tolerance: exact equality (int32 throughout; integer adds commute)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import distributed as D
from repro_torch.core.csr import Graph, build_residual
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.graphs.generators import washington_rlg
from repro_torch.launch import maxflow as tlaunch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SIZES = (1, 2, 4)
#: steps a superstep: not a multiple of the engine's chunk of 4, so every
#: superstep ends in gated steps
CYCLES = 6
#: ranks' and the reference's processes stay single-threaded: ten of them
#: run at once
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": SRC}
TIMEOUT = 240


def _random(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    return Graph(n, e, rng.integers(1, 9, size=m).astype(np.int64)), 0, n - 1


def _graphs():
    """name -> (graph, s, t): three random graphs (30 and 37 vertices are
    not divisible by 4, 37 not by 2) and a Washington random-level graph
    of 258 vertices; then the edge cases."""
    out = {"rand30": _random(30, 90, 11), "rand37": _random(37, 120, 12),
           "rand48": _random(48, 160, 13),
           "wash16": washington_rlg(16, 16, seed=7)}
    out["no_arcs"] = (Graph(6, np.zeros((0, 2), np.int64),
                            np.zeros(0, np.int64)), 0, 5)
    g, s, t = _random(24, 80, 14)
    keep = g.edges[:, 0] != s  # the source has no out-arcs
    out["source_no_out"] = (Graph(g.n, g.edges[keep], g.cap[keep]), s, t)
    keep = g.edges[:, 1] != t  # nothing enters the sink
    out["sink_unreachable"] = (Graph(g.n, g.edges[keep], g.cap[keep]), s, t)
    return out


GRAPHS = _graphs()
PARITY = ("rand30", "rand37", "rand48", "wash16")
EDGE = ("no_arcs", "source_no_out", "sink_unreachable")
#: the reference also runs the edge cases on this mesh size
EDGE_P = 2

REF_SCRIPT = r"""
import json, os, sys
P, work, spec = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro import compat
from repro.core import distributed as D
from repro.core.csr import Graph, build_residual

mesh = compat.make_mesh((P,), ("shard",))
data = np.load(os.path.join(work, "graphs.npz"))
for name in spec["graphs"]:
    s, t = (int(x) for x in data[name + "_st"])
    r = build_residual(Graph(int(data[name + "_n"]), data[name + "_edges"],
                             data[name + "_cap"]), "bcsr")
    for mode in spec["modes"]:
        g, meta, res0 = D.partition_graph(r, P, s, t, mode)
        superstep = jax.jit(D.make_superstep(meta, "shard", spec["cycles"],
                                             mesh))
        with compat.set_mesh(mesh):
            # the host preflow of solve_distributed, distributed.py:338-352
            res = np.asarray(res0).copy()
            heads = np.asarray(g.heads).reshape(-1)
            rev = np.asarray(g.rev).reshape(-1)
            e = np.zeros(meta.n, np.int32)
            h = np.zeros(meta.n, np.int32)
            h[s] = meta.n
            w0, lo = s // meta.vs, s % meta.vs
            ip = np.asarray(g.indptr)
            for k in range(ip[w0, lo], ip[w0, lo + 1]):
                a = w0 * meta.amax + k
                d = res[a]
                res[a] = 0
                res[rev[a]] += d
                e[heads[a]] += d
            e[s] = 0
            rec = {"res": [res.copy()], "h": [h.copy()], "e": [e.copy()],
                   "nact": [-1]}
            res = jnp.asarray(res)
            if mode in ("sharded", "sparse"):
                res = jax.device_put(res.reshape(P, meta.amax),
                                     NamedSharding(mesh, PartitionSpec("shard")))
            h, e = jnp.asarray(h), jnp.asarray(e)
            for _ in range(10000):
                res, h, e, nact = superstep(g, res, h, e)
                for k, v in (("res", res), ("h", h), ("e", e)):
                    rec[k].append(np.asarray(v).reshape(-1))
                rec["nact"].append(int(nact))
                if int(nact) == 0:
                    break
        np.savez(os.path.join(work, f"ref_P{P}_{name}_{mode}.npz"),
                 **{k: np.stack(v) for k, v in rec.items()})
print("REF-OK")
"""

PORT_SCRIPT = r"""
import json, os, sys
rank, P, work, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                       json.loads(sys.argv[4]))
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    work, f"rendezvous_P{P}"), rank=rank, world_size=P)
from repro_torch.core import distributed as D
from repro_torch.core.csr import Graph, build_residual

data = np.load(os.path.join(work, "graphs.npz"))
for name in spec["graphs"]:
    s, t = (int(x) for x in data[name + "_st"])
    r = build_residual(Graph(int(data[name + "_n"]), data[name + "_edges"],
                             data[name + "_cap"]), "bcsr")
    for mode in spec["modes"]:
        # the superstep loop of distributed_solve_impl, each state kept
        slabs, meta, res0 = D.partition_graph(r, P, s, t, mode)
        res, h, e = D.initial_state(slabs, meta, res0, rank, "cpu")
        superstep = D.make_superstep(meta, slabs[rank].to("cpu"), None,
                                     spec["cycles"])
        rec = {"res": [D.gather_res(res, meta).numpy().copy()],
               "h": [h.numpy().copy()], "e": [e.numpy().copy()],
               "nact": [-1]}
        while True:
            res, h, e, nact, _ = superstep(res, h, e)
            for k, v in (("res", D.gather_res(res, meta)), ("h", h),
                         ("e", e)):
                rec[k].append(v.numpy().copy())
            rec["nact"].append(int(nact))
            if int(nact) == 0:
                break
        out = D.distributed_solve_impl(r, s, t, mode=mode,
                                       cycles=spec["cycles"], device="cpu")
        final = [D.gather_res(out.res, out.meta).numpy(), out.h.numpy(),
                 out.e.numpy()]
        value = D.solve_distributed(r, s, t, mode=mode,
                                    cycles=spec["cycles"], device="cpu")
        if rank == 0:
            np.savez(os.path.join(work, f"port_P{P}_{name}_{mode}.npz"),
                     **{k: np.stack(v) for k, v in rec.items()},
                     final_res=final[0], final_h=final[1], final_e=final[2],
                     value=out.value, value_again=value,
                     supersteps=out.supersteps)
dist.destroy_process_group()
print("PORT-OK")
"""


def _spawn(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every reference and port run of the parity cases, all started
    together; returns the directory of their ``.npz`` files."""
    work = tmp_path_factory.mktemp("dist")
    arrays = {}
    for name, (g, s, t) in GRAPHS.items():
        arrays.update({f"{name}_n": g.n, f"{name}_edges": g.edges,
                       f"{name}_cap": g.cap, f"{name}_st": [s, t]})
    np.savez(work / "graphs.npz", **arrays)
    procs = []
    for p in SIZES:
        names = PARITY + (EDGE if p == EDGE_P else ())
        procs.append(_spawn(REF_SCRIPT, p, work, json.dumps(
            {"graphs": names, "modes": D.MODES, "cycles": CYCLES})))
        spec = json.dumps({"graphs": PARITY + EDGE, "modes": D.MODES,
                           "cycles": CYCLES})
        procs += [_spawn(PORT_SCRIPT, rank, p, work, spec)
                  for rank in range(p)]
    for proc in procs:
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
        assert "-OK" in out
    return work


def _load(work, who, p, name, mode):
    return np.load(work / f"{who}_P{p}_{name}_{mode}.npz")


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("name", PARITY + EDGE)
def test_partition_matches_reference(name, p):
    """``partition_graph``'s rows are the reference's ``(P, ·)`` arrays,
    byte for byte, and the host preflow is the reference's
    (``distributed.py:338-352``, transcribed over those arrays)."""
    from repro.core import csr as jcsr
    from repro.core import distributed as JD

    g, s, t = GRAPHS[name]
    jr = jcsr.build_residual(jcsr.Graph(g.n, g.edges, g.cap), "bcsr")
    jg, jmeta, jres0 = JD.partition_graph(jr, p, s, t, "sharded")
    slabs, meta, res0 = D.partition_graph(build_residual(g, "bcsr"), p, s,
                                          t, "sharded")
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    for f in ("indptr", "heads", "rev", "tail_local"):
        want = np.asarray(getattr(jg, f))
        got = np.stack([getattr(sl, f) for sl in slabs])
        assert got.dtype == want.dtype == np.int32 and got.tobytes() == \
            want.tobytes(), f
    want = np.asarray(jres0)
    assert res0.dtype == want.dtype and res0.tobytes() == want.tobytes()

    res = want.copy()
    heads = np.asarray(jg.heads).reshape(-1)
    rev = np.asarray(jg.rev).reshape(-1)
    e = np.zeros(jmeta.n, np.int32)
    h = np.zeros(jmeta.n, np.int32)
    h[s] = jmeta.n
    w0, lo = s // jmeta.vs, s % jmeta.vs
    ip = np.asarray(jg.indptr)
    for k in range(ip[w0, lo], ip[w0, lo + 1]):
        a = w0 * jmeta.amax + k
        d = res[a]
        res[a] = 0
        res[rev[a]] += d
        e[heads[a]] += d
    e[s] = 0
    for got, want in zip(D.host_preflow(slabs, meta, res0), (res, h, e)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", D.MODES)
@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("name", PARITY + EDGE)
def test_supersteps_match_reference(runs, name, p, mode):
    """Each superstep's ``(res, h, e, nact)`` (a sharded ``res`` gathered)
    equals the reference's ``make_superstep`` output exactly, the
    superstep counts agree, ``distributed_solve_impl`` ends in the last of
    those states, and the value is Dinic's."""
    g, s, t = GRAPHS[name]
    port = _load(runs, "port", p, name, mode)
    want = dinic_maxflow(g, s, t)
    assert int(port["value"]) == int(port["value_again"]) == want
    steps = len(port["nact"]) - 1
    assert int(port["supersteps"]) == steps and port["nact"][-1] == 0
    for k in ("res", "h", "e"):
        assert np.array_equal(port[f"final_{k}"], port[k][-1]), k
    assert int(port["e"][-1][t]) == want
    if name in EDGE and p != EDGE_P:
        return
    ref = _load(runs, "ref", p, name, mode)
    for k in ("res", "h", "e", "nact"):
        assert ref[k].shape == port[k].shape, k
        assert ref[k].dtype == port[k].dtype, k
        assert np.array_equal(ref[k], port[k]), (k, np.argwhere(
            ref[k] != port[k])[:5])


def test_modes_agree_with_each_other(runs):
    """The three exchanges are one computation: at every P each superstep's
    state is the same in every mode."""
    for p in SIZES:
        for name in PARITY + EDGE:
            base = _load(runs, "port", p, name, "replicated")
            for mode in D.MODES[1:]:
                other = _load(runs, "port", p, name, mode)
                for k in ("res", "h", "e", "nact"):
                    assert np.array_equal(base[k], other[k]), (p, name, mode)


FACADE_SCRIPT = r"""
import os, sys
import numpy as np, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.graphs.generators import washington_rlg, random_sparse

problems = [MaxflowProblem(*washington_rlg(16, 16, seed=3)),
            MaxflowProblem(*random_sparse(40, 150, seed=2))]
want = [dinic_maxflow(p.graph, p.s, p.t) for p in problems]
solver = Solver(backend="distributed", device="cpu")
sol = solver.solve(problems[0])
assert sol.value == want[0], (sol.value, want)
assert sol.warm_start is None and sol.state is None
st = sol.stats
assert st.backend == "distributed" and st.mode == "vc" and st.layout == "bcsr"
assert st.rounds >= 1 and st.cycles == 64 * st.rounds and st.gr_sweeps > 0
for view in (sol.flows, sol.min_cut):
    try:
        view()
    except RuntimeError as err:
        assert "distributed" in str(err)
    else:
        raise AssertionError("a view of a distributed solution ran")
sols = Solver(backend="distributed", device="cpu",
              global_relabel_cadence=8).solve_many(problems)
assert [x.value for x in sols] == want
assert all(x.stats.cycles == 8 * x.stats.rounds for x in sols)
dist.destroy_process_group()
print("FACADE-OK")
"""


def test_facade_under_one_rank_group(tmp_path):
    """``Solver(backend="distributed", device="cpu")`` on a one-rank gloo
    group: Dinic's value, no warm-start handle (its views raise), and
    ``solve_many`` one solve per problem."""
    r = subprocess.run([sys.executable, "-c", FACADE_SCRIPT,
                        str(tmp_path / "rendezvous")], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FACADE-OK" in r.stdout


def test_facade_without_group_raises():
    """No process group: ``NotImplementedError`` naming ``torchrun`` and
    ``init_process_group``, never a solve on another backend."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    p = MaxflowProblem(*washington_rlg(8, 8, seed=1))
    for call in (lambda s: s.solve(p), lambda s: s.solve_many([p, p])):
        with pytest.raises(NotImplementedError,
                           match="torchrun.*init_process_group"):
            call(Solver(backend="distributed", device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        D.solve_distributed(build_residual(p.graph, "bcsr"), p.s, p.t,
                            device="cpu")


@pytest.mark.parametrize("mode", ["vc_kernel", "vc_kernel_bsearch",
                                  "vc_fused", "tc"])
def test_facade_refuses_non_vc_modes(mode):
    with pytest.raises(ValueError, match="vertex-centric only"):
        Solver(backend="distributed", mode=mode, device="cpu")


@pytest.mark.parametrize("backend,device,ok", [
    ("gloo", "cpu", True), ("nccl", "cpu", False),
    ("cpu:gloo,cuda:nccl", "cpu", True), ("cpu:nccl,cuda:gloo", "cpu", False)])
def test_group_backend_must_carry_the_device(monkeypatch, backend, device,
                                             ok):
    """NCCL carries CUDA tensors and gloo CPU tensors; a group whose
    backend does not carry the solve's device raises."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    if ok:
        assert D.check_group(None, device) == torch.device(device)
    else:
        with pytest.raises(ValueError, match="does not carry"):
            D.check_group(None, device)


def test_unknown_exchange_mode_raises():
    g, s, t = GRAPHS["rand30"]
    with pytest.raises(ValueError, match="exchange mode"):
        D.partition_graph(build_residual(g, "bcsr"), 2, s, t, "ring")


def test_launcher_under_torchrun():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.maxflow
    --backend distributed --device cpu --smoke``: rank 0 alone prints, and
    verifies against Dinic."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.maxflow",
         "--backend", "distributed", "--device", "cpu", "--smoke"],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("SMOKE PASS") == 1
    assert r.stdout.count("backend=distributed") == 1


def test_launcher_size_passes_torchrun(monkeypatch):
    """The size flag survives ``torchrun``'s own parser under the name
    the docs give (``--vertices``), and the launcher sizes its graph by
    it before it opens the group."""
    from torch.distributed.run import get_args_parser

    from repro_torch.graphs import generators as G

    cmd = ["--standalone", "--nproc-per-node", "1", "-m",
           "repro_torch.launch.maxflow", "--backend", "distributed",
           "--generator", "washington", "--vertices", "64", "--seed", "7",
           "--cycle-chunk", "1024", "--device", "cpu"]
    run = get_args_parser().parse_args(cmd)
    assert run.training_script == "repro_torch.launch.maxflow"
    assert run.training_script_args == cmd[5:]
    seen = []

    def generate(rows, cols, seed):
        seen.append((rows, cols, seed))
        return washington_rlg(rows, cols, seed=seed)

    def stop(device):
        seen.append(device)
        raise SystemExit("stopped before the group")

    monkeypatch.setattr(G, "washington_rlg", generate)
    monkeypatch.setattr(tlaunch, "init_distributed", stop)
    with pytest.raises(SystemExit, match="stopped before the group"):
        tlaunch.main(run.training_script_args)
    assert seen == [(8, 8, 7), "cpu"]


def test_launcher_without_torchrun_exits(monkeypatch):
    """Run bare, ``--backend distributed`` exits with the ``torchrun``
    command; it never falls back to another backend."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node"):
        tlaunch.main(["--backend", "distributed", "--device", "cpu",
                      "--smoke"])
