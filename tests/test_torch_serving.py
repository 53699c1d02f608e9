"""The port's serving tier against the JAX package's, on the same seeded
inputs: the copied modules (graph keys, buckets, caches, queues, the mode
policy and the ladder, the workload generator, the fault plan,
``to_jsonable``) under seeded random schedules, the handle's corrector
hook, the service request for request with equal ``stats()`` (without
its times) and equal ``serve.*`` counters in ``vc`` and in each kernel
mode (their plain versions on the CPU, held against JAX ``vc``), the
pooled phase-2 correction bit for bit, and the launcher.  JAX runs its
plain path, as ``tests/test_serving.py`` runs it.  Tolerance: exact
equality (every compared value is an integer, a flag or a string)."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.api import WarmStartHandle as JHandle
from repro.core.csr import build_residual as jbuild
from repro.obs import REGISTRY as JREGISTRY
from repro.obs import to_jsonable as jto_jsonable
from repro.runtime import fault as jfault
from repro.serving import MaxflowService as JService
from repro.serving import ServiceConfig as JConfig
from repro.serving import cache as jcache
from repro.serving import policy as jpolicy
from repro.serving import queueing as jqueue
from repro.serving import workload as jwork
from repro_torch.api import WarmStartHandle
from repro_torch.core.csr import Graph, build_residual
from repro_torch.launch import serve_maxflow
from repro_torch.obs import REGISTRY, to_jsonable
from repro_torch.runtime import fault
from repro_torch.serving import (BucketModePolicy, MaxflowService,
                                 ServiceConfig, candidate_modes)
from repro_torch.serving import cache, policy, queueing, workload
from tests.conftest import random_graph

SEEDS = range(6)
#: the parity workload: ``synthesize(24, seed)``, both packages
WORKLOAD_SEEDS = (0, 1)
WORKLOAD = dict(matching_frac=0.3, repeat_frac=0.15, resubmit_frac=0.2)
SERVICE = dict(max_batch=4, cycle_chunk=16)
#: the modes the port serves here against JAX ``vc`` (``vc_fused`` is
#: held against the JAX ``vc_fused`` driver in test_torch_serving_fused)
PORT_MODES = ("vc", "vc_kernel", "vc_kernel_bsearch")


@pytest.fixture(autouse=True)
def _fresh_registries():
    JREGISTRY.reset()
    REGISTRY.reset()
    yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module, restored after it: a service
    runs many small ops, and with a thread a core they wait on each other
    when test workers share the cores (a ``vc_kernel`` drive of the
    workload took 42.3 s with 8 threads and 2.9 s with one, beside 5
    busy processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tgraph(g):
    return Graph(g.n, g.edges.copy(), g.cap.copy())


# -- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_graph_key_and_bucket_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        g = random_graph(rng, n_lo=2, n_hi=60)
        s, t = (int(x) for x in rng.integers(0, g.n, 2))
        for layout in ("bcsr", "rcsr"):
            assert cache.canonical_graph_key(_tgraph(g), s, t, layout) \
                == jcache.canonical_graph_key(g, s, t, layout)
            rj, rt = jbuild(g, layout), build_residual(_tgraph(g), layout)
            mins = tuple(int(x) for x in rng.integers(1, 64, 3))
            got = queueing.bucket_for(rt, *mins)
            want = jqueue.bucket_for(rj, *mins)
            assert tuple(got) == tuple(want) and got.label == want.label


@pytest.mark.parametrize("seed", SEEDS)
def test_result_and_executable_caches_match_jax(seed):
    """One random schedule of put/get/peek and of signature notes through
    both packages' LRUs: every answer, the LRU order and ``stats()``."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 6))
    rc, jrc = cache.ResultCache(cap), jcache.ResultCache(cap)
    ec, jec = cache.ExecutableCache(cap), jcache.ExecutableCache(cap)
    for _ in range(80):
        key = f"g{int(rng.integers(0, 9))}"
        op = rng.integers(0, 3)
        if op == 0:
            rc.put(cache.CacheEntry(key, len(key), None))
            jrc.put(jcache.CacheEntry(key, len(key), None))
        else:
            fn = "get" if op == 1 else "peek"
            got, want = getattr(rc, fn)(key), getattr(jrc, fn)(key)
            assert (got is None) == (want is None)
        assert list(rc._entries) == list(jrc._entries)
        b = int(rng.integers(0, 3))
        sig = (queueing.BucketKey(16 << b, 32, 4), int(rng.integers(1, 3)),
               ["vc", "vc_fused"][int(rng.integers(0, 2))],
               [None, 16][int(rng.integers(0, 2))])
        assert ec.note(sig) == jec.note((jqueue.BucketKey(*sig[0]),
                                         *sig[1:]))
    assert (rc.hits, rc.misses, len(rc)) == (jrc.hits, jrc.misses, len(jrc))
    assert ec.stats() == jec.stats()
    assert json.dumps(ec.stats())


def _request(mod, rng, i, now):
    dl = None if rng.random() < 0.4 else now + float(rng.uniform(-1, 3))
    return mod.Request(graph_id=f"r{i}", residual=None, s=0, t=1,
                       futures=[], enqueued_at=now - float(rng.uniform(0, 2)),
                       deadline_at=dl)


@pytest.mark.parametrize("seed", SEEDS)
def test_microbatch_queue_matches_jax(seed):
    """Pushes, ``ready``, ``shed_expired``, ``pop_batch`` and
    ``padded_batch_size`` at explicit clocks, in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(max_batch=int(rng.integers(1, 9)),
              max_wait_s=float(rng.choice([0.5, 1.5, np.inf])),
              max_queue=int(rng.integers(2, 12)),
              deadline_slack_s=float(rng.uniform(0, 1)))
    q = queueing.MicrobatchQueue(queueing.BucketKey(16, 32, 4), **kw)
    jq = jqueue.MicrobatchQueue(jqueue.BucketKey(16, 32, 4), **kw)
    now = 100.0
    for i in range(60):
        now += float(rng.uniform(0, 0.5))
        op = rng.integers(0, 4)
        if op == 0 and not q.full():
            state = rng.bit_generator.state
            q.push(_request(queueing, rng, i, now))
            rng.bit_generator.state = state
            jq.push(_request(jqueue, rng, i, now))
        elif op == 1:
            assert [r.graph_id for r in q.shed_expired(now)] \
                == [r.graph_id for r in jq.shed_expired(now)]
        elif op == 2 and q.ready(now):
            assert [r.graph_id for r in q.pop_batch()] \
                == [r.graph_id for r in jq.pop_batch()]
        assert q.ready(now) == jq.ready(now)
        assert (q.full(), len(q), q.next_deadline()) \
            == (jq.full(), len(jq), jq.next_deadline())
    for live in range(1, 10):
        for pad in (False, True):
            assert q.padded_batch_size(live, pad) \
                == jq.padded_batch_size(live, pad)


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("seed", SEEDS)
def test_mode_policy_and_ladder_match_jax(seed, layout):
    """``BucketModePolicy`` and ``BucketLadder`` driven by one random
    schedule of ``choose``/``record``/``disqualify``/``pin_now`` and of
    ``note_failure``/``clamp``: equal choices and ``stats()``, and equal
    ``serve.mode_*``/``serve.demotions`` counters."""
    rng = np.random.default_rng(seed)
    cands = candidate_modes(layout)
    assert cands == jpolicy.candidate_modes(layout)
    trials = int(rng.integers(1, 3))
    p = BucketModePolicy(cands, trials=trials, label="b")
    jp = jpolicy.BucketModePolicy(cands, trials=trials, label="b")
    lad = policy.BucketLadder(demote_after=int(rng.integers(1, 3)),
                              label="b")
    jlad = jpolicy.BucketLadder(demote_after=lad.demote_after, label="b")
    for _ in range(40):
        op = rng.integers(0, 10)
        if op < 6:
            m = p.choose()
            assert m == jp.choose()
            secs, cyc = float(rng.uniform(0.1, 2)), int(rng.integers(0, 50))
            p.record(m, secs, cyc)
            jp.record(m, secs, cyc)
        elif op == 6:
            m = str(rng.choice(cands))
            p.disqualify(m)
            jp.disqualify(m)
        elif op == 7 and rng.random() < 0.3:
            p.pin_now()
            jp.pin_now()
        m = str(rng.choice(policy.LADDER[:-1]))
        if rng.random() < 0.5:
            lad.note_failure(m)
            jlad.note_failure(m)
        assert lad.clamp(m) == jlad.clamp(m)
        assert p.stats() == jp.stats() and lad.stats() == jlad.stats()
        assert p.uses_kernels() == jp.uses_kernels()
    for m in policy.LADDER:
        assert policy.ladder_rank(m) == jpolicy.ladder_rank(m)
        assert policy.demote_mode(m) == jpolicy.demote_mode(m)
    assert (policy.LADDER, policy.HOST_REF, policy.CANDIDATE_MODES) \
        == (jpolicy.LADDER, jpolicy.HOST_REF, jpolicy.CANDIDATE_MODES)
    _same_counters(("serve.",))


def _item_tuple(it):
    g = it.graph
    if g is not None and hasattr(g, "lr_edges"):  # a BipartiteProblem
        g = (g.graph.n, g.graph.edges.tolist(), g.graph.cap.tolist(), g.s,
             g.t, g.n_left, g.n_right, g.lr_edges.tolist())
    elif g is not None:
        g = (g.n, g.edges.tolist(), g.cap.tolist())
    return (it.arrival_s, it.kind, g, it.s, it.t, it.repeat_of,
            it.updates, it.deadline_s)


@pytest.mark.parametrize("process", workload.ARRIVAL_PROCESSES)
def test_workload_generator_matches_jax(process):
    assert workload.ARRIVAL_PROCESSES == jwork.ARRIVAL_PROCESSES
    for seed in (0, 3):
        np.testing.assert_array_equal(
            workload.arrival_times(40, 150.0, process, seed=seed),
            jwork.arrival_times(40, 150.0, process, seed=seed))
        kw = dict(rate_hz=150.0, seed=seed, process=process,
                  deadline_s=[None, 2.5][seed % 2], **WORKLOAD)
        items, jitems = (workload.synthesize(30, **kw),
                         jwork.synthesize(30, **kw))
        assert [_item_tuple(x) for x in items] \
            == [_item_tuple(x) for x in jitems]
        for it, jit in zip(items, jitems):
            g, s, t = workload.resolve_item(items, it)
            jg, js, jt = jwork.resolve_item(jitems, jit)
            assert (g.n, g.edges.tolist(), g.cap.tolist(), s, t) \
                == (jg.n, jg.edges.tolist(), jg.cap.tolist(), js, jt)
    with pytest.raises(ValueError, match="unknown arrival process"):
        workload.arrival_times(3, process="nope")


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_plan_matches_jax(seed):
    """One plan of every rate, driven by the same opportunities: the same
    injections raise, and equal handles come out with the same poison."""
    rng = np.random.default_rng(seed)
    kw = dict(seed=seed, dispatch_error_rate=0.3,
              fail_modes=("vc_fused",), fail_mode_rate=0.7,
              fail_mode_limit=int(rng.integers(1, 6)),
              corrupt_handle_rate=0.6)
    plan, jplan = fault.FaultPlan(**kw), jfault.FaultPlan(**kw)
    assert fault.CORRUPTION_KINDS == jfault.CORRUPTION_KINDS
    for i in range(30):
        mode = str(rng.choice(["vc", "vc_fused", "host_ref"]))
        outcome = []
        for p, exc in ((plan, fault.InjectedFault),
                       (jplan, jfault.InjectedFault)):
            try:
                p.before_dispatch(mode, where=f"flush:{i}")
                outcome.append(None)
            except exc as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
        g = random_graph(rng, n_lo=4, n_hi=20)
        rj = jbuild(g, "bcsr")
        rt = build_residual(_tgraph(g), "bcsr")
        res = rng.integers(0, 9, rj.num_arcs).astype(np.int32)
        e = rng.integers(0, 9, rj.n).astype(np.int32)
        h = WarmStartHandle(rt, 0, g.n - 1, res, e, device="cpu")
        jh = JHandle(rj, 0, g.n - 1, res, e)
        assert plan.corrupt_handle(h) == jplan.corrupt_handle(jh)
        np.testing.assert_array_equal(h._res, jh._res)
        np.testing.assert_array_equal(h._e, jh._e)
    assert plan.stats() == jplan.stats()
    with pytest.raises(ValueError):
        fault.FaultPlan(dispatch_error_rate=1.5)


def test_to_jsonable_matches_jax():
    tree = {"a": np.int32(3), "b": np.float64(0.5), "c": np.bool_(True),
            "d": np.arange(4, dtype=np.int32), "e": (1, {2, 3}),
            queueing.BucketKey(16, 32, 4): [np.zeros(2, object)],
            7: jwork.WorkItem(0.1, "repeat"), None: frozenset([1]),
            2.5: complex(1, 2)}
    jtree = dict(tree)
    jtree[jqueue.BucketKey(16, 32, 4)] = jtree.pop(
        queueing.BucketKey(16, 32, 4))
    got, want = to_jsonable(tree), jto_jsonable(jtree)
    assert got == want
    json.dumps(got)
    assert to_jsonable(torch.arange(3, dtype=torch.int32)) == [0, 1, 2]


# -- the corrector hook -------------------------------------------------------

def _preflow(seed):
    """A JAX-solved maximum preflow on a seeded random graph: ``(jax
    residual, port residual, res, e, s, t)``."""
    from repro.core import pushrelabel as jpr
    from repro_torch.core.csr import residual_from_arrays

    g = random_graph(np.random.default_rng(seed), n_lo=8, n_hi=40)
    rj = jbuild(g, "bcsr")
    sol = jpr.solve_impl(rj, 0, g.n - 1)
    return (rj, residual_from_arrays(**dataclasses.asdict(rj)),
            np.asarray(sol.state.res, np.int32),
            np.asarray(sol.state.e, np.int32), 0, g.n - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_corrector_hook_matches_jax(seed):
    """A handle with a corrector calls it exactly once (and not with
    ``reference=True``); ``_install_corrected`` keeps the arrays of an
    already-corrected handle; a handle without one corrects itself as
    the JAX handle does."""
    rj, rt, res, e, s, t = _preflow(seed)
    for reference in (True, False):
        plain = WarmStartHandle(rt, s, t, res, e, device="cpu")
        jplain = JHandle(rj, s, t, res, e)
        got, want = plain.arrays(reference), jplain.arrays(reference)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        assert plain.corrected and plain._corrector is None
    # ``want`` is now the device phase 2's (reference=False) flow

    calls = []

    def corrector():
        calls.append(1)
        h._install_corrected(want[0], want[1])

    h = WarmStartHandle(rt, s, t, res, e, corrector=corrector, device="cpu")
    h.arrays()
    h.arrays()
    assert calls == [1] and h.corrected and h._corrector is None
    np.testing.assert_array_equal(h.arrays()[0], want[0])
    # an already-corrected handle keeps its arrays
    h._install_corrected(np.zeros_like(want[0]), np.zeros_like(want[1]))
    np.testing.assert_array_equal(h.arrays()[0], want[0])
    # reference=True bypasses the hook and runs the host phase 2
    h2 = WarmStartHandle(rt, s, t, res, e, corrector=corrector,
                         device="cpu")
    h2.arrays(reference=True)
    assert calls == [1] and h2.corrected and h2._corrector is None
    # a hook that corrects nothing leaves the handle to correct itself
    h3 = WarmStartHandle(rt, s, t, res, e, corrector=lambda: None,
                         device="cpu")
    np.testing.assert_array_equal(h3.arrays()[0], want[0])


def test_service_runs_on_the_card_by_default(monkeypatch):
    """``ServiceConfig(device=None)`` is the card: without one the service
    raises, as ``resolve_device`` does, and never serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaxflowService(ServiceConfig())
    with pytest.raises(ValueError):
        ServiceConfig(mode="nope")
    assert MaxflowService(ServiceConfig(device="cpu")).device.type == "cpu"


@pytest.mark.parametrize("mode,phase2_kernel,kernel", [
    ("vc", None, False), ("vc_kernel", None, True), ("vc_fused", None, True),
    ("vc", True, True)])
def test_served_handles_take_the_correction_route(monkeypatch, mode,
                                                  phase2_kernel, kernel):
    """Served handles drain (and correct themselves, without the pool) on
    the route of the service's pooled correction: the min search's gather
    entry in a fixed kernel mode or with ``phase2_kernel=True``, else the
    plain path.  The pooled correction packs its group to the group's own
    largest member, and a drained decrease re-solves to Dinic's value."""
    from repro_torch.core.ref_maxflow import dinic_maxflow
    from repro_torch.graphs.generators import washington_rlg
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import TRACER

    calls = []
    gather = kops.tile_min_neighbor_gather
    monkeypatch.setattr(kops, "tile_min_neighbor_gather",
                        lambda *a, **k: calls.append(1) or gather(*a, **k))
    svc = MaxflowService(ServiceConfig(mode=mode, phase2_kernel=phase2_kernel,
                                       device="cpu", **SERVICE))
    insts = [washington_rlg(r, c, seed=r) for r, c in ((5, 6), (7, 4),
                                                       (6, 6))]
    futs = [svc.submit(*x) for x in insts]
    svc.flush()
    handles = [svc.results.peek(f.result().graph_id).handle for f in futs]
    assert [h._use_kernel for h in handles] == [kernel] * 3
    TRACER.clear()
    TRACER.enable()
    try:
        res, _ = handles[0].arrays()
    finally:
        TRACER.disable()
    (ev,) = [e for e in TRACER.to_dict()["traceEvents"]
             if e["name"] == "serve.phase2" and e["ph"] == "B"]
    rs = [h.residual for h in handles]
    assert ev["args"]["batch"] == ev["args"]["group"] == 3
    assert ev["args"]["shape"] == (f"n{max(r.n for r in rs)}"
                                   f"a{max(r.num_arcs for r in rs)}"
                                   f"d{max(r.deg_max for r in rs)}")
    assert all(h.corrected for h in handles)
    g, s, t = insts[0]
    r = rs[0]
    seg = np.arange(r.indptr[s], r.indptr[s + 1])
    a = seg[(r.res0[seg] - res[seg]) > 0][0]  # a flow-carrying source arc
    u, v = int(r.tails[a]), int(r.heads[a])
    calls.clear()
    fut = svc.resubmit(futs[0].result().graph_id, [(u, v, -int(r.res0[a]))])
    assert bool(calls) == kernel
    cap = g.cap.copy()
    cap[(g.edges[:, 0] == u) & (g.edges[:, 1] == v)] = 0
    assert fut.result().maxflow == dinic_maxflow(Graph(g.n, g.edges, cap),
                                                 s, t)
    assert fut.result().warm


# -- the service against the JAX service --------------------------------------

def _counters(registry, prefixes=("serve.", "stream.")):
    snap = registry.snapshot()
    out = {}
    for kind in ("counters", "gauges"):
        for k, v in snap[kind].items():
            if k.startswith(prefixes):
                out[f"{kind}:{k}"] = v
    for k, v in snap["histograms"].items():  # observation counts only
        if k.startswith(prefixes):
            out[f"histograms:{k}"] = v["count"]
    return out


def _same_counters(prefixes=("serve.", "stream.")):
    assert _counters(REGISTRY, prefixes) == _counters(JREGISTRY, prefixes)


def _records(recs):
    out = []
    for r in recs:
        res = r["result"]
        out.append((r["kind"], type(r["error"]).__name__,
                    None if res is None else (
                        res.graph_id, res.maxflow, res.cycles, res.rounds,
                        res.warm, res.cached, res.batch_size, res.version)))
    return out


def _untimed(st, mode=None):
    """``stats()`` without its time fields; ``mode`` renames the port's
    signature mode to JAX ``vc`` (the kernel modes held against it)."""
    st = copy.deepcopy(st)
    for k in ("phase2_time_s", "sweep_time_s"):
        st.pop(k)
    for p in st["mode_policy"].values():
        p.pop("per_cycle_s")
    if mode is not None:
        ex = st["executables"]
        ex["keys"] = [[*k[:2], "vc" if k[2] == mode else k[2], *k[3:]]
                      for k in ex["keys"]]
        ex["dispatches_by_mode"] = {
            ("vc" if m == mode else m): c
            for m, c in ex["dispatches_by_mode"].items()}
    return st


def _drive(service_cls, config_cls, wl, items, **kw):
    svc = service_cls(config_cls(**SERVICE, **kw))
    recs = wl.drive(svc, items)
    return svc, recs


@pytest.fixture(scope="module", params=WORKLOAD_SEEDS)
def jax_served(request):
    """One JAX ``vc`` service driven through ``synthesize(24, seed)``:
    its records, ``stats()`` and counters at the end of the drive, and
    the live service (its handles still uncorrected)."""
    seed = request.param
    JREGISTRY.reset()
    items = jwork.synthesize(24, seed=seed, **WORKLOAD)
    svc, recs = _drive(JService, JConfig, jwork, items, mode="vc")
    return {"seed": seed, "svc": svc, "records": _records(recs),
            "stats": jto_jsonable(_untimed(svc.stats())),
            "counters": _counters(JREGISTRY)}


@pytest.mark.parametrize("mode", PORT_MODES)
def test_service_matches_jax_vc(jax_served, mode):
    """The same workload through the port's service on the CPU: every
    request's result (or error type), ``stats()`` without its times and
    every ``serve.*`` counter equal JAX ``vc``'s."""
    items = workload.synthesize(24, seed=jax_served["seed"], **WORKLOAD)
    svc, recs = _drive(MaxflowService, ServiceConfig, workload, items,
                       mode=mode, device="cpu")
    assert _records(recs) == jax_served["records"]
    assert to_jsonable(_untimed(svc.stats(), mode)) == jax_served["stats"]
    assert _counters(REGISTRY) == jax_served["counters"]
    assert svc.stats()["executables"]["dispatches_by_mode"].keys() == {mode}


@pytest.fixture(scope="module")
def jax_corrected(jax_served):
    """Every cached JAX handle corrected through ``arrays()`` in the result
    cache's order, and the pooled corrections that took."""
    JREGISTRY.reset()
    svc = jax_served["svc"]
    out = {k: tuple(np.array(x) for x in svc.results.peek(k).handle.arrays())
           for k in list(svc.results._entries)}
    return out, JREGISTRY.counter("serve.phase2_corrections").value


@pytest.mark.parametrize("phase2_kernel", [None, True])
def test_pooled_correction_matches_jax(jax_served, jax_corrected,
                                       phase2_kernel):
    """``arrays()`` on every cached handle, in the same order in both
    packages: the pooled corrections' ``res``/``e`` are bit-equal and
    ``serve.phase2_corrections`` counts the same handles; on the plain
    scan selector and on the min-search hook (its plain version here)."""
    want, n_corr = jax_corrected
    items = workload.synthesize(24, seed=jax_served["seed"], **WORKLOAD)
    svc, _ = _drive(MaxflowService, ServiceConfig, workload, items,
                    mode="vc", phase2_kernel=phase2_kernel, device="cpu")
    assert svc.config.resolve_phase2_kernel() == bool(phase2_kernel)
    REGISTRY.reset()
    assert list(svc.results._entries) == list(want)
    for k, (res, e) in want.items():
        h = svc.results.peek(k).handle
        got = h.arrays()
        np.testing.assert_array_equal(got[0], res)
        np.testing.assert_array_equal(got[1], e)
        h.validate()
    assert REGISTRY.counter("serve.phase2_corrections").value == n_corr > 0


def test_launcher_serves_and_passes_the_smoke_gates(tmp_path, capsys):
    """``serve_maxflow.main`` on the CPU with ``--verify``: every served
    value equals a sequential solve, and the snapshot and trace it writes
    pass ``check_smoke`` (with a fixed overhead: the launcher's own
    wall-clock gate is not run here)."""
    trace, snap_path = tmp_path / "trace.json", tmp_path / "snap.json"
    svc, records = serve_maxflow.main(
        ["--device", "cpu", "--mode", "vc", "--verify", "--requests", "16",
         "--trace-out", str(trace), "--metrics-out", str(snap_path)])
    out = capsys.readouterr().out
    assert "verified all 16 served values" in out
    assert len(records) == 16 and svc.device.type == "cpu"
    snap = json.loads(snap_path.read_text())
    assert snap["stats"]["solved"] > 0
    serve_maxflow.check_smoke(snap, str(trace), {
        "overhead": 0.0, "telemetry_on_s": 1.0, "telemetry_off_s": 1.0},
        auto_mode=False)
    with pytest.raises(AssertionError, match="telemetry overhead"):
        serve_maxflow.check_smoke(snap, str(trace), {
            "overhead": 0.2, "telemetry_on_s": 1.2, "telemetry_off_s": 1.0},
            auto_mode=False)
    with pytest.raises(AssertionError, match="mode-policy"):
        serve_maxflow.check_artifacts(snap, str(trace), auto_mode=True)
