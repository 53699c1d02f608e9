"""The port's service against the JAX package's on streams, chaos and
overload: ``open_stream`` and waves of ``stream_apply_many`` (pooled
drains, structural rebuilds, no-op applies), a seeded ``FaultPlan`` of
dispatch errors and handle corruptions (retries, the ladder down to the
host's Dinic, quarantines), bounded queues under a flood, and deadlines
at admission or far away (wall-clock expiry in between is not
deterministic).  Both packages run ``vc`` on the CPU with no retry
sleeps.  Every result, every error's type (and an ``Overloaded``'s
bucket, depth and limit), ``stats()`` without its times and the
``serve.*``/``stream.*`` counters must be equal."""
import pytest

from repro.errors import Overloaded as JOverloaded
from repro.graphs import generators as jgen
from repro.obs import REGISTRY as JREGISTRY
from repro.obs import to_jsonable as jto_jsonable
from repro.runtime.fault import FaultPlan as JFaultPlan
from repro.serving import MaxflowService as JService
from repro.serving import ServiceConfig as JConfig
from repro.serving import workload as jwork
from repro_torch.errors import Overloaded
from repro_torch.graphs import generators as tgen
from repro_torch.obs import REGISTRY, to_jsonable
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serving import MaxflowService, ServiceConfig
from repro_torch.serving import workload
from tests.test_torch_serving import one_torch_thread  # noqa: F401
from tests.test_torch_serving import (SERVICE, WORKLOAD, _counters,
                                      _records, _untimed)

#: streams: graphs (grid_road(10, 10), seeds 0..2); the first wave an
#: adversarial batch (flow-carrying source arcs zeroed: drains), the
#: second a mixed one (new arc pairs: structural rebuilds)
STREAMS = 3
WAVES = (dict(adversarial=True), dict(p_insert=0.5, p_delete=0.2))


@pytest.fixture(autouse=True)
def _fresh_registries():
    JREGISTRY.reset()
    REGISTRY.reset()
    yield


PORT = dict(svc=MaxflowService, cfg=ServiceConfig, wl=workload, gen=tgen,
            plan=FaultPlan, overloaded=Overloaded, reg=REGISTRY,
            jsonable=to_jsonable, kw={"device": "cpu"})
JAX = dict(svc=JService, cfg=JConfig, wl=jwork, gen=jgen, plan=JFaultPlan,
           overloaded=JOverloaded, reg=JREGISTRY, jsonable=jto_jsonable,
           kw={})


def _service(pkg, faults=None, **kw):
    cfg = pkg["cfg"](mode="vc", retry_base_s=0.0, **SERVICE, **kw,
                     **pkg["kw"])
    return pkg["svc"](cfg, faults=faults)


def _outcome(pkg, svc, recs):
    """Records (with an ``Overloaded``'s fields), ``stats()`` without its
    times and the counters."""
    over = [(e.bucket, e.depth, e.limit) if isinstance(
        e := r["error"], pkg["overloaded"]) else None for r in recs]
    return (_records(recs), over, pkg["jsonable"](_untimed(svc.stats())),
            _counters(pkg["reg"]))


def _streams(pkg):
    """Open 3 streams, apply two waves of ``update_trace`` batches (one
    ``stream_apply_many`` each), query, pin, close: every result."""
    gen = pkg["gen"]
    svc = _service(pkg)
    graphs = [gen.grid_road(10, 10, seed=i) for i in range(STREAMS)]
    sids = [svc.open_stream(g, s, t, max_versions=2) for g, s, t in graphs]
    traces = [[gen.update_trace(g, s, t, n_batches=1, batch_size=4, seed=i,
                                **kw)[0] for kw in WAVES]
              for i, (g, s, t) in enumerate(graphs)]
    out = []
    for wave in range(len(WAVES)):
        futs = svc.stream_apply_many(
            [(sid, tr[wave]) for sid, tr in zip(sids, traces)])
        out.append(_records([{"kind": "apply", "error": None,
                              "result": f.result()} for f in futs]))
    svc.stream_pin(sids[0], 1)
    one = svc.stream_apply(sids[0], traces[0][0]).result()
    out.append(_records([{"kind": "apply", "error": None, "result": one}]))
    queries = [svc.stream_query(sid) for sid in sids]
    queries.append(svc.stream_query(sids[0], 1))
    out.append([(q.graph_id, q.maxflow, q.warm, q.version) for q in queries])
    with pytest.raises(KeyError):
        svc.stream_query(sids[1], 0)  # evicted from a 2-version chain
    svc.stream_unpin(sids[0], 1)
    out.append(pkg["jsonable"](_untimed(svc.stats())))
    out.append([svc.close_stream(sid) for sid in sids])
    out.append(_counters(pkg["reg"]))
    return out


def test_streams_match_jax():
    """Versions, values, cycles, no-op applies, rebuilds, chain stats and
    counters of three streams through two pooled waves, in both."""
    want = _streams(JAX)
    REGISTRY.reset()
    got = _streams(PORT)
    assert got == want
    closes = got[-2]
    assert sum(c["rebuilds"] for c in closes) > 0
    assert got[-1]["counters:stream.reroute.batched_dispatches"] > 0
    assert got[-1]["counters:stream.reroute.overflow_units"] > 0


#: chaos plans: transient errors and corruptions, and every rung of the
#: ladder failing for the first flushes (typed ``DispatchFailed``)
CHAOS = [dict(dispatch_error_rate=0.3, corrupt_handle_rate=0.5)] * 3 + [
    dict(fail_modes=("vc", "host_ref"), fail_mode_limit=9,
         corrupt_handle_rate=0.2)]


def _chaos(pkg, seed, plan_kw):
    svc = _service(pkg, faults=pkg["plan"](seed=seed, **plan_kw))
    items = pkg["wl"].synthesize(24, seed=seed, **WORKLOAD)
    return _outcome(pkg, svc, pkg["wl"].drive(svc, items))


@pytest.mark.parametrize("seed", range(len(CHAOS)))
def test_chaos_matches_jax(seed):
    """A seeded ``FaultPlan``: the same retries, demotions to the host's
    Dinic, quarantines and typed failures, the same answers."""
    want = _chaos(JAX, seed, CHAOS[seed])
    REGISTRY.reset()
    got = _chaos(PORT, seed, CHAOS[seed])
    assert got == want
    rb = got[2]["robustness"]
    fi = rb["faults_injected"]
    assert fi["dispatch_errors"] + fi["mode_failures"] > 0
    assert rb["retries"] > 0 and fi["corruptions"] > 0
    if "fail_modes" in CHAOS[seed]:
        assert rb["dispatch_failed"] > 0


def _overload(pkg, seed, deadline_s, max_queue):
    svc = _service(pkg, max_queue=max_queue)
    items = pkg["wl"].synthesize(32, seed=seed, process="flood",
                                 deadline_s=deadline_s, **WORKLOAD)
    return _outcome(pkg, svc, pkg["wl"].drive(svc, items, poll_every=4))


@pytest.mark.parametrize("deadline_s,max_queue",
                         [(None, 2), (1e6, 3), (0.0, 2), (-1.0, None)])
def test_overload_and_deadlines_match_jax(deadline_s, max_queue):
    """A flood polled every 4 admissions into bounded queues: the
    ``Overloaded`` rejections come at the same requests with the same
    depth and limit; a deadline far away changes nothing; a deadline
    already spent rejects every request at admission."""
    want = _overload(JAX, 0, deadline_s, max_queue)
    REGISTRY.reset()
    got = _overload(PORT, 0, deadline_s, max_queue)
    assert got == want
    rb = got[2]["robustness"]
    if deadline_s is not None and deadline_s <= 0:
        assert rb["expired_at_admission"] == 32
        assert {e for _, e, _ in got[0]} == {"DeadlineExceeded"}
    else:
        assert rb["rejected"] > 0 and rb["shed"] == 0
        assert any(o is not None for o in got[1])
