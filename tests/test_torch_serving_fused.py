"""The port's service in ``vc_fused`` and under the ``auto`` mode policy,
against the JAX package's, on the same seeded workloads.

``vc_fused`` is bit-equal to ``vc`` per launch, but its batched loop
looks at whole launches of K = 8 cycles for its exit, so a row may run
more cycles than in ``vc``: its values are held against JAX ``vc``, and
its cycles, rounds, ``stats()`` and counters against the JAX
``vc_fused`` service, whose Pallas kernel does not run on the installed
jax and is emulated in jnp (``test_torch_discharge.jax_kernels_emulated``).
The port's kernel hooks take their plain versions on the CPU.
Tolerance: exact equality."""
import numpy as np
import pytest

from repro.graphs import generators as jgen
from repro.obs import REGISTRY as JREGISTRY
from repro.obs import to_jsonable as jto_jsonable
from repro.serving import MaxflowService as JService
from repro.serving import ServiceConfig as JConfig
from repro.serving import workload as jwork
from repro_torch.core.csr import Graph
from repro_torch.obs import REGISTRY, to_jsonable
from repro_torch.serving import MaxflowService, ServiceConfig
from repro_torch.serving import workload
from tests.test_torch_discharge import jax_kernels_emulated
from tests.test_torch_serving import one_torch_thread  # noqa: F401
from tests.test_torch_serving import (SERVICE, WORKLOAD, WORKLOAD_SEEDS,
                                      _counters, _records, _untimed)

#: the auto policy's workload: one shape class, so one bucket takes
#: its four trial flushes and one pinned flush
POLICY_INSTANCES = 20


@pytest.fixture(autouse=True)
def _fresh_registries():
    JREGISTRY.reset()
    REGISTRY.reset()
    yield


def _served(svc_cls, cfg_cls, wl, items, registry, **kw):
    svc = svc_cls(cfg_cls(**SERVICE, **kw))
    recs = wl.drive(svc, items)
    return svc, _records(recs), _counters(registry)


@pytest.fixture(scope="module", params=WORKLOAD_SEEDS)
def jax_fused(request):
    """The JAX ``vc`` service and the JAX ``vc_fused`` service (emulated
    kernel) driven through ``synthesize(24, seed)``."""
    items = jwork.synthesize(24, seed=request.param, **WORKLOAD)
    JREGISTRY.reset()
    _, vc, _ = _served(JService, JConfig, jwork, items, JREGISTRY, mode="vc")
    JREGISTRY.reset()
    with pytest.MonkeyPatch.context() as mp, jax_kernels_emulated(mp):
        svc, fused, counters = _served(JService, JConfig, jwork, items,
                                       JREGISTRY, mode="vc_fused")
    return {"seed": request.param, "vc": vc, "fused": fused,
            "stats": jto_jsonable(_untimed(svc.stats())),
            "counters": counters}


def test_fused_service_matches_jax(jax_fused):
    """Every request's value and flags equal JAX ``vc``'s; its cycles and
    rounds, ``stats()`` without times and counters equal the JAX
    ``vc_fused`` service's."""
    items = workload.synthesize(24, seed=jax_fused["seed"], **WORKLOAD)
    svc, recs, counters = _served(MaxflowService, ServiceConfig, workload,
                                  items, REGISTRY, mode="vc_fused",
                                  device="cpu")
    assert svc.config.resolve_phase2_kernel()

    def values(rs):  # everything but cycles and rounds
        return [(k, e, r and (*r[:2], *r[4:])) for k, e, r in rs]

    assert values(recs) == values(jax_fused["vc"])
    assert recs == jax_fused["fused"]
    assert to_jsonable(_untimed(svc.stats())) == jax_fused["stats"]
    assert counters == jax_fused["counters"]


def _policy_instances(gen):
    return [gen.washington_rlg(16, 16, seed=i)
            for i in range(POLICY_INSTANCES)]


@pytest.fixture(scope="module")
def jax_policy_values():
    svc = JService(JConfig(mode="vc", **SERVICE))
    futs = [svc.submit(*x) for x in _policy_instances(jgen)]
    svc.flush()
    return [f.result().maxflow for f in futs]


def _port_instances():
    from repro_torch.graphs import generators as tgen

    return _policy_instances(tgen)


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_auto_policy_trials_then_pins_the_fastest(jax_policy_values,
                                                  layout):
    """``mode="auto"`` on the CPU: one bucket trials every candidate
    (``vc_kernel_bsearch`` only under ``bcsr``), each on a warm
    re-dispatch of its first signature, pins the measured minimum per
    cycle, and serves the values of JAX ``vc``."""
    svc = MaxflowService(ServiceConfig(mode="auto", layout=layout,
                                       device="cpu", **SERVICE))
    futs = [svc.submit(*x) for x in _port_instances()]
    svc.flush()
    assert [f.result().maxflow for f in futs] == jax_policy_values
    st = svc.stats()
    (pol,) = st["mode_policy"].values()
    cands = ["vc", "vc_kernel", "vc_fused"] + (
        ["vc_kernel_bsearch"] if layout == "bcsr" else [])
    assert pol["candidates"] == cands
    assert set(pol["per_cycle_s"]) == set(cands)
    assert pol["pinned"] == min(pol["per_cycle_s"],
                                key=pol["per_cycle_s"].get)
    flushes = POLICY_INSTANCES // SERVICE["max_batch"]
    assert pol["flushes"] == flushes and st["batches"] == flushes
    # each trial dispatched twice (its first signature re-run warm), the
    # pinned mode once more a later flush
    by_mode = st["executables"]["dispatches_by_mode"]
    later = flushes - len(cands)
    assert by_mode == {m: 2 + later * (m == pol["pinned"]) for m in cands}
    assert not any(v for k, v in st["robustness"].items()
                   if k not in ("ladders", "faults_injected"))


def test_pin_modes_ends_the_trials():
    """``pin_modes()`` mid-trial pins the best mode measured so far (and
    ``vc`` for a bucket with no sample); later flushes run the pin."""
    svc = MaxflowService(ServiceConfig(mode="auto", device="cpu",
                                       **SERVICE))
    insts = _port_instances()
    for x in insts[:8]:
        svc.submit(*x)
    svc.flush()  # two trials: vc, vc_kernel
    (label,) = svc.stats()["mode_policy"]
    pol = svc.stats()["mode_policy"][label]
    best = min(pol["per_cycle_s"], key=pol["per_cycle_s"].get)
    assert svc.pin_modes() == {label: best}
    for x in insts[8:12]:
        svc.submit(*x)
    svc.flush()
    by_mode = svc.stats()["executables"]["dispatches_by_mode"]
    assert by_mode.get(best) == 3 and "vc_fused" not in by_mode
    g = Graph(4, np.array([[0, 1], [1, 3]]), np.array([2, 3]))
    fresh = MaxflowService(ServiceConfig(mode="auto", device="cpu"))
    fresh.submit(g, 0, 3)  # queued, never flushed: no policy yet
    assert fresh.pin_modes() == {}
