"""Max-flow serving launcher: drive a synthetic Poisson workload through
``MaxflowService`` (port of ``python -m repro.launch.serve_maxflow``; it
serves on the CUDA card unless ``--device cpu`` asks for the CPU).

``python -m repro_torch.launch.serve_maxflow --requests 64 --max-batch 8``
``python -m repro_torch.launch.serve_maxflow --device cpu --verify``

Mixes fresh max-flow and bipartite-matching queries with exact repeats
(result-cache hits) and capacity-edit resubmits (warm-started re-solves),
then prints throughput, latency percentiles and service counters.  Use
``--verify`` to cross-check every served value against the sequential
solver (``repro_torch.api.Solver`` on the same device).

Observability surfaces:

* ``--trace-out trace.json`` — enable the span tracer for the drive and
  export Chrome ``trace_event`` JSON (open in chrome://tracing or
  https://ui.perfetto.dev): per-request lifecycle events plus the
  nested flush -> solve -> phase-2 span tree.
* ``--metrics-out snap.json`` — write ``telemetry_snapshot()``: service
  ``stats()`` (incl. per-bucket device push/relabel counters) plus the
  full metrics registry.
* ``--smoke`` — small workload + acceptance gates: nonzero per-bucket
  push/relabel counters, live cache and mode-policy counters, a valid
  trace, and telemetry overhead <= 5% of the telemetry-off wall.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure_telemetry_overhead(items, cfg_kwargs: dict,
                               repeats: int = 3) -> dict:
    """Best-of-N wall clock of the same workload on fresh services with
    device-counter telemetry on vs off (each config warmed once first so
    neither timed pass pays a signature's first dispatch)."""
    from repro_torch.serving import MaxflowService, ServiceConfig
    from repro_torch.serving.workload import drive

    def best(telemetry: bool) -> float:
        cfg = ServiceConfig(telemetry=telemetry, **cfg_kwargs)
        drive(MaxflowService(cfg), items)  # compile warmup
        walls = []
        for _ in range(repeats):
            svc = MaxflowService(cfg)
            t0 = time.perf_counter()
            drive(svc, items)
            walls.append(time.perf_counter() - t0)
        return min(walls)

    on, off = best(True), best(False)
    return {"telemetry_on_s": on, "telemetry_off_s": off,
            "overhead": on / off - 1.0 if off else 0.0}


def check_smoke(snap: dict, trace_path: str | None, overhead: dict,
                auto_mode: bool) -> None:
    """The --smoke acceptance gates, asserted after every artifact is
    written so a failed gate still leaves the data on disk: the
    artifacts' (:func:`check_artifacts`) and telemetry overhead <= 5%."""
    check_artifacts(snap, trace_path, auto_mode)
    assert overhead["overhead"] <= 0.05, \
        (f"telemetry overhead {100 * overhead['overhead']:.1f}% > 5% "
         f"(on {overhead['telemetry_on_s']:.3f}s vs off "
         f"{overhead['telemetry_off_s']:.3f}s)")
    print(f"SMOKE PASS: counters live, trace valid, telemetry overhead "
          f"{100 * max(overhead['overhead'], 0.0):.1f}% <= 5%")


def check_artifacts(snap: dict, trace_path: str | None,
                    auto_mode: bool) -> None:
    """The gates of --smoke on what a run wrote: nonzero per-bucket
    push/relabel counters, live cache and mode-policy counters in the
    registry, and a balanced trace with request lifecycle events."""
    st = snap["stats"]
    bcs = st["bucket_counters"]
    assert bcs, "no per-bucket device counters recorded"
    for bucket, bc in bcs.items():
        # a near-trivial bucket can converge without a single relabel,
        # but every flushed bucket must have counted SOME work
        assert bc.get("pushes", 0) + bc.get("relabels", 0) > 0, \
            f"dead device counters for bucket {bucket}: {bc}"
    assert sum(bc.get("pushes", 0) for bc in bcs.values()) > 0 \
        and sum(bc.get("relabels", 0) for bc in bcs.values()) > 0, \
        f"zero aggregate push/relabel counts: {bcs}"
    rc = st["result_cache"]
    assert rc["hits"] + rc["misses"] > 0, "result cache never consulted"
    counters = snap["metrics"]["counters"]
    assert any(k.startswith("serve.pushes{") for k in counters), \
        "registry missing serve.pushes counters"
    assert any(k.startswith("serve.result_cache.") for k in counters), \
        "registry missing cache counters"
    if auto_mode:
        assert any(k.startswith("serve.mode_trials{") for k in counters), \
            "registry missing mode-policy trial counters"
    if trace_path is not None:
        with open(trace_path) as f:
            trace = json.load(f)
        evs = trace["traceEvents"]
        assert evs, "empty trace"
        phs = [e["ph"] for e in evs]
        assert phs.count("B") == phs.count("E"), \
            f"unbalanced span events: {phs.count('B')}B/{phs.count('E')}E"
        assert any(e["ph"] == "X" and e["name"] == "serve.request"
                   for e in evs), "no request lifecycle events in trace"


def main(argv=None):
    """Run the launcher; returns ``(service, records)`` — the driven
    ``MaxflowService`` and ``workload.drive``'s one record per item."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate (Hz) of the synthetic trace")
    ap.add_argument("--process", default="poisson",
                    choices=["poisson", "bursty", "diurnal", "flood"],
                    help="arrival shape of the synthetic trace")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound each bucket's queue; admission past it "
                         "rejects with a typed Overloaded")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="attach this relative deadline to every request; "
                         "expired work is shed, never solved")
    ap.add_argument("--poll-every", type=int, default=1,
                    help="poll the service every N admissions (N>1 lets "
                         "queue depth build, exercising admission control)")
    ap.add_argument("--chaos", action="store_true",
                    help="inject faults (repro_torch.runtime.fault."
                         "FaultPlan): "
                         "transient dispatch errors + cached-handle "
                         "corruption, rates below")
    ap.add_argument("--chaos-dispatch-rate", type=float, default=0.1)
    ap.add_argument("--chaos-corrupt-rate", type=float, default=0.25)
    ap.add_argument("--chaos-fail-modes", default="",
                    help="comma-separated solver modes that always fail "
                         "(forces the degradation ladder)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="flush a bucket once its oldest request has waited "
                         "this long (default: only on full batch / drain)")
    from repro_torch.core.pushrelabel import ALL_MODES

    ap.add_argument("--mode", default="auto",
                    choices=["auto"] + list(ALL_MODES),
                    help="'auto' = measured per-bucket policy; a fixed "
                         "mode pins every bucket")
    ap.add_argument("--layout", default="bcsr", choices=["bcsr", "rcsr"])
    ap.add_argument("--cycle-chunk", type=int, default=16)
    ap.add_argument("--matching-frac", type=float, default=0.3)
    ap.add_argument("--repeat-frac", type=float, default=0.15)
    ap.add_argument("--resubmit-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing; export Chrome trace_event "
                         "JSON here (Perfetto-loadable)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write telemetry_snapshot() JSON here")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip the device-side workload counters")
    ap.add_argument("--smoke", action="store_true",
                    help="small workload + telemetry acceptance gates")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.obs import TRACER, to_jsonable
    from repro_torch.serving import MaxflowService, ServiceConfig
    from repro_torch.serving.workload import drive, synthesize

    if args.smoke:
        args.requests = min(args.requests, 48)
    items = synthesize(args.requests, rate_hz=args.rate, seed=args.seed,
                       matching_frac=args.matching_frac,
                       repeat_frac=args.repeat_frac,
                       resubmit_frac=args.resubmit_frac,
                       process=args.process,
                       deadline_s=(args.deadline_ms / 1e3
                                   if args.deadline_ms is not None
                                   else None))
    cfg_kwargs = dict(
        mode=args.mode, layout=args.layout, max_batch=args.max_batch,
        cycle_chunk=args.cycle_chunk,
        max_queue=args.max_queue, device=args.device,
        max_wait_s=(args.max_wait_ms / 1e3 if args.max_wait_ms is not None
                    else float("inf")))
    cfg = ServiceConfig(telemetry=not args.no_telemetry, **cfg_kwargs)
    faults = None
    if args.chaos:
        from repro_torch.runtime.fault import FaultPlan
        faults = FaultPlan(
            seed=args.chaos_seed,
            dispatch_error_rate=args.chaos_dispatch_rate,
            corrupt_handle_rate=args.chaos_corrupt_rate,
            fail_modes=tuple(m for m in args.chaos_fail_modes.split(",")
                             if m))
    if args.trace_out is not None:
        TRACER.enable()
    svc = MaxflowService(cfg, faults=faults)
    t0 = time.perf_counter()
    records = drive(svc, items, poll_every=args.poll_every)
    wall = time.perf_counter() - t0

    ok = [r for r in records if r["error"] is None]
    errs = [r for r in records if r["error"] is not None]
    lat_ms = 1e3 * np.array([r["latency_s"] for r in ok] or [0.0])
    warm = [r for r in ok if r["result"].warm]
    cached = [r for r in ok if r["result"].cached]
    print(f"served {len(ok)}/{len(records)} requests in {wall:.2f}s "
          f"({len(ok) / wall:.2f} req/s)")
    print(f"latency p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms")
    print(f"warm re-solves: {len(warm)}  cache hits: {len(cached)}")
    if errs:
        kinds: dict[str, int] = {}
        for r in errs:
            kinds[type(r["error"]).__name__] = \
                kinds.get(type(r["error"]).__name__, 0) + 1
        print("rejected/expired: "
              + " ".join(f"{k}={v}" for k, v in sorted(kinds.items())))
    st = svc.stats()
    print(f"buckets={st['buckets']} batches={st['batches']} "
          f"executables={st['executables']['compiles']} "
          f"coalesced={st['coalesced']} gr_sweeps={st['gr_sweeps']}")
    rb = st["robustness"]
    print(f"robustness: rejected={rb['rejected']} shed={rb['shed']} "
          f"retries={rb['retries']} demotions={rb['sticky_demotions']} "
          f"host_fallbacks={rb['host_fallbacks']} "
          f"quarantined={rb['quarantined']}")
    if rb["faults_injected"]:
        print("faults injected: "
              + json.dumps(rb["faults_injected"], sort_keys=True))
    for bucket, entry in sorted(st["mode_policy"].items()):
        print(f"  {bucket}: mode={entry['pinned'] or 'measuring'} "
              f"({entry['flushes']} flushes)")
    # per-bucket device workload counters, JSON-rendered via the one
    # canonical converter (the same path telemetry_snapshot uses)
    print("device counters: "
          + json.dumps(to_jsonable(st["bucket_counters"]), sort_keys=True))

    if args.trace_out is not None:
        TRACER.export(args.trace_out)
        print(f"wrote {args.trace_out} ({len(TRACER)} events; open in "
              "chrome://tracing or ui.perfetto.dev)")
        TRACER.disable()
    snap = svc.telemetry_snapshot()
    if args.metrics_out is not None:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        print(f"wrote {args.metrics_out}")

    if args.verify:
        from repro_torch.api import MaxflowProblem, Solver, SolverOptions
        from repro_torch.serving.workload import resolve_item
        solver = Solver(SolverOptions(layout=args.layout,
                                      device=args.device))
        checked = 0
        for item, rec in zip(items, records):
            if rec["error"] is not None:  # rejected/shed: typed, no value
                continue
            g, s, t = resolve_item(items, item)
            want = solver.solve(MaxflowProblem(g, s, t)).value
            assert rec["result"].maxflow == want, \
                (item.kind, rec["result"].maxflow, want)
            checked += 1
        print(f"verified all {checked} served values against "
              f"sequential solves")

    if args.smoke:  # gate AFTER every artifact exists
        overhead = measure_telemetry_overhead(items, cfg_kwargs)
        check_smoke(snap, args.trace_out, overhead,
                    auto_mode=args.mode == "auto")
    return svc, records


if __name__ == "__main__":
    main()
