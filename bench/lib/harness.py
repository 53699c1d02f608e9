"""One run of one cell: set-up, the measured window, the check, the result.

Set-up builds (or loads from the checkout's cache) the program's kernels,
draws the inputs from the seed and serves the traffic's warm-up requests
on them.  A traced run then serves one request under ``torch.profiler``.
The window serves whole requests, one after the other, until ``seconds``
have passed; each request ends in a synchronize after the host has read
its answers.  The time metric is the window's length over its requests.
Once the window has closed and the memory peak has been read, the
reference judges every answer that was kept.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback

from bench.lib import devtrace, request, spec
from bench.lib.request import Spans

GIB = 2**30


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cell: str
    records: list  # one dict per window request: wall, spans, counters
    program_spans: devtrace.ProgramSpans | None  # the program's, traced runs
    trace: devtrace.TraceResult | None  # the profiled request's trace


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, quick: bool = False) -> dict:
    """One run; returns the result's fields (``checks`` last)."""
    import torch

    on_card = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    if quick:  # the CPU rehearsal: the cell's code at a tiny size
        config = _merge(config, config.get("quick"))
        traffic = _merge(traffic, traffic.get("quick"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        from repro_torch.kernels import build

        build.build_all()
    driver = request.load(traffic["kind"]).Driver(config, traffic, seed,
                                                  device)
    warm = int(traffic["warmup"])
    failed = 0
    try:
        for i in range(warm):
            driver.request(i, Spans())
        sync()
    except Exception:
        traceback.print_exc()
        failed = 1
    setup_s = time.perf_counter() - t_start

    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    readers = {m["name"]: spec.load_metric(m["name"])
               for m in cell.per_layer} if trace else {}
    tracer = devtrace.DeviceTrace(device, readers) if trace else None
    program_spans = devtrace.ProgramSpans() if trace else None
    i = warm
    if tracer and not failed:
        # a traced run's device readings: one more request, under the
        # profiler, before the window (so that the profiler's teardown,
        # seconds long, stays out of it)
        try:
            with tracer:
                driver.request(i, Spans())
                sync()
        except Exception:
            traceback.print_exc()
            failed = 1
        i += 1
    records = []
    w0 = time.perf_counter()
    while not failed:
        spans = Spans()
        r0 = time.perf_counter()
        try:
            with program_spans or contextlib.nullcontext():
                counters = driver.request(i, spans)
                sync()
        except Exception:
            traceback.print_exc()
            failed += 1
            break
        records.append({"wall": time.perf_counter() - r0,
                        "spans": spans.seconds, **counters})
        i += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0

    t_read = time.perf_counter()
    ctx = Context(cell.name, records, program_spans,
                  tracer.result() if tracer and not failed else None)
    t_check = time.perf_counter()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if quick and m["source"] != "program_counter":
            continue  # no time or device reading from a CPU run
        if not trace:
            value = {"setup_s": setup_s,
                     "peak_mem_gib": peak_window / GIB,
                     traffic["request_metric"]:
                         window_s / max(1, len(records))}.get(m["name"])
        else:
            value = readers[m["name"]].read(ctx)
        if value is not None and records:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    try:
        checks = driver.check()
    except Exception:  # an answer the reference cannot even read
        traceback.print_exc()
        checks = {"unreadable_answer": 1}
    print(f"phases: setup {setup_s:.1f} s, window {window_s:.1f} s, trace "
          f"read {t_check - t_read:.1f} s, check "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = (failed == 0 and bool(records)
               and all(v <= 0 for v in checks.values()))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": cell.chips if on_card else 1,
           "memory_peak_bytes": max(peak_setup, peak_window)}
    out = {"correct": correct, "attempted": len(records) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if ctx.trace and on_card:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return out
