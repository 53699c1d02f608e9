"""The traced run's readings: one request under ``torch.profiler``, before
the window, and the program's own spans over the window.

The profiler records device activity only (no host operations), which
costs the host a fraction of what recording its operations would; and
the harness adds no device operation of its own to that request.  ``torch.profiler`` lists the port's CUDA
kernels, which are built with ``nvcc`` and launched through ``ctypes``,
among the device events of its trace, under their device symbols
(``fused_discharge_kernel``, ``dense_kernel<KeyGather>``,
``avq_kernel<KeyGather, true>``).  So every device time here comes from
that trace: a kernel's by its symbol, the device's busy time as the
union of all its device intervals.

A per-layer metric's own file says which kernel it reads
(``bench/metrics/<metric>.py``):

* ``SYMBOL``: the parts of the kernel's device symbol, each of which the
  trace's name holds; the kernel's device time and launches are summed
  from the trace.
* ``ENTRY`` (``"module:attribute"``) and ``bytes_of(*args, **kwargs)``:
  the program's entry that launches the kernel, wrapped for the traced
  request, and the bytes one call moves at the least, from its
  arguments' shapes alone (``None`` where a call does not launch this
  kernel).  The wrapper does arithmetic on the host and nothing else.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import time


@dataclasses.dataclass
class KernelReading:
    calls: int = 0  # the wrapped entry's calls that launch the kernel
    bytes: float = 0.0  # their bytes, by the metric's ``bytes_of``
    launches: int = 0  # the kernel's device events in the trace
    seconds: float = 0.0  # and their device time


@dataclasses.dataclass
class TraceResult:
    device_kind: str
    window_s: float  # the traced request's host wall time
    busy_s: float  # union of device intervals inside it
    kernels: dict  # metric name -> KernelReading
    top_ops: list  # [(name, device seconds)]
    gaps: list  # [(the device operation before the gap, idle seconds)]

    def breakdown(self) -> dict:
        return {"device_ops": [list(x) for x in self.top_ops[:10]],
                "idle_gaps": [list(x) for x in self.gaps[:10]]}


class ProgramSpans:
    """Turns the program's tracer (``repro_torch.obs.TRACER``) on over
    each stretch it is entered for, and sums its spans by name across
    them."""

    def __init__(self):
        self.seconds: dict[str, list] = {}
        self.stretches = 0

    def __enter__(self):
        from repro_torch.obs import TRACER

        TRACER.clear()
        TRACER.enable()
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import TRACER

        TRACER.disable()
        self.stretches += 1
        open_: dict = {}
        for ev in TRACER.to_dict()["traceEvents"]:
            key = (ev["tid"], ev["name"])
            if ev["ph"] == "B":
                open_.setdefault(key, []).append(ev["ts"])
            elif ev["ph"] == "E" and open_.get(key):
                self.seconds.setdefault(ev["name"], []).append(
                    (ev["ts"] - open_[key].pop()) / 1e6)
        TRACER.clear()
        return False


def _short(name: str) -> str:
    """A device symbol without its namespaces' noise and its argument
    list, at most 100 letters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:100]


class DeviceTrace:
    """Context manager around one request: the profiler's device trace,
    and the calls and bytes of the entries the metrics name.

    ``metrics`` maps a per-layer metric's name to its module; those that
    declare a ``SYMBOL`` are read here."""

    def __init__(self, device, metrics: dict):
        import torch

        self.torch = torch
        self.device = device
        self.on_card = device.type == "cuda"
        self.kind = (torch.cuda.get_device_name(device) if self.on_card
                     else "cpu")
        self.metrics = {name: mod for name, mod in metrics.items()
                        if hasattr(mod, "SYMBOL")}
        self.readings = {name: KernelReading() for name in self.metrics}
        self._saved: list = []

    def _wrap(self):
        for name, mod in self.metrics.items():
            if not hasattr(mod, "ENTRY"):
                continue
            where, attr = mod.ENTRY.split(":")
            owner = importlib.import_module(where)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._counted(fn, mod.bytes_of,
                                               self.readings[name]))

    @staticmethod
    def _counted(fn, bytes_of, reading: KernelReading):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            b = bytes_of(*args, **kwargs)
            if b is not None:
                reading.calls += 1
                reading.bytes += b
            return out
        return call

    def _unwrap(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._wrap()
        self._prof = profile(activities=[ProfilerActivity.CUDA]
                             if self.on_card else [ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self.torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self._unwrap()
        return False

    def result(self) -> TraceResult:
        dev = sorted(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
            for ev in self._prof.profiler.kineto_results.events()
            if "CUDA" in str(ev.device_type()))
        busy, gaps, end, before = 0, [], None, "nothing"
        by_name: dict[str, float] = {}
        for a, b, name in dev:
            short = _short(name)
            by_name[short] = by_name.get(short, 0) + (b - a)
            for key, mod in self.metrics.items():
                if all(p in name for p in mod.SYMBOL):
                    self.readings[key].launches += 1
                    self.readings[key].seconds += (b - a) / 1e9
            if end is None or a > end:
                if end is not None:
                    gaps.append((a - end, before))
                busy += b - a
                end, before = b, short
            elif b > end:
                busy += b - end
                end, before = b, short
        for key, r in self.readings.items():
            if hasattr(self.metrics[key], "ENTRY") and r.calls != r.launches:
                print(f"{key}: {r.calls} calls of its entry against "
                      f"{r.launches} launches in the trace; left out",
                      file=sys.stderr)
        gaps.sort(reverse=True)
        labelled = [("after " + what, width / 1e9)
                    for width, what in gaps[:10]]
        top = sorted(((k, v / 1e9) for k, v in by_name.items()),
                     key=lambda kv: -kv[1])
        return TraceResult(self.kind, self.window_s, busy / 1e9,
                           self.readings, top[:10], labelled)
