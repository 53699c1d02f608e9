"""The arithmetic the per-layer metrics' readers share: a mean over the
window's requests of a span or a counter, a kernel's share of its byte
roofline, the device's idle share.  Each returns ``None`` where the run
holds nothing to read."""
from __future__ import annotations

from bench.lib import peaks


def mean_span(ctx, name: str) -> float | None:
    """Seconds a request spent in the harness's span ``name``."""
    vals = [r["spans"][name] for r in ctx.records if name in r["spans"]]
    return sum(vals) / len(vals) if vals else None


def mean_counter(ctx, name: str) -> float | None:
    """The program's counter ``name`` (from ``SolveStats``) a request."""
    vals = [r[name] for r in ctx.records if name in r]
    return sum(vals) / len(vals) if vals else None


def program_span(ctx, *names: str) -> float | None:
    """Seconds a request spent in the program's own spans ``names``
    (``repro_torch.obs.trace``), summed: 0 where the program opened none
    of them."""
    spans = ctx.program_spans
    if spans is None or not spans.stretches:
        return None
    return sum(sum(spans.seconds.get(n, ())) for n in names) / spans.stretches


def _kernel(ctx, metric: str):
    """The traced request's reading of the kernel that the metric's file
    names, where the trace holds launches of it."""
    if ctx.trace is None:
        return None
    k = ctx.trace.kernels.get(metric)
    return k if k is not None and k.launches and k.seconds > 0 else None


def roofline(ctx, metric: str) -> float | None:
    """The kernel's share of its byte roofline, in %: the bytes its calls
    in the traced request move at the least (the metric file's
    ``bytes_of``) over the card's peak bandwidth, against the device time
    of those calls.  ``None`` where the entry's calls and the trace's
    launches do not pair up."""
    k = _kernel(ctx, metric)
    bw = peaks.bandwidth(ctx.trace.device_kind) if k else None
    if k is None or bw is None or k.calls != k.launches:
        return None
    return 100.0 * k.bytes / bw / k.seconds


def device_seconds(ctx, metric: str) -> float | None:
    """The kernel's device time in the traced request, in seconds."""
    k = _kernel(ctx, metric)
    return None if k is None else k.seconds


def idle_pct(ctx) -> float | None:
    """The share of the traced request in which no operation ran on the
    device, in %.  The trace records device activity only, which slows
    the host far less than recording its operations does, but still
    somewhat: the share reads a few points high."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
