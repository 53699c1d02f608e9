"""``python -m repro_torch.launch.analyze`` — the contract analyzer of the
port (the counterpart of ``repro.launch.analyze``).

Runs every registered dispatch surface (``repro_torch.analysis.
surfaces``) once under the op census, checks the contract rules against
each census, runs the AST lint of the port's tree (``repro_torch.
analysis.lint``), takes the per-mode op baselines, and writes everything
to ``ANALYSIS_torch.json``::

    python -m repro_torch.launch.analyze                  # on the card
    python -m repro_torch.launch.analyze --device cpu --smoke
    python -m repro_torch.launch.analyze --surface 'run_cycles/*'

``--smoke`` exits 1 on any rule violation or lint finding.  The device
defaults to the card, which must be there.  On the card each surface's
census also runs under ``torch.cuda.set_sync_debug_mode("error")``
(only the engine's one read a chunk is let through), its kernel launches
are held to the wrappers' ``.launches`` counters, and ``capturable``
records whether one chunk of its first engine loop that nests none
captures into a ``torch.cuda.CUDAGraph`` and replays to the eager carry
bit for bit (no rule gates it; the counters do not tick on a replay, so
they are read around the census only).

The payload has the reference's keys: ``surfaces`` (each surface's
census, verdicts and ``device``), ``lint``, ``baselines``, ``summary``.
"""
from __future__ import annotations

import argparse
import contextlib
import fnmatch
import json
import sys
from pathlib import Path

import torch


def launch_counters() -> dict[str, int]:
    """Every kernel entry's ``.launches`` counter, by the name
    ``census_launch`` records."""
    from repro_torch.kernels import discharge, revsearch, segmin

    return {f.__name__: f.launches for f in (
        segmin.tile_min_neighbor, segmin.tile_min_neighbor_gather,
        segmin.tile_min_neighbor_gather_rev, revsearch.bcsr_rev_search,
        discharge.fused_discharge_batched)}


@contextlib.contextmanager
def sync_errors(device: torch.device):
    """On the card, any synchronisation raises inside (the census lets
    the engine's read through); elsewhere a no-op."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def capture_chunk(chunk_loop) -> tuple[bool, str | None]:
    """Whether one engine chunk of ``chunk_loop`` (``OpCensus.
    chunk_loop``) captures into a CUDA graph and its replay equals the
    eager chunk from the same carry bit for bit; ``(False, first line of
    the error)`` otherwise."""
    from torch.utils import _pytree

    from repro_torch.core import engine

    if chunk_loop is None:
        return False, "no engine loop that nests none ran"
    step, cond, carry0, chunk, pass_gate = chunk_loop

    def run(carry):
        return engine.run_chunk(step, carry, cond_fn=cond, chunk=chunk,
                                pass_gate=pass_gate)

    def fresh():
        return _pytree.tree_map_only(torch.Tensor, torch.clone, carry0)

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = run(fresh())  # also the capture's warm-up
        torch.cuda.current_stream().wait_stream(side)
        static = fresh()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run(static)
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            _pytree.tree_leaves(out), _pytree.tree_leaves(eager))
            if isinstance(a, torch.Tensor))
        return same, None if same else "the replay differs from the eager " \
            "chunk"
    except Exception as ex:  # a boundary: record why, go on to the next
        lines = str(ex).strip().splitlines()
        return False, f"{type(ex).__name__}: {lines[0] if lines else ''}"


def census_json(census) -> dict:
    from repro_torch.analysis.collectives import collective_bytes

    return {
        "op_count": census.op_count,
        "ops_per_step": census.ops_per_step(),
        "kernel_op_count": census.kernel_op_count,
        "loop_shape": {"loops": census.loop_shells,
                       "chunked": census.chunked_shells,
                       "steps": census.steps,
                       "host_reads": census.host_reads,
                       "kernel_calls": census.kernel_call_count},
        "launches": census.launches_by_kernel(),
        "loops": [{"site": str(lp.site), "chunk": lp.chunk,
                   "steps": lp.steps, "reads": lp.reads,
                   "step_launches": list(lp.step_launches),
                   "nested": lp.nested} for lp in census.loops],
        "kernel_calls": [{"kernel": k.kernel, "rows": k.rows, "q": k.q,
                          "origin": str(k.origin)}
                         for k in census.kernel_calls],
        "casts": sorted({(c.op, c.src, c.dst, str(c.origin), c.index_only,
                          c.index_source) for c in census.casts}),
        "host_calls": [{"op": h.op, "origin": str(h.origin),
                        "reason": h.reason} for h in census.host_calls],
        "collectives": [{"op": c.op, "kind": c.kind, "bytes": c.nbytes,
                         "group_size": c.group_size,
                         "origin": str(c.origin)}
                        for c in census.collectives],
        "collective_bytes": collective_bytes(census),
        "op_counts": dict(sorted(census.op_counts.items())),
        "capturable": census.capturable,
        "capture_error": census.capture_error,
    }


def _run_surface(surf, on_card: bool):
    """One surface's census (with the card's checks); returns ``(census or
    None, violations, launch counts or None)``."""
    import dataclasses

    from repro_torch.analysis import ir
    from repro_torch.analysis.rules import Violation, check_rules

    counts = None
    try:
        with surf.session() if surf.session else contextlib.nullcontext():
            fn, args = surf.build()
            before = launch_counters()
            with sync_errors(surf.device):
                _, census = ir.record(fn, *args, keep_chunk=on_card)
            if on_card:
                torch.cuda.synchronize()
                after = launch_counters()
                counters = {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}
                counts = {"census": census.launches_by_kernel(),
                          "counters": counters}
                ok, err = capture_chunk(census.chunk_loop)
                census = dataclasses.replace(census, capturable=ok,
                                             capture_error=err)
    except Exception as ex:  # a boundary: the surface fails, the run goes on
        lines = str(ex).strip().splitlines()
        return None, [Violation("census", surf.name,
                                f"{type(ex).__name__}: "
                                f"{lines[0] if lines else ''}")], counts
    violations = check_rules(census, surf.rules, surf.name)
    if counts is not None and counts["census"] != counts["counters"]:
        violations.append(Violation(
            "launch-counters", surf.name,
            f"census launches {counts['census']} != the wrappers' "
            f".launches deltas {counts['counters']}"))
    return census, violations, counts


def run_analysis(patterns: list[str] | None = None, with_lint: bool = True,
                 with_baselines: bool = True, repo_root: str | Path = ".",
                 device=None) -> dict:
    """The full analysis payload on ``device`` (``None``: the card)."""
    from repro_torch.analysis import surfaces as S
    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    surface_out = {}
    n_viol = 0
    for surf in S.iter_surfaces(device=dev):
        if patterns and not any(fnmatch.fnmatch(surf.name, p)
                                for p in patterns):
            continue
        census, violations, counts = _run_surface(surf, on_card)
        n_viol += len(violations)
        surface_out[surf.name] = {
            "family": surf.family,
            "tags": surf.tag_dict(),
            "device": str(dev),
            "rules": [r.name for r in surf.rules],
            "census": None if census is None else census_json(census),
            "launch_counts": counts,
            "capturable": None if census is None else census.capturable,
            "violations": [v.to_json() for v in violations],
            "ok": not violations,
        }

    lint_out = []
    if with_lint:
        from repro_torch.analysis.lint import run_lint

        lint_out = [f.to_json() for f in run_lint(repo_root)]

    baselines = {}
    if with_baselines:
        from repro_torch.analysis.baselines import chunk_baselines

        baselines = chunk_baselines(device=dev)

    return {
        "analysis": "device-program contracts (PyTorch port)",
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "surfaces": surface_out,
        "lint": lint_out,
        "baselines": baselines,
        "summary": {
            "surfaces_traced": len(surface_out),
            "surfaces_clean": sum(1 for s in surface_out.values()
                                  if s["ok"]),
            "rule_violations": n_viol,
            "lint_findings": len(lint_out),
            "capturable": sum(1 for s in surface_out.values()
                              if s["capturable"]),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="run every dispatch surface of the port under the op "
                    "census, check the contract rules, run the lint, write "
                    "ANALYSIS_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="exit nonzero on any rule violation or lint "
                         "finding")
    ap.add_argument("--surface", action="append", default=None,
                    metavar="GLOB",
                    help="only surfaces matching this glob (repeatable), "
                         "e.g. 'run_cycles/*'")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--no-baselines", action="store_true",
                    help="skip the per-mode op baselines")
    ap.add_argument("--out", default="ANALYSIS_torch.json",
                    help="output path (default: ./ANALYSIS_torch.json)")
    ap.add_argument("--root", default=".",
                    help="repository root for the lint")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    payload = run_analysis(patterns=args.surface, with_lint=not args.no_lint,
                           with_baselines=not args.no_baselines,
                           repo_root=args.root, device=args.device)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)

    s = payload["summary"]
    for name, rec in sorted(payload["surfaces"].items()):
        mark = "ok  " if rec["ok"] else "VIOL"
        c = rec["census"]
        if c is not None:
            shape = c["loop_shape"]
            print(f"{mark} {name:40s} loops={shape['loops']} "
                  f"steps={shape['steps']} reads={shape['host_reads']} "
                  f"launches={shape['kernel_calls']} "
                  f"ops/step={c['ops_per_step']:.1f} "
                  f"capturable={rec['capturable']}")
        for v in rec["violations"]:
            print(f"       [{v['rule']}] {v['message']}")
    for f_ in payload["lint"]:
        print(f"lint {f_['path']}:{f_['line']}: [{f_['rule']}] "
              f"{f_['message']}")
    print(f"wrote {args.out} ({payload['device']}): {s['surfaces_clean']}/"
          f"{s['surfaces_traced']} surfaces clean, {s['rule_violations']} "
          f"rule violation(s), {s['lint_findings']} lint finding(s)")
    if args.smoke and (s["rule_violations"] or s["lint_findings"]):
        print("smoke gate FAILED: the contract does not hold",
              file=sys.stderr)
        return 1
    if args.smoke:
        print("smoke OK: every contract holds on every dispatch surface")
    return 0


if __name__ == "__main__":
    sys.exit(main())
