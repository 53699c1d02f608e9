"""Per-mode op-count baselines: a gated chunk's ops a step against the
ungated step's (the port of ``repro.analysis.baselines``).

The reference probes one cycle step traced through one scan-compiled
engine chunk against the same chunk unrolled: the program size the sweep
engine saves.  The port has no compiled program; its counterpart is the
host's dispatch cost: the aten ops a step dispatches inside one gated
chunk of ``engine.DEFAULT_CHUNK`` steps (``engine.run_chunk``), against
one ungated step alone.  The difference is the gate's cost a step (the
loop condition and the whole-carry ``where``).  The counts are a property
of the step, not of the graph, so they are probed once on a small fixture
(the reference's probe graph) and recorded as the port's baselines in
``ANALYSIS_torch.json`` under ``"baselines"``.

:func:`step_loops` builds the loops whose steps ``chip_smoke.py`` times
and censuses at full width, and :func:`chunk_census` takes one chunk's
census, so that a chunk at full width can be held to the same chunk on a
small graph.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Callable

import torch

from repro_torch.analysis import ir

__all__ = ["step_loops", "chunk_census", "chunk_baselines",
           "load_baselines", "mode_baselines"]

#: the reference's probe fixture (n, m, seed)
_PROBE_GRAPH = (60, 240, 7)


def step_loops(g, meta, state, s: int, t: int, minh_fn: Callable
               ) -> dict[str, tuple]:
    """``name -> (step_fn, cond_fn, make_carry, pass_gate)`` of the loops
    ``chip_smoke.py``'s ``step_timing`` runs from ``state``: the cycles of
    ``vc_kernel_bsearch``, ``vc_fused`` and ``vc``, and relabel sweeps on
    the kernel hook ``minh_fn`` and plain.  ``make_carry()`` gives a
    fresh carry (``vc_fused``'s step updates its state in place: its own
    copy each time).  No condition ends a loop early."""
    from repro_torch.core import engine, globalrelabel
    from repro_torch.core import pushrelabel as pr

    zero = torch.zeros((), dtype=torch.int32, device=state.res.device)
    loops = {}
    for mode in ("vc_kernel_bsearch", "vc_fused", "vc"):
        body, cond = pr.cycle_loop(g, meta, s, t, mode, cap=2**30)
        if mode == "vc_fused":
            def carry():
                return pr.PRState(*(x.clone() for x in state)), zero
        else:
            def carry():
                return state, zero
        loops[f"cycle[{mode}]"] = (body, cond, carry, mode == "vc_fused")
    for name, fn in (("sweep[kernel]", minh_fn), ("sweep[plain]", None)):
        sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t, fn)
        step, cond, carry0 = engine.fixpoint_loop(sweep, dist0, cap=2**30)
        loops[name] = (step, cond, lambda carry0=carry0: carry0, False)
    return loops


def chunk_census(step_fn, cond_fn, carry, chunk: int | None = None,
                 pass_gate: bool = False) -> ir.OpCensus:
    """The census of one engine chunk (``engine.run_chunk``) of ``chunk``
    steps (default ``engine.DEFAULT_CHUNK``) from ``carry``."""
    from repro_torch.core import engine

    return ir.census(engine.run_chunk, step_fn, carry, cond_fn=cond_fn,
                     chunk=chunk or engine.DEFAULT_CHUNK,
                     pass_gate=pass_gate)


@functools.lru_cache(maxsize=None)
def chunk_baselines(modes: tuple[str, ...] | None = None,
                    chunk: int | None = None, device=None) -> dict:
    """mode -> ``{"chunk", "chunk_ops_per_step", "step_ops",
    "gate_ops_per_step", "launches_per_step"}`` on the probe graph on
    ``device`` (``None``: the card).  ``vc_fused`` is left out, as in the
    reference: its engine step is K cycles in one launch, not one cycle
    step."""
    from repro_torch.core import engine, globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import build_residual
    from repro_torch.graphs import generators as G

    if modes is None:
        modes = tuple(m for m in pr.ALL_MODES if m != "vc_fused")
    chunk = engine.DEFAULT_CHUNK if chunk is None else int(chunk)
    n, m, seed = _PROBE_GRAPH
    adj, s, t = G.random_sparse(n, m, seed=seed)
    g, meta, res0 = pr.to_device(build_residual(adj, "bcsr"), device)
    state = pr.preflow(g, meta, res0, s)
    state, _, _ = globalrelabel.global_relabel_impl(g, meta, state, s, t)
    zero = torch.zeros((), dtype=torch.int32, device=res0.device)

    out = {}
    for mode in modes:
        if mode == "vc_fused":
            continue
        body, cond = pr.cycle_loop(g, meta, s, t, mode, cap=2**30)
        gated = chunk_census(body, cond, (state, zero), chunk)
        step = ir.census(body, (state, zero))
        per_step = gated.op_count / chunk
        out[mode] = {"chunk": chunk, "chunk_ops_per_step": per_step,
                     "step_ops": step.op_count,
                     "gate_ops_per_step": per_step - step.op_count,
                     "launches_per_step": gated.kernel_call_count / chunk}
    return out


def load_baselines(path: str | Path) -> dict | None:
    """The ``"baselines"`` section of an ``ANALYSIS_torch.json``, or None
    if the file is absent, unreadable or lacks the section."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        payload = json.loads(path.read_text())
    except ValueError:
        return None
    base = payload.get("baselines")
    return base if isinstance(base, dict) and base else None


def mode_baselines(path: str | Path | None = None, device=None) -> dict:
    """The per-mode baselines: from ``path`` (an ``ANALYSIS_torch.json``)
    when given and readable, else probed fresh on ``device``."""
    if path is not None:
        loaded = load_baselines(path)
        if loaded is not None:
            return loaded
    return chunk_baselines(device=device)
