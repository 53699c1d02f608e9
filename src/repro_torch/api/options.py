"""Typed, validated solver configuration (port of the JAX package's
``repro.api.options``; ``interpret`` becomes ``device``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pushrelabel import ALL_MODES as MODES
from repro_torch.kernels.runtime import resolve_device

LAYOUTS = ("bcsr", "rcsr")
BACKENDS = ("single", "batched", "distributed")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to execute a solve, independent of what is being solved.

    ``mode``
        Push-relabel step strategy, under the JAX package's names: ``vc``
        (the paper's workload-balanced vertex-centric, on plain PyTorch
        ops), the faithful CUDA variants ``vc_kernel`` (warp-per-vertex
        min search) and ``vc_kernel_bsearch`` (plus the BCSR
        binary-search reverse lookup), ``vc_fused`` (K whole cycles per
        launch of the fused discharge kernel), and ``tc`` (the paper's
        thread-centric baseline: every vertex scans its whole segment
        each cycle, on plain PyTorch ops).
    ``layout``
        Residual-graph layout, ``bcsr`` or ``rcsr`` (paper §3.2).
    ``backend``
        ``single`` (one instance per solve) or ``batched`` (instances
        padded to one shape and advanced together, one kernel launch
        per step for the whole batch; ``solve`` is a batch of one) or
        ``distributed`` (one instance range-partitioned over the ranks of
        the default ``torch.distributed`` process group, ``mode="vc"``
        only; raises ``NotImplementedError`` without a group).
    ``global_relabel_cadence``
        Push-relabel cycles between global relabels.  ``None`` picks the
        heuristic ``max(32, min(1024, n))``.
    ``max_cycles``
        Exact total push-relabel cycle budget; the solve raises
        ``BudgetExhausted`` if it has not converged within it.  ``None``
        means effectively unbounded.
    ``scan_chunk``
        Steps per chunk inside the sweep engine's loops
        (``repro_torch.core.engine.run_bulk_loop``), i.e. steps between
        host reads of the loop condition.  ``None`` picks
        ``engine.DEFAULT_CHUNK``.
    ``dtype``
        Capacity dtype.  Only ``int32`` is supported (the paper's integer
        capacities), the state dtype of residuals, heights and excess.
    ``device``
        Where the solve runs: ``None`` (default) is the CUDA card and
        raises when none is visible; ``"cpu"`` runs every kernel's plain
        PyTorch version.
    ``telemetry``
        Device-side workload counters (``repro_torch.obs.
        solvercounters``): push/relabel totals in ``SolveStats``, plus
        per-cycle active/frontier/maxdeg histories on the single
        backend.
    """

    mode: str = "vc"
    layout: str = "bcsr"
    backend: str = "single"
    global_relabel_cadence: int | None = None
    max_cycles: int | None = None
    scan_chunk: int | None = None
    dtype: str | type | np.dtype = "int32"
    device: str | torch.device | None = None
    telemetry: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; expected one of {MODES}")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; expected one of {LAYOUTS}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; "
                f"expected one of {BACKENDS}")
        if self.mode == "vc_kernel_bsearch" and self.layout != "bcsr":
            raise ValueError(
                "mode 'vc_kernel_bsearch' binary-searches head-sorted "
                f"segments and needs layout='bcsr', got {self.layout!r}")
        if self.backend == "distributed" and self.mode != "vc":
            raise ValueError(
                "backend 'distributed' is vertex-centric only (mode='vc'), "
                f"got {self.mode!r}")
        resolve_device(self.device)  # raises without a card for None
        if (self.global_relabel_cadence is not None
                and self.global_relabel_cadence < 1):
            raise ValueError("global_relabel_cadence must be >= 1 or None, "
                             f"got {self.global_relabel_cadence}")
        if self.max_cycles is not None and self.max_cycles < 1:
            raise ValueError(
                f"max_cycles must be >= 1 or None, got {self.max_cycles}")
        if self.scan_chunk is not None and self.scan_chunk < 1:
            raise ValueError(
                f"scan_chunk must be >= 1 or None, got {self.scan_chunk}")
        if np.dtype(self.dtype) != np.dtype(np.int32):
            raise ValueError(
                "capacities are int32 (the paper's integer-capacity "
                f"formulation); got dtype {self.dtype!r}")

    def cycle_chunk(self, n: int) -> int:
        """Cycles per ``run_cycles`` call between global relabels."""
        if self.global_relabel_cadence is not None:
            return self.global_relabel_cadence
        return max(32, min(1024, n))

    def max_rounds(self, n: int) -> int:
        """[cycles -> global relabel] rounds implied by ``max_cycles``."""
        if self.max_cycles is None:
            return 100000
        return max(1, -(-self.max_cycles // self.cycle_chunk(n)))

    def replace(self, **changes) -> SolverOptions:
        return dataclasses.replace(self, **changes)
