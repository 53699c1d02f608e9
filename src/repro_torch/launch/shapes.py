"""Assigned input-shape cells (per-arch) and skip rules.

A copy of the JAX package's ``repro.launch.shapes``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int
    wide_cache: bool = False  # shard cache seq over (data, model)


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1,
                           wide_cache=True),
}

# the paper's own workload: graph scales for the distributed WBPR superstep
GRAPH_SHAPES = {
    "graph_16m": ShapeCell("graph_16m", "maxflow", 2**24, 2**21),  # arcs, V
    "graph_128m": ShapeCell("graph_128m", "maxflow", 2**27, 2**24),
}


def subquadratic(cfg) -> bool:
    """long_500k runs only for archs with sub-quadratic decode state."""
    if getattr(cfg, "window", None):
        return True  # SWA ring cache is O(window)
    return getattr(cfg, "family", "") in ("ssm", "hybrid")


def cells_for(cfg):
    if getattr(cfg, "family", None) == "graph":
        return list(GRAPH_SHAPES.values())
    out = []
    for cell in LM_SHAPES.values():
        if cell.name == "long_500k" and not subquadratic(cfg):
            continue  # full-attention arch: noted skip (DESIGN.md §5)
        out.append(cell)
    return out
