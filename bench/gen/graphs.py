"""The instances the benchmark's configurations draw, and the families
that draw them, found by name: a configuration's ``family`` key names
the module ``bench/gen/<family>.py``, whose ``make(rng, **params)``
draws one :class:`Instance` from a NumPy generator.

The families keep those of the program's generators
(``repro_torch.graphs.generators``) -- the same shapes, degrees,
capacity ranges and source/sink construction -- but not their random
stream: the program's per-vertex Python loops take half a minute at a
million vertices, these a second or two.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Instance:
    """The edge list the program and the reference are both handed, the
    terminals, and for a bipartite instance the two sides."""

    n: int
    edges: np.ndarray  # (m, 2) int64 (tail, head)
    cap: np.ndarray  # (m,) int64
    s: int
    t: int
    n_left: int = 0  # bipartite instances: left vertices 0..n_left-1
    n_right: int = 0  # right vertices n_left..n_left+n_right-1


def family(name: str):
    """The module ``bench/gen/<name>.py``; ``KeyError`` if it has no
    ``make``."""
    try:
        mod = importlib.import_module(f"bench.gen.{name}")
    except ModuleNotFoundError:
        mod = None
    if not callable(getattr(mod, "make", None)) or mod.__name__ == __name__:
        raise KeyError(f"no graph family {name!r} under bench/gen/")
    return mod


def make(name: str, seed_seq: np.random.SeedSequence,
         params: dict) -> Instance:
    """One instance of the family ``name`` with ``params``, drawn from
    ``seed_seq``."""
    return family(name).make(np.random.default_rng(seed_seq), **params)
