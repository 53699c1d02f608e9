"""What a run may not have loaded: JAX, the JAX package of this repository
(``repro``) or any module of its old benchmark folder ``benchmarks/``."""
from __future__ import annotations

import pathlib
import sys

#: top-level module names, compared whole: ``repro_torch`` is the program
#: under test and passes, ``repro`` does not
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(root: pathlib.Path, modules=None) -> list[str]:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`,
    or whose file lies under ``root / "benchmarks"``."""
    modules = sys.modules if modules is None else modules
    old = (root / "benchmarks").resolve()
    found = []
    for name, mod in list(modules.items()):
        if name.split(".")[0] in FORBIDDEN:
            found.append(name)
            continue
        path = getattr(mod, "__file__", None)
        if path and old in pathlib.Path(path).resolve().parents:
            found.append(name)
    return sorted(found)
