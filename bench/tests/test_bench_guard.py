"""The run's guard compares top-level module names whole."""
from __future__ import annotations

import types

from bench.lib import guard
from bench.lib.spec import ROOT


def mods(*names, file=None):
    out = {}
    for n in names:
        m = types.ModuleType(n)
        m.__file__ = file
        out[n] = m
    return out


def test_the_program_passes():
    assert guard.forbidden_modules(ROOT, mods(
        "repro_torch", "repro_torch.api", "reprox", "jaxtyping",
        "flaxen", "numpy")) == []


def test_jax_and_the_jax_package_are_found():
    assert guard.forbidden_modules(ROOT, mods(
        "repro", "repro.core", "jax", "jax.numpy", "jaxlib", "flax",
        "repro_torch")) == ["flax", "jax", "jax.numpy", "jaxlib", "repro",
                            "repro.core"]


def test_a_module_of_the_old_benchmark_folder_is_found():
    old = str(ROOT / "benchmarks" / "common.py")
    assert guard.forbidden_modules(ROOT, mods("common", file=old)) == \
        ["common"]
    new = str(ROOT / "bench" / "run.py")
    assert guard.forbidden_modules(ROOT, mods("run", file=new)) == []

