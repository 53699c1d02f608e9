"""What the request kinds share, and the lookup of a kind by name.

A traffic mix's ``kind`` key names the module ``bench/drivers/<kind>.py``.
Its ``Driver(config, traffic, seed, device)`` draws its inputs from the
run's seed when it is made, serves one whole request per
``request(i, spans)`` call (one client, closed loop: the next request is
sent when the last has returned) and, once the window has closed, judges
every answer it kept with the plain reference (``bench/reference``) in
``check()``.  A request's wall time ends in a host read: every answer the
program hands back is host data.  The module also names the control and
the faults (``bench/lib/faults.py``) that its check has to catch:
``CONTROL`` and ``FAULTS``.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np

from bench.gen import graphs


class Spans:
    """Seconds spent in named stretches of one request, by the host
    clock."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def seed_seq(seed: int, *stream: int) -> np.random.SeedSequence:
    """The random stream ``stream`` of the run seeded with ``seed`` (any
    whole number; a negative one is taken modulo 2**64)."""
    return np.random.SeedSequence([seed % 2**64, *stream])


def worst(readings) -> dict:
    """Each check's largest count over the answers' readings."""
    out: dict[str, int] = {}
    for got in readings:
        for name, v in got.items():
            out[name] = max(out.get(name, 0), v)
    return out


def solver(config: dict, device):
    from repro_torch.api import Solver, SolverOptions

    return Solver(SolverOptions(device=device, **config["solver"]))


class Pool:
    """The graphs a run's cold requests draw from: ``traffic["graphs"]``
    instances of the configuration's family, drawn from the run's seed,
    sent in turn."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.solver = solver(config, device)
        self.instances = [
            graphs.make(config["family"], seed_seq(seed, 0, i),
                        config["params"])
            for i in range(int(traffic["graphs"]))]
        self.answers: list = []

    def instance(self, i: int):
        k = i % len(self.instances)
        return k, self.instances[k]


def load(kind: str):
    """The module ``bench/drivers/<kind>.py``; ``KeyError`` if it has no
    ``Driver``."""
    try:
        mod = importlib.import_module(f"bench.drivers.{kind}")
    except ModuleNotFoundError:
        mod = None
    if mod is None or not hasattr(mod, "Driver"):
        raise KeyError(f"no request kind {kind!r} under bench/drivers/")
    return mod
