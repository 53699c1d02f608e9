"""DIMACS max-flow format I/O (1st DIMACS Implementation Challenge)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph


def write_dimacs(path: str, g: Graph, s: int, t: int, comment: str = "") -> None:
    with open(path, "w") as f:
        if comment:
            for line in comment.splitlines():
                f.write(f"c {line}\n")
        f.write(f"p max {g.n} {g.m}\n")
        f.write(f"n {s + 1} s\n")
        f.write(f"n {t + 1} t\n")
        for (u, v), c in zip(g.edges, g.cap):
            f.write(f"a {u + 1} {v + 1} {c}\n")


def _ints(path: str, lineno: int, tok: list[str], want: int) -> list[int]:
    """Parse ``tok`` as integers, with the offending line on failure."""
    if len(tok) != want:
        raise ValueError(
            f"{path}:{lineno}: expected {want} fields, got {len(tok)}: "
            f"{' '.join(tok)!r}")
    try:
        return [int(x) for x in tok]
    except ValueError:
        raise ValueError(
            f"{path}:{lineno}: malformed integer token in "
            f"{' '.join(tok)!r}") from None


def _check_vertex(path: str, lineno: int, v: int, n: int | None) -> int:
    """Validate a 1-based DIMACS vertex id and return it 0-based."""
    if n is None:
        raise ValueError(
            f"{path}:{lineno}: vertex id before the 'p max' problem line")
    if not 1 <= v <= n:
        raise ValueError(
            f"{path}:{lineno}: vertex id {v} outside [1, {n}]")
    return v - 1


def read_dimacs(path: str):
    """Parse a DIMACS max-flow file into ``(Graph, s, t)``.

    Malformed lines raise ``ValueError`` naming the file and line number;
    1-based vertex ids are validated against the ``p`` line's ``n``; and
    duplicate parallel arcs are coalesced by summing their capacities (the
    residual builder would merge them anyway — doing it here keeps
    ``Graph.m`` and round-trips through ``write_dimacs`` faithful).
    """
    n = None
    s = t = None
    edges, caps = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            tok = line.split()
            if not tok or tok[0] == "c":
                continue
            kind, rest = tok[0], tok[1:]
            if kind == "p":
                if len(rest) != 3 or rest[0] != "max":
                    raise ValueError(
                        f"{path}:{lineno}: expected 'p max <n> <m>', got "
                        f"{line.strip()!r}")
                if n is not None:
                    raise ValueError(
                        f"{path}:{lineno}: duplicate problem line")
                n, _ = _ints(path, lineno, rest[1:], 2)
                if n < 0:
                    raise ValueError(f"{path}:{lineno}: negative n {n}")
            elif kind == "n":
                if len(rest) != 2 or rest[1] not in ("s", "t"):
                    raise ValueError(
                        f"{path}:{lineno}: expected 'n <id> s|t', got "
                        f"{line.strip()!r}")
                (v,) = _ints(path, lineno, rest[:1], 1)
                v = _check_vertex(path, lineno, v, n)
                if rest[1] == "s":
                    s = v
                else:
                    t = v
            elif kind == "a":
                u, v, c = _ints(path, lineno, rest, 3)
                u = _check_vertex(path, lineno, u, n)
                v = _check_vertex(path, lineno, v, n)
                if c < 0:
                    raise ValueError(
                        f"{path}:{lineno}: negative capacity {c}")
                edges.append((u, v))
                caps.append(c)
            else:
                raise ValueError(
                    f"{path}:{lineno}: unknown line type {kind!r}")
    if n is None or s is None or t is None:
        missing = [name for name, val in
                   (("p (problem)", n), ("n ... s (source)", s),
                    ("n ... t (sink)", t)) if val is None]
        raise ValueError(f"{path}: missing required line(s): "
                         + ", ".join(missing))
    e = np.array(edges, np.int64).reshape(-1, 2)
    c = np.array(caps, np.int64)
    if e.shape[0]:  # coalesce duplicate parallel arcs: sum their capacities
        key = e[:, 0] * max(n, 1) + e[:, 1]
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        if uniq.shape[0] != e.shape[0]:
            csum = np.zeros(uniq.shape[0], np.int64)
            np.add.at(csum, inv, c)
            order = np.argsort(first)  # keep first-appearance order
            e, c = e[first[order]], csum[order]
    return Graph(n, e, c), s, t
