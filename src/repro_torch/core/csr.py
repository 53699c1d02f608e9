"""Enhanced compressed sparse representations for residual graphs (paper §3.2).

The paper replaces the O(V^2) adjacency-matrix residual graph with two O(V+E)
layouts:

* **RCSR** (reversed CSR): the forward CSR plus a second, reversed CSR whose
  entries point back into the forward flow array (``flow_idx``).  Backward
  arcs are found in O(1), but a vertex's residual neighbours live in two
  discontiguous regions.
* **BCSR** (bidirectional CSR): each vertex's in- and out-arcs are aggregated
  into one contiguous segment, sorted by neighbour id, so scans are coalesced;
  the backward arc of a push is located by binary search (O(log d)) — or, in
  our beyond-paper variant, via a precomputed ``rev`` index array.

On TPU both layouts lower to the same *flat arc array* residual form:

    ``res[a]`` — residual capacity of arc ``a``;  push ``d`` on ``a`` is
    ``res[a] -= d; res[rev[a]] += d``.

The layouts differ in the per-vertex arc ordering (RCSR: out-arcs then
in-arcs; BCSR: merged, sorted by head) and in how ``rev`` is obtained
(RCSR: free, it *is* ``flow_idx``; BCSR: binary search / precomputed).
Construction is host-side numpy; the solver consumes device arrays.

A copy of the JAX package's ``repro.core.csr``, byte-identical in
behaviour, plus :func:`residual_from_arrays`, which carries a residual
built by the JAX package across as plain numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

Layout = Literal["rcsr", "bcsr"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed, capacitated graph (host-side edge list)."""

    n: int
    edges: np.ndarray  # (m, 2) int64 — (tail, head)
    cap: np.ndarray  # (m,) int64

    def __post_init__(self):
        if self.edges.ndim != 2 or self.edges.shape[1] != 2:
            raise ValueError(
                f"edges must be (m, 2) (tail, head) pairs, got shape "
                f"{self.edges.shape}")
        if self.cap.shape[0] != self.edges.shape[0]:
            raise ValueError(
                f"cap length {self.cap.shape[0]} != edge count "
                f"{self.edges.shape[0]}")

    @property
    def m(self) -> int:
        return self.edges.shape[0]


@dataclasses.dataclass(frozen=True)
class ResidualCSR:
    """Flat-arc residual graph in RCSR or BCSR ordering (host numpy arrays).

    Memory is O(V + E): five integer arrays of length ``A = 2 * m_coalesced``
    plus the (n+1)-long ``indptr``.  (The paper's memory-reduction claim; see
    ``memory_bytes`` / ``adjacency_matrix_bytes``.)
    """

    layout: Layout
    n: int
    m: int  # coalesced edge-pair count; A = 2m arcs
    indptr: np.ndarray  # (n+1,) int32 — segment of vertex v is indptr[v]:indptr[v+1]
    heads: np.ndarray  # (A,) int32 — head vertex of each arc
    tails: np.ndarray  # (A,) int32 — tail vertex (owner) of each arc
    res0: np.ndarray  # (A,) int64 — initial residual capacity
    rev: np.ndarray  # (A,) int32 — partner (reverse) arc index
    is_fwd: np.ndarray  # (A,) bool — True if arc carries original edge capacity
    pair_u: np.ndarray  # (m,) int32 — coalesced pair endpoints (u -> v arc ids)
    pair_arc: np.ndarray  # (m,) int32 — arc id of the u->v direction of each pair

    @property
    def num_arcs(self) -> int:
        return self.heads.shape[0]

    @property
    def deg(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    @property
    def deg_max(self) -> int:
        return 0 if self.n == 0 else int(self.deg.max())

    def memory_bytes(self) -> int:
        """Bytes of the device-resident representation (O(V+E))."""
        arrs = (self.indptr, self.heads, self.res0, self.rev)
        return int(sum(a.nbytes for a in arrs))

    def adjacency_matrix_bytes(self, dtype_bytes: int = 2) -> int:
        """What the prior-work O(V^2) residual adjacency matrix would cost."""
        return self.n * self.n * dtype_bytes

    def binary_search_ready(self) -> bool:
        """BCSR keeps each segment sorted by head so rev can be re-derived."""
        return self.layout == "bcsr"


def _coalesce(n: int, edges: np.ndarray, cap: np.ndarray):
    """Drop self-loops and merge parallel/antiparallel edges into unordered
    pairs (standard residual-graph canonicalisation; keeps binary search for
    the backward arc unambiguous — one arc per direction per vertex pair)."""
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    keep = u != v
    u, v, c = u[keep], v[keep], cap[keep].astype(np.int64)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key_s, u_s, c_s = key[order], u[order], c[order]
    is_lo_first = u_s == (key_s // n)
    uniq_key, first_idx = np.unique(key_s, return_index=True)
    seg_id = np.searchsorted(uniq_key, key_s)
    npairs = uniq_key.shape[0]
    cap_fwd = np.zeros(npairs, np.int64)  # capacity lo->hi
    cap_bwd = np.zeros(npairs, np.int64)  # capacity hi->lo
    np.add.at(cap_fwd, seg_id[is_lo_first], c_s[is_lo_first])
    np.add.at(cap_bwd, seg_id[~is_lo_first], c_s[~is_lo_first])
    pu = (uniq_key // n).astype(np.int64)
    pv = (uniq_key % n).astype(np.int64)
    return pu, pv, cap_fwd, cap_bwd


def build_residual(g: Graph, layout: Layout = "bcsr") -> ResidualCSR:
    """Build the residual graph in the requested enhanced-CSR layout."""
    n = g.n
    pu, pv, cf, cb = _coalesce(n, g.edges, g.cap)
    m = pu.shape[0]
    # Arc 2i   : pu[i] -> pv[i]  (residual cf[i])
    # Arc 2i+1 : pv[i] -> pu[i]  (residual cb[i])
    tails = np.empty(2 * m, np.int64)
    heads = np.empty(2 * m, np.int64)
    res0 = np.empty(2 * m, np.int64)
    isf = np.empty(2 * m, bool)
    tails[0::2], heads[0::2], res0[0::2], isf[0::2] = pu, pv, cf, True
    tails[1::2], heads[1::2], res0[1::2], isf[1::2] = pv, pu, cb, False
    partner = np.arange(2 * m) ^ 1

    if layout == "bcsr":
        # Aggregated per tail, sorted by head (paper Fig. 2(d)).
        order = np.lexsort((heads, tails))
    elif layout == "rcsr":
        # Per tail: original-CSR block (capacity-bearing arcs, sorted by
        # head) followed by the reversed-CSR block (paper Fig. 2(c)).
        order = np.lexsort((heads, ~isf, tails))
    else:
        raise ValueError(f"unknown layout {layout!r}")

    inv = np.empty(2 * m, np.int64)
    inv[order] = np.arange(2 * m)
    rev = inv[partner[order]]
    tails_o, heads_o, res_o, isf_o = tails[order], heads[order], res0[order], isf[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, tails_o + 1, 1)
    indptr = np.cumsum(indptr)
    pair_arc = inv[np.arange(0, 2 * m, 2)]

    return ResidualCSR(
        layout=layout,
        n=n,
        m=m,
        indptr=indptr.astype(np.int32),
        heads=heads_o.astype(np.int32),
        tails=tails_o.astype(np.int32),
        res0=res_o.astype(np.int64),
        rev=rev.astype(np.int32),
        is_fwd=isf_o,
        pair_u=pu.astype(np.int32),
        pair_arc=pair_arc.astype(np.int32),
    )


def build_rcsr(g: Graph) -> ResidualCSR:
    return build_residual(g, "rcsr")


def build_bcsr(g: Graph) -> ResidualCSR:
    return build_residual(g, "bcsr")


def validate_residual(r: ResidualCSR) -> None:
    """Structural invariants (used by property tests).  Raises
    ``ValueError`` on the first violation — real raises, not asserts, so
    the checks survive ``python -O``."""
    A = r.num_arcs

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"invalid ResidualCSR: {what}")

    check(A == 2 * r.m, f"num_arcs {A} != 2*m ({2 * r.m})")
    check(r.indptr[0] == 0 and r.indptr[-1] == A,
          "indptr does not span [0, num_arcs]")
    check(bool(np.all(np.diff(r.indptr) >= 0)), "indptr not monotone")
    check(bool(np.all(r.rev[r.rev] == np.arange(A))),
          "rev is not an involution")
    check(bool(np.all(r.heads[r.rev] == r.tails)),
          "partner arcs do not mirror endpoints (heads)")
    check(bool(np.all(r.tails[r.rev] == r.heads)),
          "partner arcs do not mirror endpoints (tails)")
    check(bool(np.all(r.res0 >= 0)), "negative initial residual")
    seg = np.repeat(np.arange(r.n), np.diff(r.indptr))
    check(np.array_equal(seg, r.tails), "tails disagree with indptr segments")
    if r.layout == "bcsr":
        # heads sorted within each segment — binary-searchable
        same_seg = seg[1:] == seg[:-1]
        check(bool(np.all(r.heads[1:][same_seg] >= r.heads[:-1][same_seg])),
              "bcsr heads not sorted within segments")


def residual_from_arrays(**fields) -> ResidualCSR:
    """A ``ResidualCSR`` from plain numpy arrays (and ``layout``/``n``/``m``),
    e.g. ``dataclasses.asdict`` of the JAX package's ``ResidualCSR``: the
    carry-across function for graph data, so both packages solve the same
    bytes.  Arrays are copied with this module's dtypes; the result is
    checked with :func:`validate_residual`."""
    want = {f.name for f in dataclasses.fields(ResidualCSR)}
    if set(fields) != want:
        raise ValueError(
            f"residual fields {sorted(fields)} != {sorted(want)}")
    dtypes = {"indptr": np.int32, "heads": np.int32, "tails": np.int32,
              "res0": np.int64, "rev": np.int32, "is_fwd": bool,
              "pair_u": np.int32, "pair_arc": np.int32}
    arrays = {k: np.array(fields[k], dtype=dt) for k, dt in dtypes.items()}
    r = ResidualCSR(layout=fields["layout"], n=int(fields["n"]),
                    m=int(fields["m"]), **arrays)
    validate_residual(r)
    return r
