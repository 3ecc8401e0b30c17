"""Domain Decomposition of CLS problems (DD-CLS) — paper §4, host half.

The numpy side of ``repro.core.dd``:
  * geometric 1D decomposition of the state index set I = {1..n} with
    optional overlap s (eq. 21-22),
  * the graph-general :class:`Decomposition` (column sets, column
    multiplicity, halo sizes) and its neighbour-exchange schedule
    (:class:`HaloExchange`),
  * row assignment of observations to subdomains (Remark 5).

The tensor half (reduction/extension operators and the ``SchwarzSolver``
sweeps) is not ported yet; the DD-KF solve lives in
:mod:`repro_torch.core.ddkf`.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Sequence

import numpy as np

from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod


# ---------------------------------------------------------------------------
# Neighbour-only halo exchange metadata.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class HaloExchange:
    """Precomputed neighbour-exchange schedule of a Decomposition.

    The paper's overhead model (T^p_oh) charges each subdomain only for
    traffic with its grid-graph neighbours; this object is the machinery
    that realizes exactly that communication pattern on device.  It is
    graph-general: an *edge* is any pair of subdomains whose column sets
    intersect — the grid-graph neighbours for a cross-shaped 2D halo, the
    chain neighbours in 1D, plus any halo∩halo pairs a wide overlap
    creates (e.g. diagonal cells whose halos meet at a tiling corner).

    Each edge (i, j) induces two directed *arcs* i->j and j->i; the arcs
    are coloured with an optimal bipartite (Konig) edge colouring so that
    within one colour class every device sends to at most one partner and
    receives from at most one (possibly different) partner.  One
    collective permute of a single packed ``h``-lane buffer per class
    moves every arc of the class — exactly ``rounds = max degree`` of the
    neighbour graph permutes per iteration, regardless of how many edges
    meet at a device (the greedy undirected matching schedule needed up
    to ``2*maxdeg - 1``).  Payloads are padded to the widest edge (``h``
    lanes); slot ``w`` of the padded local vector is the dump slot both
    for gather padding (reads zero) and scatter padding.

    Attributes:
      p: subdomain count.
      w: padded local slot width (= ``max |col_set|``, the PackedDD pad
        width); also the dump slot index.
      h: widest per-edge shared-column count (payload lanes per round).
      rounds: number of colour classes (= ppermute rounds per iteration
        = max degree of the neighbour graph).
      edges: ((i, j), ...) with i < j — column-sharing subdomain pairs.
      shared: per edge, the ascending global column indices both own.
      send_slots: per edge, ``(slots_in_i, slots_in_j)`` — positions of
        ``shared`` inside each endpoint's local column set.  Endpoint i
        gathers its payload at ``slots_in_i`` and endpoint j scatters the
        received payload at ``slots_in_j`` (and vice versa): the send map
        of one side *is* the recv map of the other.
      perms: per round, the ((src, dst), ...) directed arcs handed to
        ppermute — each device appears at most once as src and at most
        once as dst per round.
      pack_idx: (p, rounds, h) int32 — device d's round-r *send* buffer
        lane k gathers from local slot ``pack_idx[d, r, k]`` (``w`` =
        dump: reads the zero pad, for unused lanes and idle senders).
      unpack_idx: (p, rounds, h) int32 — device d's round-r *received*
        buffer lane k scatter-adds into local slot
        ``unpack_idx[d, r, k]`` (``w`` = dump for unused lanes and idle
        receivers).  Separate from ``pack_idx`` because in a directed
        round d's send partner need not be its recv partner.
    """

    p: int
    w: int
    h: int
    rounds: int
    edges: tuple
    shared: tuple
    send_slots: tuple
    perms: tuple
    pack_idx: np.ndarray
    unpack_idx: np.ndarray

    def edge_send_bytes(self, itemsize: int) -> dict:
        """Per-iteration bytes each endpoint of each edge sends, keyed
        ``"i-j"`` (JSON-friendly) — the single source of the per-edge
        pricing every accounting layer (``ddkf.comm_model``,
        ``PackedDD.edge_send_bytes``, the bench JSON) derives from."""
        return {f"{i}-{j}": int(s.size) * int(itemsize)
                for (i, j), s in zip(self.edges, self.shared)}

    def device_send_bytes(self, itemsize: int) -> np.ndarray:
        """(p,) per-iteration bytes each device sends over all its edges."""
        out = np.zeros((self.p,), dtype=np.int64)
        for (i, j), s in zip(self.edges, self.shared):
            out[i] += s.size * int(itemsize)
            out[j] += s.size * int(itemsize)
        return out


def _bipartite_arc_coloring(arcs, p: int) -> list:
    """Colour directed arcs so that within one colour no device sends
    twice and no device receives twice — the send side and the recv side
    are the two shores of a bipartite multigraph, so Konig's theorem
    applies and the alternating-path algorithm below colours the arcs
    with exactly ``maxdeg`` colours (maxdeg = the largest number of
    neighbours any device has; both directions of every edge are arcs,
    so out-degree == in-degree == degree).

    For each arc (u, v): take ``a`` = the smallest colour free at sender
    u and ``b`` = the smallest free at receiver v.  If they differ, walk
    the alternating a/b path starting at v (an a-arc at a receiver, then
    a b-arc at its sender, ...) and swap its colours — the path can never
    reach u (u has no a-arc), so afterwards ``a`` is free at both ends.
    """
    snd: list = [dict() for _ in range(p)]   # sender side: colour -> arc
    rcv: list = [dict() for _ in range(p)]   # receiver side
    color = [-1] * len(arcs)

    def mex(used):
        c = 0
        while c in used:
            c += 1
        return c

    for e, (u, v) in enumerate(arcs):
        a = mex(snd[u])
        b = mex(rcv[v])
        if a != b:
            # Collect the maximal a/b-alternating path from v, then flip.
            path = []
            node, node_is_rcv, want = v, True, a
            while True:
                table = rcv[node] if node_is_rcv else snd[node]
                arc = table.get(want)
                if arc is None:
                    break
                path.append(arc)
                au, av = arcs[arc]
                node, node_is_rcv = (au, False) if node_is_rcv else (av, True)
                want = b if want == a else a
            # Two-phase flip: consecutive path arcs share an endpoint, so
            # deleting and re-inserting arc by arc would clobber the
            # neighbour's fresh entry.  Clear every old slot first.
            for arc in path:
                au, av = arcs[arc]
                del snd[au][color[arc]], rcv[av][color[arc]]
            for arc in path:
                au, av = arcs[arc]
                new = b if color[arc] == a else a
                color[arc] = new
                snd[au][new] = arc
                rcv[av][new] = arc
        color[e] = a
        snd[u][a] = e
        rcv[v][a] = e
    return color


# ---------------------------------------------------------------------------
# Geometric 1D decomposition.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Decomposition:
    """A decomposition of I = {0..n-1} into p (possibly overlapping) blocks.

    ``col_sets`` (and the per-column multiplicity derived from them) are
    the source of truth: each subdomain's set is its core ∪ halo columns
    on an *arbitrary* processor graph — 1D interval chains, 2D shelf
    tilings, or anything else that partitions-with-overlap the index set.
    Everything downstream (``ddkf.pack_operator``, the halo schedule)
    reads only these general fields.

    Attributes:
      n: global number of columns (state size).
      col_sets: tuple of p int arrays — column indices per subdomain,
        ascending; sets may share columns (the Schwarz halo) and may be
        empty.
      overlap: halo width s >= 0 the decomposition was built with (eq. 21:
        how many mesh columns/rows each subdomain absorbs per neighbour).
      boundaries: optional (p+1,) float array in [0, 1] — geometric
        interval edges, metadata kept only by the 1D constructor
        :func:`decompose_1d` (subdomain i covers
        [boundaries[i], boundaries[i+1])).  ``None`` for graph-general
        decompositions (2D tilings); nothing in the solver/packing layer
        dereferences it.
    """

    n: int
    col_sets: tuple
    overlap: int
    boundaries: np.ndarray | None = None

    @property
    def p(self) -> int:
        return len(self.col_sets)

    @functools.cached_property
    def column_multiplicity(self) -> np.ndarray:
        """(n,) count of subdomains owning each column (>= 2 on halos).

        This is the weight of the partition-of-unity assembly (eq. 28):
        overlap columns are averaged with weight 1/multiplicity.
        """
        counts = np.zeros(self.n, dtype=np.int64)
        for c in self.col_sets:
            counts[np.asarray(c)] += 1
        return counts

    @property
    def has_overlap(self) -> bool:
        """True iff some column is shared (multiplicity > 1) — what gates
        the mu-regularization term of eq. 25/26."""
        return bool(self.column_multiplicity.max(initial=0) > 1)

    @property
    def pad_width(self) -> int:
        """The padded local slot width w = max |col_set| (>= 1) — the
        layout ``ddkf.pack_operator`` packs into and the dump slot index
        of the halo-exchange payload maps."""
        return max(1, max((int(np.asarray(c).shape[0])
                           for c in self.col_sets), default=1))

    @functools.cached_property
    def halo_sizes(self) -> np.ndarray:
        """(p,) count of halo columns (multiplicity > 1) each subdomain
        carries — the per-subdomain overlap work the overlap-aware DyDD
        weighting adds to the observation loads."""
        counts = self.column_multiplicity
        return np.array([int((counts[np.asarray(c)] > 1).sum())
                         for c in self.col_sets], dtype=np.int64)

    @functools.cached_property
    def halo_fraction(self) -> float:
        """Fraction of owned column slots that are halo (shared) slots —
        0.0 for a non-overlapping decomposition."""
        total = sum(int(np.asarray(c).shape[0]) for c in self.col_sets)
        return float(self.halo_sizes.sum() / total) if total else 0.0

    @functools.cached_property
    def halo_exchange(self) -> HaloExchange:
        """Cached neighbour-exchange schedule (see :class:`HaloExchange`).

        Edges are discovered from actual ``col_sets`` intersections via an
        inverted owner index (O(n * multiplicity^2)), so the schedule is
        correct on any graph — including the halo∩halo pairs a wide
        overlap creates between non-adjacent subdomains.  Empty-core
        subdomains own no columns, so they acquire no edges and their
        ``pack_idx``/``unpack_idx`` rows are all dump.
        """
        with trace_mod.span("halo.build", p=self.p,
                            overlap=int(self.overlap)):
            return self._build_halo_exchange()

    def _build_halo_exchange(self) -> HaloExchange:
        sets = [np.asarray(c) for c in self.col_sets]
        w = self.pad_width
        # Inverted index: columns with multiplicity > 1 -> owner pairs.
        owners = defaultdict(list)
        for i, c in enumerate(sets):
            for col in c[self.column_multiplicity[c] > 1].tolist():
                owners[col].append(i)
        edge_cols = defaultdict(list)
        for col, own in owners.items():
            for a in range(len(own)):
                for b in range(a + 1, len(own)):
                    edge_cols[(own[a], own[b])].append(col)
        edges = tuple(sorted(edge_cols))
        shared = tuple(np.array(sorted(edge_cols[e]), dtype=np.int64)
                       for e in edges)
        h = max((s.size for s in shared), default=0)
        send_slots = []
        for (i, j), s in zip(edges, shared):
            # col_sets are ascending, so position-in-set == searchsorted.
            si = np.searchsorted(sets[i], s)
            sj = np.searchsorted(sets[j], s)
            send_slots.append((si.astype(np.int64), sj.astype(np.int64)))
        # Directed packed schedule: both arcs of every edge, coloured so
        # each round is a permutation fragment (every device <= 1 send
        # and <= 1 recv).  Konig colouring uses exactly maxdeg rounds.
        arcs = [a for e in edges for a in (e, e[::-1])]
        color = _bipartite_arc_coloring(arcs, self.p)
        rounds = max(color) + 1 if arcs else 0
        pack_idx = np.full((self.p, rounds, h), w, dtype=np.int32)
        unpack_idx = np.full((self.p, rounds, h), w, dtype=np.int32)
        perms: list = [[] for _ in range(rounds)]
        for a, ((src, dst), c) in enumerate(zip(arcs, color)):
            k = a // 2                       # arcs 2k, 2k+1 belong to edge k
            s = shared[k]
            si, sj = send_slots[k]
            ssend, srecv = (si, sj) if src < dst else (sj, si)
            pack_idx[src, c, :s.size] = ssend
            unpack_idx[dst, c, :s.size] = srecv
            perms[int(c)].append((src, dst))
        m = meters_mod.get_meters()
        m.inc("halo.builds")
        m.inc("halo.edges", len(edges))
        m.event("halo.build", p=self.p, overlap=int(self.overlap),
                edges=len(edges), rounds=rounds, payload_lanes=int(h))
        m.gauge("halo.rounds", rounds)
        return HaloExchange(p=self.p, w=w, h=h, rounds=rounds,
                           edges=edges, shared=shared,
                           send_slots=tuple(send_slots),
                           perms=tuple(tuple(pr) for pr in perms),
                           pack_idx=pack_idx, unpack_idx=unpack_idx)

    def overlap_sets(self):
        """I_{i,i+1} — shared indices between consecutive subdomains."""
        out = []
        for i in range(self.p - 1):
            a = set(np.asarray(self.col_sets[i]).tolist())
            b = set(np.asarray(self.col_sets[i + 1]).tolist())
            out.append(np.array(sorted(a & b), dtype=np.int64))
        return out


def mesh_positions(n: int) -> np.ndarray:
    """Cell-centred positions of the n mesh points in [0, 1]."""
    return (np.arange(n) + 0.5) / n


def decompose_1d(n: int, boundaries: Sequence[float],
                 overlap: int = 0) -> Decomposition:
    """Decompose I = {0..n-1} according to geometric interval boundaries.

    Columns are assigned to the interval containing their mesh position;
    each interior boundary then donates ``overlap`` columns to both sides
    (eq. 21: I_2 starts at n_1 - s + 1).
    """
    boundaries = np.asarray(boundaries, dtype=np.float64)
    p = len(boundaries) - 1
    assert boundaries[0] == 0.0 and abs(boundaries[-1] - 1.0) < 1e-12
    pos = mesh_positions(n)
    owner = np.clip(np.searchsorted(boundaries, pos, side="right") - 1, 0,
                    p - 1)
    col_sets = []
    for i in range(p):
        core = np.where(owner == i)[0]
        lo = int(core[0]) if core.size else 0
        hi = int(core[-1]) + 1 if core.size else 0
        lo = max(0, lo - (overlap if i > 0 else 0))
        hi = min(n, hi + (overlap if i < p - 1 else 0))
        col_sets.append(np.arange(lo, hi, dtype=np.int64))
    return Decomposition(n=n, col_sets=tuple(col_sets),
                         boundaries=boundaries, overlap=overlap)


def uniform_boundaries(p: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, p + 1)


def assign_rows(locations: np.ndarray, boundaries: np.ndarray):
    """Assign observation rows to subdomains by spatial location
    (Remark 5: row DD is what DyDD balances)."""
    p = len(boundaries) - 1
    owner = np.clip(np.searchsorted(boundaries, locations, side="right") - 1,
                    0, p - 1)
    return [np.where(owner == i)[0].astype(np.int64) for i in range(p)]
