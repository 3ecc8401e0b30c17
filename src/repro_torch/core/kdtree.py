"""k-d tree adaptive domain — space-recursive decomposition of Ω ⊂ R².

The shelf tiling (:class:`repro.core.domain.ShelfTiling2D`) constrains
its cells to pr strips x pc columns, so a strongly anisotropic
observation network — mass on a thin diagonal or curved band — wastes
whole cells on empty strips (the ROADMAP's open quadtree/k-d item).
:class:`KDTreeDomain` drops the shelf constraint: the domain is split by
a k-d tree whose leaves are axis-aligned rectangles and whose cut planes
sit at observation *medians* (the space-recursive decomposition line of
D'Amore & Cacciapuoti, arXiv:2312.00007, applied to the DD-DA framework
of arXiv:2203.16535).  Each recursion level halves the leaf budget
(``ceil(k/2)`` / ``floor(k/2)``, so any p >= 1 works) and splits the
rectangle along the axis with the most mesh cells, at the quantile that
balances the two leaf budgets.

DyDD on this domain is the rebuild itself: ``rebalance`` re-derives the
cut planes from the current stream — warm-started in the sense that the
tree *structure* (recursion order, leaf identity) is stable, so the
migration volume is counted rank-by-rank against the previous leaf
assignment, exactly like the 1D/2D DyDD movement accounting.

Cut planes are placed at the midpoint of *distinct* consecutive order
statistics nearest the target quantile, then snapped to the nearest
mesh line (``k / nx`` or ``k / ny``) so leaf rectangles tile whole
raster cells and col_sets align exactly with raster columns.  Ties on a
cut (possible when observation coordinates are themselves quantized to
mesh lines) are kept whole on one side by consistent half-open
semantics, so the tie-dumping failure of the pre-fix ``dydd.migrate_1d``
cannot occur (the realized loads deviate from the targets by at most the
tie-group mass plus the snap quantization).

The processor graph is the leaf face-adjacency graph — irregular, not a
grid — which is precisely what exercises the graph-general
``Decomposition`` machinery: ``decomposition(overlap=s)`` builds per-leaf
*rectangular* col_sets (core cells ∪ s-cell face halos clipped at the
domain boundary), and ``Decomposition.halo_exchange`` discovers the
resulting edge schedule from col_set intersections, so
``ddkf.solve_shardmap(comm="neighbour")`` runs unchanged on a flat
``(p,)`` device mesh with ``ppermute`` rounds between arbitrary leaf
pairs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dd as dd_mod
from repro_torch.core import domain as domain_mod
from repro_torch.core import dydd as dydd_mod


def _clip_unit(x: np.ndarray) -> np.ndarray:
    """Clamp coordinates into [0, 1) — boundary observations (x == 1.0)
    stay in the last cell instead of falling off the half-open grid."""
    return np.clip(x, 0.0, np.nextafter(1.0, 0.0))


class KDTreeDomain:
    """p axis-aligned rectangular leaves of [0,1]² split at obs medians.

    State columns are raster-ordered exactly like the shelf tiling:
    global column ``iy * nx + ix`` is the mesh point at
    ``((ix + 0.5) / nx, (iy + 0.5) / ny)``.  Leaf i's core is the set of
    mesh cells whose centre lies in its rectangle; cores partition the
    mesh because the leaves partition [0,1)² with half-open cuts.
    """

    ndim = 2

    def __init__(self, nx: int, ny: int, p: int,
                 rects: np.ndarray | None = None):
        self.nx, self.ny = int(nx), int(ny)
        self._p = int(p)
        if self._p < 1:
            raise ValueError(f"p must be >= 1 (got {p})")
        self._depth = int(np.ceil(np.log2(self._p))) if self._p > 1 else 0
        self._cx = (np.arange(self.nx) + 0.5) / self.nx
        self._cy = (np.arange(self.ny) + 0.5) / self.ny
        if rects is None:
            # No stream yet: geometric splits (cuts at the budget-weighted
            # rectangle fraction) give a deterministic near-even tiling.
            rects = self._build(np.empty((0, 2)), self._even_targets(0))
        self.rects = np.asarray(rects, np.float64)
        assert self.rects.shape == (self._p, 4)

    # -- Domain protocol statics -------------------------------------------

    @property
    def n(self) -> int:
        return self.nx * self.ny

    @property
    def p(self) -> int:
        return self._p

    # -- tree construction --------------------------------------------------

    def _even_targets(self, m: int) -> np.ndarray:
        t = np.full((self._p,), m // self._p, np.int64)
        t[:m % self._p] += 1
        return t

    def _cells_in(self, lo: float, hi: float, axis: int) -> np.ndarray:
        centers = self._cx if axis == 0 else self._cy
        return centers[(centers >= lo) & (centers < hi)]

    def _choose_cut(self, rect, pts: np.ndarray, axis: int,
                    q: float) -> tuple:
        """(cut plane, split error) along ``axis`` near the q-quantile of
        ``pts``, **snapped to a mesh line** ``k / nx`` (or ``k / ny``) so
        every leaf rectangle tiles whole raster cells and the col_sets
        align exactly with raster columns.  Among the valid lines (each
        side keeps >= 1 mesh cell) the one whose half-open point split
        lands closest to the target quantile wins (NOT the line nearest
        the unsnapped median: on a dense band that can shed a whole
        column's mass to one side), ties to the leftmost line.  The
        returned error ``|#left - q·#pts|`` is what :meth:`_build` uses
        to pick the split *axis*.  A snapped cut can coincide with a
        grid-quantized observation coordinate; ownership and the build's
        split mask are both half-open (``pts < cut`` goes left), so a tie
        group on the line is kept whole on the right side — consistent
        between counting and building, no tie dumping.  Rectangles with a
        single cell along ``axis`` fall back to an unsnapped cut at the
        order-statistics midpoint (kept off observation coordinates)."""
        lo, hi = (rect[0], rect[1]) if axis == 0 else (rect[2], rect[3])
        v = np.sort(pts[:, axis])
        cut = lo + q * (hi - lo)            # geometric fallback
        if v.size >= 2:
            c = int(np.clip(round(q * v.size), 1, v.size - 1))
            gaps = np.where(v[1:] > v[:-1])[0] + 1   # cut positions
            if gaps.size:
                g = int(gaps[np.argmin(np.abs(gaps - c))])
                cut = 0.5 * (v[g - 1] + v[g])
        nmesh = self.nx if axis == 0 else self.ny
        cells = self._cells_in(lo, hi, axis)
        if cells.size >= 2:
            # Valid snap lines: the first cell has index
            # round(cells[0] * nmesh - 0.5), and a cut at line k leaves
            # cells [..k-1] left, [k..] right — k spans (first+1) .. last.
            first = int(round(cells[0] * nmesh - 0.5))
            last = int(round(cells[-1] * nmesh - 0.5))
            ks = np.arange(first + 1, last + 1, dtype=np.int64)
            if v.size >= 2:
                lefts = np.searchsorted(v, ks / nmesh, side="left")
                errs = np.abs(lefts - q * v.size)
                i = int(np.argmin(errs))
                return ks[i] / nmesh, float(errs[i])
            k = int(np.clip(round(cut * nmesh), first + 1, last))
            return k / nmesh, 0.0
        cut = float(np.clip(cut, np.nextafter(lo, 1.0),
                            np.nextafter(hi, 0.0)))
        err = (float(abs(np.searchsorted(v, cut, side="left")
                         - q * v.size)) if v.size else 0.0)
        return cut, err

    def _build(self, pts: np.ndarray, targets: np.ndarray) -> np.ndarray:
        """Leaf rectangles from recursive median splits, leaf-id order.

        ``targets`` (p,) is the per-leaf observation budget (equal split,
        or the halo-cost-adjusted targets of the overlap-aware DyDD);
        each internal node cuts at the quantile that hands the left
        subtree exactly its share of the budget."""
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        out: list = []

        def rec(rect, pts, targets):
            k = targets.shape[0]
            if k == 1:
                out.append(rect)
                return
            kl = (k + 1) // 2
            tot = int(targets.sum())
            q = (float(targets[:kl].sum()) / tot) if tot > 0 else kl / k
            # Candidate axes: any with >= 2 mesh cells (a snappable cut);
            # if neither qualifies, fall back to the historic cell-count
            # heuristic on whichever axis has more.  Among candidates the
            # split with the smaller quantile error wins — on a snapped
            # mesh the nominally "longer" axis can only offer coarse
            # splits (a dense diagonal band sheds a whole column's mass),
            # while the other axis may land nearly exactly on target.
            # Ties: more cells, then the x axis (deterministic).
            ncx = self._cells_in(rect[0], rect[1], 0).size
            ncy = self._cells_in(rect[2], rect[3], 1).size
            axes = [a for a, nc in ((0, ncx), (1, ncy)) if nc >= 2]
            if not axes:
                if ncx != ncy:
                    axes = [0 if ncx > ncy else 1]
                else:
                    axes = [0 if (rect[1] - rect[0])
                            >= (rect[3] - rect[2]) else 1]
            best = None
            for a in axes:
                cut_a, err_a = self._choose_cut(rect, pts, a, q)
                key = (err_a, -(ncx if a == 0 else ncy), a)
                if best is None or key < best[0]:
                    best = (key, a, cut_a)
            _, axis, cut = best
            if axis == 0:
                left = (rect[0], cut, rect[2], rect[3])
                right = (cut, rect[1], rect[2], rect[3])
                mask = pts[:, 0] < cut
            else:
                left = (rect[0], rect[1], rect[2], cut)
                right = (rect[0], rect[1], cut, rect[3])
                mask = pts[:, 1] < cut
            rec(left, pts[mask], targets[:kl])
            rec(right, pts[~mask], targets[kl:])

        rec((0.0, 1.0, 0.0, 1.0), pts,
            np.asarray(targets, np.int64))
        return np.asarray(out, np.float64)

    # -- Domain protocol ----------------------------------------------------

    def _owners(self, obs: np.ndarray) -> np.ndarray:
        x = _clip_unit(obs[:, 0])
        y = _clip_unit(obs[:, 1])
        owner = np.full((obs.shape[0],), -1, np.int64)
        for i, (x0, x1, y0, y1) in enumerate(self.rects):
            inside = (x >= x0) & (y >= y0)
            if x1 < 1.0:
                inside &= x < x1
            if y1 < 1.0:
                inside &= y < y1
            owner[inside & (owner < 0)] = i
        return owner

    def counts(self, obs: np.ndarray) -> np.ndarray:
        owner = self._owners(np.asarray(obs, np.float64))
        return np.bincount(owner, minlength=self._p).astype(np.int64)

    def rebalance(self, obs: np.ndarray,
                  cost_offsets: np.ndarray | None = None
                  ) -> domain_mod.RebalanceInfo:
        obs = np.asarray(obs, np.float64).reshape(-1, 2)
        m = obs.shape[0]
        if cost_offsets is None:
            targets = self._even_targets(m)
        else:
            off = np.maximum(np.rint(np.asarray(cost_offsets)
                                     ).reshape(-1), 0).astype(np.int64)
            if off.shape != (self._p,):
                raise ValueError(f"cost_offsets must have {self._p} "
                                 f"entries, got {off.shape}")
            # Balanced *work* (obs + halo cost) per leaf, converted back
            # to observation budgets exactly like the 1D weighted DyDD.
            work = self._even_targets(m + int(off.sum()))
            targets = dydd_mod._offset_targets(work, off, m)
        owner_before = self._owners(obs)
        self.rects = self._build(obs, targets)
        migrated = int((self._owners(obs) != owner_before).sum())
        return domain_mod.RebalanceInfo(migrated=migrated,
                                        rounds=self._depth)

    def _cell_ranges(self, rect) -> tuple:
        """Half-open (ix0, ix1, iy0, iy1) mesh-cell index window of the
        cells whose centre lies in ``rect``."""
        x0, x1, y0, y1 = rect
        ix0 = int(np.searchsorted(self._cx, x0, side="left"))
        ix1 = int(np.searchsorted(self._cx, x1, side="left"))
        iy0 = int(np.searchsorted(self._cy, y0, side="left"))
        iy1 = int(np.searchsorted(self._cy, y1, side="left"))
        return ix0, ix1, iy0, iy1

    def decomposition(self, overlap: int = 0) -> dd_mod.Decomposition:
        if overlap < 0:
            raise ValueError(f"overlap must be >= 0 (got {overlap})")
        col_sets = []
        for rect in self.rects:
            ix0, ix1, iy0, iy1 = self._cell_ranges(rect)
            if ix1 <= ix0 or iy1 <= iy0:   # empty core: no halo either
                col_sets.append(np.empty((0,), np.int64))
                continue
            x0, x1, y0, y1 = rect
            # Face halos: absorb `overlap` mesh columns/rows across every
            # *interior* face (the domain boundary has no neighbour to
            # absorb from), clipped at the mesh edge.  The expanded
            # window stays rectangular — corners between two interior
            # faces are included, which is what keeps the col_set a
            # contiguous raster rectangle per row.
            hx0 = max(0, ix0 - overlap) if x0 > 0.0 else ix0
            hx1 = min(self.nx, ix1 + overlap) if x1 < 1.0 else ix1
            hy0 = max(0, iy0 - overlap) if y0 > 0.0 else iy0
            hy1 = min(self.ny, iy1 + overlap) if y1 < 1.0 else iy1
            ixs = np.arange(hx0, hx1, dtype=np.int64)
            iys = np.arange(hy0, hy1, dtype=np.int64)
            col_sets.append((iys[:, None] * self.nx
                             + ixs[None, :]).reshape(-1))
        return dd_mod.Decomposition(n=self.n, col_sets=tuple(col_sets),
                                    overlap=overlap, boundaries=None)

    def graph_edges(self) -> list:
        """Leaf face-adjacency graph: (i, j) iff the rectangles share a
        face segment of positive length.  Cut values are shared exactly
        between siblings' descendants, so face matching is exact."""
        edges = set()
        r = self.rects
        for i in range(self._p):
            for j in range(i + 1, self._p):
                xi, xj = r[i], r[j]
                touch_x = (xi[1] == xj[0] or xj[1] == xi[0])
                touch_y = (xi[3] == xj[2] or xj[3] == xi[2])
                span_y = min(xi[3], xj[3]) - max(xi[2], xj[2])
                span_x = min(xi[1], xj[1]) - max(xi[0], xj[0])
                if (touch_x and span_y > 0.0) or (touch_y and span_x > 0.0):
                    edges.add((i, j))
        return sorted(edges)

    def mesh_axes(self) -> tuple:
        # The leaf graph is irregular — no torus axis to map onto — so
        # the device mesh is a flat (p,) chain; ppermute handles the
        # arbitrary leaf-pair edges of the coloured exchange schedule.
        return ("sub",), (self._p,)

    def obs_positions(self, obs: np.ndarray) -> np.ndarray:
        return domain_mod.raster_positions(obs, self.ny)

    @property
    def row_size(self) -> int | None:
        return self.nx

    def load_table(self, loads) -> np.ndarray:
        # Leaves have no grid layout; display them flat in leaf-id order
        # (which is recursion order, i.e. roughly space-filling).
        return np.asarray(loads, np.int64)

    def describe(self) -> dict:
        return {"ndim": 2, "kind": "kdtree", "n": self.n, "p": self._p,
                "nx": self.nx, "ny": self.ny, "depth": self._depth}

    def state_dict(self) -> dict:
        """The mutable cut state, as arrays (checkpoint leaves)."""
        return {"rects": self.rects.copy()}

    def load_state(self, state: dict) -> None:
        r = np.asarray(state["rects"], np.float64)
        assert r.shape == (self._p, 4)
        self.rects = r.copy()
