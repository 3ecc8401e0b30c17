"""DyDD on a 2D domain — the paper's actual setting (Ω ⊂ R², Figures 1-4).

Decomposition is a *shelf* tiling: `pr` horizontal strips whose y-edges can
shift, each strip split into `pc` cells whose x-edges shift independently
per strip.  This is exactly the boundary-shifting migration the paper
draws: Figure 3 moves vertical edges between adjacent subdomains, Figure 1
splits an overloaded neighbour of an empty cell — both are 1D migrations
applied per axis.

Balancing is nested applications of the full 1D DyDD machinery
(:func:`repro.core.dydd.dydd_1d`: DD-step for empty subdomains →
Hu–Blake–Emerson diffusion scheduling → geometric migration):

  1. y-pass: DyDD on the y coordinates over the chain of strips,
  2. x-pass: within each strip, DyDD on that strip's x coordinates over
     the chain of cells.

The pass pair is iterated until the cell loads stop improving (the y-pass
re-targets strip totals, which can shuffle strip membership and leave a
residual the next pass removes), capped at ``max_rounds``; the actual
round count is returned in :class:`DyDD2DResult`.  Both passes move
observations only between *adjacent* subdomains (the diffusion
restriction), and the processor graph of the tiling is the pr × pc grid —
``dydd.grid_edges`` — on which the scheduling step is also validated
(tests assert the geometric result matches the graph schedule's balance
floor).

With ``pr == 1`` the y-pass is a no-op and one round is exactly
``dydd_1d`` on the x coordinates — the degenerate-dimension parity the
domain layer (``repro.core.domain.ShelfTiling2D``) relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dydd


@dataclasses.dataclass
class DyDD2DResult:
    y_edges: np.ndarray          # (pr+1,)
    x_edges: np.ndarray          # (pr, pc+1)
    loads_initial: np.ndarray    # (pr, pc)
    loads_final: np.ndarray     # (pr, pc)
    total_movement: int
    rounds: int = 1              # y-pass/x-pass rounds actually run
    y_tie_ranks: np.ndarray | None = None   # (pr-1,) strip-boundary ties
    x_tie_ranks: np.ndarray | None = None   # (pr, pc-1) per-strip cell ties

    @property
    def efficiency(self) -> float:
        return dydd.balance_ratio(self.loads_final.reshape(-1))


def _split_owners(vals: np.ndarray, edges: np.ndarray,
                  tie_ranks: np.ndarray | None) -> np.ndarray:
    """(m,) subdomain owner of each observation along one axis under the
    rank-split tie rule of :func:`repro.core.dydd._counts`.

    ``tie_ranks=None`` (all-zero ranks) reproduces the historic
    ``searchsorted(side="right")`` clip assignment bit for bit — every
    boundary-tied observation on the right side; with ranks, the first
    ``tie_ranks[k]`` of the observations tied with interior edge ``k+1``
    (in sorted-rank order) count to its left — the same split the 1D
    migration realizes, so the 2D recount sees the loads the schedule
    actually produced instead of dumping whole tie groups on one side.
    """
    vals = np.asarray(vals, np.float64)
    order = np.argsort(vals, kind="stable")
    owners_sorted = dydd._rank_owners(vals[order], edges, tie_ranks,
                                      assume_sorted=True)
    owners = np.empty(vals.shape[0], np.int64)
    owners[order] = owners_sorted
    return owners


def _counts_2d(obs: np.ndarray, y_edges: np.ndarray,
               x_edges: np.ndarray,
               y_tie_ranks: np.ndarray | None = None,
               x_tie_ranks: np.ndarray | None = None) -> np.ndarray:
    """(pr, pc) cell loads under the tie-aware rank-split counting rule
    (``None`` ranks = the historic all-right tie rule, bit for bit)."""
    pr = len(y_edges) - 1
    pc = x_edges.shape[1] - 1
    counts = np.zeros((pr, pc), np.int64)
    rows = _split_owners(obs[:, 1], y_edges, y_tie_ranks)
    for r in range(pr):
        xs = obs[rows == r, 0]
        cols = _split_owners(
            xs, x_edges[r],
            None if x_tie_ranks is None else x_tie_ranks[r])
        counts[r] = np.bincount(cols, minlength=pc)
    return counts


def _pass_2d(obs: np.ndarray, pr: int, pc: int, y_edges: np.ndarray,
             x_edges: np.ndarray,
             cost_offsets: np.ndarray | None = None,
             y_tie_ranks: np.ndarray | None = None,
             x_tie_ranks: np.ndarray | None = None):
    """One y-pass + x-pass round of nested 1D DyDD.  Returns the moved
    edges, the tie ranks realizing them, and the observation migration
    volume of the round.

    ``cost_offsets`` (pr, pc) is the overlap-aware halo-cost table: the
    y-pass sees per-strip row sums, the x-pass each strip's row."""
    moved = 0
    y_tie_ranks = (np.zeros((max(pr - 1, 0),), np.int64)
                   if y_tie_ranks is None
                   else np.asarray(y_tie_ranks, np.int64).copy())
    x_tie_ranks = (np.zeros((pr, max(pc - 1, 0)), np.int64)
                   if x_tie_ranks is None
                   else np.asarray(x_tie_ranks, np.int64).copy())
    # --- y-pass: full 1D DyDD on strip loads (chain of strips) -----------
    if pr > 1:
        res_y = dydd.dydd_1d(
            obs[:, 1], pr, boundaries=y_edges.copy(),
            cost_offsets=(None if cost_offsets is None
                          else cost_offsets.sum(axis=1)),
            tie_ranks=y_tie_ranks)
        y_edges = res_y.boundaries
        y_tie_ranks = res_y.tie_ranks
        moved += res_y.total_movement
    # --- x-pass: per strip, full 1D DyDD on cell loads --------------------
    # Strip membership under the *new* y edges and their rank split: an
    # observation tied with a moved strip boundary lands in the strip the
    # y-pass scheduled it to, not blanket-right.
    x_edges = x_edges.copy()
    rows = _split_owners(obs[:, 1], y_edges, y_tie_ranks)
    for r in range(pr):
        xs = obs[rows == r, 0]
        if xs.size == 0:
            continue  # empty strip: nothing to place, keep its edges
        res_x = dydd.dydd_1d(
            xs, pc, boundaries=x_edges[r].copy(),
            cost_offsets=(None if cost_offsets is None
                          else cost_offsets[r]),
            tie_ranks=x_tie_ranks[r])
        x_edges[r] = res_x.boundaries
        x_tie_ranks[r] = res_x.tie_ranks
        moved += res_x.total_movement
    return y_edges, x_edges, y_tie_ranks, x_tie_ranks, moved


def dydd_2d(obs: np.ndarray, pr: int, pc: int,
            y_edges: np.ndarray | None = None,
            x_edges: np.ndarray | None = None,
            max_rounds: int = 8,
            cost_offsets: np.ndarray | None = None,
            y_tie_ranks: np.ndarray | None = None,
            x_tie_ranks: np.ndarray | None = None) -> DyDD2DResult:
    """Balance m observations (m, 2) in [0,1)² over a pr x pc shelf tiling.

    Starts from the given shelf boundaries (uniform if omitted — pass the
    current edges to warm-start an online rebalance) and iterates the
    y-pass/x-pass pair until every cell's load is within integer rounding
    of m/(pr·pc) or the max deviation stops improving, at most
    ``max_rounds`` times.

    ``cost_offsets`` (pr, pc) adds a fixed per-cell work term (the
    overlap-aware halo weighting — see :func:`repro.core.dydd.dydd_1d`)
    to the loads the nested scheduling passes balance; the convergence
    check then measures deviation of the *weighted* loads.  ``None``
    reproduces the unweighted behaviour bit-for-bit.

    ``y_tie_ranks`` (pr-1,) / ``x_tie_ranks`` (pr, pc-1) carry the
    boundary-tie split state between online rebalances (the 2D analogue
    of ``dydd_1d``'s ``tie_ranks``): when observations sit exactly on a
    shelf edge — quantized coordinates — the recount splits each tie
    group by rank instead of assigning it wholesale rightward, so the
    loads the result reports are the loads the migration realized.  The
    updated ranks come back in the result; thread them into the next
    call together with the edges.
    """
    obs = np.asarray(obs, dtype=np.float64)
    assert obs.ndim == 2 and obs.shape[1] == 2
    m = obs.shape[0]
    if cost_offsets is not None:
        cost_offsets = np.maximum(
            np.rint(np.asarray(cost_offsets)), 0).astype(np.int64)
        if cost_offsets.shape != (pr, pc):
            raise ValueError(f"cost_offsets must be shape ({pr}, {pc}), "
                             f"got {cost_offsets.shape}")

    y_edges = (np.linspace(0.0, 1.0, pr + 1) if y_edges is None
               else np.asarray(y_edges, np.float64).copy())
    x_edges = (np.tile(np.linspace(0.0, 1.0, pc + 1), (pr, 1))
               if x_edges is None
               else np.asarray(x_edges, np.float64).copy())
    y_ranks = (np.zeros((max(pr - 1, 0),), np.int64) if y_tie_ranks is None
               else np.asarray(y_tie_ranks, np.int64).copy())
    x_ranks = (np.zeros((pr, max(pc - 1, 0)), np.int64)
               if x_tie_ranks is None
               else np.asarray(x_tie_ranks, np.int64).copy())
    l_in = _counts_2d(obs, y_edges, x_edges, y_ranks, x_ranks)

    # With halo-cost offsets the target is a balanced *weighted* load:
    # counts + offsets vs the weighted mean.
    off = (np.zeros((pr, pc), np.int64) if cost_offsets is None
           else cost_offsets)
    lbar = (m + off.sum()) / (pr * pc)
    total_moved = 0
    rounds = 0
    best_dev = np.inf
    for _ in range(max(1, max_rounds)):
        y_new, x_new, yr_new, xr_new, moved = _pass_2d(
            obs, pr, pc, y_edges, x_edges, cost_offsets=cost_offsets,
            y_tie_ranks=y_ranks, x_tie_ranks=x_ranks)
        dev = np.abs(_counts_2d(obs, y_new, x_new, yr_new, xr_new)
                     + off - lbar).max()
        if dev >= best_dev:
            break  # no improvement: keep the previous round's edges
        y_edges, x_edges = y_new, x_new
        y_ranks, x_ranks = yr_new, xr_new
        total_moved += moved
        best_dev = dev
        rounds += 1
        if dev < 1.0:
            break

    l_fin = _counts_2d(obs, y_edges, x_edges, y_ranks, x_ranks)
    return DyDD2DResult(y_edges=y_edges, x_edges=x_edges,
                        loads_initial=l_in, loads_final=l_fin,
                        total_movement=total_moved, rounds=rounds,
                        y_tie_ranks=y_ranks, x_tie_ranks=x_ranks)


def make_observations_2d(m: int, kind: str = "clustered",
                         seed: int = 0) -> np.ndarray:
    """2D observation locations: uniform / beta-skewed / clustered."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 1, (m, 2))
    if kind == "beta":
        return np.stack([rng.beta(2, 5, m), rng.beta(5, 2, m)], axis=1)
    centers = rng.uniform(0.15, 0.85, (3, 2))
    c = rng.integers(0, 3, m)
    pts = centers[c] + 0.06 * rng.normal(size=(m, 2))
    return np.clip(pts, 0, 0.999999)


def _owner_ranges(owner: np.ndarray, k: int):
    """Contiguous index range [lo, hi) owned by each of k owners (owner is
    monotone, from searchsorted on monotone edges)."""
    out = []
    for i in range(k):
        idx = np.where(owner == i)[0]
        if idx.size:
            out.append((int(idx[0]), int(idx[-1]) + 1))
        else:
            out.append((0, 0))
    return out


def cell_col_sets(nx: int, ny: int, y_edges: np.ndarray,
                  x_edges: np.ndarray, overlap: int = 0):
    """Map a raster-ordered nx x ny mesh onto the tiling: the 2D analogue
    of ``dd.decompose_1d`` (Remark 4's I x J decomposition).  Returns a
    list of pr*pc int arrays of global column indices (cell (r, c) is
    entry ``r * pc + c``).

    With ``overlap = s > 0`` each cell's set is core ∪ halo (eq. 21-22
    applied per axis of the grid graph): the cell absorbs ``s`` mesh
    columns from its left/right neighbour cells *within its own strip
    rows*, and ``s`` mesh rows from the strips above/below *within its
    own x-window* — a cross-shaped (grid-graph-neighbour) halo, clipped
    at the shelf seams and the domain boundary.  Diagonal (non-neighbour)
    corners are not absorbed; assembly weights follow from the resulting
    column multiplicity, nothing here needs to be conforming across
    strips.  A cell with an empty core stays empty.
    """
    assert overlap >= 0
    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    pr = len(y_edges) - 1
    pc = x_edges.shape[1] - 1
    row_owner = np.clip(np.searchsorted(y_edges, ys, side="right") - 1,
                        0, pr - 1)
    row_rng = _owner_ranges(row_owner, pr)
    out = []
    for r in range(pr):
        ry0, ry1 = row_rng[r]
        col_owner = np.clip(np.searchsorted(x_edges[r], xs,
                                            side="right") - 1, 0, pc - 1)
        col_rng = _owner_ranges(col_owner, pc)
        for c in range(pc):
            rx0, rx1 = col_rng[c]
            if ry1 <= ry0 or rx1 <= rx0:      # empty core: no halo either
                out.append(np.empty((0,), dtype=np.int64))
                continue
            mask = np.zeros((ny, nx), dtype=bool)
            # core + left/right halo along this strip's own rows
            lx0 = max(0, rx0 - (overlap if c > 0 else 0))
            lx1 = min(nx, rx1 + (overlap if c < pc - 1 else 0))
            mask[ry0:ry1, lx0:lx1] = True
            # up/down halo rows from the neighbour strips, kept inside the
            # cell's own x-window (clipped at the shelf seam)
            if overlap > 0:
                if r > 0:
                    mask[max(0, ry0 - overlap):ry0, rx0:rx1] = True
                if r < pr - 1:
                    mask[ry1:min(ny, ry1 + overlap), rx0:rx1] = True
            out.append(np.where(mask.reshape(-1))[0].astype(np.int64))
    return out
