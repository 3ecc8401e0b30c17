"""DyDD — Dynamic Domain Decomposition load balancing (paper §5, Table 13).

The four steps of procedure DyDD:

  1. DD step        — if a subdomain is empty, split the adjacent subdomain
                      with maximum load in two (geometrically, at its
                      midpoint) and re-assign.
  2. Scheduling     — on the processor graph G (vertex i = subdomain i,
                      value l_i = #observations), solve the graph-Laplacian
                      system  L lambda = b,  b_i = l_i - lbar, and set the
                      per-edge migration delta_ij = round(lambda_i-lambda_j).
                      This is the Hu-Blake-Emerson diffusion schedule that
                      minimizes ||delta||_2 and keeps all movement between
                      *adjacent* subdomains.
  3. Migration      — shift the geometric boundaries of adjacent subdomains
                      so that exactly |delta_ij| observations change side.
  4. Update         — re-map subdomains to processors / recompute loads.

The scheduling runs host-side in numpy (`schedule`, `dydd_1d`): the
p x p solve is microseconds, cheaper than any device round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.obs import meters as meters_mod


Edge = tuple  # (i, j) with i < j


# ---------------------------------------------------------------------------
# Graphs.
# ---------------------------------------------------------------------------

def chain_edges(p: int) -> list:
    """Path graph 0-1-...-(p-1) — Example 4's configuration (deg(i)<=2),
    and the natural graph of a 1D geometric decomposition."""
    return [(i, i + 1) for i in range(p - 1)]


def star_edges(p: int) -> list:
    """Star graph centred at 0 — Example 3's configuration (deg(0)=p-1)."""
    return [(0, i) for i in range(1, p)]


def ring_edges(p: int) -> list:
    """Ring — the graph of a TPU mesh axis (ICI torus dimension)."""
    if p == 1:
        return []
    if p == 2:
        return [(0, 1)]
    return [(i, (i + 1) % p) for i in range(p)]


def grid_edges(rows: int, cols: int, torus: bool = True) -> list:
    """2D grid/torus — the graph of a TPU (data, model) mesh slice."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((0, 1), (1, 0)):
                rr, cc = r + dr, c + dc
                if torus:
                    rr, cc = rr % rows, cc % cols
                elif rr >= rows or cc >= cols:
                    continue
                j = rr * cols + cc
                if i != j:
                    edges.add((min(i, j), max(i, j)))
    return sorted(edges)


def laplacian(p: int, edges: Sequence[Edge]) -> np.ndarray:
    """Graph Laplacian L (eq. 29): L_ii = deg(i), L_ij = -1 on edges."""
    L = np.zeros((p, p), dtype=np.float64)
    for i, j in edges:
        L[i, j] -= 1.0
        L[j, i] -= 1.0
        L[i, i] += 1.0
        L[j, j] += 1.0
    return L


def degrees(p: int, edges: Sequence[Edge]) -> np.ndarray:
    d = np.zeros((p,), dtype=np.int64)
    for i, j in edges:
        d[i] += 1
        d[j] += 1
    return d


# ---------------------------------------------------------------------------
# Scheduling step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """A diffusion schedule: per-edge signed integer migrations.

    deltas[k] > 0 means move that many observations from edges[k][0] to
    edges[k][1]; < 0 the other way.  Conservation holds exactly:
    sum(new_loads) == sum(loads).
    """

    edges: tuple
    deltas: np.ndarray   # (E,) int
    lam: np.ndarray      # (p,) the potential lambda (diagnostic)

    def apply(self, loads: np.ndarray) -> np.ndarray:
        new = np.asarray(loads, dtype=np.int64).copy()
        for (i, j), d in zip(self.edges, self.deltas):
            new[i] -= d
            new[j] += d
        return new

    @property
    def total_movement(self) -> int:
        return int(np.abs(self.deltas).sum())


def _solve_laplacian_cg(edges_arr: np.ndarray, deg: np.ndarray,
                        b: np.ndarray, tol: float = 1e-10,
                        maxiter: int | None = None) -> np.ndarray:
    """Matrix-free CG for L lam = b on the span{1}-orthogonal complement.

    O(|E|) per iteration and ~O(graph diameter) iterations — this is what
    keeps the scheduling step microseconds at p = 4096 (64x64 torus) and
    beyond, the 1000+-node requirement (DESIGN.md §3)."""
    p = deg.shape[0]
    src, dst = edges_arr[:, 0], edges_arr[:, 1]

    def apply_L(x):
        out = deg * x
        np.subtract.at(out, src, x[dst])
        np.subtract.at(out, dst, x[src])
        return out

    b = b - b.mean()
    x = np.zeros(p)
    r = b.copy()
    q = r.copy()
    rs = r @ r
    maxiter = maxiter or 4 * p
    cg_hist = meters_mod.get_meters().series["dydd.cg_residual"]
    for _ in range(maxiter):
        cg_hist.append(float(np.sqrt(rs)))
        if rs < tol * tol * max(b @ b, 1e-30):
            break
        Lq = apply_L(q)
        alpha = rs / max(q @ Lq, 1e-300)
        x += alpha * q
        r -= alpha * Lq
        rs_new = r @ r
        q = r + (rs_new / max(rs, 1e-300)) * q
        rs = rs_new
    return x - x.mean()


def schedule(loads: np.ndarray, edges: Sequence[Edge]) -> Schedule:
    """One scheduling step: solve L lambda = (l - lbar), delta = round(dlam).

    L is singular with nullspace span{1}; b sums to ~0 (up to the fractional
    part of lbar) so the min-norm lstsq solution is the Hu-Blake-Emerson
    schedule.  Verified against the paper's §5 worked example in tests.
    Small graphs use dense lstsq; large ones (p > 512) the matrix-free CG.
    """
    loads = np.asarray(loads, dtype=np.float64)
    p = loads.shape[0]
    if p == 1 or not edges:
        return Schedule(edges=tuple(edges), deltas=np.zeros((0,), np.int64),
                        lam=np.zeros((p,)))
    b = loads - loads.mean()
    if p <= 512:
        L = laplacian(p, edges)
        lam, *_ = np.linalg.lstsq(L, b, rcond=None)
    else:
        edges_arr = np.asarray(edges, dtype=np.int64)
        lam = _solve_laplacian_cg(edges_arr, degrees(p, edges).astype(
            np.float64), b)
    edges_arr = np.asarray(edges, dtype=np.int64)
    deltas = np.rint(lam[edges_arr[:, 0]]
                     - lam[edges_arr[:, 1]]).astype(np.int64)
    return Schedule(edges=tuple(edges), deltas=deltas, lam=lam)


def balance(loads: np.ndarray, edges: Sequence[Edge],
            max_rounds: int = 64):
    """Iterate scheduling until the max deviation from the average load is
    within the rounding floor (Table 13 'repeat ... until' loop).

    Returns (final_loads, list_of_schedules).  Each round only moves data
    between graph neighbours; loads never go negative (moves are clamped by
    re-solving on the residual graph if a vertex would overdraw —
    in practice the lstsq schedule never overdraws on connected graphs
    with non-negative loads, but we guard anyway).
    """
    loads = np.asarray(loads, dtype=np.int64).copy()
    total = int(loads.sum())
    p = loads.shape[0]
    schedules = []
    for _ in range(max_rounds):
        lbar = total / p
        dev = np.abs(loads - lbar).max()
        # Keep scheduling until within integer rounding of the average
        # (the worked example of §5 reaches the exact average); the
        # total_movement == 0 break below is the paper's deg/2 floor in
        # practice — once the lstsq potentials round to zero everywhere,
        # no further neighbour move can help.
        if dev < 1.0:
            break
        sch = schedule(loads, edges)
        if sch.total_movement == 0:
            break
        new = sch.apply(loads)
        if new.min() < 0:
            # Clamp: scale this round's deltas down to keep feasibility.
            scale = 0.5
            sch = Schedule(edges=sch.edges,
                           deltas=(sch.deltas * scale).astype(np.int64),
                           lam=sch.lam)
            new = sch.apply(loads)
            if new.min() < 0 or sch.total_movement == 0:
                break
        loads = new
        schedules.append(sch)
    assert int(loads.sum()) == total, "conservation violated"
    m = meters_mod.get_meters()
    m.inc("dydd.schedule_rounds", len(schedules))
    m.inc("dydd.scheduled_movement",
          sum(s.total_movement for s in schedules))
    return loads, schedules


def balance_ratio(loads: np.ndarray) -> float:
    """E = min(l)/max(l) (paper §6) — 1.0 is perfectly balanced."""
    loads = np.asarray(loads, dtype=np.float64)
    mx = loads.max()
    return float(loads.min() / mx) if mx > 0 else 1.0


@dataclasses.dataclass
class DyDDResult:
    boundaries: np.ndarray          # (p+1,) final interval edges
    loads_initial: np.ndarray       # l_in
    loads_repartitioned: np.ndarray  # l_r (after DD step; = l_in if no empty)
    loads_final: np.ndarray         # l_fin
    rounds: int
    total_movement: int             # observations whose owner changed
    repartitioned: bool
    tie_ranks: np.ndarray | None = None  # (p-1,) rank split of boundary ties
    scheduled_movement: int = 0     # sum |delta| over scheduling rounds

    @property
    def efficiency(self) -> float:
        return balance_ratio(self.loads_final)


def _counts(obs: np.ndarray, boundaries: np.ndarray,
            tie_ranks: np.ndarray | None = None,
            assume_sorted: bool = False) -> np.ndarray:
    """Per-subdomain observation counts under a rank-split tie rule.

    ``tie_ranks[k]`` is the number of observations *exactly equal to*
    interior boundary ``boundaries[k+1]`` that count to its left side;
    ``None`` means all-zero ranks, which reproduces the historic
    ``searchsorted(side="right")`` counting bit for bit (every tied
    observation on the right side).  Counting is cumulative — the number
    of observations in subdomains ``0..k`` is the number strictly below
    boundary k+1 plus that boundary's tie rank — so equal-valued interior
    boundaries (collapsed by the DD step) and out-of-order guards need no
    special casing.  ``assume_sorted`` skips the sort for hot-loop
    callers that hold ``obs`` ascending already."""
    p = len(boundaries) - 1
    obs_sorted = np.asarray(obs, np.float64)
    if not assume_sorted:
        obs_sorted = np.sort(obs_sorted)
    interior = np.asarray(boundaries[1:p], np.float64)
    cum = np.searchsorted(obs_sorted, interior, side="left")
    if tie_ranks is not None:
        eq = np.searchsorted(obs_sorted, interior, side="right") - cum
        cum = cum + np.clip(np.asarray(tie_ranks, np.int64), 0, eq)
    cum = np.concatenate([[0], np.maximum.accumulate(cum),
                          [obs_sorted.size]])
    return np.diff(cum).astype(np.int64)


def _rank_owners(obs: np.ndarray, boundaries: np.ndarray,
                 tie_ranks: np.ndarray | None = None,
                 assume_sorted: bool = False) -> np.ndarray:
    """(m,) owner of each *sorted-rank* observation slot — tied
    observations are interchangeable, so the per-rank assignment is the
    minimal-movement matching between two decompositions."""
    counts = _counts(obs, boundaries, tie_ranks,
                     assume_sorted=assume_sorted)
    return np.repeat(np.arange(counts.shape[0]), counts)


def _repartition_empty(obs: np.ndarray, boundaries: np.ndarray,
                       tie_ranks: np.ndarray | None):
    """DD step (paper Fig. 1): while some subdomain is empty, split the
    *adjacent* subdomain with maximum load at its geometric midpoint and
    give the empty subdomain the half adjacent to it.  Boundaries that
    move reset their tie rank (a fresh geometric cut owns no tie split);
    unmoved boundaries keep theirs.  Returns (boundaries, tie_ranks)."""
    obs = np.sort(np.asarray(obs, np.float64))
    boundaries = boundaries.copy()
    p = len(boundaries) - 1
    ranks = (np.zeros((max(p - 1, 0),), np.int64) if tie_ranks is None
             else np.asarray(tie_ranks, np.int64).copy())
    for _ in range(4 * p):  # termination guard
        counts = _counts(obs, boundaries, ranks, assume_sorted=True)
        empties = np.where(counts == 0)[0]
        if empties.size == 0:
            break
        i = int(empties[0])
        nbrs = [j for j in (i - 1, i + 1) if 0 <= j < p and counts[j] > 0]
        if not nbrs:
            break  # isolated empty region with empty neighbours: next round
        m = max(nbrs, key=lambda j: counts[j])
        lo, hi = boundaries[m], boundaries[m + 1]
        mid = 0.5 * (lo + hi)
        if m < i:       # donate the right half of the neighbour
            boundaries[i] = mid     # i's left edge moves down to mid
            # intermediate boundaries between m+1..i collapse onto mid
            boundaries[m + 1:i] = mid
            ranks[m:i] = 0
        else:           # donate the left half of the neighbour
            boundaries[i + 1] = mid
            boundaries[i + 2:m + 1] = mid
            ranks[i:m] = 0
    return boundaries, ranks


def repartition_empty_1d(obs: np.ndarray,
                         boundaries: np.ndarray) -> np.ndarray:
    """Historic DD-step entry point: boundaries only, all-right tie rule."""
    return _repartition_empty(obs, boundaries, None)[0]


def migrate_1d(obs: np.ndarray, boundaries: np.ndarray,
               target_counts: np.ndarray, assume_sorted: bool = False):
    """Migration step: shift interior boundaries left-to-right so subdomain i
    contains exactly target_counts[i] observations (paper Fig. 3).

    Works for chain-adjacent (1D) decompositions: boundary k is placed
    between the cumsum(target)[k]-th and +1-th order statistic of obs.
    When those order statistics tie, no geometric boundary can realize
    the cut — the boundary sits *on* the tied value and the returned
    ``tie_ranks[k]`` records how many of the tied observations belong to
    its left (an index-based rank split; see :func:`_counts`), so the
    scheduled targets are realized exactly instead of dumping the whole
    tie group on one side.

    Returns ``(boundaries, tie_ranks)``.
    """
    obs_sorted = np.asarray(obs, np.float64)
    if not assume_sorted:
        obs_sorted = np.sort(obs_sorted)
    m = obs_sorted.shape[0]
    p = len(boundaries) - 1
    csum = np.clip(np.cumsum(target_counts)[:-1], 0, m).astype(np.int64)
    new = boundaries.copy()
    for k, c in enumerate(csum):
        c = int(c)
        if c == 0:
            new[k + 1] = boundaries[0]
        elif c == m:
            new[k + 1] = boundaries[-1]
        elif obs_sorted[c - 1] < obs_sorted[c]:
            new[k + 1] = 0.5 * (obs_sorted[c - 1] + obs_sorted[c])
        else:
            new[k + 1] = obs_sorted[c]   # tied cut: boundary on the value
    # Keep edges monotone.
    for k in range(1, len(new)):
        new[k] = max(new[k], new[k - 1])
    new[-1] = boundaries[-1]
    # Rank split: place c - #(obs < boundary) of the boundary-tied
    # observations on the left so the cumulative count at boundary k+1 is
    # exactly csum[k].  (The midpoint of two *distinct* order statistics
    # can still round onto one of them in float arithmetic — the uniform
    # formula covers that too.)
    lt = np.searchsorted(obs_sorted, new[1:p], side="left")
    eq = np.searchsorted(obs_sorted, new[1:p], side="right") - lt
    ranks = np.clip(csum - lt, 0, eq).astype(np.int64)
    return new, ranks


def _offset_targets(work_fin: np.ndarray, offsets: np.ndarray,
                    total: int) -> np.ndarray:
    """Convert balanced *work* loads back to observation targets.

    work_i = obs_i + offset_i, so the migration target is
    work_fin - offsets — clipped at zero (a subdomain whose fixed halo
    cost already exceeds its balanced work share can hold no fewer than
    zero observations) and renormalized to conserve the observation
    count, shaving the deficit off the largest targets."""
    t = np.maximum(np.asarray(work_fin, np.int64) - offsets, 0)
    # balance() conserves totals, so sum(work_fin) = total + sum(offsets)
    # and the clip can only push sum(t) *above* total — never below.
    diff = int(t.sum()) - int(total)
    assert diff >= 0, "balance() under-conserved the weighted loads"
    while diff > 0:
        # diff > 0 implies t.sum() > total >= 0, so max(t) >= 1.
        i = int(np.argmax(t))
        take = min(diff, int(t[i]))
        t[i] -= take
        diff -= take
    return t


def dydd_1d(obs: np.ndarray, p: int,
            boundaries: np.ndarray | None = None,
            max_rounds: int = 64,
            cost_offsets: np.ndarray | None = None,
            tie_ranks: np.ndarray | None = None) -> DyDDResult:
    """Full DyDD on a 1D domain [0,1] with observation locations ``obs``.

    The processor graph of a 1D chain decomposition is the path graph.
    Returns the balanced boundaries and the before/after loads, mirroring
    the quantities the paper reports (l_in, l_r, l_fin, E).

    ``cost_offsets`` (p,) is the overlap-aware weighting: a fixed
    per-subdomain work term (e.g. halo-column count x weight) added to
    the observation loads *for the scheduling step only*, so subdomains
    that carry wide Schwarz halos are scheduled as busier and receive
    fewer observations.  ``None`` (default) reproduces the unweighted
    behaviour bit-for-bit.

    ``tie_ranks`` (p-1,) carries the incoming boundaries' tie split (see
    :func:`_counts`) for streams with quantized/tied coordinates; the
    result's ``tie_ranks`` must be carried alongside ``boundaries`` by
    stateful callers (``domain.Interval1D`` does).  ``total_movement`` is
    the *true* migration volume — the number of observations whose owner
    changed between the incoming and final decomposition — while the
    diffusion schedule's summed |delta| is in ``scheduled_movement``.
    """
    # Everything below is order-invariant, so sort once up front (the
    # counting/migration/ownership helpers would each re-sort otherwise
    # — ~4p redundant O(m log m) sorts per rebalance in the streaming
    # hot path).
    obs = np.sort(np.asarray(obs, dtype=np.float64))
    if boundaries is None:
        boundaries = np.linspace(0.0, 1.0, p + 1)
    l_in = _counts(obs, boundaries, tie_ranks, assume_sorted=True)

    # 1) DD step.
    b1, t1 = _repartition_empty(obs, boundaries, tie_ranks)
    l_r = _counts(obs, b1, t1, assume_sorted=True)
    repartitioned = not np.array_equal(b1, boundaries)

    # 2) Scheduling (iterated) — on obs + halo-cost work when weighted.
    edges = chain_edges(p)
    if cost_offsets is None:
        l_fin, schedules = balance(l_r, edges, max_rounds=max_rounds)
    else:
        off = np.maximum(np.rint(np.asarray(cost_offsets)), 0).astype(
            np.int64)
        if off.shape != (p,):
            raise ValueError(f"cost_offsets must be shape ({p},), got "
                             f"{off.shape}")
        work_fin, schedules = balance(l_r + off, edges,
                                      max_rounds=max_rounds)
        l_fin = _offset_targets(work_fin, off, int(l_r.sum()))

    # 3) Migration: realize l_fin geometrically + rank-split boundary ties.
    b2, t2 = migrate_1d(obs, b1, l_fin, assume_sorted=True)

    # 4) Update: recount.  Exact by construction of migrate_1d — the rank
    # split realizes every scheduled cut even inside a tie group —
    # *provided* every observation lies within the boundary span.  An
    # out-of-span observation is pinned to an end subdomain by counting
    # but invisible to the cut placement, so a zero end target cannot be
    # realized; those callers get the honest recount (the pre-fix
    # behaviour) instead of a crash.
    l_check = _counts(obs, b2, t2, assume_sorted=True)
    if obs.size == 0 or (obs[0] >= boundaries[0]
                         and obs[-1] <= boundaries[-1]):
        assert np.array_equal(l_check, l_fin), \
            f"migration failed to realize the scheduled targets: " \
            f"{l_check.tolist()} != {l_fin.tolist()}"

    # True migration volume: observations whose owner changed between the
    # incoming and final decomposition (tied observations matched by rank
    # — the minimal reassignment).
    moved = int((_rank_owners(obs, boundaries, tie_ranks,
                              assume_sorted=True)
                 != _rank_owners(obs, b2, t2, assume_sorted=True)).sum())
    return DyDDResult(boundaries=b2, loads_initial=l_in,
                      loads_repartitioned=l_r, loads_final=l_check,
                      rounds=len(schedules),
                      total_movement=moved,
                      repartitioned=repartitioned,
                      tie_ranks=t2,
                      scheduled_movement=sum(s.total_movement
                                             for s in schedules))


def dydd_graph(loads: np.ndarray, edges: Sequence[Edge],
               max_rounds: int = 64):
    """DyDD scheduling on an arbitrary processor graph (star for Example 3,
    grids/tori for the TPU mesh).  Returns (final_loads, schedules)."""
    return balance(loads, edges, max_rounds=max_rounds)
