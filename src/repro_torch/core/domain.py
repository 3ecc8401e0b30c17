"""Dimension-agnostic domain layer for the streaming DD-KF engine.

The paper's setting is Ω ⊂ R² (Figures 1-4), but the streaming engine of
PR 1 was hardwired to 1D interval boundaries.  This module abstracts the
four domain responsibilities the engine needs behind one protocol:

  * **count**   — per-subdomain observation loads against the *current*
                  boundaries (what the rebalance trigger policy reads);
  * **rebalance** — run DyDD (DD-step for empty subdomains, diffusion
                  scheduling on the processor graph, geometric boundary
                  migration) and adopt the moved boundaries;
  * **decompose** — emit a :class:`repro.core.dd.Decomposition` of the
                  raster-ordered state mesh for the operator packing;
  * **graph**   — expose the processor adjacency used by the scheduling
                  step (chain in 1D, pr x pc grid in 2D).

Two implementations:

  * :class:`Interval1D`   — wraps ``dydd.dydd_1d`` / ``dd.decompose_1d``
    (the PR 1 behaviour, bit-for-bit).
  * :class:`ShelfTiling2D` — wraps ``dydd2d.dydd_2d`` /
    ``dydd2d.cell_col_sets``: a shelf tiling of pr strips x pc cells whose
    y- and per-strip x-edges migrate independently (the paper's Figure 3
    moves applied per axis), with the empty-cell DD-step of Figure 1.

A ``ShelfTiling2D`` with ``pr == 1`` and ``ny == 1`` degenerates *exactly*
to ``Interval1D`` — same loads, same boundaries, same decomposition, same
observation raster positions — which ``tests/test_assim.py`` asserts
bit-for-bit against the 1D engine.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import dd as dd_mod
from repro_torch.core import dydd as dydd_mod
from repro_torch.core import dydd2d as dydd2d_mod


def raster_positions(obs: np.ndarray, ny: int) -> np.ndarray:
    """(m,) row-continuous raster coordinate of 2D observations on an
    ny-row mesh: the observation keeps its continuous x within the mesh
    row its y falls in, so column ``row * nx + floor(x * nx)`` is the
    nearest mesh point.  The result is clamped strictly below the next
    row's start: an ``x == 1.0`` boundary observation used to alias to
    ``(row + 1) / ny`` — the *next* raster row's first column — and even
    a clamped in-row coordinate can round up across the row seam in
    float arithmetic (``(2 + (1 - eps)) / 4 == 0.75``).  With ``ny == 1``
    this is exactly the identity on in-range x (the 1D convention)."""
    obs = np.asarray(obs, np.float64)
    rows = np.clip((obs[:, 1] * ny).astype(np.int64), 0, ny - 1)
    pos = (rows + np.clip(obs[:, 0], 0.0, 1.0)) / ny
    return np.minimum(pos, np.nextafter((rows + 1.0) / ny, 0.0))


@dataclasses.dataclass(frozen=True)
class RebalanceInfo:
    """What a DyDD run moved: observation migration volume and rounds."""

    migrated: int
    rounds: int


@runtime_checkable
class Domain(Protocol):
    """Protocol of a (re)decomposable assimilation domain.

    ``ndim``/``n``/``p`` are static; ``counts``/``rebalance``/
    ``decomposition`` read (and, for ``rebalance``, advance) the mutable
    boundary state.  ``obs`` arrays are ``(m,)`` for ``ndim == 1`` and
    ``(m, ndim)`` otherwise.
    """

    ndim: int

    @property
    def n(self) -> int:
        """State mesh size (number of columns of A)."""
        ...

    @property
    def p(self) -> int:
        """Number of subdomains (= processors)."""
        ...

    def counts(self, obs: np.ndarray) -> np.ndarray:
        """(p,) observation loads against the current boundaries."""
        ...

    def rebalance(self, obs: np.ndarray,
                  cost_offsets: np.ndarray | None = None) -> RebalanceInfo:
        """Run DyDD on ``obs``; mutates the boundary state.

        ``cost_offsets`` (p,) is the overlap-aware weighting: fixed
        per-subdomain work (halo-column count x weight) added to the
        loads the diffusion schedule balances, so wide halos don't skew
        the migration toward already-loaded subdomains."""
        ...

    def decomposition(self, overlap: int = 0) -> dd_mod.Decomposition:
        """Decompose the raster-ordered state mesh on current boundaries."""
        ...

    def graph_edges(self) -> list:
        """Processor graph edges the diffusion schedule runs on."""
        ...

    def mesh_axes(self) -> tuple:
        """(names, shape) of the device mesh the processor graph maps
        onto: (("sub",), (p,)) for a chain, (("row", "col"), (pr, pc))
        for a grid — subdomain i lives on mesh coordinate
        ``np.unravel_index(i, shape)``."""
        ...

    def obs_positions(self, obs: np.ndarray) -> np.ndarray:
        """(m,) raster-ordered positions in [0, 1) for the observation
        operator (identity in 1D; row-continuous raster coordinate in 2D)."""
        ...

    @property
    def row_size(self) -> int | None:
        """Stencil confinement for ``cls.observation_operator``: the
        raster-row width (nx) on a 2D mesh, None on a 1D mesh (an
        interpolation window may span the whole state vector)."""
        ...

    def load_table(self, loads) -> np.ndarray:
        """Loads shaped for display ((p,) in 1D, (pr, pc) in 2D)."""
        ...

    def describe(self) -> dict:
        """JSON-serializable domain metadata for journals/benchmarks."""
        ...


# ---------------------------------------------------------------------------
# 1D interval domain (PR 1 semantics).
# ---------------------------------------------------------------------------

class Interval1D:
    """p contiguous intervals of [0, 1] with migrating interior edges."""

    ndim = 1

    def __init__(self, n: int, p: int,
                 boundaries: np.ndarray | None = None,
                 tie_ranks: np.ndarray | None = None):
        self._n = int(n)
        self._p = int(p)
        self.boundaries = (np.linspace(0.0, 1.0, p + 1)
                           if boundaries is None
                           else np.asarray(boundaries, np.float64).copy())
        assert self.boundaries.shape == (p + 1,)
        # Rank split of observations tied with an interior boundary (see
        # dydd._counts) — zero means the historic all-right tie rule.
        self.tie_ranks = (np.zeros((max(p - 1, 0),), np.int64)
                          if tie_ranks is None
                          else np.asarray(tie_ranks, np.int64).copy())
        assert self.tie_ranks.shape == (max(p - 1, 0),)

    @property
    def n(self) -> int:
        return self._n

    @property
    def p(self) -> int:
        return self._p

    def counts(self, obs: np.ndarray) -> np.ndarray:
        return dydd_mod._counts(np.asarray(obs, np.float64),
                                self.boundaries, self.tie_ranks)

    def rebalance(self, obs: np.ndarray,
                  cost_offsets: np.ndarray | None = None) -> RebalanceInfo:
        res = dydd_mod.dydd_1d(np.asarray(obs, np.float64), self._p,
                               boundaries=self.boundaries.copy(),
                               cost_offsets=cost_offsets,
                               tie_ranks=self.tie_ranks.copy())
        self.boundaries = res.boundaries
        self.tie_ranks = res.tie_ranks
        return RebalanceInfo(migrated=res.total_movement, rounds=res.rounds)

    def decomposition(self, overlap: int = 0) -> dd_mod.Decomposition:
        return dd_mod.decompose_1d(self._n, self.boundaries,
                                   overlap=overlap)

    def graph_edges(self) -> list:
        return dydd_mod.chain_edges(self._p)

    def mesh_axes(self) -> tuple:
        return ("sub",), (self._p,)

    def obs_positions(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs, np.float64)

    @property
    def row_size(self) -> int | None:
        return None

    def load_table(self, loads) -> np.ndarray:
        return np.asarray(loads, np.int64)

    def describe(self) -> dict:
        return {"ndim": 1, "kind": "interval1d", "n": self._n,
                "p": self._p}

    def state_dict(self) -> dict:
        """The mutable boundary state, as arrays (checkpoint leaves)."""
        return {"boundaries": self.boundaries.copy(),
                "tie_ranks": self.tie_ranks.copy()}

    def load_state(self, state: dict) -> None:
        b = np.asarray(state["boundaries"], np.float64)
        t = np.asarray(state["tie_ranks"], np.int64)
        assert b.shape == (self._p + 1,)
        assert t.shape == (max(self._p - 1, 0),)
        self.boundaries = b.copy()
        self.tie_ranks = t.copy()


# ---------------------------------------------------------------------------
# 2D shelf tiling (the paper's Ω ⊂ R²).
# ---------------------------------------------------------------------------

class ShelfTiling2D:
    """pr horizontal strips x pc cells per strip over an nx x ny mesh.

    State columns are raster-ordered: global column ``iy * nx + ix`` is the
    mesh point at ``((ix + 0.5) / nx, (iy + 0.5) / ny)``.  Subdomain
    ``r * pc + c`` is cell (r, c) of the shelf tiling; the processor graph
    is the pr x pc grid.  ``decomposition(overlap=s)`` gives each cell a
    cross-shaped halo of ``s`` mesh columns/rows absorbed from its
    grid-graph neighbours (``dydd2d.cell_col_sets``), with the
    multiplicity-weighted Schwarz assembly falling out of the general
    :class:`~repro.core.dd.Decomposition` fields.
    """

    ndim = 2

    def __init__(self, nx: int, ny: int, pr: int, pc: int,
                 y_edges: np.ndarray | None = None,
                 x_edges: np.ndarray | None = None,
                 max_rounds: int = 8,
                 y_tie_ranks: np.ndarray | None = None,
                 x_tie_ranks: np.ndarray | None = None):
        self.nx, self.ny = int(nx), int(ny)
        self.pr, self.pc = int(pr), int(pc)
        self.max_rounds = int(max_rounds)
        self.y_edges = (np.linspace(0.0, 1.0, pr + 1)
                        if y_edges is None
                        else np.asarray(y_edges, np.float64).copy())
        self.x_edges = (np.tile(np.linspace(0.0, 1.0, pc + 1), (pr, 1))
                        if x_edges is None
                        else np.asarray(x_edges, np.float64).copy())
        assert self.y_edges.shape == (pr + 1,)
        assert self.x_edges.shape == (pr, pc + 1)
        # Rank splits of observations tied with a shelf edge (see
        # dydd2d._counts_2d) — zero means the historic all-right tie rule.
        self.y_tie_ranks = (np.zeros((max(pr - 1, 0),), np.int64)
                            if y_tie_ranks is None
                            else np.asarray(y_tie_ranks, np.int64).copy())
        self.x_tie_ranks = (np.zeros((pr, max(pc - 1, 0)), np.int64)
                            if x_tie_ranks is None
                            else np.asarray(x_tie_ranks, np.int64).copy())
        assert self.y_tie_ranks.shape == (max(pr - 1, 0),)
        assert self.x_tie_ranks.shape == (pr, max(pc - 1, 0))

    @property
    def n(self) -> int:
        return self.nx * self.ny

    @property
    def p(self) -> int:
        return self.pr * self.pc

    def counts(self, obs: np.ndarray) -> np.ndarray:
        return dydd2d_mod._counts_2d(np.asarray(obs, np.float64),
                                     self.y_edges, self.x_edges,
                                     self.y_tie_ranks,
                                     self.x_tie_ranks).reshape(-1)

    def rebalance(self, obs: np.ndarray,
                  cost_offsets: np.ndarray | None = None) -> RebalanceInfo:
        if cost_offsets is not None:
            cost_offsets = np.asarray(cost_offsets).reshape(self.pr,
                                                            self.pc)
        res = dydd2d_mod.dydd_2d(np.asarray(obs, np.float64),
                                 self.pr, self.pc,
                                 y_edges=self.y_edges.copy(),
                                 x_edges=self.x_edges.copy(),
                                 max_rounds=self.max_rounds,
                                 cost_offsets=cost_offsets,
                                 y_tie_ranks=self.y_tie_ranks.copy(),
                                 x_tie_ranks=self.x_tie_ranks.copy())
        self.y_edges = res.y_edges
        self.x_edges = res.x_edges
        self.y_tie_ranks = res.y_tie_ranks
        self.x_tie_ranks = res.x_tie_ranks
        return RebalanceInfo(migrated=res.total_movement, rounds=res.rounds)

    def decomposition(self, overlap: int = 0) -> dd_mod.Decomposition:
        if overlap < 0:
            raise ValueError(f"overlap must be >= 0 (got {overlap})")
        col_sets = dydd2d_mod.cell_col_sets(self.nx, self.ny, self.y_edges,
                                            self.x_edges, overlap=overlap)
        # boundaries is 1D-interval metadata; a tiling has none (and the
        # solver/packing layer reads only col_sets + multiplicity).
        return dd_mod.Decomposition(n=self.n, col_sets=tuple(col_sets),
                                    overlap=overlap, boundaries=None)

    def graph_edges(self) -> list:
        return dydd_mod.grid_edges(self.pr, self.pc, torus=False)

    def mesh_axes(self) -> tuple:
        return ("row", "col"), (self.pr, self.pc)

    def obs_positions(self, obs: np.ndarray) -> np.ndarray:
        return raster_positions(obs, self.ny)

    @property
    def row_size(self) -> int | None:
        return self.nx

    def load_table(self, loads) -> np.ndarray:
        return np.asarray(loads, np.int64).reshape(self.pr, self.pc)

    def describe(self) -> dict:
        return {"ndim": 2, "kind": "shelf2d", "n": self.n,
                "p": self.p, "nx": self.nx, "ny": self.ny,
                "pr": self.pr, "pc": self.pc}

    def state_dict(self) -> dict:
        """The mutable shelf state, as arrays (checkpoint leaves)."""
        return {"y_edges": self.y_edges.copy(),
                "x_edges": self.x_edges.copy(),
                "y_tie_ranks": self.y_tie_ranks.copy(),
                "x_tie_ranks": self.x_tie_ranks.copy()}

    def load_state(self, state: dict) -> None:
        ye = np.asarray(state["y_edges"], np.float64)
        xe = np.asarray(state["x_edges"], np.float64)
        yt = np.asarray(state["y_tie_ranks"], np.int64)
        xt = np.asarray(state["x_tie_ranks"], np.int64)
        assert ye.shape == (self.pr + 1,)
        assert xe.shape == (self.pr, self.pc + 1)
        assert yt.shape == (max(self.pr - 1, 0),)
        assert xt.shape == (self.pr, max(self.pc - 1, 0))
        self.y_edges = ye.copy()
        self.x_edges = xe.copy()
        self.y_tie_ranks = yt.copy()
        self.x_tie_ranks = xt.copy()


def factor_mesh(n: int) -> tuple:
    """Split n into (nx, ny) with ny = the largest factor <= sqrt(n) —
    the default 2D mesh shape when only a state size is given."""
    ny = max(int(np.sqrt(n)), 1)
    while n % ny:
        ny -= 1
    return n // ny, ny
