"""Generic load-balancing API on top of the DyDD scheduler.

A copy of ``repro.core.balance`` (numpy) with the port's imports.

This is the bridge between the paper's algorithm and the LM framework
layers: the data pipeline balances *documents/tokens* across data-parallel
shards, and the MoE layer balances *routed tokens* across experts.  Both
reduce to "integer loads on the vertices of a fixed device-topology graph",
which is exactly DyDD's scheduling problem (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import dydd


@dataclasses.dataclass(frozen=True)
class Topology:
    """A device/shard topology graph with precomputed solve operators."""

    p: int
    edges: tuple
    pinvL: np.ndarray       # (p, p) Laplacian pseudo-inverse
    incidence: np.ndarray   # (E, p) signed incidence matrix

    @staticmethod
    def ring(p: int) -> "Topology":
        return Topology.from_edges(p, dydd.ring_edges(p))

    @staticmethod
    def chain(p: int) -> "Topology":
        return Topology.from_edges(p, dydd.chain_edges(p))

    @staticmethod
    def torus2d(rows: int, cols: int) -> "Topology":
        return Topology.from_edges(rows * cols,
                                   dydd.grid_edges(rows, cols, torus=True))

    @staticmethod
    def from_edges(p: int, edges: Sequence) -> "Topology":
        L = dydd.laplacian(p, edges)
        pinvL = np.linalg.pinv(L) if p > 1 else np.zeros((1, 1))
        return Topology(p=p, edges=tuple(edges), pinvL=pinvL,
                        incidence=dydd.incidence_matrix(p, edges))

    def neighbours(self, i: int):
        out = []
        for a, b in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class MovePlan:
    """A concrete migration plan: moves[k] = (src, dst, count)."""

    moves: tuple
    loads_before: np.ndarray
    loads_after: np.ndarray

    @property
    def total_moved(self) -> int:
        return sum(c for _, _, c in self.moves)

    @property
    def efficiency(self) -> float:
        return dydd.balance_ratio(self.loads_after)


def plan(loads: np.ndarray, topo: Topology,
         max_rounds: int = 16) -> MovePlan:
    """Compute a neighbour-only migration plan that levels ``loads``."""
    loads = np.asarray(loads, dtype=np.int64)
    final, schedules = dydd.balance(loads, list(topo.edges),
                                    max_rounds=max_rounds)
    moves = []
    for sch in schedules:
        for (i, j), d in zip(sch.edges, sch.deltas):
            if d > 0:
                moves.append((int(i), int(j), int(d)))
            elif d < 0:
                moves.append((int(j), int(i), int(-d)))
    return MovePlan(moves=tuple(moves), loads_before=loads,
                    loads_after=final)
