"""Per-cycle journal for the streaming assimilation engine.

Every cycle appends one :class:`CycleMetrics` record; tests assert on the
records and benchmarks serialize them (``Journal.to_dict`` → JSON).  The
imbalance figures use the max/mean load ratio (1.0 = perfectly balanced,
p = everything on one subdomain) alongside the paper's §6 efficiency
E = min/max.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np


def imbalance_ratio(loads) -> float:
    """max(load) / mean(load) — 1.0 is perfectly balanced."""
    loads = np.asarray(loads, dtype=np.float64)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


@dataclasses.dataclass
class CycleMetrics:
    """One assimilation cycle's worth of accounting."""

    cycle: int
    loads: list                 # per-subdomain observation counts (post-DD)
    loads_before: list          # counts against the *incoming* boundaries
    imbalance: float            # max/mean after any repartition this cycle
    imbalance_before: float     # max/mean against the incoming boundaries
    efficiency: float           # paper's E = min/max after repartition
    repartitioned: bool         # did DyDD fire this cycle?
    migrated: int               # observations moved by the diffusion schedule
    rounds: int                 # scheduling rounds DyDD used
    pack_time: float            # host-side operator packing (s); overlaps
                                # the previous solve under double buffering
    solve_time: float           # device DD-KF solve (s)
    cycle_time: float           # wall time since the previous cycle
                                # completed (s) — the throughput measure;
                                # ~max(pack, solve) when double-buffered

    error_vs_direct: float      # ||x_engine - x_one_shot||, nan if untracked

    # Communication accounting (modelled — solve_shardmap's per-iteration
    # send volume for the cycle's decomposition and configured comm path,
    # times the iteration count; journalled for every solver so vmapped
    # runs still show what a sharded run would move).
    comm_bytes_per_cycle: float = 0.0   # total modelled bytes per cycle
    halo_fraction: float = 0.0          # shared-slot fraction of the
                                        # decomposition (0 = no overlap)
    loads_weighted: list = dataclasses.field(default_factory=list)
                                # obs loads + halo-cost offsets — what the
                                # overlap-aware DyDD schedule balances
                                # (== loads when halo_weight is 0)
    rebalance_suppressed: bool = False
                                # a rebalance trigger armed this cycle but
                                # was suppressed because the previous
                                # cycle's rebalance already left exactly
                                # these loads (an unpopulatable subdomain
                                # would otherwise re-fire the DD step
                                # every cycle)

    # Observability (the telemetry PR's fields — all default-empty so
    # journals written before it round-trip unchanged).
    phases: dict = dataclasses.field(default_factory=dict)
                                # per-phase host durations (s): count,
                                # dydd, halo, pack, data, solve — the
                                # span timings, journalled even when no
                                # tracer is installed
    residual_history: list = dataclasses.field(default_factory=list)
                                # per-iteration Schwarz update norms
                                # ||x^{k+1} - x^k||_F (empty unless
                                # record_residuals)
    comm_edge_bytes_per_cycle: dict = dataclasses.field(
        default_factory=dict)   # "i-j" -> bytes each endpoint sends per
                                # cycle, neighbour-path pricing of the
                                # cycle's halo geometry (modelled for
                                # every comm config, like comm_bytes on
                                # vmapped runs); obs.meters.comm_matrix
                                # turns this into the (p, p) matrix
    comm_mvec_bytes_per_cycle: float = 0.0
                                # m-vector all-reduce bytes per cycle,
                                # summed over devices (comm_bytes_per_
                                # cycle = matrix.sum() + this, neighbour)
    comm_mvec_axis_bytes_per_cycle: dict = dataclasses.field(
        default_factory=dict)   # mesh-axis name -> per-cycle all-reduce
                                # bytes under torus pricing (outer axes
                                # move the full vector per psum hop; the
                                # values sum to comm_mvec_bytes_per_cycle)
    device_solve_times: list = dataclasses.field(default_factory=list)
                                # per-device time-to-shard-ready (s)
                                # since solve dispatch, device order;
                                # [solve_time] on the vmapped path
    straggler_flags: list = dataclasses.field(default_factory=list)
                                # device indices the EWMA-deadline
                                # straggler monitor flagged this cycle
    window: int = -1            # time-window id when the cycle ran under
                                # the parallel-in-time engine (repro.
                                # assim.timepar); -1 on sequential runs.
                                # Deterministic given config (the window
                                # partition is a pure function of the
                                # cycle count), so it stays in the
                                # bitwise deterministic_dict view

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["loads"] = [int(v) for v in self.loads]
        d["loads_before"] = [int(v) for v in self.loads_before]
        d["loads_weighted"] = [int(v) for v in self.loads_weighted]
        d["phases"] = {k: float(v) for k, v in self.phases.items()}
        d["residual_history"] = [float(v) for v in self.residual_history]
        d["comm_edge_bytes_per_cycle"] = {
            k: float(v) for k, v in self.comm_edge_bytes_per_cycle.items()}
        d["comm_mvec_axis_bytes_per_cycle"] = {
            k: float(v)
            for k, v in self.comm_mvec_axis_bytes_per_cycle.items()}
        d["device_solve_times"] = [float(v)
                                   for v in self.device_solve_times]
        d["straggler_flags"] = [int(v) for v in self.straggler_flags]
        # nan (error untracked) is not valid JSON — serialize as null.
        if not np.isfinite(self.error_vs_direct):
            d["error_vs_direct"] = None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CycleMetrics":
        """Inverse of :meth:`to_dict` (null error back to nan); unknown
        keys are ignored so newer journals load on older readers."""
        d = dict(d)
        if d.get("error_vs_direct") is None:
            d["error_vs_direct"] = float("nan")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class Journal:
    """Append-only per-cycle record list with summary statistics.

    ``meta`` carries the domain descriptor (``Domain.describe()`` — ndim,
    mesh shape, tiling) so a serialized journal is self-describing: 2D
    consumers can reshape the flat per-subdomain ``loads`` back into the
    pr x pc cell table.
    """

    records: List[CycleMetrics] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def append(self, rec: CycleMetrics) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def repartition_count(self) -> int:
        return sum(r.repartitioned for r in self.records)

    @property
    def migrated_total(self) -> int:
        return sum(r.migrated for r in self.records)

    @property
    def imbalance_trajectory(self) -> list:
        return [r.imbalance for r in self.records]

    @property
    def cycle_times(self) -> list:
        return [r.cycle_time for r in self.records]

    def phase_stats(self) -> dict:
        """Per-phase p50/p99/mean durations (s) across all cycles, from
        the records' ``phases`` dicts: ``{phase: {p50, p99, mean}}``."""
        series: dict = {}
        for r in self.records:
            for k, v in r.phases.items():
                series.setdefault(k, []).append(float(v))
        return {k: {"p50": float(np.percentile(v, 50)),
                    "p99": float(np.percentile(v, 99)),
                    "mean": float(np.mean(v))}
                for k, v in series.items()}

    def summary(self) -> dict:
        if not self.records:
            return {"cycles": 0}
        imb = np.array(self.imbalance_trajectory)
        times = np.array(self.cycle_times)
        errs = np.array([r.error_vs_direct for r in self.records])
        return {
            "cycles": len(self.records),
            "repartitions": self.repartition_count,
            "repartitions_suppressed": int(sum(
                r.rebalance_suppressed for r in self.records)),
            "migrated_total": self.migrated_total,
            "imbalance_max": float(imb.max()),
            "imbalance_mean": float(imb.mean()),
            "cycle_time_mean": float(times.mean()),
            "cycle_time_max": float(times.max()),
            "pack_time_mean": float(np.mean(
                [r.pack_time for r in self.records])),
            "solve_time_mean": float(np.mean(
                [r.solve_time for r in self.records])),
            "error_max": float(np.nanmax(errs)) if np.isfinite(
                errs).any() else None,
            "comm_bytes_per_cycle_mean": float(np.mean(
                [r.comm_bytes_per_cycle for r in self.records])),
            "halo_fraction_mean": float(np.mean(
                [r.halo_fraction for r in self.records])),
            "phases": self.phase_stats(),
            "straggler_flags_total": int(sum(
                len(r.straggler_flags) for r in self.records)),
            "residual_final_mean": (float(np.mean(
                [r.residual_history[-1] for r in self.records
                 if r.residual_history]))
                if any(r.residual_history for r in self.records)
                else None),
        }

    def to_dict(self) -> dict:
        return {"meta": dict(self.meta),
                "records": [r.to_dict() for r in self.records],
                "summary": self.summary()}

    @classmethod
    def from_dict(cls, d: dict) -> "Journal":
        """Rebuild a journal from ``to_dict`` output (summary is
        recomputed, not trusted)."""
        return cls(records=[CycleMetrics.from_dict(r)
                            for r in d.get("records", [])],
                   meta=dict(d.get("meta", {})))

    # Wall-clock-derived record fields: identical inputs produce
    # different values across runs, so the resume/chaos bitwise
    # comparisons strip them (everything else in a record is a pure
    # function of stream + seed + config).
    NONDETERMINISTIC_FIELDS = ("pack_time", "solve_time", "cycle_time",
                               "phases", "device_solve_times",
                               "straggler_flags")

    def deterministic_dict(self) -> dict:
        """``to_dict`` minus wall-clock fields and resume bookkeeping —
        the view under which an interrupted-and-resumed run must be
        *bitwise identical* to an uninterrupted one.  Straggler flags are
        timing-derived too (an injected straggle changes them by design),
        so they are part of the chaos evidence, not this view."""
        records = []
        for r in self.records:
            d = r.to_dict()
            for k in self.NONDETERMINISTIC_FIELDS:
                d.pop(k, None)
            records.append(d)
        meta = {k: v for k, v in self.meta.items() if k != "resume"}
        return {"meta": meta, "records": records}

    def deterministic_json(self) -> str:
        return json.dumps(self.deterministic_dict(), sort_keys=True)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
