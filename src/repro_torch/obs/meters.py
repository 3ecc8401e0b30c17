"""Counters / gauges / series registry for the assimilation stack.

One process-wide :class:`Meters` instance (swap it with
:func:`set_meters` for scoped collection) that the engine, the DD-KF
solver, the halo-exchange builder, DyDD and the gram autotuner report
into.  Everything is host-side Python on dict operations — cheap enough
to stay always-on (instruments fire per cycle / per rebalance, never per
solver iteration).

Four instrument kinds:

  * **counter** — monotonically accumulated totals
    (``inc("engine.rebalance.fired")``);
  * **gauge**   — last-written values (``gauge("engine.imbalance", x)``);
  * **series**  — append-only float lists
    (``observe("dydd.cg_residual", r)`` — per-iteration histories);
  * **event**   — timestamped structured payloads
    (``event("gram.autotune", shape=..., block_m=...)`` — the autotune
    decisions, halo-schedule builds, rebalance triggers/suppressions).

``snapshot()`` returns the whole registry as one JSON-ready dict (what
the streaming bench embeds in its report); ``reset()`` clears it.

Meter name taxonomy (dotted, subsystem-first) — the full list lives in
``src/repro/assim/README.md`` §Observability:

    engine.cycles, engine.rebalance.fired, engine.rebalance.suppressed,
    engine.migrated, engine.imbalance, engine.halo_fraction,
    engine.residual_final, engine.straggler.flags,
    solve.comm_bytes_per_cycle,
    halo.builds, halo.edges, halo.rounds,
    dydd.schedule_rounds, dydd.scheduled_movement, dydd.cg_residual,
    gram.autotune
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np


class Meters:
    """A counters/gauges/series/events registry (thread-safe: one lock
    serializes every mutation and export — the serving layer's packing
    pool has many host threads reporting concurrently, and a read-modify-
    write like ``counters[name] += value`` is not atomic under the GIL)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict = defaultdict(float)
        self.gauges: dict = {}
        self.series: dict = defaultdict(list)
        self.events: list = []

    # -- instruments --------------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self.series[name].append(float(value))

    def extend(self, name: str, values) -> None:
        vals = [float(v) for v in values]
        with self._lock:
            self.series[name].extend(vals)

    def event(self, name: str, **payload) -> None:
        rec = {"name": name, "t": time.time(), **payload}
        with self._lock:
            self.events.append(rec)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable view of everything recorded so far."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "series": {k: list(v) for k, v in self.series.items()},
                "events": [dict(e) for e in self.events],
            }

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.series.clear()
            self.events.clear()


_ACTIVE = Meters()


def get_meters() -> Meters:
    return _ACTIVE


def set_meters(meters: Optional[Meters]) -> Meters:
    """Install a registry (None = a fresh one); returns the previous."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = meters if meters is not None else Meters()
    return prev


# ---------------------------------------------------------------------------
# Comm-matrix helper: per-edge bytes dict -> dense (p, p) matrix.
# ---------------------------------------------------------------------------

def comm_matrix(p: int, per_edge_bytes: dict) -> np.ndarray:
    """(p, p) per-device-pair send-bytes matrix from the ``"i-j"``-keyed
    per-edge dict (:meth:`HaloExchange.edge_send_bytes` /
    ``comm_model()["per_edge_bytes"]``).

    Entry [i, j] is what device i sends to device j; the neighbour
    exchange is symmetric (both endpoints send the shared slots), so the
    matrix is too, and ``matrix.sum()`` equals the model's
    ``state_bytes_total`` at the same itemsize/iteration scaling.
    """
    M = np.zeros((p, p), dtype=np.float64)
    for key, b in per_edge_bytes.items():
        i, j = (int(v) for v in key.split("-"))
        M[i, j] += float(b)
        M[j, i] += float(b)
    return M
