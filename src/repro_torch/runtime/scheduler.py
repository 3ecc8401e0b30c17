"""Shared continuous-batching scheduler: FIFO queue + fixed slot table.

A copy of ``repro.runtime.scheduler`` on the port's meters.  In the
reference it is the one admission/retirement engine of every serving
surface: the LM driver (:mod:`repro_torch.launch.serve` admits prompt
requests in waves here) and the assimilation fleet
(:class:`repro_torch.assim.serving.FleetServer` admits streams here).
Both need the same small mechanism — a bounded table of *slots* holding
in-flight work, a FIFO queue of work waiting for a slot, and
admit/retire transitions that never disturb the other occupants — so it
lives here once.

The scheduler is bookkeeping only: it never touches devices and holds
opaque payloads.  Callers decide *when* to admit (each fleet round, each
LM wave) and what a payload means.  Telemetry rides along on the active
:class:`~repro_torch.obs.meters.Meters`: a ``<prefix>queue_depth`` /
``<prefix>active`` gauge pair updated on every transition plus
``<prefix>admit`` / ``<prefix>retire`` events carrying the slot id —
the serving dashboards are built from exactly these.

Thread-safety: all transitions take one internal lock, so producers may
``submit`` from worker threads while a driver loop admits/retires.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import meters as meters_mod


class SlotScheduler:
    """Fixed-capacity slot table with a FIFO admission queue.

    ``capacity=None`` means unbounded (every submission is admissible
    immediately — the fleet's "run everything" mode); a positive integer
    bounds the number of in-flight payloads, with the rest parked in
    arrival order.  Slot ids are stable for the lifetime of an occupancy
    and are recycled lowest-first after retirement, so a capacity-k
    scheduler only ever hands out ids ``0..k-1`` — which is what lets
    the fleet treat a slot id as a position in a bounded batch.
    """

    def __init__(self, capacity: Optional[int] = None,
                 meters_prefix: str = "sched."):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None (unbounded), "
                             f"got {capacity}")
        self.capacity = capacity
        self._prefix = meters_prefix
        self._lock = threading.Lock()
        self._queue: deque = deque()          # (seq, payload) FIFO
        self._slots: Dict[int, Any] = {}      # slot id -> payload
        self._free: List[int] = []            # recycled slot ids (heapless:
                                              # sorted on retire, popped
                                              # lowest-first)
        self._next_slot = 0
        self._seq = itertools.count()
        self._submitted = 0
        self._retired = 0

    # -- transitions -------------------------------------------------------

    def submit(self, payload: Any) -> None:
        """Park a payload on the admission queue (FIFO)."""
        with self._lock:
            self._queue.append((next(self._seq), payload))
            self._submitted += 1
            self._gauges_locked()

    def admit(self, max_new: Optional[int] = None) -> List[Tuple[int, Any]]:
        """Move queued payloads into free slots, in arrival order.

        Returns the newly admitted ``(slot, payload)`` pairs (possibly
        empty).  Admission stops at the capacity bound and, if given, at
        ``max_new`` admissions — the LM driver uses the latter to shape
        waves smaller than the table.
        """
        out: List[Tuple[int, Any]] = []
        m = meters_mod.get_meters()
        with self._lock:
            while self._queue:
                if max_new is not None and len(out) >= max_new:
                    break
                if self.capacity is not None \
                        and len(self._slots) >= self.capacity:
                    break
                _, payload = self._queue.popleft()
                if self._free:
                    slot = self._free.pop(0)
                else:
                    slot = self._next_slot
                    self._next_slot += 1
                self._slots[slot] = payload
                out.append((slot, payload))
            self._gauges_locked()
        for slot, _ in out:
            m.event(self._prefix + "admit", slot=slot)
        return out

    def retire(self, slot: int) -> Any:
        """Free a slot; returns its payload.  The slot id becomes
        reusable by the next :meth:`admit`."""
        with self._lock:
            if slot not in self._slots:
                raise KeyError(f"slot {slot} is not occupied")
            payload = self._slots.pop(slot)
            self._free.append(slot)
            self._free.sort()
            self._retired += 1
            self._gauges_locked()
        meters_mod.get_meters().event(self._prefix + "retire", slot=slot)
        return payload

    # -- views -------------------------------------------------------------

    def active(self) -> Dict[int, Any]:
        """Snapshot of occupied slots (slot id -> payload)."""
        with self._lock:
            return dict(self._slots)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def idle(self) -> bool:
        """True when nothing is queued and nothing is in flight."""
        with self._lock:
            return not self._queue and not self._slots

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"submitted": self._submitted,
                    "retired": self._retired,
                    "active": len(self._slots),
                    "queued": len(self._queue)}

    def _gauges_locked(self) -> None:
        m = meters_mod.get_meters()
        m.gauge(self._prefix + "queue_depth", len(self._queue))
        m.gauge(self._prefix + "active", len(self._slots))
