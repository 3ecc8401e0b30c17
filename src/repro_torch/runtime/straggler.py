"""Straggler detection & mitigation (host-side; DESIGN.md §8).

Two layers of defence:

  1. *Data-induced* stragglers — unequal per-shard work — are prevented
     upstream by the DyDD balancer (the paper's contribution applied to the
     token pipeline; ``data.pipeline.BalancedLoader``).
  2. *Hardware* stragglers — a slow/failing host — are detected here by an
     EWMA step-time deadline.  On a real cluster the runner triggers the
     elastic path (checkpoint -> drop host -> re-mesh, see
     ``runtime.elastic``); in this container the trigger is surfaced to the
     caller and unit-tested with injected timings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch import device as device_mod


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.1
    deadline_factor: float = 3.0     # step slower than 3x EWMA -> straggler
    grace_steps: int = 5             # ignore the first (compile) steps
    consecutive_trigger: int = 2     # require N consecutive slow steps


class StragglerMonitor:
    """Feed per-step wall times; fires ``on_straggler`` when the deadline is
    repeatedly exceeded."""

    def __init__(self, config: StragglerConfig | None = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = config or StragglerConfig()
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.step = 0
        self._slow_streak = 0
        self.events: list = []

    def record(self, seconds: float) -> bool:
        """Returns True if this step was flagged."""
        self.step += 1
        flagged = False
        if self.step <= self.cfg.grace_steps:
            return False
        if self.ewma is None:
            self.ewma = seconds
            return False
        if seconds > self.cfg.deadline_factor * self.ewma:
            self._slow_streak += 1
            if self._slow_streak >= self.cfg.consecutive_trigger:
                flagged = True
                self.events.append((self.step, seconds))
                if self.on_straggler:
                    self.on_straggler(self.step, seconds)
                self._slow_streak = 0
        else:
            self._slow_streak = 0
            a = self.cfg.ewma_alpha
            self.ewma = (1 - a) * self.ewma + a * seconds
        return flagged

    def state_dict(self) -> dict:
        """JSON-ready EWMA/streak state (``events`` stays host-local —
        it's an operator log, not detector state)."""
        return {"ewma": self.ewma, "step": int(self.step),
                "slow_streak": int(self._slow_streak)}

    def load_state(self, state: dict) -> None:
        self.ewma = (None if state.get("ewma") is None
                     else float(state["ewma"]))
        self.step = int(state.get("step", 0))
        self._slow_streak = int(state.get("slow_streak", 0))

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = device_mod.block(out)
        self.record(time.perf_counter() - t0)
        return out

