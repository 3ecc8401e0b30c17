"""Deterministic chaos injection for the fault-tolerance stack.

Long-running assimilation services die in exactly the ways that are
hardest to reproduce: a process SIGKILLed mid-stream, a device that
starts straggling, a checkpoint torn by a crash mid-write, a transient
packing/solve error from a flaky host.  This module makes every one of
those failures *schedulable*: a :class:`ChaosInjector` derives a fault
schedule deterministically from ``ChaosConfig.seed``, so the same seed
produces the same kills, the same stragglers and the same transient
faults on every run — which is what lets tests assert bitwise journal
equality between a chaos run and its replay, and lets a kill-and-resume
CI job re-create the exact crash it is recovering from.

Injection sites (all opt-in, all journalled as ``repro_torch.obs``
events under ``chaos.*``):

  * **kill points** — ``maybe_kill(site, cycle)`` SIGKILLs the process
    at configured cycles (no cleanup handlers run: the honest crash);
  * **transient faults** — ``check(site, cycle)`` raises
    :class:`TransientFault` at scheduled ``(site, cycle)`` points; the
    engine/fleet retry-with-backoff paths treat it as retryable.  The
    engine calls the ``"pack"`` site *before* any state mutation, so a
    retried prepare is bitwise-identical to an uninjected one;
  * **forced stragglers** — ``straggle(cycle, device_times)`` inflates
    the configured device's reported shard-ready time by
    ``straggle_factor`` at scheduled cycles, driving the EWMA-deadline
    :class:`~repro_torch.runtime.straggler.StragglerMonitor` without
    touching the solve itself (analyses stay bitwise);
  * **torn checkpoints** — :func:`tear_checkpoint` /
    :func:`corrupt_manifest` fabricate the half-written states a killed
    writer leaves behind, for exercising ``latest_checkpoint``'s
    hash-verified fallback.

The injector is host-side bookkeeping only; nothing here touches torch.
A copy of ``repro.runtime.chaos`` on the port's meters: the same config
draws the same schedule in both packages.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np

from repro_torch.obs import meters as meters_mod


class TransientFault(RuntimeError):
    """A retryable injected failure (flaky host, transient OOM, lost
    RPC).  Retry paths back off and re-attempt; anything else raised
    from a prepare/solve is treated as fatal for that stream."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Schedule parameters for one :class:`ChaosInjector`.

    Explicit cycle tuples (``kill_cycles``/``straggle_cycles``/
    ``pack_fault_cycles``/``solve_fault_cycles``) pin faults to exact
    cycles; the ``*_fault_rate`` knobs draw additional per-cycle faults
    Bernoulli(seeded) over ``max_cycle`` cycles at construction time —
    the schedule is fixed before the first cycle runs, never sampled
    on the fly, which is what makes a chaos run replayable.
    """

    seed: int = 0
    max_cycle: int = 4096            # horizon the random schedule covers
    kill_cycles: tuple = ()          # SIGKILL the process after these
                                     # cycles complete (site "cycle_end")
    pack_fault_cycles: tuple = ()    # transient faults at prepare entry
    solve_fault_cycles: tuple = ()   # transient faults at solve dispatch
    pack_fault_rate: float = 0.0     # extra Bernoulli pack faults
    solve_fault_rate: float = 0.0    # extra Bernoulli solve faults
    straggle_cycles: tuple = ()      # cycles with a forced straggler
    straggle_device: int = 0         # which device straggles
    straggle_factor: float = 50.0    # reported time multiplier
    fail_every_attempt: bool = False  # if True, a scheduled fault fires
                                     # on retries too (exhausts bounded
                                     # retry); default fires once, so
                                     # the first retry succeeds


class ChaosInjector:
    """Seeded fault injector with a precomputed, replayable schedule.

    One injector serves one stream/engine.  ``schedule()`` exposes the
    full precomputed plan as a JSON-ready dict (the determinism tests
    compare two injectors' schedules and injection logs); every firing
    is appended to ``self.injections`` (timestamp-free) and emitted as
    a ``chaos.inject`` event on the active meters registry.
    """

    def __init__(self, config: ChaosConfig | None = None):
        self.cfg = config or ChaosConfig()
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        # Draw both rate-based schedules unconditionally (and in a fixed
        # order) so adding one rate never shifts the other's draws.
        pack_draw = rng.random(cfg.max_cycle) < cfg.pack_fault_rate
        solve_draw = rng.random(cfg.max_cycle) < cfg.solve_fault_rate
        self._faults = {
            "pack": set(int(c) for c in cfg.pack_fault_cycles)
            | set(np.where(pack_draw)[0].tolist()),
            "solve": set(int(c) for c in cfg.solve_fault_cycles)
            | set(np.where(solve_draw)[0].tolist()),
        }
        self._kills = set(int(c) for c in cfg.kill_cycles)
        self._straggles = set(int(c) for c in cfg.straggle_cycles)
        self._fired: set = set()     # (site, cycle) already injected
        self.injections: list = []   # timestamp-free firing log

    # -- schedule introspection --------------------------------------------

    def schedule(self) -> dict:
        """The full precomputed plan, JSON-serializable (for determinism
        assertions and bench reports)."""
        return {
            "seed": int(self.cfg.seed),
            "kill_cycles": sorted(self._kills),
            "pack_fault_cycles": sorted(self._faults["pack"]),
            "solve_fault_cycles": sorted(self._faults["solve"]),
            "straggle_cycles": sorted(self._straggles),
            "straggle_device": int(self.cfg.straggle_device),
            "straggle_factor": float(self.cfg.straggle_factor),
        }

    def _log(self, site: str, cycle: int, **extra) -> None:
        rec = {"site": site, "cycle": int(cycle), **extra}
        self.injections.append(rec)
        meters_mod.get_meters().event("chaos.inject", **rec)
        meters_mod.get_meters().inc(f"chaos.injected.{site}")

    # -- injection sites ----------------------------------------------------

    def check(self, site: str, cycle: int) -> None:
        """Raise :class:`TransientFault` if a fault is scheduled at
        ``(site, cycle)``.  Fires once per point unless
        ``fail_every_attempt`` — so a bounded retry observes exactly one
        failure and then succeeds."""
        if cycle not in self._faults.get(site, ()):
            return
        key = (site, int(cycle))
        if key in self._fired and not self.cfg.fail_every_attempt:
            return
        self._fired.add(key)
        self._log(site, cycle, kind="transient_fault")
        raise TransientFault(f"injected transient {site} fault at "
                             f"cycle {cycle}")

    def maybe_kill(self, site: str, cycle: int) -> None:
        """SIGKILL the process if a kill point is scheduled at this
        cycle.  SIGKILL on purpose: no atexit/finally runs, exactly
        like the OOM-killer or a preempted host.  Under a process mesh
        every rank's injector draws the same schedule, so every rank
        kills itself at the same cycle end — after the step's checkpoint
        is published (the engine's ``save_checkpoint`` returns on no rank
        before that) — and ``runtime.mesh.launch`` ends at once, raising
        an error that names the signal."""
        if cycle not in self._kills:
            return
        self._log(site, cycle, kind="kill")
        os.kill(os.getpid(), signal.SIGKILL)

    def straggle(self, cycle: int, device_times: list) -> list:
        """Inflate the scheduled device's reported time at straggle
        cycles (returns a new list; the input is never mutated).  Only
        the *reported* timing changes — the solve already happened —
        so analyses stay bitwise while the EWMA-deadline monitor sees
        a genuinely late device."""
        if cycle not in self._straggles or not device_times:
            return list(device_times)
        out = list(device_times)
        dev = min(self.cfg.straggle_device, len(out) - 1)
        out[dev] = float(out[dev]) * float(self.cfg.straggle_factor)
        self._log("straggle", cycle, device=int(dev),
                  factor=float(self.cfg.straggle_factor))
        return out


# ---------------------------------------------------------------------------
# Torn/corrupt checkpoint fabrication (what a killed writer leaves).
# ---------------------------------------------------------------------------

def tear_checkpoint(path: str, seed: int = 0) -> str:
    """Truncate one leaf ``.npy`` of a finalized checkpoint mid-bytes —
    the state a crash leaves when the rename landed but a leaf write
    didn't make it to disk (or the disk lied about durability).
    Returns the truncated file's path."""
    rng = np.random.default_rng(seed)
    leaves = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not leaves:
        raise FileNotFoundError(f"no leaf arrays under {path}")
    victim = os.path.join(path, leaves[int(rng.integers(len(leaves)))])
    size = os.path.getsize(victim)
    keep = int(rng.integers(1, max(size, 2)))
    with open(victim, "rb+") as f:
        f.truncate(keep)
    return victim


def corrupt_manifest(path: str, seed: int = 0) -> str:
    """Flip bytes in the middle of ``manifest.json`` — a torn metadata
    write.  Returns the manifest path."""
    rng = np.random.default_rng(seed)
    manifest = os.path.join(path, "manifest.json")
    data = bytearray(open(manifest, "rb").read())
    if not data:
        raise ValueError(f"empty manifest at {manifest}")
    for _ in range(max(len(data) // 8, 1)):
        data[int(rng.integers(len(data)))] = int(rng.integers(256))
    with open(manifest, "wb") as f:
        f.write(bytes(data))
    return manifest


# ---------------------------------------------------------------------------
# Bounded retry-with-backoff (shared by the engine and the fleet).
# ---------------------------------------------------------------------------

def retry_transient(fn, *, retries: int = 2, backoff: float = 0.05,
                    site: str = "solve", cycle: int = -1,
                    sleep=time.sleep):
    """Call ``fn()``; on :class:`TransientFault`, back off exponentially
    and retry up to ``retries`` times (``backoff * 2**attempt`` seconds),
    emitting a ``chaos.retry`` event per re-attempt.  Any other
    exception — and a fault that outlives the retry budget — propagates
    to the caller's fatal path."""
    m = meters_mod.get_meters()
    for attempt in range(retries + 1):
        try:
            return fn()
        except TransientFault:
            if attempt >= retries:
                raise
            delay = backoff * (2.0 ** attempt)
            m.event("chaos.retry", site=site, cycle=int(cycle),
                    attempt=attempt + 1, delay=delay)
            m.inc("chaos.retries")
            sleep(delay)
