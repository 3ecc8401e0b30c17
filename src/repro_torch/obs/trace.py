"""Lightweight span tracer for the assimilation stack.

The engine's cycle loop is a pipeline of host phases (observation
counting, DyDD, halo-schedule build, operator packing) interleaved with
device work (the DD-KF solve), split across two threads under double
buffering.  This module provides the one primitive that makes all of it
visible: a nested ``span("pack")`` context manager with monotonic host
timing that exports Chrome/Perfetto ``trace_events`` JSON — open the
output at https://ui.perfetto.dev (or chrome://tracing) and every
thread/device gets its own row with the nesting rendered as stacked
slices.

Design constraints, in order:

  * **Zero overhead when disabled.**  The module-level :func:`span`
    dispatches through the active tracer; the default
    :class:`NullTracer` returns one shared no-op context manager, so a
    disabled call site costs two function calls and no allocation —
    ``tests/test_obs.py`` pins this with a micro-benchmark.  Call sites
    therefore need exactly one guarded branch: the ``with span(...)``
    statement itself.
  * **Thread-aware.**  Spans land on a per-thread track (Chrome ``tid``)
    keyed by the thread name, so the engine's double-buffered packing
    worker shows up as its own row next to the main solve thread; span
    nesting is tracked per thread (a worker's ``pack`` span never
    becomes a child of the main thread's ``solve``).
  * **Honest device timing.**  Host timestamps lie about async device
    work — a dispatched solve returns immediately.  Spans that wrap
    device work must fence: ``with span("solve") as sp: x = f();
    sp.fence(x)`` waits for the value's device work (a CUDA event on the
    current stream) before the span closes, so the recorded duration is
    the device wall time, not the dispatch time.  For kernel-level
    timelines use the :func:`torch_profile` passthrough instead
    (``--profile`` on the CLI), which wraps ``torch.profiler``.

Spans with an explicit ``track=`` land on a named row instead of the
thread's — :meth:`Tracer.emit` uses this to attach per-device rows
("device 0" ... "device p-1") from timestamps observed after the fact
(per-shard ready times of a sharded solve).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch

from repro_torch import device as device_mod


# ---------------------------------------------------------------------------
# Disabled path: shared no-op span, no allocation per call.
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing context manager (the disabled-tracing fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw) -> None:
        pass

    def fence(self, value=None):
        return value


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The inactive tracer: every span is the shared no-op instance."""

    enabled = False

    def span(self, name: str, track: Optional[str] = None, **args):
        return _NULL_SPAN

    def emit(self, name: str, t0: float, dur: float,
             track: Optional[str] = None, **args) -> None:
        pass


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# Active tracer.
# ---------------------------------------------------------------------------

class _Span:
    """One live span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "track", "args", "_t0", "_fence")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._t0 = 0.0
        self._fence = None

    def __enter__(self):
        tracer = self._tracer
        if self.track is None:
            self.track = threading.current_thread().name
        stack = tracer._stack()
        self.args.setdefault("depth", len(stack))
        if stack:
            self.args.setdefault("parent", stack[-1].name)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._fence is not None:
            _block(self._fence)
            self._fence = None
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self.name, self._t0, t1 - self._t0,
                             self.track, self.args)
        return False

    def annotate(self, **kw) -> None:
        """Attach JSON-serializable key/values to the span's args."""
        self.args.update(kw)

    def fence(self, value):
        """Register a device value to wait for at span exit, so the
        span's duration includes the device work that produced it.
        Returns the value unchanged."""
        self._fence = value
        return value


def _block(value):
    return device_mod.block(value)


class Tracer:
    """Span recorder with Chrome ``trace_events`` export.

    Thread safe: each thread keeps its own nesting stack (thread-local)
    and completed events append under a lock.  ``time.perf_counter`` is
    the clock — monotonic and shared across threads, so cross-thread
    span overlap in the exported trace reflects real concurrency.
    """

    enabled = True

    def __init__(self, process_name: str = "repro"):
        self.process_name = process_name
        self.events: list = []          # (name, t0, dur, track, args)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = time.perf_counter()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, track: Optional[str] = None, **args):
        """Context manager timing a nested span on this thread's track
        (or an explicit ``track=`` row)."""
        return _Span(self, name, track, args)

    def emit(self, name: str, t0: float, dur: float,
             track: Optional[str] = None, **args) -> None:
        """Record an already-measured span (``t0`` in perf_counter
        seconds) — how per-device rows are attached after the fact."""
        if track is None:
            track = threading.current_thread().name
        self._record(name, t0, dur, track, args)

    def _record(self, name: str, t0: float, dur: float, track: str,
                args: dict) -> None:
        with self._lock:
            self.events.append((name, t0, dur, track, args))

    # -- queries ------------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> list:
        """Completed spans as dicts (filtered by name if given)."""
        with self._lock:
            evs = list(self.events)
        out = [{"name": n, "t0": t0, "dur": dur, "track": tr,
                "args": dict(a)} for n, t0, dur, tr, a in evs]
        if name is not None:
            out = [e for e in out if e["name"] == name]
        return out

    def total_duration(self, name: str) -> float:
        """Summed duration (s) of all spans with this name."""
        return sum(e["dur"] for e in self.spans(name))

    def coverage(self, name: str, wall: float) -> float:
        """Fraction of ``wall`` seconds covered by spans named ``name``
        (the acceptance metric: cycle spans vs measured wall-clock)."""
        return self.total_duration(name) / wall if wall > 0 else 0.0

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_events`` JSON object.

        Complete ("X") events with microsecond timestamps relative to
        the tracer's epoch; one ``tid`` per track with a thread_name
        metadata record so Perfetto labels the rows.  Track order:
        "main" first, then the worker threads, then the device rows.
        """
        with self._lock:
            evs = list(self.events)
        tracks: dict = {}

        def tid_of(track: str) -> int:
            if track not in tracks:
                tracks[track] = len(tracks)
            return tracks[track]

        # Deterministic row order regardless of event arrival order.
        def track_key(t: str):
            if t in ("main", "MainThread"):
                return (0, t)
            if t.startswith("device"):
                return (2, t)
            return (1, t)

        for t in sorted({e[3] for e in evs}, key=track_key):
            tid_of(t)

        events = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": self.process_name}},
        ]
        for track, tid in tracks.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": track}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": 0, "tid": tid,
                           "args": {"sort_index": tid}})
        for name, t0, dur, track, args in evs:
            events.append({
                "ph": "X", "name": name, "pid": 0, "tid": tid_of(track),
                "ts": (t0 - self._epoch) * 1e6,
                "dur": dur * 1e6,
                "cat": "repro",
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


# ---------------------------------------------------------------------------
# Active-tracer plumbing (the one guarded branch per call site).
# ---------------------------------------------------------------------------

_ACTIVE: "Tracer | NullTracer" = NULL_TRACER


def get_tracer() -> "Tracer | NullTracer":
    return _ACTIVE


def set_tracer(tracer: "Tracer | NullTracer | None"):
    """Install the process-wide tracer (None = disable).  Returns the
    previous tracer so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else NULL_TRACER
    return prev


@contextlib.contextmanager
def tracing(tracer: "Tracer | NullTracer | None"):
    """Scoped ``set_tracer``: installs for the block, restores after."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, track: Optional[str] = None, **args):
    """Record a span on the active tracer — a shared no-op when tracing
    is disabled (the call sites' single guarded branch)."""
    return _ACTIVE.span(name, track=track, **args)


def emit(name: str, t0: float, dur: float, track: Optional[str] = None,
         **args) -> None:
    _ACTIVE.emit(name, t0, dur, track=track, **args)


@contextlib.contextmanager
def torch_profile(logdir: Optional[str]):
    """Optional ``torch.profiler`` passthrough: profiles the block (host
    and, where a card is present, CUDA activity) and writes a Chrome
    trace into ``logdir`` when a directory is given; a no-op otherwise."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "torch_trace.json"))
