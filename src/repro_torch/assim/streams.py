"""Observation-stream scenarios for the streaming assimilation engine.

A *stream* is a named, seeded generator of per-cycle observation locations
— the moving observation network the paper's conclusion names as future
work.  Scenarios declare the dimension of their domain: a 1D scenario
yields sorted ``(m,)`` arrays in [0, 1); a 2D scenario yields ``(m, 2)``
arrays in [0, 1)², lexicographically sorted by (y, x).  Every scenario is
registered under a name so engines, tests and benchmarks can sweep the
registry:

    for name in streams.available(ndim=2):
        for obs in streams.make_stream(name, m=400, cycles=6, seed=0):
            ...  # obs is a lex-sorted (m, 2) float array in [0, 1)^2

Adding a scenario is one decorated function::

    @register("my_scenario", ndim=2)
    def my_scenario(m, cycles, seed):
        rng = np.random.default_rng(seed)
        for c in range(cycles):
            yield _finalize_2d(rng.uniform(0, 1, (m, 2)))

Contract: a scenario must be deterministic under a fixed ``seed`` and
yield exactly ``cycles`` arrays of shape ``(m,)`` (sorted) for ``ndim=1``
or ``(m, 2)`` (lex-sorted by y then x) for ``ndim=2``, every location in
[0, 1).  ``tests/test_assim.py`` enforces this for every registered name,
so a new scenario gets its determinism/shape coverage for free.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.data import observations as obs_mod


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A registered scenario: ``fn(m, cycles, seed)`` yielding locations."""

    name: str
    fn: Callable[..., Iterator[np.ndarray]]
    doc: str
    ndim: int = 1


_REGISTRY: dict = {}


def register(name: str, ndim: int = 1):
    """Register a scenario generator under ``name`` for an ndim-D domain."""
    if ndim not in (1, 2):
        raise ValueError(f"ndim must be 1 or 2 (got {ndim})")

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"stream scenario {name!r} already registered")
        _REGISTRY[name] = StreamSpec(name=name, fn=fn,
                                     doc=(fn.__doc__ or "").strip(),
                                     ndim=ndim)
        return fn
    return deco


def available(ndim: Optional[int] = None) -> tuple:
    """Sorted names of registered scenarios, optionally filtered by ndim."""
    return tuple(sorted(n for n, s in _REGISTRY.items()
                        if ndim is None or s.ndim == ndim))


def get(name: str) -> StreamSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown stream scenario {name!r}; "
                         f"available: {available()}")
    return _REGISTRY[name]


def make_stream(name: str, m: int, cycles: int, seed: int = 0,
                **kw) -> Iterator[np.ndarray]:
    """Instantiate scenario ``name`` as an iterator of per-cycle locations."""
    spec = get(name)
    want_shape = (m,) if spec.ndim == 1 else (m, 2)

    def checked():
        count = 0
        for obs in spec.fn(m, cycles, seed, **kw):
            obs = np.asarray(obs, dtype=np.float64)
            assert obs.shape == want_shape, (name, obs.shape)
            yield obs
            count += 1
        assert count == cycles, (name, count, cycles)

    return checked()


class ResumableStream:
    """A stream with a serializable cursor, for checkpoint/resume.

    Wraps the checked scenario iterator and counts cycles consumed.
    ``cursor`` is a JSON-ready dict (scenario name, m, cycles, seed,
    extra kwargs, and the position); :meth:`from_cursor` rebuilds the
    stream and *fast-forwards* it — scenarios are seeded and
    deterministic, so re-drawing and discarding the first ``pos``
    arrays reproduces the generator's internal state exactly without
    replaying any solves.  This is what lets engine resume continue a
    stream bitwise from the cycle after the snapshot.
    """

    def __init__(self, name: str, m: int, cycles: int, seed: int = 0,
                 **kw):
        self.name, self.m, self.cycles, self.seed = name, m, cycles, seed
        self.kw = dict(kw)
        self.pos = 0
        self._it = make_stream(name, m, cycles, seed, **kw)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        obs = next(self._it)
        self.pos += 1
        return obs

    @property
    def cursor(self) -> dict:
        return {"name": self.name, "m": int(self.m),
                "cycles": int(self.cycles), "seed": int(self.seed),
                "pos": int(self.pos), "kw": dict(self.kw)}

    @classmethod
    def from_cursor(cls, cursor: dict) -> "ResumableStream":
        s = cls(cursor["name"], int(cursor["m"]), int(cursor["cycles"]),
                int(cursor["seed"]), **cursor.get("kw", {}))
        for _ in range(int(cursor["pos"])):   # fast-forward, no solves
            next(s._it)
            s.pos += 1
        return s

    def remaining(self) -> int:
        return self.cycles - self.pos


def _finalize(obs: np.ndarray) -> np.ndarray:
    return np.sort(np.clip(obs, 0.0, np.nextafter(1.0, 0.0)))


def _finalize_2d(pts: np.ndarray) -> np.ndarray:
    """Clip to [0, 1)² and lex-sort by (y, x) for determinism."""
    pts = np.clip(pts, 0.0, np.nextafter(1.0, 0.0))
    return pts[np.lexsort((pts[:, 0], pts[:, 1]))]


# ---------------------------------------------------------------------------
# 1D scenarios.
# ---------------------------------------------------------------------------

@register("drifting_swarm")
def drifting_swarm(m, cycles, seed, width=0.08, start=0.15, stop=0.85):
    """A tight sensor swarm drifting across the domain over the run —
    the configuration that collapses a static DD to E ~ 0."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        center = start + (stop - start) * c / max(cycles - 1, 1)
        yield _finalize(center + width * rng.normal(size=m))


@register("bursty_clusters")
def bursty_clusters(m, cycles, seed, max_clusters=3):
    """A few clusters whose positions re-draw every cycle and whose mass is
    bursty: one dominant cluster absorbs most sensors each cycle."""
    rng = np.random.default_rng(seed)
    for _ in range(cycles):
        k = int(rng.integers(1, max_clusters + 1))
        centers = rng.uniform(0.05, 0.95, k)
        weights = rng.dirichlet(0.35 * np.ones(k))
        which = rng.choice(k, size=m, p=weights)
        yield _finalize(centers[which] + 0.04 * rng.normal(size=m))


@register("sensor_dropout")
def sensor_dropout(m, cycles, seed, p=8):
    """Uniform coverage that loses a growing contiguous block of sensors
    mid-run — whole subdomains go empty, exercising the DyDD DD-step
    (split-the-loaded-neighbour repartition) — then recovers."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        obs = rng.uniform(0, 1, m)
        # Outage window: middle third of the run, blacking out an expanding
        # range of the p-way uniform intervals.
        lo, hi = cycles // 3, max(2 * cycles // 3, cycles // 3 + 1)
        if lo <= c < hi:
            n_dead = min(1 + (c - lo), p - 1)
            dead = tuple(range(n_dead))
            obs = obs_mod.squeeze_out_of_subdomains(obs, dead, p, rng)
        yield _finalize(obs)


@register("diurnal")
def diurnal(m, cycles, seed, period=8, width=0.10):
    """A diurnal oscillation: the observation mass swings back and forth
    across the domain sinusoidally, breathing wider at the turning points."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        phase = 2.0 * np.pi * c / period
        center = 0.5 + 0.35 * np.sin(phase)
        w = width * (1.0 + 0.5 * np.abs(np.cos(phase)))
        yield _finalize(center + w * rng.normal(size=m))


@register("storm_front")
def storm_front(m, cycles, seed, background_frac=0.3):
    """Composite 'storm front': a sparse uniform background network plus a
    sharp front sweeping the domain, intensifying mid-run (drawing sensors
    away from the background) and knocking out coverage behind it."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        t = c / max(cycles - 1, 1)
        front = 0.1 + 0.8 * t
        # Intensity peaks mid-run: the front recruits up to ~90% of sensors.
        intensity = np.sin(np.pi * t)
        m_front = int(m * (1.0 - background_frac) * intensity)
        m_bg = m - m_front
        storm = front + 0.03 * rng.normal(size=m_front)
        # Behind the front the network is knocked out: background sensors
        # only survive ahead of it (and a thin recovering strip at the far
        # left edge).
        bg = np.concatenate([
            rng.uniform(min(front + 0.05, 0.95), 1.0, (2 * m_bg) // 3),
            rng.uniform(0.0, 0.05, m_bg - (2 * m_bg) // 3),
        ])
        yield _finalize(np.concatenate([storm, bg]))


# ---------------------------------------------------------------------------
# 2D scenarios (the paper's Ω ⊂ R² setting, Figures 1-4).
# ---------------------------------------------------------------------------

@register("storm_front_2d", ndim=2)
def storm_front_2d(m, cycles, seed, background_frac=0.25):
    """A storm front sweeping the plane diagonally (lower-left to
    upper-right): a dense band of sensors rides the front line while a
    sparse background survives only ahead of it.  The front keeps moving
    through the final cycle, so a static tiling ends badly unbalanced."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        t = c / max(cycles - 1, 1)
        d = 0.15 + 0.7 * t                      # front offset along x + y
        m_front = int(m * (1.0 - background_frac))
        m_bg = m - m_front
        # Band perpendicular to the (1, 1) sweep direction.
        along = rng.uniform(-0.5, 0.5, m_front)
        across = 0.03 * rng.normal(size=m_front)
        fx = d + along + across
        fy = d - along + across
        # Background only ahead of the front (x + y > 2d).
        bx = rng.uniform(0, 1, 4 * m_bg)
        by = rng.uniform(0, 1, 4 * m_bg)
        ahead = np.where(bx + by > 2 * d)[0][:m_bg]
        if ahead.size < m_bg:  # late cycles: fall back to the far corner
            extra = m_bg - ahead.size
            bx = np.concatenate([bx[ahead], rng.uniform(0.9, 1.0, extra)])
            by = np.concatenate([by[ahead], rng.uniform(0.9, 1.0, extra)])
        else:
            bx, by = bx[ahead], by[ahead]
        pts = np.stack([np.concatenate([fx, bx]),
                        np.concatenate([fy, by])], axis=1)
        yield _finalize_2d(pts)


@register("rotating_swarm", ndim=2)
def rotating_swarm(m, cycles, seed, radius=0.3, width=0.06):
    """A tight sensor swarm orbiting the domain center — every cycle the
    mass sits in a different cell of any static tiling."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        phase = 2.0 * np.pi * c / max(cycles, 1)
        cx = 0.5 + radius * np.cos(phase)
        cy = 0.5 + radius * np.sin(phase)
        pts = np.stack([cx + width * rng.normal(size=m),
                        cy + width * rng.normal(size=m)], axis=1)
        yield _finalize_2d(pts)


@register("coastal_band", ndim=2)
def coastal_band(m, cycles, seed, amplitude=0.2, width=0.05):
    """A coastal observation band: sensors hug a sinusoidal 'shoreline'
    whose phase drifts across the run (a shelf boundary shifting in both
    axes — the Figure 2-4 configuration)."""
    rng = np.random.default_rng(seed)
    for c in range(cycles):
        phase = 2.0 * np.pi * c / max(2 * cycles, 1)
        x = rng.uniform(0, 1, m)
        coast = 0.5 + amplitude * np.sin(2.0 * np.pi * x + phase) \
            + 0.25 * (c / max(cycles - 1, 1))
        y = coast + width * rng.normal(size=m)
        yield _finalize_2d(np.stack([x, y], axis=1))


@register("satellite_track", ndim=2)
def satellite_track(m, cycles, seed, tracks=3, stations=8, width=0.02):
    """Polar-orbit ground tracks: all mass rides a few thin diagonal
    swaths whose phase precesses each cycle, sampled at a fixed set of
    along-track stations — so the x coordinates are *quantized* (heavy
    ties) and the network is strongly anisotropic.  A shelf tiling
    wastes cells on the empty area between swaths and cannot split a
    heavy station column except at a global strip boundary; the k-d
    domain splits it locally along y."""
    rng = np.random.default_rng(seed)
    xg = (np.arange(stations) + 0.5) / stations
    for c in range(cycles):
        phase = 0.13 * c
        k = rng.integers(0, tracks, m)
        weights = rng.dirichlet(0.5 * np.ones(stations))
        x = xg[rng.choice(stations, size=m, p=weights)]
        y = np.mod(x + k / tracks + phase, 1.0) \
            + width * rng.normal(size=m)
        yield _finalize_2d(np.stack([x, y], axis=1))


@register("river_gauges", ndim=2)
def river_gauges(m, cycles, seed, gauges=10, width=0.015):
    """Stream gauges on a meandering river: observations sit at a fixed
    set of gauge stations (tied x) along a curved band y = f(x), and a
    flood pulse travels downstream through the run, concentrating the
    sampling mass gauge by gauge — a curved, strongly anisotropic
    network whose hot spot moves every cycle."""
    rng = np.random.default_rng(seed)
    xg = np.sort(rng.uniform(0.05, 0.95, gauges))
    for c in range(cycles):
        t = c / max(cycles - 1, 1)
        pulse = 0.1 + 0.8 * t
        w = np.exp(-((xg - pulse) / 0.25) ** 2) + 0.15
        x = xg[rng.choice(gauges, size=m, p=w / w.sum())]
        y = 0.5 + 0.3 * np.sin(2.2 * np.pi * x + 0.4) \
            + width * rng.normal(size=m)
        yield _finalize_2d(np.stack([x, y], axis=1))


@register("grid_dropout", ndim=2)
def grid_dropout(m, cycles, seed, pr=2, pc=2):
    """A uniform 2D sensor network that loses a growing rectangle of
    pr x pc tiling cells mid-run — whole cells go empty (Figure 1's
    configuration, exercising the empty-cell DD-step) and the outage
    persists through the final cycle."""
    rng = np.random.default_rng(seed)
    lo = cycles // 3
    for c in range(cycles):
        pts = rng.uniform(0, 1, (m, 2))
        if c >= lo:
            # Dead rectangle of cells grows from the lower-left corner:
            # first along x to the full row, then up rows — never the
            # whole domain (the top strip always survives).
            k = c - lo
            kc = min(1 + k, pc)
            kr = min(1 + max(k - (pc - 1), 0), max(pr - 1, 1))
            pts = obs_mod.squeeze_out_of_rect(pts, kc / pc, kr / pr, rng)
        yield _finalize_2d(pts)
