"""Observation-location generators for the DA experiments (paper §6).

The paper's scenarios need observations that are "non uniformly distributed
and general sparse"; we provide the distributions used by the benchmark
tables, including configurations where entire subdomains start empty.

Multi-cycle *streams* of observations (drifting swarms, bursty clusters,
sensor dropout, ...) live in :mod:`repro.assim.streams`, which builds on
the single-snapshot generators here.
"""
from __future__ import annotations

import numpy as np

KINDS = ("uniform", "beta", "clustered")


def squeeze_out_of_subdomains(obs: np.ndarray, empty_subdomains,
                              p: int, rng: np.random.Generator) -> np.ndarray:
    """Remap observations so the listed p-way uniform intervals are empty.

    Each observation keeps its within-interval offset and is assigned
    (seeded-uniformly) to one of the allowed intervals — reproduces the
    paper's Example 1 Case 2 / Example 2 Cases 2-4 setups, and the
    streaming sensor-dropout scenario.
    """
    empty = set(int(i) for i in empty_subdomains)
    bad = [i for i in empty if not 0 <= i < p]
    if bad:
        raise ValueError(
            f"empty_subdomains {sorted(bad)} out of range for p={p}")
    allowed = [i for i in range(p) if i not in empty]
    if not allowed:
        raise ValueError(
            f"cannot empty every subdomain: p={p}, "
            f"empty_subdomains={sorted(empty)} leaves no interval for the "
            f"observations (did you forget to pass p?)")
    w = 1.0 / p
    frac = np.asarray(obs, dtype=np.float64) % 1.0
    idx = rng.integers(0, len(allowed), len(frac))
    return (np.asarray(allowed, dtype=np.float64)[idx] + frac) * w


def squeeze_out_of_rect(pts: np.ndarray, x_hi: float, y_hi: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Re-draw 2D points inside [0, x_hi) x [0, y_hi) uniformly into the
    complementary L-shaped region — the 2D analogue of
    :func:`squeeze_out_of_subdomains` (a rectangle of tiling cells goes
    dark; Figure 1's empty-subdomain configuration).
    """
    if not (0.0 < x_hi <= 1.0 and 0.0 < y_hi <= 1.0):
        raise ValueError(f"dead rectangle [0,{x_hi})x[0,{y_hi}) must lie "
                         f"inside the unit square with positive extent")
    if x_hi >= 1.0 and y_hi >= 1.0:
        raise ValueError("cannot empty the whole domain: the dead "
                         "rectangle covers [0,1)² and leaves nowhere for "
                         "the observations")
    pts = np.asarray(pts, dtype=np.float64).copy()
    inside = (pts[:, 0] < x_hi) & (pts[:, 1] < y_hi)
    k = int(inside.sum())
    if k == 0:
        return pts
    # Exact area-weighted sampling over the two strips of the L:
    # right strip [x_hi,1) x [0,1), top-left strip [0,x_hi) x [y_hi,1).
    a_right = (1.0 - x_hi)
    a_top = x_hi * (1.0 - y_hi)
    right = rng.uniform(0, 1, k) < a_right / (a_right + a_top)
    u, v = rng.uniform(0, 1, k), rng.uniform(0, 1, k)
    xs = np.where(right, x_hi + (1.0 - x_hi) * u, x_hi * u)
    ys = np.where(right, v, y_hi + (1.0 - y_hi) * v)
    pts[inside] = np.stack([xs, ys], axis=1)
    return pts


def make_observations(m: int, kind: str = "beta", seed: int = 0,
                      empty_subdomains: tuple = (), p: int = 1) -> np.ndarray:
    """m observation locations in [0, 1).

    kind: "uniform" | "beta" (skewed) | "clustered" (Gaussian bumps).
    empty_subdomains: indices (of a p-way uniform split) that must contain
    no observations — reproduces the paper's Example 1 Case 2 / Example 2
    Cases 2-4 setups.  Requires ``p > len(empty_subdomains)``; the default
    p=1 admits no empty subdomains.
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        obs = rng.uniform(0, 1, m)
    elif kind == "beta":
        obs = rng.beta(2.0, 5.0, m)
    elif kind == "clustered":
        centers = rng.uniform(0.1, 0.9, 3)
        c = rng.integers(0, len(centers), m)
        obs = np.clip(centers[c] + 0.05 * rng.normal(size=m), 0, 0.999999)
    else:
        raise ValueError(
            f"unknown observation kind {kind!r}; expected one of {KINDS}")

    if empty_subdomains:
        obs = squeeze_out_of_subdomains(obs, empty_subdomains, p, rng)
    return np.sort(obs)
