"""Constrained Least Squares (CLS) model — the paper's prototype DA problem.

The CLS problem (paper §3.1) combines two overdetermined linear systems,

    state:        H0 x = y0,   H0 in R^{m0 x n},  rank(H0) = n, m0 > n
    observations: H1 x = y1,   H1 in R^{m1 x n},  m1 > 0

into  S: A x = b  with  A = [H0; H1], b = [y0; y1] and weight
R = diag(R0, R1).  The CLS estimate minimizes

    J(x) = ||A x - b||_R^2 = ||H0 x - y0||_{R0}^2 + ||H1 x - y1||_{R1}^2

and is given by the normal equations (eq. 18-19)

    (A^T R A) x = A^T R b.

Problems hold torch tensors on one device; the operator builders
(:func:`state_operator`, :func:`observation_operator`) are numpy, and the
random builders draw from a ``numpy.random.Generator`` so tests can feed
identical inputs to the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod


@dataclasses.dataclass(frozen=True)
class CLSProblem:
    """A CLS problem instance.

    Attributes:
      H0: (m0, n) state operator, full column rank.
      y0: (m0,) state data.
      H1: (m1, n) observation operator.
      y1: (m1,) observation data.
      R0: (m0,) diagonal of the state weight matrix (paper: R diagonal).
      R1: (m1,) diagonal of the observation weight matrix.
    """

    H0: torch.Tensor
    y0: torch.Tensor
    H1: torch.Tensor
    y1: torch.Tensor
    R0: torch.Tensor
    R1: torch.Tensor

    @property
    def n(self) -> int:
        return self.H0.shape[1]

    @property
    def m0(self) -> int:
        return self.H0.shape[0]

    @property
    def m1(self) -> int:
        return self.H1.shape[0]

    def stacked(self):
        """Return (A, b, r) with A = [H0; H1], b = [y0; y1], r = diag(R)."""
        A = torch.cat([self.H0, self.H1], dim=0)
        b = torch.cat([self.y0, self.y1], dim=0)
        r = torch.cat([self.R0, self.R1], dim=0)
        return A, b, r


def objective(prob: CLSProblem, x: torch.Tensor) -> torch.Tensor:
    """J(x) = ||H0 x - y0||_{R0}^2 + ||H1 x - y1||_{R1}^2  (eq. 17)."""
    r0 = prob.H0 @ x - prob.y0
    r1 = prob.H1 @ x - prob.y1
    return torch.sum(prob.R0 * r0 * r0) + torch.sum(prob.R1 * r1 * r1)


def normal_matrix(prob: CLSProblem) -> torch.Tensor:
    """A^T R A = H0^T R0 H0 + H1^T R1 H1."""
    return (prob.H0.T * prob.R0) @ prob.H0 + (prob.H1.T * prob.R1) @ prob.H1


def normal_rhs(prob: CLSProblem) -> torch.Tensor:
    """A^T R b = H0^T R0 y0 + H1^T R1 y1."""
    return prob.H0.T @ (prob.R0 * prob.y0) + prob.H1.T @ (prob.R1 * prob.y1)


def solve(prob: CLSProblem) -> torch.Tensor:
    """Closed-form CLS solution via Cholesky on the normal equations (eq. 19).

    A^T R A is SPD because rank(H0) = n and R > 0, so Cholesky and two
    triangular solves (no pivoting) give the estimate.
    """
    chol = torch.linalg.cholesky(normal_matrix(prob))
    c = normal_rhs(prob)[:, None]
    z = torch.linalg.solve_triangular(chol, c, upper=False)
    return torch.linalg.solve_triangular(chol.mT, z, upper=True)[:, 0]


def state_operator(n: int, smooth: float = 0.25):
    """H0 of the paper's PDE setting: identity rows plus ``smooth``-weighted
    second-difference rows (a discretized diffusion/background term) —
    banded, m0 = 2n - 2 > n, rank n.  Returns a numpy (2n-2, n) array."""
    eye = np.eye(n)
    d2 = np.zeros((n - 2, n))
    for i in range(n - 2):
        d2[i, i:i + 3] = (-1.0, 2.0, -1.0)
    return np.concatenate([eye, smooth * d2], axis=0)


def observation_operator(n: int, obs_locations, stencil: int = 3,
                         block: int | None = None):
    """H1 of the paper's PDE setting: each observation at location
    ``obs_locations[k] in [0,1)`` maps to a ``stencil``-point interpolation
    row around the nearest mesh point — the row is *local to the subdomain
    containing the observation*, which is what makes DyDD's row balancing
    meaningful.  Returns a numpy (m1, n) array.

    ``block`` confines each stencil window to the size-``block`` aligned
    chunk of columns containing its center: on a raster-ordered 2D mesh
    (``block = nx``) this stops a window near a mesh-row edge from leaking
    onto the physically distant first column of the next row."""
    obs = np.asarray(obs_locations, dtype=np.float64)
    m1 = obs.shape[0]
    H1 = np.zeros((m1, n))
    centers = np.clip((obs * n).astype(np.int64), 0, n - 1)
    half = stencil // 2
    for kk in range(m1):
        lo, hi = 0, n
        if block is not None:
            lo = (centers[kk] // block) * block
            hi = min(n, lo + block)
        lo = max(lo, centers[kk] - half)
        hi = min(hi, centers[kk] + half + 1)
        wts = np.exp(-0.5 * (np.arange(lo, hi) - obs[kk] * n) ** 2)
        H1[kk, lo:hi] = wts / wts.sum()
    return H1


def from_arrays(H0, y0, H1, y1, dtype=device_mod.DTYPE,
                device=None) -> CLSProblem:
    """A unit-weight CLS problem (R = I) from host arrays, on ``device``
    (``None`` = the card)."""
    device = device_mod.resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return CLSProblem(H0=t(H0), y0=t(y0), H1=t(H1), y1=t(y1),
                      R0=torch.ones((H0.shape[0],), dtype=dtype,
                                    device=device),
                      R1=torch.ones((H1.shape[0],), dtype=dtype,
                                    device=device))


def local_problem(rng: np.random.Generator, n: int, obs_locations,
                  stencil: int = 3, dtype=device_mod.DTYPE,
                  smooth: float = 0.25, device=None) -> CLSProblem:
    """A spatially-local CLS instance mirroring the paper's PDE setting
    (see :func:`state_operator` and :func:`observation_operator`); the
    truth and the data noise are drawn from ``rng``."""
    obs = np.asarray(obs_locations, dtype=np.float64)
    H0 = state_operator(n, smooth=smooth)
    H1 = observation_operator(n, obs, stencil=stencil)
    x_true = rng.normal(size=n)
    noise = 1e-3 * rng.normal(size=H0.shape[0] + obs.shape[0])
    return from_arrays(H0, H0 @ x_true + noise[:H0.shape[0]],
                       H1, H1 @ x_true + noise[H0.shape[0]:], dtype, device)


def random_problem(rng: np.random.Generator, n: int, m0: int, m1: int,
                   dtype=device_mod.DTYPE, device=None) -> CLSProblem:
    """A random well-conditioned CLS instance (used by tests/benchmarks)."""
    H0 = rng.normal(size=(m0, n)) + np.eye(m0, n)
    H1 = rng.normal(size=(m1, n))
    x_true = rng.normal(size=n)
    noise = 1e-3 * rng.normal(size=m0 + m1)
    return from_arrays(H0, H0 @ x_true + noise[:m0],
                       H1, H1 @ x_true + noise[m0:], dtype, device)
