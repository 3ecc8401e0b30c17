"""Kalman Filter and its variational (VAR-KF) form — paper §2.

Implements the textbook KF (eqs. 5-8) plus the sequential VAR-KF solver for
CLS problems used as the reference ("KF solving CLS problem", paper §6): the
observation rows of H1 are assimilated one block at a time starting from the
state system H0 x = y0, so the final estimate equals the CLS solution.
This is the sequential baseline that DD-KF is validated against
(error_DD-DA ~ 1e-11 in the paper), and its run time is the paper's T^1.

The port of ``repro.core.kalman``: the products are plain dense matrix
products (``torch.matmul``), the SPD solve of the corrector is a Cholesky
factor and ``torch.cholesky_solve``, and the reference's ``lax.scan``
loops are Python loops.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cls as cls_mod


@dataclasses.dataclass(frozen=True)
class KFState:
    """Filter state: estimate and covariance (information is kept dense —
    the paper's CLS case study has Q = 0 and diagonal R, §3 remark)."""

    x: torch.Tensor  # (n,) state estimate
    P: torch.Tensor  # (n, n) error covariance


def predict(state: KFState, M: torch.Tensor, Q: torch.Tensor) -> KFState:
    """Predictor phase (eqs. 5-6): x <- M x, P <- M P M^T + Q."""
    return KFState(x=M @ state.x, P=M @ state.P @ M.T + Q)


def correct(state: KFState, H: torch.Tensor, y: torch.Tensor,
            R: torch.Tensor) -> KFState:
    """Corrector phase (eqs. 7-8).

    K = P H^T (H P H^T + R)^-1 ; x <- x + K (y - H x) ; P <- (I - K H) P.
    R is the (m,) diagonal of the observation covariance.
    """
    HP = H @ state.P                                  # (m, n)
    S = HP @ H.T + torch.diag(R)
    # Solve instead of explicit inverse: K = P H^T S^-1 = (S^-1 H P)^T.
    K = torch.cholesky_solve(HP, torch.linalg.cholesky(S)).T
    x = state.x + K @ (y - H @ state.x)
    # (I - K H) P = P - K (H P): O(n^2 m) instead of O(n^3).
    return KFState(x=x, P=state.P - K @ HP)


def run(x0: torch.Tensor, P0: torch.Tensor,
        Ms: torch.Tensor, Qs: torch.Tensor,
        Hs: torch.Tensor, ys: torch.Tensor, Rs: torch.Tensor):
    """Run r KF steps; returns (final state, xs) with xs the (r, n)
    estimates after each step.

    Ms: (r, n, n), Qs: (r, n, n), Hs: (r, m, n), ys: (r, m), Rs: (r, m).
    """
    state = KFState(x=x0, P=P0)
    xs = []
    for M, Q, H, y, R in zip(Ms, Qs, Hs, ys, Rs):
        state = correct(predict(state, M, Q), H, y, R)
        xs.append(state.x)
    return state, torch.stack(xs)


# ---------------------------------------------------------------------------
# VAR-KF on a CLS problem: the paper's sequential reference method.
# ---------------------------------------------------------------------------

def _info_init(prob: cls_mod.CLSProblem) -> KFState:
    """Initialize from the state system H0 x = y0 (information form).

    Since rank(H0) = n, the GLS solution of the state system alone is
    x = (H0^T R0 H0)^-1 H0^T R0 y0 with covariance P = (H0^T R0 H0)^-1.
    """
    N = (prob.H0.T * prob.R0) @ prob.H0
    P = torch.linalg.inv(N)
    return KFState(x=P @ (prob.H0.T @ (prob.R0 * prob.y0)), P=P)


def solve_cls_sequential(prob: cls_mod.CLSProblem,
                         block: int = 1) -> torch.Tensor:
    """Assimilate the m1 observation rows sequentially (KF corrector steps,
    M = I, Q = 0) — 'KF procedure on CLS problem' of paper §6.

    The result equals the direct CLS solve up to roundoff; tests assert this.
    ``block`` rows are assimilated per corrector step (m1 % block == 0).
    """
    m1 = prob.H1.shape[0]
    assert m1 % block == 0, (m1, block)
    state = _info_init(prob)
    for H, y, R in zip(prob.H1.reshape(m1 // block, block, prob.n),
                       prob.y1.reshape(m1 // block, block),
                       prob.R1.reshape(m1 // block, block)):
        state = correct(state, H, y, R)
    return state.x
