"""Plain PyTorch versions of the DD-KF kernels.

The counterparts of ``repro.kernels.ref.gram_ref``, ``schwarz_fwd_ref``
and ``schwarz_bwd_ref``.  They compute the same functions as the CUDA
kernels of :mod:`repro_torch.kernels.gram` and
:mod:`repro_torch.kernels.schwarz_step`: the CPU path runs them, and the
card's checks hold each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch


def gram_plain(A, r):
    """N = A^T diag(r) A, batched.  A: (p, m, w), r: (p, m) -> (p, w, w)."""
    return torch.einsum("pmw,pm,pmv->pwv", A, r, A)


def schwarz_fwd_plain(A, x, wdiv):
    """Forward half of the Schwarz step: (y, u) = (A @ (x * wdiv), A @ x)
    as one stacked two-column matmat over A.  A: (p, m, w), x/wdiv:
    (p, w) -> two (p, m) tensors."""
    xs = torch.stack([x * wdiv, x], dim=1)          # (p, 2, w)
    yu = torch.einsum("pmw,pkw->pkm", A, xs)
    return yu[:, 0], yu[:, 1]


def schwarz_bwd_plain(A, r, b, Ax, u, x, muov, mask):
    """Backward half: rhs = (A^T @ (r * (b - Ax + u)) + muov * x) * mask.
    A: (p, m, w), r/b/Ax: (m,), u: (p, m), rest (p, w) -> (p, w)."""
    resid = (b - Ax)[None] + u                      # (p, m)
    t = r[None] * resid
    return (torch.einsum("pmw,pm->pw", A, t) + muov * x) * mask
