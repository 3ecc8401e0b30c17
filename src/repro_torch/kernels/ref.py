"""Plain PyTorch versions of the kernels.

The counterparts of ``repro.kernels.ref.gram_ref``, ``schwarz_fwd_ref``,
``schwarz_bwd_ref``, ``attention_ref`` and ``rglru_scan_ref``.  They
compute the same functions as the CUDA kernels of
:mod:`repro_torch.kernels.gram`, :mod:`~repro_torch.kernels.schwarz_step`,
:mod:`~repro_torch.kernels.flash_attention` and
:mod:`~repro_torch.kernels.rglru_scan`: the CPU path runs them, and the
card's checks hold each kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Softmax attention with f32 scores.  q, k, v: (BH, S, D) ->
    (BH, S, D) in q's dtype; a key is visible when (causal) it is not
    after the query and (window > 0) it is less than ``window`` before
    it; masked scores are -1e30."""
    s, d = q.shape[1], q.shape[2]
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    scores = torch.where(ok[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def rglru_scan_plain(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, one step at a time in f32.
    a, b: (B, S, W) -> h: (B, S, W) in a's dtype."""
    a32, b32 = a.float(), b.float()
    h = torch.empty_like(a32)
    state = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        state = a32[:, t] * state + b32[:, t]
        h[:, t] = state
    return h.to(a.dtype)
