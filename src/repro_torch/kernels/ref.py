"""Plain PyTorch versions of the kernels.

The counterparts of ``repro.kernels.ref.gram_ref``, ``schwarz_fwd_ref``,
``schwarz_bwd_ref``, ``attention_ref``, ``rglru_scan_ref`` and
``ssd_heads_ref``.  They compute the same functions as the CUDA kernels
of :mod:`repro_torch.kernels.gram`,
:mod:`~repro_torch.kernels.schwarz_step`,
:mod:`~repro_torch.kernels.flash_attention`,
:mod:`~repro_torch.kernels.rglru_scan` and
:mod:`~repro_torch.kernels.ssd_scan`: the CPU path runs them, and the
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


def attention_shapes(name: str, q_shape, k_shape, v_shape) -> int:
    """Raise ``ValueError`` unless q is (BH, S, D) and k, v are both
    (BH_kv, S, D) with BH_kv dividing BH; returns BH // BH_kv."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) != 3 or min(q_shape) < 1:
        raise ValueError(f"{name}: q must be (BH, S, D) with BH, S, D >= 1 "
                         f"(got {q_shape})")
    bh = q_shape[0]
    if (len(k_shape) != 3 or k_shape[1:] != q_shape[1:] or k_shape[0] < 1
            or bh % k_shape[0]):
        raise ValueError(f"{name}: k must be (BH_kv, S, D) with BH_kv "
                         f"dividing BH = {bh} (got {k_shape} for q "
                         f"{q_shape})")
    if tuple(v_shape) != k_shape:
        raise ValueError(f"{name}: v has shape {tuple(v_shape)}, expected "
                         f"k's {k_shape}")
    return bh // k_shape[0]


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Softmax attention with f32 scores.  q: (BH, S, D), k, v:
    (BH_kv, S, D) with BH_kv dividing BH, expanded along dim 0 in
    ``repeat_interleave``'s order -> (BH, S, D) in q's dtype; a key is
    visible when (causal) it is not after the query and (window > 0) it
    is less than ``window`` before it; masked scores are -1e30."""
    rep = attention_shapes("attention_plain", q.shape, k.shape, v.shape)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
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


def ssd_chunk(s: int, chunk: int) -> int:
    """The chunk length of a scan over ``s`` steps: ``min(chunk, s)``,
    which must divide ``s``, as in the reference's scan."""
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"ssd_scan: the sequence length {s} is not a "
                         f"multiple of the chunk length {c} = min(chunk, S)")
    return c


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256,
                   state: bool = False):
    """Mamba-2 SSD, the chunked algorithm of the reference prefill's
    ``ssd_forward_with_state`` in the head-folded layout.  x: (BH, S, P),
    dt: (BH, S), A: (BH,), B/C: (BH / rep, S, N), row ``bh // rep``
    serving head ``bh`` -> y (BH, S, P) in x's dtype, and with ``state``
    also the state after the last chunk (BH, N, P) in f32.  C B^T is
    formed once per group and shared by its ``rep`` heads.  The in-chunk
    cumulative log-decay is summed in f64, as the kernel does: at the
    model's step sizes it reaches about -180 within a chunk, where f32
    rounding would put ~1e-5 into every exponent cum_i - cum_j."""
    bh, s, p = x.shape
    groups, n = B.shape[0], B.shape[2]
    rep = bh // groups
    chunk = ssd_chunk(s, chunk)
    nc = s // chunk
    xc = x.float().reshape(groups, rep, nc, chunk, p)
    dtc = dt.float().reshape(groups, rep, nc, chunk)
    Bc = B.float().reshape(groups, nc, chunk, n)
    Cc = C.float().reshape(groups, nc, chunk, n)
    cum = torch.cumsum((dtc * A.float().reshape(groups, rep, 1, 1)).double(),
                       dim=-1)

    def exp(t):   # of an f64 exponent, in f32
        return torch.exp(t.float())

    # L[i, j] = exp(cum_i - cum_j) for i >= j: a select, since the
    # exponent of i < j may overflow to inf and inf * 0 is NaN.
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    L = torch.where(causal, exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    CB = torch.einsum("gcln,gcmn->gclm", Cc, Bc)[:, None]
    y = torch.matmul(CB * L * dtc[..., None, :], xc)   # (g, rep, nc, l, p)
    w = exp(cum[..., -1:] - cum) * dtc
    states = torch.einsum("gcln,grclp->grcnp", Bc, xc * w[..., None])
    decay = exp(cum[..., -1])                            # (g, rep, nc)
    carry = torch.zeros(groups, rep, n, p, dtype=torch.float32,
                        device=x.device)
    before = []
    for c in range(nc):
        before.append(carry)
        carry = decay[..., c, None, None] * carry + states[:, :, c]
    prev = torch.stack(before, dim=2)                    # (g, rep, nc, n, p)
    y = y + torch.einsum("gcln,grcnp->grclp", Cc, prev) * exp(cum)[..., None]
    y = y.reshape(bh, s, p).to(x.dtype)
    if state:
        return y, carry.reshape(bh, n, p)
    return y
