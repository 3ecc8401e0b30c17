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


def attention_shapes(name: str, q_shape, k_shape, v_shape, *,
                     causal: bool = False, window: int = 0) -> int:
    """Raise ``ValueError`` unless q is (BH, S_q, D) and k, v are both
    (BH_kv, S_kv, D) with BH_kv dividing BH; S_kv may differ from S_q only
    in non-causal attention with no window (a cross-attention: the
    reference asks for no causal or windowed one).  Returns BH // BH_kv."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) != 3 or min(q_shape) < 1:
        raise ValueError(f"{name}: q must be (BH, S, D) with BH, S, D >= 1 "
                         f"(got {q_shape})")
    bh = q_shape[0]
    if (len(k_shape) != 3 or k_shape[2] != q_shape[2] or k_shape[0] < 1
            or k_shape[1] < 1 or bh % k_shape[0]):
        raise ValueError(f"{name}: k must be (BH_kv, S_kv, D) with BH_kv "
                         f"dividing BH = {bh} (got {k_shape} for q "
                         f"{q_shape})")
    if k_shape[1] != q_shape[1] and (causal or window > 0):
        raise ValueError(f"{name}: k has S_kv = {k_shape[1]} rows against "
                         f"S = {q_shape[1]} query rows; S_kv may differ from "
                         f"S only when causal is false and window is 0 "
                         f"(causal {causal}, window {window})")
    if tuple(v_shape) != k_shape:
        raise ValueError(f"{name}: v has shape {tuple(v_shape)}, expected "
                         f"k's {k_shape}")
    return bh // k_shape[0]


def _visible(s: int, causal: bool, window: int, device, s_kv: int | None
             = None):
    """(S, S_kv) bool (S_kv defaults to S): key k visible to query q."""
    s_kv = s if s_kv is None else s_kv
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s_kv, device=device)[None, :]
    ok = torch.ones((s, s_kv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    lse: bool = False, scale: float | None = None,
                    softcap: float = 0.0):
    """Softmax attention with f32 scores (f64 for f64 inputs).  q: (BH,
    S, D), k, v: (BH_kv, S_kv, D) with BH_kv dividing BH, expanded along
    dim 0 in ``repeat_interleave``'s order -> (BH, S, D) in q's dtype; a
    key is visible when (causal) it is not after the query and (window >
    0) it is less than ``window`` before it; masked scores are -1e30.
    S_kv differs from S only in a non-causal call with no window
    (:func:`attention_shapes`).  ``softcap`` > 0 caps the scaled scores
    as cap tanh(s / cap) before the mask (the reference's
    ``attn_softcap``).  With ``lse`` also the log-sum-exp of each row's
    scaled (and capped) scores, (BH, S) in f32 (f64), which the backward
    reads.  ``scale`` defaults to 1 / sqrt(D); a head dimension
    zero-padded to D keeps its own."""
    rep = attention_shapes("attention_plain", q.shape, k.shape, v.shape,
                           causal=causal, window=window)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    s, d = q.shape[1], q.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scores = torch.einsum("bqd,bkd->bqk", q.to(wide), k.to(wide)) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    ok = _visible(s, causal, window, q.device, k.shape[1])
    scores = torch.where(ok[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", probs, v.to(wide)).to(q.dtype)
    if lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


# Elements of V_j - O_i that attention_bwd_plain holds at once (1 GB in
# f64): its dQ takes the difference element by element, over chunks of
# query rows.
ATTN_DIFF_ELEMENTS = 1 << 27


def _dq_scores(dof, ve, of, causal: bool, window: int):
    """(BH, S, S_kv): dO_i . (V_j - O_i), the difference taken inside the
    sum over D, for the keys each chunk of query rows may see (0
    elsewhere)."""
    bh, s, d = dof.shape
    s_kv = ve.shape[1]
    span = min(s_kv, window) if window > 0 else s_kv
    rows = max(1, ATTN_DIFF_ELEMENTS // (bh * d * span))
    out = dof.new_zeros((bh, s, s_kv))
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        k0 = max(0, i0 - window + 1) if window > 0 else 0
        k1 = i1 if causal else s_kv
        diff = ve[:, None, k0:k1] - of[:, i0:i1, None]   # (BH, r, keys, D)
        out[:, i0:i1, k0:k1] = torch.matmul(diff,
                                            dof[:, i0:i1, :, None])[..., 0]
    return out


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None,
                        softcap: float = 0.0):
    """The gradients (dq, dk, dv) of :func:`attention_plain` by the FA2
    formulas the kernels evaluate: P = exp(s / sqrt(D) - lse) on visible
    keys, Delta = rowsum(dO .* O), dS = P .* (dO V^T - Delta), dK = dS^T
    Q / sqrt(D) and dV = P^T dO, with dK and dV of a shared kv row summed
    over the query rows it serves; dQ = dS K / sqrt(D) in bf16, as the
    bf16 kernel, and in f32 and f64, as the f32 kernel, (dS' K - m P K) /
    sqrt(D) with dS'_ij = P_ij dO_i . (V_j - O_i), the difference taken
    inside the sum over D, so that a row whose softmax sits nearly on one
    key (V_j ~ O_i) keeps its digits, and m_i = sum_j dS'_ij / sum_j P_ij,
    0 in exact arithmetic, which takes out the rounding of the saved o and
    lse against P (it would otherwise reach dQ as m_i times the
    P-weighted mean of K, far larger than the dQ of a row whose dS nearly
    cancels); f32 inside (f64 for f64 inputs), each gradient in its
    input's dtype.  ``scale`` (1 / sqrt(D) by default) as in
    :func:`attention_plain`.

    ``softcap`` > 0: with t = tanh(s / sqrt(D) / cap), P = exp(cap t -
    lse) and every dS is multiplied by g = 1 - t^2 before it meets K or
    Q: dK = (g .* dS)^T Q / sqrt(D), and dQ = (g .* dS) K / sqrt(D) in
    bf16, (sum_j g_ij dS'_ij K_j - m_i sum_j g_ij P_ij K_j) / sqrt(D) in
    f32 and f64 with dS' and m unchanged (the m term carries g too); dV
    is unchanged."""
    rep = attention_shapes("attention_bwd_plain", q.shape, k.shape,
                           v.shape, causal=causal, window=window)
    bh_kv, s_kv, d = k.shape
    wide = torch.promote_types(q.dtype, torch.float32)
    ke = k.to(wide).repeat_interleave(rep, dim=0)
    ve = v.to(wide).repeat_interleave(rep, dim=0)
    qf, dof, of = q.to(wide), do.to(wide), o.to(wide)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scores = torch.einsum("bqd,bkd->bqk", qf, ke) * scale
    gate = None
    if softcap > 0:
        t = torch.tanh(scores / softcap)
        scores = t * softcap
        gate = 1 - t * t
        del t
    ok = _visible(q.shape[1], causal, window, q.device, s_kv)[None]
    p = torch.where(ok, torch.exp(scores - lse.to(wide)[..., None]), 0.0)
    del scores
    delta = (dof * of).sum(-1)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, ve) - delta[..., None])
    if gate is not None:
        ds = ds * gate
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    if q.dtype == torch.bfloat16:
        dq = torch.einsum("bqk,bkd->bqd", ds, ke) * scale
    else:
        del ds
        ds = p * _dq_scores(dof, ve, of, causal, window)
        mean = ds.sum(-1) / p.sum(-1).clamp_min(torch.finfo(wide).tiny)
        if gate is not None:
            ds, p = ds * gate, p * gate
        dq = (torch.einsum("bqk,bkd->bqd", ds, ke)
              - mean[..., None] * torch.einsum("bqk,bkd->bqd", p, ke)) * scale
    dk = dk.view(bh_kv, rep, s_kv, d).sum(1)
    dv = dv.view(bh_kv, rep, s_kv, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_plain(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, one step at a time in f32.
    a, b: (B, S, W) -> h: (B, S, W) in a's dtype."""
    a32, b32 = a.float(), b.float()
    state = torch.zeros_like(a32[:, 0])
    h = []
    for t in range(a.shape[1]):
        state = a32[:, t] * state + b32[:, t]
        h.append(state)
    return torch.stack(h, dim=1).to(a.dtype)


RGLRU_BWD_CHUNK = 64   # steps a chunk of the backward kernel (kChunk)


def rglru_scan_bwd_plain(a, h, dh, *, chunk: int = RGLRU_BWD_CHUNK):
    """The gradients (da, db) of :func:`rglru_scan_plain` from its output
    h: the reverse scan g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t and
    da_t = g_t h_{t-1} (h_{-1} = 0), in f32, in a's dtype; in the steps
    the kernel takes (``csrc/rglru_scan.cu``), over chunks of ``chunk``
    steps [t0, t1) (the last one ragged):

    * chunk: each chunk's reverse scan from a zero carry, keeping
      u_k = a_{t0} g_{t0} and A_k, the product of its own a's;
    * carry: x_{nc-1} = 0 and x_{k-1} = u_k + A_k x_k, the value that
      enters chunk k - 1 (a_{t1} g_{t1} of the chunk after it);
    * out: each chunk's reverse scan again from x_k, giving da and db.

    Every chunk advances at once, so the loops run ``chunk`` and ``nc``
    steps, not S."""
    if chunk < 1:
        raise ValueError(f"rglru_scan_bwd_plain: chunk must be >= 1 (got "
                         f"{chunk})")
    bsz, s, w = a.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    # Steps past S: a = 1 and dh = 0 carry a zero gradient and leave the
    # last chunk's product A alone.
    a32 = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    dh32 = torch.nn.functional.pad(dh.float(), (0, 0, 0, pad))
    # h_{t-1}: h moved one step later, 0 at t = 0 (a pad of -1 crops).
    hprev = torch.nn.functional.pad(h.float(), (0, 0, 1, pad - 1))
    a32, dh32, hprev = (t.reshape(bsz, nc, chunk, w)
                        for t in (a32, dh32, hprev))

    g = torch.zeros_like(a32[:, :, 0])
    an = torch.zeros_like(g)
    prod = torch.ones_like(g)
    for t in reversed(range(chunk)):
        g = dh32[:, :, t] + an * g
        an = a32[:, :, t]
        prod = prod * an
    u = an * g

    x = [None] * nc
    x[nc - 1] = torch.zeros_like(g[:, 0])
    for k in range(nc - 1, 0, -1):
        x[k - 1] = u[:, k] + prod[:, k] * x[k]
    g = torch.stack(x, dim=1)
    an = torch.ones_like(g)
    db = [None] * chunk
    da = [None] * chunk
    for t in reversed(range(chunk)):
        g = dh32[:, :, t] + an * g
        an = a32[:, :, t]
        db[t] = g
        da[t] = g * hprev[:, :, t]
    da = torch.stack(da, dim=2).reshape(bsz, nc * chunk, w)[:, :s]
    db = torch.stack(db, dim=2).reshape(bsz, nc * chunk, w)[:, :s]
    return da.to(a.dtype), db.to(a.dtype)


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
    # exponent of i < j may overflow to inf and inf * 0 is NaN; the
    # exponent is selected too, so that autograd's exp' is never inf.
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    L = torch.where(causal, exp(torch.where(
        causal, cum[..., :, None] - cum[..., None, :], 0.0)), 0.0)
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


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, *, chunk: int = 256,
                       matmul=torch.matmul):
    """The gradients (dx, ddt, dA, dB, dC) of :func:`ssd_scan_plain`'s y
    (the final state gets none), in the steps the kernel takes
    (``csrc/ssd_scan_bwd.cu``), in f32 with the in-chunk cumulative decay
    in f64 as in the forward.  Per head and chunk, with
    Lm = exp(cum_l - cum_m) (m <= l), G = C B^T, M = G .* Lm .* dt_m,
    w = dt exp(cum_last - cum), e = exp(cum) and S_prev the state before
    the chunk:

    * ychunk (per head and chunk): Y_c = (e .* C)^T dy (N, P);
    * rpass (per head, slices of the state): the state gradients in
      reverse, R_c = Y_c + exp(cum_last) R_{c+1}, keeping dS_c = R_{c+1}
      (the gradient of the chunk's own state) and ddecay_c = sum(dS_c .*
      S_prev);
    * col (per group, chunk and rows m, the group's heads in turn):
      dM = dy x^T, once; dG = dM .* Lm .* dt_m; Z = dG .* G; g = B dS;
      dx = M^T dy + w g; ddt = sum_l dM .* G .* Lm + exp(cum_last -
      cum_m) (x . g); the row sums of Z and, for the column,
      -sum_l Z - w (x . g); the heads' sums sum_h dG and
      sum_h (w x) dS^T, which gives dB with (sum_h dG)^T C;
    * row (per group, chunk and rows l, the heads in turn): P1 = dy
      S_prev^T, dc = e P1 summed over the heads, the row sum
      C_l . dc_l per head; dC = sum_h dc + (sum_h dG) B;
    * dcum (per head): cum_last also gets sum_m w (x . g) + ddecay
      exp(cum_last); the reverse in-chunk cumsum of dcum is the gradient
      of dt * A, which gives ddt's last term and dA.

    B and C are shared by the heads of a group, so dG B and dG^T C are
    formed once per group from the heads' sum of dG.  ``matmul`` takes
    every matrix product of those steps (the tests pass one that rounds
    as the kernel's tensor cores do).

    x (BH, S, P), dt (BH, S), A (BH,), B/C (BH / rep, S, N), dy like x ->
    dx, ddt, dA, dB, dC in their inputs' shapes and dtypes."""
    bh, s, p = x.shape
    groups, n = B.shape[0], B.shape[2]
    rep = bh // groups
    chunk = ssd_chunk(s, chunk)
    nc = s // chunk
    mm = matmul
    xc = x.float().reshape(groups, rep, nc, chunk, p)
    dyc = dy.float().reshape(groups, rep, nc, chunk, p)
    dtc = dt.float().reshape(groups, rep, nc, chunk)
    Af = A.float().reshape(groups, rep, 1, 1)
    Bc = B.float().reshape(groups, nc, chunk, n)
    Cc = C.float().reshape(groups, nc, chunk, n)
    cum = torch.cumsum((dtc * Af).double(), dim=-1)

    def exp(t):   # of an f64 exponent, in f32
        return torch.exp(t.float())

    # The forward's quantities, which the kernel reads from its
    # workspaces: G and the state before each chunk.
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    Lm = torch.where(causal, exp(torch.where(
        causal, cum[..., :, None] - cum[..., None, :], 0.0)), 0.0)
    G = torch.where(causal, torch.einsum("gcln,gcmn->gclm", Cc, Bc)[:, None],
                    0.0)
    tail = exp(cum[..., -1:] - cum)                      # exp(cum_last - cum)
    w = tail * dtc
    decay = exp(cum[..., -1])                            # (g, rep, nc)
    states = torch.einsum("gcln,grclp->grcnp", Bc, xc * w[..., None])
    carry = torch.zeros(groups, rep, n, p, dtype=torch.float32,
                        device=x.device)
    before = []
    for c in range(nc):
        before.append(carry)
        carry = decay[..., c, None, None] * carry + states[:, :, c]
    sprev = torch.stack(before, dim=2)                   # (g, rep, nc, n, p)
    ecum = exp(cum)

    # ychunk and rpass.
    yc = mm((Cc[:, None] * ecum[..., None]).mT, dyc)     # (g, rep, nc, n, p)
    r = torch.zeros_like(carry)
    ds, ddecay = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        ds[c] = r
        ddecay[c] = (r * sprev[:, :, c]).sum((-1, -2))
        r = yc[:, :, c] + decay[..., c, None, None] * r
    ds = torch.stack(ds, dim=2)                          # (g, rep, nc, n, p)
    ddecay = torch.stack(ddecay, dim=2)                  # (g, rep, nc)

    # col: per m, the heads' sums over the group.
    dM = mm(dyc, xc.mT)                                  # (.., l, m)
    dG = dM * Lm * dtc[..., None, :]
    Z = (dG * G).double()
    gds = mm(Bc[:, None], ds)                            # B dS (.., m, p)
    bv = (xc * gds).sum(-1)                              # B . (dS x_m)
    M = G * Lm * dtc[..., None, :]
    dx = mm(M.mT, dyc) + w[..., None] * gds
    ddt = (dM * G * Lm).sum(-2) + tail * bv
    dcum = Z.sum(-1) - Z.sum(-2) - w * bv
    dGs = dG.sum(1)                                      # (g, nc, l, m)
    # sum_h (w x_h) dS_h^T as one product over (head, p).
    wx = (w[..., None] * xc).permute(0, 2, 3, 1, 4).reshape(
        groups, nc, chunk, rep * p)
    dsT = ds.mT.permute(0, 2, 1, 3, 4).reshape(groups, nc, rep * p, n)
    dB = mm(wx, dsT) + mm(dGs.mT, Cc)

    # row: per l.
    dc = ecum[..., None] * mm(dyc, sprev.mT)             # (.., l, n)
    dcum = dcum + (dc * Cc[:, None]).sum(-1).double()
    dC = dc.sum(1) + mm(dGs, Bc)

    # dcum: cum_last's own terms, then the reverse in-chunk cumsum.  The
    # sums that build dcum, its cumsum and dA run in f64, as autograd
    # through the forward's f64 cumsum runs them: the row and column
    # sums of G .* dG cancel in the reverse cumsum (at Mamba-2's decays
    # to ~1e-3 of their size, which in f32 puts ~1e-3 into dA).
    last = (w * bv).double().sum(-1) + ddecay * decay
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], -1)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + Af * dda.float()
    dA = (dtc.double() * dda).sum((-1, -2)).reshape(bh)
    return (dx.reshape(bh, s, p).to(x.dtype), ddt.reshape(bh, s).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(groups, s, n).to(B.dtype),
            dC.reshape(groups, s, n).to(C.dtype))
