"""Mamba-2 SSD (state-space duality) block (arXiv:2405.21060).

The counterpart of ``repro.models.ssd``.  The selective SSM with
scalar-times-identity A is computed with the SSD chunked algorithm:
within a chunk the output is a masked attention-like matmul (duality),
and chunk-to-chunk information flows through the recurrent state
S_c = (decay) S_{c-1} + B_c^T (decay-weighted X_c).

Shapes follow the Mamba-2 reference: inner dim di = expand * d_model,
heads nh = di / headdim, state N = ssm_state, groups G (B/C shared
across heads within a group).

The scan runs through :func:`repro_torch.kernels.ops.ssd_scan` on the
head-folded tensors (the CUDA kernel on the card, its plain version on
the CPU), with B and C left ungrouped: head h of a group reads the
group's row, so the ``nh / G``-fold copy of B and C is never made.
Decode carries (conv_state, ssm_state (B, nh, N, hd)), O(1) per token,
and runs no kernel.

On a mesh whose "model" axis splits ``ssm_inner``
(:mod:`repro_torch.runtime.tp`) each rank computes its heads.  The
reference's spec cuts the packed ``in_proj`` (d, 2 di + 2 G N + nh),
``conv_w`` and ``conv_b`` in contiguous blocks, which are not the z, x
and dt columns of a rank's heads, so those three leaves
(:data:`WHOLE_LEAVES`) reach the rank whole and it slices out the z, x
and dt columns of its heads and the whole B and C; ``out_proj`` and
``norm`` split by heads already.  ``A_log``, ``D`` and ``dt_bias`` are
whole and sliced to the rank's heads (their gradients psummed), the gated
norm over di psums its squares, and ``out_proj`` is row-parallel.  The
decode cache keeps every head: the prefill and each decode step
all-gather the rank's states and conv rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import sharding, tp

# The leaves that reach a rank whole over "model" (their spec's blocks
# are not a rank's heads).
WHOLE_LEAVES = ("in_proj", "conv_w", "conv_b")


def _dims(cfg: ModelConfig):
    """(di, nh, G, N)."""
    di = cfg.ssm_expand * cfg.d_model
    return di, di // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state


def make_ssd_params(b: nn.Builder, cfg: ModelConfig):
    d = cfg.d_model
    di, nh, g, N = _dims(cfg)
    conv_dim = di + 2 * g * N
    return {
        "in_proj": b.param((d, 2 * di + 2 * g * N + nh), ("embed",
                                                          "ssm_inner")),
        "conv_w": b.param((cfg.ssm_conv, conv_dim), (None, "ssm_inner"),
                          scale=1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": b.param((conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": b.param((nh,), (None,), init="zeros"),
        "D": b.param((nh,), (None,), init="ones"),
        "dt_bias": b.param((nh,), (None,), init="zeros"),
        "norm": b.param((di,), ("ssm_inner",), init="zeros"),
        "out_proj": b.param((di, d), ("ssm_inner", "embed")),
    }


def ssd_forward_with_state(x, dt, A, B, C, chunk: int, *,
                           mode: str = "auto"):
    """The chunked SSD in the model layout, and the final ssm state.

    x: (b, s, nh, hd), dt: (b, s, nh), A: (nh,), B/C: (b, s, g, N) ->
    y (b, s, nh, hd) and the state (b, nh, N, hd) in f32.  The
    reference's counterpart lives in ``repro.models.transformer``.
    Folds the heads into the batch, (b * nh, s, ...), and B/C to
    (b * g, s, N) for :func:`ops.ssd_scan` (``mode`` goes to it)."""
    b, s, nh, hd = x.shape
    g, N = B.shape[2], B.shape[3]

    def fold(t, rows):   # heads (or groups) into the batch, contiguous
        return t.transpose(1, 2).reshape(rows, s, *t.shape[3:]).contiguous()

    y, final = ops.ssd_scan(
        fold(x, b * nh), fold(dt, b * nh), A.float().repeat(b),
        fold(B, b * g), fold(C, b * g), chunk=chunk, state=True, mode=mode)
    return (y.view(b, nh, s, hd).permute(0, 2, 1, 3),
            final.view(b, nh, N, hd))


def ssd_ref(x, dt, A, B, C, chunk: int):
    """SSD chunked reference in the model layout (shapes as
    :func:`ssd_forward_with_state`) -> y (b, s, nh, hd): the plain
    version on any device."""
    return ssd_forward_with_state(x, dt, A, B, C, chunk, mode="plain")[0]


def heads_split(cfg: ModelConfig, norm_spec, model: int) -> bool:
    """Whether the block computes a rank's heads on a mesh whose "model"
    axis has ``model`` ranks and splits ``norm`` (di) as ``norm_spec``:
    its di must split on the heads' boundaries, with one group of B and
    C.  Otherwise the block reaches every rank whole."""
    di, nh, g, _ = _dims(cfg)
    return ("model" in sharding.spec_axes(norm_spec) and model > 1
            and nh % model == 0 and g == 1)


def _heads(cfg: ModelConfig, params):
    """(h0, h1) of this rank's heads where ``norm`` holds a share of di
    (:func:`tp.share`), else None."""
    di, nh, _, _ = _dims(cfg)
    sh = tp.share(params["norm"].shape[0], di)
    if sh is None:
        return None
    hd = cfg.ssm_headdim
    if sh[0] % hd or sh[1] % hd or cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"{cfg.name}: di = {di} splits over 'model' off the heads' "
            f"boundaries ({nh} heads of {hd}) or with {cfg.ssm_ngroups} "
            f"groups of B and C")
    return sh[0] // hd, sh[1] // hd


def _columns(cfg: ModelConfig, heads):
    """The columns of the packed ``in_proj`` that heads [h0, h1) read
    (their z, their x, the whole B and C, their dt) and those of the
    conv's channels (their x, B and C); None for every head."""
    if heads is None:
        return None, None
    di, nh, g, N = _dims(cfg)
    hd = cfg.ssm_headdim
    x = torch.arange(heads[0] * hd, heads[1] * hd)
    bc = torch.arange(2 * di, 2 * di + 2 * g * N)
    dt = 2 * di + 2 * g * N + torch.arange(heads[0], heads[1])
    return (torch.cat([x, di + x, bc, dt]),
            torch.cat([x, bc - di]))


def _gated_norm(y, z, weight, eps: float, di: int, split: bool):
    """RMSNorm over di of y * silu(z), the squares psummed over the ranks
    where y holds a rank's heads."""
    y = y * F.silu(z)
    if not split:
        return nn.rms_norm(y, weight, eps)
    dt = y.dtype
    yf = y.float()
    ss = tp.allreduce(torch.sum(yf * yf, dim=-1, keepdim=True))
    out = yf * torch.rsqrt(ss / di + eps)
    return (out * (1.0 + weight.float())).to(dt)


def _local_params(cfg: ModelConfig, params, heads):
    """(conv_w, conv_b, A_log, D, dt_bias) of heads [h0, h1) (all of them
    off a mesh)."""
    names = ("conv_w", "conv_b", "A_log", "D", "dt_bias")
    if heads is None:
        return tuple(params[k] for k in names)
    _, conv = _columns(cfg, heads)
    conv = conv.to(params["conv_w"].device)
    # the replicated per-head leaves: each rank's gradient is a part
    a, d, b = (tp.enter(params[k], grad_dtype=torch.float32)[
        heads[0]:heads[1]] for k in ("A_log", "D", "dt_bias"))
    return (params["conv_w"].index_select(1, conv),
            params["conv_b"].index_select(0, conv), a, d, b)


def _local_in_proj(cfg: ModelConfig, params, heads):
    """The ``in_proj`` columns of heads [h0, h1): their z, x and dt, and
    the whole B and C (all of them off a mesh)."""
    if heads is None:
        return params["in_proj"]
    cols, _ = _columns(cfg, heads)
    return params["in_proj"].index_select(
        1, cols.to(params["in_proj"].device))


def _prefill(cfg: ModelConfig, params, x, *, pad: bool, mode: str):
    """The block over a sequence x (B, S, D): (out (B, S, D), the
    pre-conv (x, B, C) stream (B, S, conv_dim') of the rank's channels,
    the final ssm state of its heads).  ``pad`` pads S to a multiple of
    the chunk (dt = 0 there, which keeps the state), as ``apply_ssd``
    does; without it S must be one, as in the reference prefill."""
    B_, S, D = x.shape
    di, nh, g, N = _dims(cfg)
    heads = _heads(cfg, params)
    if heads is not None:
        x = tp.enter(x)
        nh = heads[1] - heads[0]
    dl = nh * cfg.ssm_headdim
    conv_w, conv_b, A_log, D_, dt_bias = _local_params(cfg, params, heads)
    z, xs, Bm, Cm, dt = torch.split(x @ _local_in_proj(cfg, params, heads),
                                    [dl, dl, g * N, g * N, nh], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    conv = F.silu(nn.causal_conv(xbc, conv_w, conv_b))
    xs, Bm, Cm = torch.split(conv, [dl, g * N, g * N], dim=-1)
    dt = F.softplus(dt + dt_bias)                           # (B, S, nh)
    A = -torch.exp(A_log)                                   # (nh,)
    xh = xs.reshape(B_, S, nh, cfg.ssm_headdim)
    chunk = min(cfg.ssm_chunk, S)
    extra = (-S) % chunk if pad else 0

    def seq(t):   # f32, zero-padded along the sequence by `extra` steps
        t = t.float()
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra)) if extra else t

    y, state = ssd_forward_with_state(
        seq(xh), seq(dt), A, seq(Bm).reshape(B_, S + extra, g, N),
        seq(Cm).reshape(B_, S + extra, g, N), chunk, mode=mode)
    y = y[:, :S].to(x.dtype) + xh * D_[None, None, :, None]
    y = _gated_norm(y.reshape(B_, S, dl), z, params["norm"], cfg.norm_eps,
                    di, heads is not None)
    out = y @ params["out_proj"]
    return (tp.exit(out) if heads is not None else out), xbc, state


def cache_rows(cfg: ModelConfig, xbc, state, width: int, heads):
    """The decode cache of a prefill: the last ``width`` rows of the
    pre-conv stream and the final state, every head's (all-gathered over
    "model" where ``heads`` are a rank's)."""
    rows = xbc[:, -width:, :]
    if heads is None:
        return rows, state
    nh, hd = heads[1] - heads[0], cfg.ssm_headdim
    xs = rows[..., :nh * hd].unflatten(-1, (nh, hd))
    xs, state = tp.gather_dims([(xs, 2), (state, 1)])
    return torch.cat([xs.flatten(-2), rows[..., nh * hd:]], dim=-1), state


def apply_ssd(cfg: ModelConfig, params, x, *, mode: str = "auto"):
    """Mamba-2 block, training and prefill, with S padded to a multiple
    of the chunk as in the reference.  x: (B, S, D) -> (B, S, D);
    ``mode`` goes to :func:`ops.ssd_scan`."""
    return _prefill(cfg, params, x, pad=True, mode=mode)[0]


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device):
    di, nh, g, N = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * g * N),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, N, cfg.ssm_headdim),
                             dtype=torch.float32, device=device),
    }


def decode_ssd(cfg: ModelConfig, params, cache, x):
    """x: (B, 1, D) -> (out (B, 1, D), new_cache).  Exact recurrent step:
    S <- exp(dt*A) S + dt * B x^T ;  y = C S + D x.  On a mesh that
    splits the heads the rank steps its own: the whole new conv row (the
    whole ``in_proj`` is on every rank), its heads' states, all-gathered
    into the whole cache."""
    B_ = x.shape[0]
    di, nh, g, N = _dims(cfg)
    heads = _heads(cfg, params)
    hd = cfg.ssm_headdim
    conv_w, conv_b, A_log, D_, dt_bias = _local_params(cfg, params, heads)
    z, xbc, dt = torch.split(x[:, 0] @ params["in_proj"],
                             [di, di + 2 * g * N, nh], dim=-1)
    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    state_prev = cache["state"]
    if heads is not None:
        h0, h1 = heads
        _, conv_cols = _columns(cfg, heads)
        hist_r = hist.index_select(2, conv_cols.to(hist.device))
        z, dt = z[:, h0 * hd:h1 * hd], dt[:, h0:h1]
        state_prev = state_prev[:, h0:h1]
        nh = h1 - h0
    else:
        hist_r = hist
    conv = sum(hist_r[:, i, :] * conv_w[i] for i in range(cfg.ssm_conv))
    conv = F.silu(conv + conv_b)
    xs, Bm, Cm = torch.split(conv, [nh * hd, g * N, g * N], dim=-1)

    dt = F.softplus(dt + dt_bias).float()
    A = -torch.exp(A_log)
    xh = xs.reshape(B_, nh, hd).float()
    rep = max(nh // g, 1)
    Bh = Bm.reshape(B_, g, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B_, g, N).repeat_interleave(rep, dim=1).float()

    decay = torch.exp(dt * A)                               # (B, nh)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, xh)
    state = decay[:, :, None, None] * state_prev + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y.to(x.dtype) + xh.to(x.dtype) * D_[None, :, None]
    y = _gated_norm(y.reshape(B_, nh * hd), z, params["norm"],
                    cfg.norm_eps, di, heads is not None)
    out = (y @ params["out_proj"])[:, None, :]
    if heads is not None:
        out = tp.exit(out)
        state = tp.all_gather(state, 1)
    return out, {"conv": hist[:, 1:, :], "state": state}
