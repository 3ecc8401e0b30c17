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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig


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


def _prefill(cfg: ModelConfig, params, x, *, pad: bool, mode: str):
    """The block over a sequence x (B, S, D): (out (B, S, D), the
    pre-conv (x, B, C) stream (B, S, conv_dim), the final ssm state).
    ``pad`` pads S to a multiple of the chunk (dt = 0 there, which keeps
    the state), as ``apply_ssd`` does; without it S must be one, as in
    the reference prefill."""
    B_, S, D = x.shape
    di, nh, g, N = _dims(cfg)
    z, xs, Bm, Cm, dt = torch.split(x @ params["in_proj"],
                                    [di, di, g * N, g * N, nh], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    conv = F.silu(nn.causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(conv, [di, g * N, g * N], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                 # (B, S, nh)
    A = -torch.exp(params["A_log"])                         # (nh,)
    xh = xs.reshape(B_, S, nh, cfg.ssm_headdim)
    chunk = min(cfg.ssm_chunk, S)
    extra = (-S) % chunk if pad else 0

    def seq(t):   # f32, zero-padded along the sequence by `extra` steps
        t = t.float()
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra)) if extra else t

    y, state = ssd_forward_with_state(
        seq(xh), seq(dt), A, seq(Bm).reshape(B_, S + extra, g, N),
        seq(Cm).reshape(B_, S + extra, g, N), chunk, mode=mode)
    y = y[:, :S].to(x.dtype) + xh * params["D"][None, None, :, None]
    y = nn.rms_norm(y.reshape(B_, S, di) * F.silu(z), params["norm"],
                    cfg.norm_eps)
    return y @ params["out_proj"], xbc, state


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
    S <- exp(dt*A) S + dt * B x^T ;  y = C S + D x."""
    B_ = x.shape[0]
    di, nh, g, N = _dims(cfg)
    z, xs, Bm, Cm, dt = torch.split(x[:, 0] @ params["in_proj"],
                                    [di, di, g * N, g * N, nh], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv_w = params["conv_w"]
    conv = sum(hist[:, i, :] * conv_w[i] for i in range(cfg.ssm_conv))
    conv = F.silu(conv + params["conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, g * N, g * N], dim=-1)

    dt = F.softplus(dt + params["dt_bias"]).float()
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B_, nh, cfg.ssm_headdim).float()
    rep = nh // g
    Bh = Bm.reshape(B_, g, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B_, g, N).repeat_interleave(rep, dim=1).float()

    decay = torch.exp(dt * A)                               # (B, nh)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, xh)
    state = decay[:, :, None, None] * cache["state"] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y.to(x.dtype) + xh.to(x.dtype) * params["D"][None, :, None]
    y = nn.rms_norm(y.reshape(B_, di) * F.silu(z), params["norm"],
                    cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": hist[:, 1:, :], "state": state}
