"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

The counterpart of ``repro.models.rglru``.  The temporal mixing is the
Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    (per-channel decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin recurrent block: linear in-proj to a gated branch
(GeLU) and a recurrent branch (temporal conv1d width 4 -> RG-LRU), merged
by elementwise product and projected out.  The training and prefill
recurrence runs through :func:`repro_torch.kernels.ops.rglru_scan` (the
CUDA kernel and its backward on the card, the plain versions on the
CPU); decode carries (h, conv_state), O(1) per step.

On a mesh whose "model" axis splits the ``lru`` channels
(:mod:`repro_torch.runtime.tp`) the conv, the gates and the decay act
per channel, so a rank's channels are exact with no collective until
``w_out``, row-parallel, whose partial sums are psummed.  The decode
cache keeps every channel (its spec splits rows alone): the prefill and
each decode step all-gather the rank's new state and conv rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import tp

_C = 8.0


def make_rglru_params(b: nn.Builder, cfg: ModelConfig):
    d = cfg.d_model
    w = _width(cfg)
    conv = 4
    return {
        "w_in_rec": b.param((d, w), ("embed", "lru")),
        "w_in_gate": b.param((d, w), ("embed", "lru")),
        "w_out": b.param((w, d), ("lru", "embed")),
        "conv_w": b.param((conv, w), (None, "lru"),
                          scale=1.0 / math.sqrt(conv)),
        "conv_b": b.param((w,), ("lru",), init="zeros"),
        "gate_a": b.param((w,), ("lru",), init="zeros"),
        "gate_x": b.param((w,), ("lru",), init="zeros"),
        # Lambda parametrized so a in (0.9, 0.999) at init
        "log_lambda": b.param((w,), ("lru",), init="zeros"),
    }


def _decay(params, x_rec):
    """Per-timestep decay a_t and input scale, both like x_rec."""
    lam = F.softplus(params["log_lambda"] + 4.0) / _C
    r = torch.sigmoid(x_rec + params["gate_a"])
    a = torch.exp(-_C * lam * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))


def _scan_inputs(params, rec_c):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, in f32."""
    a, b_scale = _decay(params, rec_c)
    bx = b_scale * torch.sigmoid(params["gate_x"]) * rec_c
    return a.float(), bx.float()


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _channels(cfg: ModelConfig, params):
    """(c0, c1) of this rank's ``lru`` channels where the params hold a
    share of them (:func:`tp.share`), else None."""
    return tp.share(params["w_in_rec"].shape[1], _width(cfg))


def _prefill(cfg: ModelConfig, params, x, mode: str = "auto"):
    """The block's prefill body: (out (B, S, D), the f32 states
    hseq (B, S, W'), the pre-conv branch rec (B, S, W')) over the rank's
    channels W' (every channel off a mesh); the model's prefill builds
    its decode cache from the last two."""
    split = _channels(cfg, params) is not None
    if split:
        x = tp.enter(x)
    gate = nn.gelu(x @ params["w_in_gate"])
    rec = x @ params["w_in_rec"]
    rec_c = nn.causal_conv(rec, params["conv_w"], params["conv_b"])
    hseq = ops.rglru_scan(*_scan_inputs(params, rec_c), mode=mode)
    out = (hseq.to(x.dtype) * gate) @ params["w_out"]
    return (tp.exit(out) if split else out), hseq, rec


def apply_rglru(cfg: ModelConfig, params, x, *, mode: str = "auto"):
    """Griffin recurrent block, training and prefill.  x: (B, S, D) ->
    (B, S, D); ``mode`` goes to :func:`ops.rglru_scan`."""
    return _prefill(cfg, params, x, mode)[0]


# ---------------------------------------------------------------------------
# Decode (single step, O(1) state).
# ---------------------------------------------------------------------------

def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device):
    w = _width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 4 - 1, w), dtype=dtype, device=device),
    }


def decode_rglru(cfg: ModelConfig, params, cache, x):
    """x: (B, 1, D) -> (out (B, 1, D), new_cache).  On a mesh that splits
    the channels the rank steps its own and all-gathers the new state and
    conv row into the whole cache."""
    ch = _channels(cfg, params)
    h_prev, conv_prev = cache["h"], cache["conv"]
    if ch is not None:
        h_prev, conv_prev = h_prev[:, ch[0]:ch[1]], conv_prev[..., ch[0]:ch[1]]
    xt = x[:, 0]
    gate = nn.gelu(xt @ params["w_in_gate"])
    rec = xt @ params["w_in_rec"]

    conv_w = params["conv_w"]
    width = conv_w.shape[0]
    hist = torch.cat([conv_prev, rec[:, None, :]], dim=1)
    rec_c = sum(hist[:, i, :] * conv_w[i] for i in range(width))
    rec_c = rec_c + params["conv_b"]

    a, b_scale = _decay(params, rec_c[:, None, :])
    a, b_scale = a[:, 0], b_scale[:, 0]
    bx = b_scale * torch.sigmoid(params["gate_x"]) * rec_c
    h = a.float() * h_prev + bx.float()
    out = ((h.to(x.dtype) * gate) @ params["w_out"])[:, None, :]
    if ch is None:
        return out, {"h": h, "conv": hist[:, 1:, :]}
    h, rec = tp.gather_dims([(h, 1), (rec, 1)])
    conv = torch.cat([cache["conv"][:, 1:], rec[:, None, :]], dim=1)
    return tp.exit(out), {"h": h, "conv": conv}
