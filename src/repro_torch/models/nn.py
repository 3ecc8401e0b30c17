"""Parameter builder and basic neural-net primitives.

The counterpart of ``repro.models.nn``.  Every parameter is declared
once through ``Builder.param`` with its shape, initializer and *logical*
sharding axes; the same declaration code produces, by the builder's
mode, (i) initialized tensors (``"init"``), (ii) ``meta``-device tensors
of the right shape and dtype (``"shape"``) and (iii) partition specs
(``"spec"``, :func:`repro_torch.runtime.sharding.param_spec`), so the
three never drift.  ``"init"`` draws every parameter from one explicit
``torch.Generator`` with the reference's scheme (fan-in-scaled normal,
``zeros``, ``ones``, an explicit ``scale``); the two packages give
different numbers from the same seed, so the parity tests carry the
reference's weights across
(:func:`repro_torch.convert.lm_params_from_numpy`).  The reference's
activation sharding constraints are dropped: on a mesh the partition is
stated by hand (:mod:`repro_torch.runtime.tp`), here in the MLP (column-
parallel up and gate, row-parallel down) and the vocab-parallel loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.runtime import sharding, tp


class Builder:
    """Collects parameter declarations in one of three modes: ``"init"``
    initializes them on ``device`` in ``dtype`` from ``generator`` (normal
    draws are made in f32, then cast), ``"shape"`` gives ``meta`` tensors
    in ``dtype``, ``"spec"`` their partition specs under the ambient mesh
    and sharding profile."""

    def __init__(self, generator: torch.Generator | None = None,
                 device=None, dtype=torch.float32, *, mode: str = "init"):
        if mode not in ("init", "spec", "shape"):
            raise ValueError(f"Builder mode must be 'init', 'spec' or "
                             f"'shape' (got {mode!r})")
        self.mode = mode
        self.generator = generator
        if mode == "shape":
            device = "meta"
        self.device = None if device is None else torch.device(device)
        self.dtype = dtype

    def param(self, shape, axes, init="normal", scale: float | None = None):
        shape = tuple(shape)
        if self.mode == "spec":
            return sharding.param_spec(shape, *axes)
        if self.mode == "shape":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            # fan-in scaling
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(self.dtype)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dt)


def layer_norm(x, weight, bias, eps: float):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


def make_norm_params(b: Builder, d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": b.param((d,), (None,), init="zeros")}
    return {"scale": b.param((d,), (None,), init="ones"),
            "bias": b.param((d,), (None,), init="zeros")}


def apply_norm(params, x, kind: str, eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


def causal_conv(x, w, b):
    """Causal depthwise conv1d over the sequence: x (B, S, W), w
    (width, W), b (W,) -> (B, S, W); the taps are summed in order."""
    width, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(width)) + b


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """Apply RoPE.  x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                      * (log_theta / half)).to(x.device)
    ang = positions[..., :, None].float() * freqs      # (..., S, half)
    ang = ang[..., None, :]                            # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def make_mlp_params(b: Builder, d: int, f: int, gated: bool):
    p = {"w_up": b.param((d, f), ("embed", "ff")),
         "w_down": b.param((f, d), ("ff", "embed"))}
    if gated:
        p["w_gate"] = b.param((d, f), ("embed", "ff"))
    return p


def gelu(x):
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, act: str, gated: bool, d_ff: int | None = None):
    """The MLP of x (..., D).  Where ``w_up`` holds fewer than ``d_ff``
    columns it is this rank's share of d_ff (:func:`tp.share`): up and
    gate column-parallel, down row-parallel, the partial sums psummed."""
    split = d_ff is not None and tp.share(params["w_up"].shape[-1],
                                          d_ff) is not None
    if split:
        x = tp.enter(x)
    act_fn = F.silu if act == "silu" else gelu
    up = x @ params["w_up"]
    if gated:
        h = act_fn(x @ params["w_gate"]) * up
    else:
        h = act_fn(up)
    out = h @ params["w_down"]
    return tp.exit(out) if split else out


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# Loss.
# ---------------------------------------------------------------------------

def _token_nll(logits, labels, vocab: tuple | None = None):
    """Each token's nll from its logits; ``vocab`` = (v0, v1): the logits
    are this rank's vocab rows [v0, v1) of a table split over "model",
    and the row maximum (a pmax), the sum of exponentials and the target's
    logit (one psum) are the ranks' (:mod:`repro_torch.runtime.tp`)."""
    logits = logits.float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse - picked
    v0, v1 = vocab
    m = tp.pmax(logits.amax(dim=-1))
    local = labels.long() - v0
    mine = (local >= 0) & (local < v1 - v0)
    picked = torch.gather(logits, -1,
                          local.clamp(0, v1 - v0 - 1)[..., None])[..., 0]
    parts = tp.exit(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(mine, picked, torch.zeros((), device=logits.device))]))
    return m + torch.log(parts[0]) - parts[1]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in f32.  logits: (B, S, V), labels: (B, S)."""
    if mask is None:
        return torch.mean(_token_nll(logits, labels))
    tot, cnt = cross_entropy_parts(logits, labels, mask)
    return tot / torch.clamp(cnt, min=1.0)


def cross_entropy_parts(logits, labels, mask, vocab: tuple | None = None):
    """(sum of the masked token cross-entropies, sum of the mask) in f32:
    :func:`cross_entropy` with a mask is their quotient.  ``vocab``: the
    logits are a rank's vocab rows (:func:`_token_nll`)."""
    mask = mask.float()
    return (torch.sum(_token_nll(logits, labels, vocab) * mask),
            torch.sum(mask))


def _chunk_nll(hc, embed, yc, mc, softcap_val: float, vocab=None):
    """(sum of the masked nll, sum of the mask) of one sequence chunk."""
    logits = softcap(hc @ embed.T, softcap_val).float()
    return torch.sum(_token_nll(logits, yc, vocab) * mc), torch.sum(mc)


def chunked_loss(h_final, embed, labels, chunk: int, softcap_val: float,
                 mask=None):
    """Sequence-chunked cross entropy: never materializes (B, S, V).

    h_final: (B, S, D) final hidden states; embed: (V, D) tied output
    table.  Each chunk runs under ``torch.utils.checkpoint``, so the
    backward recomputes one chunk's logits at a time, as the reference's
    ``jax.checkpoint`` per chunk does."""
    tot, cnt = chunked_loss_parts(h_final, embed, labels, chunk,
                                  softcap_val, mask)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_loss_parts(h_final, embed, labels, chunk: int,
                       softcap_val: float, mask=None,
                       vocab: tuple | None = None):
    """(sum of the masked token losses, sum of the mask) of
    :func:`chunked_loss`, which is their quotient; ``vocab``: ``embed``
    holds a rank's vocab rows [v0, v1) (:func:`_token_nll`)."""
    B, S, D = h_final.shape
    if S % chunk:
        raise ValueError(f"chunked_loss: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=h_final.device)
    tot = torch.zeros((), device=h_final.device)
    cnt = torch.zeros((), device=h_final.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll, m = tp.checkpoint(
            _chunk_nll, h_final[:, sl], embed, labels[:, sl],
            mask[:, sl].float(), softcap_val, vocab)
        tot = tot + nll
        cnt = cnt + m
    return tot, cnt
