"""Mixture-of-Experts with the paper's DyDD balancer as the token router.

The counterpart of ``repro.models.moe``.  Top-k routing with a static
capacity per expert drops tokens when the router's load is skewed, which
is the paper's "observations non-uniformly distributed" problem; DyDD's
scheduling step balances it on the expert ring:

  * the expert-major sorted token order is the 1D domain,
  * each expert's chunk of that order is a subdomain,
  * the routed-token counts are the loads l_i,
  * the expert ring is the processor graph G.

The schedule (:func:`repro_torch.core.dydd.schedule_tensor` on the ring's
integer operators) gives target counts; migration re-chunks the sorted
order at the new boundaries, so tokens move to an adjacent expert only,
and a token that moves is weighted by its router probability for the
expert that receives it.

Every shape is static.  The router's softmax is f32 whatever the
activations' dtype, as in the reference.  The order and the experts are
discrete decisions (:func:`route`, ``detach``-ed where the reference has
``stop_gradient``): gradients flow through the gate values and the
dispatched rows.  Dispatch and combine gather rows and add nothing up
in parallel: each slot of an expert's capacity holds at most one token
(a scatter of token indices builds that map), and each token has
exactly k entries of the sorted order, which the combine gathers back
through the order's inverse and sums over k, so a call is bitwise
repeatable on the card.  The expert products are batched matmuls.

On a mesh whose "model" axis splits the experts (``moe_ep``: whole
virtual experts a rank) or their d_ff (:mod:`repro_torch.runtime.tp`),
the router, :func:`route` and the DyDD schedule run identically on every
rank, each rank runs its experts' slots (or its d_ff columns of every
expert), and the combine's partial sums are psummed; the router's
gradient, a part on each rank, is psummed too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import dydd
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import tp


def make_moe_params(b: nn.Builder, cfg: ModelConfig):
    """The router (d, E) and the experts' (E v, d, f / v), (E v, d, f / v)
    and (E v, f / v, d) weights: with ``moe_ep`` each expert splits into
    ``moe_virtual_experts`` = v shards of f / v columns (Mixtral: v = 2),
    whose partial sums the combine adds."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    v = cfg.moe_virtual_experts if cfg.moe_ep else 1
    ev, fv = e * v, f // v
    if cfg.moe_ep:
        # whole (virtual) experts on the 'model' axis
        ax_up = ("moe_expert", "embed", None)
        ax_dn = ("moe_expert", None, "embed")
    else:
        # d_ff on 'model', experts replicated over it
        ax_up = ("expert", "embed", "ff")
        ax_dn = ("expert", "ff", "embed")
    return {
        "router": b.param((d, e), ("embed", "expert")),
        "w_up": b.param((ev, d, fv), ax_up),
        "w_gate": b.param((ev, d, fv), ax_up),
        "w_down": b.param((ev, fv, d), ax_dn),
    }


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert: max(8, min(ceil(S k / E cf), S)); 8 at decode."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(math.ceil(S * k / e * cfg.capacity_factor))
    return max(8, min(cap, S))


def dydd_target_counts(counts, ops, capacity: int):
    """DyDD scheduling step on the expert ring (paper Table 13, on the
    device).  counts: (..., E) routed-token counts; ``ops`` the ring's
    (M, den, incidence) of :func:`repro_torch.core.dydd.ring_operators`.
    Returns the (..., E) int64 loads after the per-edge migrations,
    clamped to [0, capacity]."""
    c = counts.to(torch.float64)
    new = c - dydd.schedule_tensor(c, ops) @ ops[2]
    return new.clamp(0.0, capacity).round().to(torch.int64)


def _top_k(probs, k: int):
    """The k largest probabilities of each row and their experts, the
    lower expert first among equal ones (``lax.top_k``'s order), by a
    stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, probs):
    """The discrete routing decisions of a batch of rows from the router
    probabilities (B, S, E) f32: each token's k experts (B, S, k) and the
    expert-major order of the (B, S k) assignments (expert ascending,
    probability descending within an expert, stable), computed without
    gradient."""
    k = cfg.experts_per_token
    with torch.no_grad():
        top_p, top_e = _top_k(probs, k)
        B, S = probs.shape[:2]
        key = (top_e.reshape(B, S * k).to(torch.float32)
               - top_p.reshape(B, S * k) * 0.5)
        order = torch.argsort(key, dim=-1, stable=True)
    return top_e, order


def _dispatch(cfg: ModelConfig, params, x):
    """Route each row of x (B, S, D): the dispatched rows (B, E, C, D)
    and what the combine reads, (sorted token, slot, gate) of each of the
    S k assignments in expert-major order and the order itself."""
    e, k = cfg.num_experts, cfg.experts_per_token
    B, S, D = x.shape
    cap = capacity(cfg, S)
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)
    top_e, order = route(cfg, probs)
    flat_e = top_e.reshape(B, S * k)
    counts = F.one_hot(flat_e, e).sum(1)                       # (B, E)
    if cfg.moe_dydd_balance:
        target = dydd_target_counts(counts,
                                    dydd.ring_operators(e, x.device), cap)
    else:
        target = counts.clamp(max=cap)
    flat_tok = torch.arange(S, device=x.device).repeat_interleave(k)
    sorted_tok = flat_tok[order]                               # (B, S k)
    ends = torch.cumsum(target, -1)
    starts = ends - target
    ranks = torch.arange(S * k, device=x.device).expand(B, S * k)
    # the expert each rank lands on after migration: its chunk
    new_e = torch.searchsorted(ends, ranks.contiguous(), right=True)
    new_e = new_e.clamp(max=e - 1)
    pos = ranks - torch.gather(starts, 1, new_e)
    valid = (pos < cap) & (ranks < ends[:, -1:])
    # combine weight: the router probability of the receiving expert
    gate = probs[torch.arange(B, device=x.device)[:, None], sorted_tok,
                 new_e]
    gate = torch.where(valid, gate, torch.zeros((), device=x.device))
    slot = torch.where(valid, new_e * cap + pos, e * cap)
    # dispatch: the token each slot holds (S, none) as a gather
    holder = torch.full((B, e * cap + 1), S, dtype=torch.int64,
                        device=x.device)
    holder.scatter_(1, slot, torch.where(valid, sorted_tok, S))
    xp = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)           # row S: 0
    disp = torch.gather(xp, 1, holder[:, :-1, None].expand(-1, -1, D))
    return disp.view(B, e, cap, D), (sorted_tok, slot, gate, order)


def _virtual(cfg: ModelConfig) -> int:
    return cfg.moe_virtual_experts if cfg.moe_ep else 1


def _split(cfg: ModelConfig, params) -> bool:
    """Whether the expert weights are this rank's share over "model"
    (its virtual experts with ``moe_ep``, else its d_ff columns)."""
    if cfg.moe_ep:
        return tp.share(params["w_up"].shape[0],
                        cfg.num_experts * _virtual(cfg)) is not None
    return tp.share(params["w_up"].shape[2], cfg.d_ff) is not None


def _experts(cfg: ModelConfig, params, disp):
    """The expert FFNs on the dispatched rows (B, E, C, D); with v
    virtual experts each row goes to the v shards of its expert and their
    partial sums add up.  Where the rank holds virtual experts [e0, e1)
    of E v alone, it runs their slots and the others' rows stay zero."""
    v = _virtual(cfg)
    ev = params["w_up"].shape[0]
    own = tp.share(ev, cfg.num_experts * v) if cfg.moe_ep else None
    if own is not None:
        experts = torch.arange(own[0], own[1], device=disp.device) // v
        rows = disp.index_select(1, experts)        # (B, E_r, C, D)
    elif v > 1:
        rows = disp.repeat_interleave(v, dim=1)      # (B, E v, C, D)
    else:
        rows = disp
    act = F.silu if cfg.act == "silu" else nn.gelu
    up = torch.einsum("becd,edf->becf", rows, params["w_up"])
    h = act(torch.einsum("becd,edf->becf", rows, params["w_gate"])) * up
    out = torch.einsum("becf,efd->becd", h, params["w_down"])
    if own is not None:
        return disp.new_zeros(disp.shape).index_add(1, experts, out)
    if v > 1:
        B, EV, C, D = out.shape
        out = out.view(B, EV // v, v, C, D).sum(2)
    return out


def _combine(cfg: ModelConfig, out_e, aux, S: int):
    """y (B, S, D): each token's k expert outputs weighted by their gates
    and summed, gathered back through the inverse of the order (a dropped
    assignment reads the zero row past the slots)."""
    _, slot, gate, order = aux
    B, _, _, D = out_e.shape
    k = cfg.experts_per_token
    flat = torch.cat([out_e.reshape(B, -1, D), out_e.new_zeros(B, 1, D)],
                     dim=1)
    contrib = (torch.gather(flat, 1, slot[..., None].expand(-1, -1, D))
               * gate[..., None].to(out_e.dtype))             # sorted order
    inv = torch.argsort(order, dim=-1)       # assignment t k + j -> rank
    contrib = torch.gather(contrib, 1, inv[..., None].expand(-1, -1, D))
    return contrib.view(B, S, k, D).sum(2)


def apply_moe(cfg: ModelConfig, params, x):
    """x: (B, S, D) -> (B, S, D); each row routed on its own."""
    split = _split(cfg, params)
    if split:
        x = tp.enter(x)
        params = dict(params, router=tp.enter(params["router"],
                                              grad_dtype=torch.float32))
    disp, aux = _dispatch(cfg, params, x)
    out = _combine(cfg, _experts(cfg, params, disp), aux, x.shape[1])
    return tp.exit(out) if split else out


def load_balance_stats(cfg: ModelConfig, params, x):
    """Diagnostics: the (E,) routed counts over the batch and the DyDD
    targets of the per-row mean counts (the balance ratio E = min / max
    of each is :func:`repro_torch.core.dydd.balance_ratio`)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    B, S = x.shape[:2]
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)
    _, top_e = _top_k(probs, k)
    counts = F.one_hot(top_e.reshape(B, -1), e).sum((0, 1))
    per_row = torch.div(counts, B, rounding_mode="floor")
    if cfg.moe_dydd_balance:
        target = dydd_target_counts(per_row,
                                    dydd.ring_operators(e, x.device),
                                    capacity(cfg, S))
    else:
        target = per_row.clamp(max=capacity(cfg, S))
    return counts, target
