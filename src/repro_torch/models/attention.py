"""Attention: MHA/GQA/MQA, global + sliding-window, KV caches for decode.

The counterpart of ``repro.models.attention``: causal and non-causal
self-attention and cross-attention (whisper's decoder reading the
encoder's frames, ``kv_override``).  Training and prefill run
:func:`attention`, whose core is
:func:`repro_torch.kernels.ops.flash_attention` (the flash kernel and its
backward on the card, the plain versions on the CPU), also where k and v
have another length than q; the reference's blocked jnp attention
computes the same function.  Decode runs no kernel: the cached softmax
of :func:`decode_attention` and :func:`cross_attention_cached`.  Decode uses a
static-shape KV cache; sliding-window layers use a ring buffer of
exactly ``window`` slots, so decode state stays O(window).  A token at
absolute position ``pos`` is written to slot ``pos % length`` and each
slot keeps the absolute position it holds (-1 when empty), so masking
stays right after wraparound, exactly as in the reference.

On a process mesh the projections are tensor parallel
(:mod:`repro_torch.runtime.tp`): ``wq`` column-parallel over the rank's
query heads [h0, h1), ``wk`` and ``wv`` over its kv heads where their
spec splits them, ``wo`` row-parallel and its partial sums psummed
(:func:`_sum_heads`).  Where kv heads do not split (GQA and MQA with
fewer kv heads than ranks) ``wk`` and ``wv`` are whole on every rank:
the rank computes the kv heads its query heads read (head h reads kv
head h // q_per_kv) and their gradients are psummed.

In serving (``runtime.steps.make_serve_step(mesh=...)``) each rank
holds its block of every cache leaf, as ``cache_specs_tree`` lays it
out, and decode takes the block's :class:`BlockLayout`.  There are three
layouts, and none gathers the cache:

* **kv heads split** (``dim="heads"``): the rank's query heads read its
  kv heads alone; the row-parallel ``wo`` and one psum end the layer;
* **sequence split** (``dim="seq"``, the ``kv_seq`` fallback): every
  rank updates the replicated slot positions, the owner of the slot
  writes the new k and v (every kv head), the step's queries are
  all-gathered over the heads' split, each rank takes its slots' f32
  maximum, sum of exponentials and weighted sum of values, and the ranks
  combine them (:func:`_combine_slots`: a ``pmax`` and one ``psum``);
  the rank keeps its heads for ``wo``;
* **rows only** (no layout): the rank computes its rows, with no
  collective beyond the projections' (the "dp" profile; recurrent and
  SSD states are never split further).

With no layout the single-process path runs as it always has.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import tp

NEG_INF = -1e30


def make_attn_params(b: nn.Builder, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": b.param((d, h, hd), ("embed", "heads", None)),
        "wk": b.param((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": b.param((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": b.param((h, hd, d), ("heads", None, "embed")),
    }


def _expand_kv(k, q_per_kv: int):
    """(B, S, KV, D) -> (B, S, KV * q_per_kv, D) by repeat (GQA)."""
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _mask(seq_q: int, seq_k: int, window: int, causal: bool,
          q_offset: int = 0, device=None):
    """(Sq, Sk) additive mask; ``window <= 0`` means unbounded."""
    qpos = torch.arange(seq_q, device=device)[:, None] + q_offset
    kpos = torch.arange(seq_k, device=device)[None, :]
    ok = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    zero = torch.zeros((), device=device)
    return torch.where(ok, zero, NEG_INF)


def _heads(cfg: ModelConfig, params):
    """(h0, h1) of this rank's query heads where ``wq`` holds a share of
    them (:func:`tp.share`), else None."""
    return tp.share(params["wq"].shape[1], cfg.num_heads)


def _kv_for(cfg: ModelConfig, heads, held: tuple):
    """The kv heads that query heads [h0, h1) read, as an index of the
    kv heads ``held`` = (k0, k1) that the tensors hold: a slice where the
    heads read them in equal runs (the kernel's ``bh // (BH / BH_kv)``
    rule then maps them), else one kv head a query head."""
    h0, h1 = heads
    want = [h // cfg.q_per_kv - held[0] for h in range(h0, h1)]
    lo, hi = want[0], want[-1] + 1
    rep = (h1 - h0) // (hi - lo)
    if rep * (hi - lo) == h1 - h0 and all(
            w == lo + j // rep for j, w in enumerate(want)):
        return slice(lo, hi)
    return torch.tensor(want)


def _select(t, idx):
    """Heads ``idx`` (a slice or an index tensor) of (B, S, KV, hd)."""
    if isinstance(idx, slice):
        return t[:, :, idx]
    return t.index_select(2, idx.to(t.device))


def _project_kv(cfg: ModelConfig, params, x, heads, all_kv: bool):
    """k and v (B, S, KV', hd) of x, and the index of the kv heads the
    rank's query heads read in them (None: all of them, in order).  With
    ``wk`` split the kv heads are the rank's; with ``wk`` whole and
    query heads split, every kv head where ``all_kv`` (the prefill
    caches them), else only those read, and the gradients of ``wk`` and
    ``wv`` are psummed (each rank's is a part)."""
    wk, wv = params["wk"], params["wv"]
    kv_split = wk.shape[1] < cfg.num_kv_heads
    if heads is None or kv_split:
        return (torch.einsum("bsd,dhk->bshk", x, wk),
                torch.einsum("bsd,dhk->bshk", x, wv), None)
    wk = tp.enter(wk, grad_dtype=torch.float32)
    wv = tp.enter(wv, grad_dtype=torch.float32)
    idx = _kv_for(cfg, heads, (0, cfg.num_kv_heads))
    if not all_kv:
        wk, wv = _select(wk[None], idx)[0], _select(wv[None], idx)[0]
        idx = None
    return (torch.einsum("bsd,dhk->bshk", x, wk),
            torch.einsum("bsd,dhk->bshk", x, wv), idx)


def _sum_heads(out):
    """The psum over "model" of the rank's row-parallel ``wo`` product
    (the end of the layer's tensor-parallel region)."""
    return tp.exit(out)


def attention(cfg: ModelConfig, params, x, positions, *, window: int,
              causal: bool = True, rope_theta: float | None = None,
              kv_override=None, mode: str = "auto", return_kv: bool = False):
    """Training and prefill attention.  x: (B, S, D) -> (B, S, D); with
    ``return_kv`` also k and v (B, S_kv, KV, hd) after rope, which the
    prefill caches (on a mesh: the rank's kv heads where they split,
    else every kv head).  ``kv_override``: (k, v) of shape (B, S_kv, KV,
    hd) from an encoder (cross-attention), which turns off rope, the
    causal mask and the window, as in the reference.  ``mode`` goes to
    :func:`ops.flash_attention`."""
    heads = _heads(cfg, params)
    if heads is not None:
        x = tp.enter(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    idx = None
    if kv_override is None:
        k, v, idx = _project_kv(cfg, params, x, heads, return_kv)
        theta = rope_theta if rope_theta is not None else cfg.rope_theta
        if theta > 0:
            q = nn.rope(q, positions, theta)
            k = nn.rope(k, positions, theta)
    else:
        k, v = kv_override
        causal, window = False, 0
        if heads is not None and k.shape[2] == cfg.num_kv_heads:
            idx = _kv_for(cfg, heads, (0, cfg.num_kv_heads))
    B, S, H, K = q.shape

    def fold(t):   # (B, S, heads, K) -> (B * heads, S, K), contiguous
        return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], K).contiguous()

    # k and v keep their kv heads: the kernel reads row bh // q_per_kv for
    # query row bh, and with one kv head fold() is a view, not a copy.
    ka, va = (k, v) if idx is None else (_select(k, idx), _select(v, idx))
    out = ops.flash_attention(fold(q), fold(ka), fold(va), causal=causal,
                              window=window, softcap=cfg.attn_softcap,
                              mode=mode)
    out = out.view(B, H, S, K).permute(0, 2, 1, 3)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if heads is not None:
        out = _sum_heads(out)
    return (out, k, v) if return_kv else out


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Where a rank's block of one cache stack sits in the global cache:
    ``dim`` is "heads" (the kv-head dimension split) or "seq" (the slots
    split) over the mesh ``axes`` of ``mesh``; the rank holds kv heads or
    slots [start, stop) of ``size``."""

    dim: str
    mesh: object
    axes: tuple
    start: int
    stop: int
    size: int


def _gather_q(q, heads):
    """(B, 1, H_r, hd) queries of this rank's heads -> every head's,
    all-gathered over "model" (a sequence-split cache needs every head's
    query on each rank's slots)."""
    return q if heads is None else tp.all_gather(q, 2)


def _combine_slots(scores, valid, v, layout):
    """The softmax-weighted sum of values over slots split across ranks:
    scores (B, H, 1, S_r) f32 and valid (S_r,) of this rank's slots, v
    (B, S_r, H, hd) (kv heads expanded).  Each rank's maximum m_r over
    its valid slots, then m = pmax(m_r); its l_r = sum exp(s - m) and
    o_r = sum exp(s - m) v in f32 over valid slots alone (a rank with
    none adds exact zeros), summed by one psum; returns o / l (B, 1, H,
    hd) in f32."""
    mesh, axes = layout.mesh, layout.axes
    m = torch.where(valid, scores, NEG_INF).amax(dim=-1, keepdim=True)
    m = mesh.pmax(m, axes)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    o = torch.einsum("bhqs,bshk->bqhk", p, v.float())
    parts = torch.cat([p.sum(dim=-1).transpose(1, 2)[..., None], o], -1)
    parts = mesh.psum(parts, axes)
    return parts[..., 1:] / parts[..., :1]


def _attend(cfg: ModelConfig, q, k, v, valid, layout):
    """Single-token attention of q (B, 1, H_r, hd) over the cached k, v
    (B, S_r, KV_r, hd) where ``valid`` (S_r,) allows, in f32 with the
    output in v's dtype (B, 1, H_r, hd)."""
    rep = q.shape[2] // k.shape[2]      # q_per_kv, or a rank's share
    kk = _expand_kv(k, rep)
    vv = _expand_kv(v, rep)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = torch.einsum("bqhk,bshk->bhqs", q, kk).float() * scale
    if cfg.attn_softcap > 0:
        scores = nn.softcap(scores, cfg.attn_softcap)
    if layout is not None and layout.dim == "seq":
        return _combine_slots(scores, valid, vv, layout).to(vv.dtype)
    if valid is not None:
        scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vv.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, vv)


def _out_proj(params, out, heads, layout):
    """The out-projection of the head outputs (B, 1, H', hd): with a
    sequence-split cache and query heads split, every head's output is
    on each rank and the rank keeps its own; the row-parallel ``wo``'s
    partial sums are then psummed."""
    if heads is not None and layout is not None and layout.dim == "seq":
        out = out[:, :, heads[0]:heads[1]]
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out if heads is None else _sum_heads(out)


def cross_attention_cached(cfg: ModelConfig, params, x, k, v,
                           layout: BlockLayout | None = None):
    """Decode's cross-attention: x (B, 1, D) against the cached encoder k
    and v (B, S_kv, KV, hd), every key visible, the f32 softmax of
    :func:`decode_attention` (no kernel).  Returns (B, 1, D).  With a
    ``layout``, k and v are this rank's block of the cross cache (its kv
    heads or its slots of the encoder's positions)."""
    heads = _heads(cfg, params)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    valid = None
    if layout is not None and layout.dim == "seq":
        valid = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
        q = _gather_q(q, heads)
    elif heads is not None and k.shape[2] == cfg.num_kv_heads:
        idx = _kv_for(cfg, heads, (0, cfg.num_kv_heads))
        k, v = _select(k, idx), _select(v, idx)
    return _out_proj(params, _attend(cfg, q, k, v, valid, layout), heads,
                     layout)


# ---------------------------------------------------------------------------
# Decode caches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of one layer's KV cache."""

    kind: str          # "full" | "ring"
    length: int        # cache slots (= seq for full, = window for ring)


def cache_spec(cfg: ModelConfig, layer_type: str, max_seq: int) -> CacheSpec:
    if layer_type == "local":
        return CacheSpec(kind="ring", length=min(cfg.window, max_seq))
    return CacheSpec(kind="full", length=max_seq)


def init_cache(cfg: ModelConfig, spec: CacheSpec, batch: int, dtype, device):
    L = spec.length
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position stored in each slot (-1 = empty)
        "pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(cfg: ModelConfig, params, cache, spec: CacheSpec, x,
                     pos: int, *, window: int,
                     rope_theta: float | None = None,
                     layout: BlockLayout | None = None):
    """Single-token decode.  x: (B, 1, D); pos: the absolute position.

    Returns (out (B, 1, D), new_cache); the input cache is not modified.
    The cache slot is ``pos % length`` (ring) or ``pos`` (full); masking
    uses the per-slot absolute positions.  With a ``layout``, ``cache``
    holds this rank's block of k and v (``spec.length`` stays the global
    slot count) and the whole replicated ``"pos"``."""
    B = x.shape[0]
    heads = _heads(cfg, params)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    seq = layout is not None and layout.dim == "seq"
    k, v, idx = _project_kv(cfg, params, x, heads, True)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if theta > 0:
        q = nn.rope(q, positions, theta)
        k = nn.rope(k, positions, theta)

    slot = pos % spec.length if spec.kind == "ring" else pos
    new_k = cache["k"].clone()
    new_v = cache["v"].clone()
    new_pos = cache["pos"].clone()
    new_pos[slot] = pos
    lo, hi = (layout.start, layout.stop) if seq else (0, spec.length)
    if lo <= slot < hi:             # this rank holds the slot
        new_k[:, slot - lo] = k[:, 0]
        new_v[:, slot - lo] = v[:, 0]
    held = new_pos[lo:hi]
    valid = (held >= 0) & (held <= pos)
    if window > 0:
        valid &= held > pos - window
    ck, cv = new_k, new_v
    if seq:
        q = _gather_q(q, heads)
    elif idx is not None:
        ck, cv = _select(ck, idx), _select(cv, idx)
    out = _attend(cfg, q, ck, cv, valid, layout)
    return (_out_proj(params, out, heads, layout),
            {"k": new_k, "v": new_v, "pos": new_pos})


def prefill_cache(cfg: ModelConfig, spec: CacheSpec, k, v, positions):
    """Build a cache from prefill-computed k/v.  k/v: (B, S, KV, D) with
    rope already applied; positions: (S,)."""
    S = k.shape[1]
    L = spec.length
    if S <= L:
        pad = L - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(positions.to(torch.int32), (0, pad),
                                      value=-1)
    else:  # keep the last L (ring semantics)
        k, v = k[:, -L:], v[:, -L:]
        pos = positions[-L:].to(torch.int32)
    return {"k": k, "v": v, "pos": pos}
