"""The LMs: init, training forward and loss, prefill and decode.

The counterpart of ``repro.models.transformer`` for every family: its
``"periods"`` branch (the hybrid RecurrentGemma: periods of (rglru,
rglru, local attention) plus a tail of RG-LRU layers), its ``("ssd",)``
branch (Mamba-2: a stack of SSD blocks), its uniform attention stack
(``"blocks"``: Yi, Gemma, GLM-4, gemma3's local and global mixture, the
MoE models OLMoE and Mixtral, whose MLP is :mod:`repro_torch.models.moe`,
and phi-3-vision, whose batch may hold ``"patches"``, precomputed patch
embeddings prepended to the sequence, the loss taken over the text tail
alone) and its encoder-decoder branch (whisper: an encoder over the
batch's ``"frames"``, precomputed frame embeddings, and a decoder whose
layers add a cross-attention to the encoder's output; learned positions,
no rope).
Parameters are a nested dict of tensors with the reference's keys and
its stacked leading layer axis, so the reference's weights carry across
leaf by leaf (:func:`repro_torch.convert.lm_params_from_numpy`).  The
reference's ``lax.scan`` over layers is a Python loop over that axis.
Each attention layer of the uniform stack gets its own window and rope
theta (:func:`layer_statics`): 0, unbounded, on a global layer.

Training (``forward``, ``loss_fn``) and the prefill run the kernels
through :mod:`repro_torch.kernels.ops`: ``rglru_scan`` in every RG-LRU
layer, ``flash_attention`` in every attention layer and ``ssd_scan`` in
every SSD layer (by the tensors' device: the CUDA kernels, and for
training their backward kernels, on the card; the plain versions on the
CPU; ``mode="plain"`` forces the plain versions).  ``cfg.remat``
recomputes each scan body (an RG-LRU period or tail layer, an SSD or
attention layer) in the backward under ``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint`` does (whisper: each encoder and each
decoder layer).  Whisper's attention runs the kernel in all three of its
kinds: the encoder's non-causal self-attention, the decoder's causal
self-attention and its cross-attention, whose k and v have the encoder's
length.  Decode runs no kernel: it is the O(1) recurrences and the cached
attention (whisper's cross-attention over the cached encoder k and v), as
in the reference.

On a process mesh (the sharded steps of :mod:`repro_torch.runtime.steps`)
the layers compute as the reference's GSPMD partition does
(:mod:`repro_torch.runtime.tp`): each rank its heads, kv heads, d_ff
columns, ``lru`` channels, SSD heads, experts and vocab rows, the partial
sums psummed once a block; the embedding looks up the tokens of the
rank's vocab rows and psums, and the loss takes the row maximum with a
pmax and psums the exponentials' sum and the target's logit, so no rank
forms the whole vocabulary's logits.  In the train step each layer's
blocks are all-gathered over their FSDP axes inside the layer's body
(under remat again in the backward, then freed) and their gradients
reduce-scattered back (:func:`gather_plan`); the top-level leaves are
gathered where the step begins.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as device_mod
from repro_torch.models import attention, moe, nn, rglru, ssd
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import sharding, tp

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _is_hybrid(cfg: ModelConfig) -> bool:
    return "rglru" in cfg.attn_pattern and len(set(cfg.attn_pattern)) > 1


def _is_ssd(cfg: ModelConfig) -> bool:
    return cfg.attn_pattern == ("ssd",)


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.is_encoder_decoder


def _is_uniform(cfg: ModelConfig) -> bool:
    return not (_is_hybrid(cfg) or _is_ssd(cfg) or _is_encdec(cfg))


def _has_patches(cfg: ModelConfig, batch) -> bool:
    return cfg.frontend == "vision_stub" and "patches" in batch


# ---------------------------------------------------------------------------
# Parameter trees.
# ---------------------------------------------------------------------------

class _Stacked:
    """Prepends a leading layer axis to every declared parameter."""

    def __init__(self, b: nn.Builder, n: int):
        self._b = b
        self._n = n

    def param(self, shape, axes, init="normal", scale=None):
        if scale is None and init == "normal":
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        return self._b.param((self._n,) + tuple(shape),
                             (None,) + tuple(axes), init=init, scale=scale)


def _attn_block(b, cfg: ModelConfig):
    p = {"norm1": nn.make_norm_params(b, cfg.d_model, cfg.norm),
         "attn": attention.make_attn_params(b, cfg),
         "norm2": nn.make_norm_params(b, cfg.d_model, cfg.norm)}
    if cfg.num_experts > 0:
        p["moe"] = moe.make_moe_params(b, cfg)
    elif cfg.d_ff > 0:
        p["mlp"] = nn.make_mlp_params(b, cfg.d_model, cfg.d_ff,
                                      cfg.gated_mlp)
    return p


def _rglru_block(b, cfg: ModelConfig):
    return {"norm1": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "rglru": rglru.make_rglru_params(b, cfg),
            "norm2": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "mlp": nn.make_mlp_params(b, cfg.d_model, cfg.d_ff,
                                      cfg.gated_mlp)}


def _ssd_block(b, cfg: ModelConfig):
    return {"norm1": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "ssd": ssd.make_ssd_params(b, cfg)}


def _cross_block(b, cfg: ModelConfig):
    """Whisper decoder block: self-attn + cross-attn + mlp."""
    return {"norm1": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "self_attn": attention.make_attn_params(b, cfg),
            "norm_x": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "cross_attn": attention.make_attn_params(b, cfg),
            "norm2": nn.make_norm_params(b, cfg.d_model, cfg.norm),
            "mlp": nn.make_mlp_params(b, cfg.d_model, cfg.d_ff,
                                      cfg.gated_mlp)}


# Rows of whisper's learned decoder positions: its real context is 448;
# the reference extends the table to cover its 32k decode and prefill
# shapes.
DEC_POS_ROWS = 40960


def _n_full(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.attn_pattern)


def _n_tail(cfg: ModelConfig) -> int:
    return cfg.num_layers % len(cfg.attn_pattern)


def _build(cfg: ModelConfig, b: nn.Builder):
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {
        "embed": b.param((v, d), ("vocab", "embed_table"), scale=1.0),
        "final_norm": nn.make_norm_params(b, d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = b.param((v, d), ("vocab", "embed_table"))
    if _is_ssd(cfg):
        params["blocks"] = _ssd_block(_Stacked(b, cfg.num_layers), cfg)
        return params
    if _is_uniform(cfg):
        params["blocks"] = _attn_block(_Stacked(b, cfg.num_layers), cfg)
        return params
    if _is_encdec(cfg):
        params["enc_pos"] = b.param((cfg.encoder_seq, d), (None, "embed"),
                                    scale=0.02)
        params["dec_pos"] = b.param((DEC_POS_ROWS, d), (None, "embed"),
                                    scale=0.02)
        params["encoder"] = _attn_block(_Stacked(b, cfg.encoder_layers), cfg)
        params["enc_final_norm"] = nn.make_norm_params(b, d, cfg.norm)
        params["decoder"] = _cross_block(_Stacked(b, cfg.num_layers), cfg)
        return params
    n_full = _n_full(cfg)
    params["periods"] = {
        "r1": _rglru_block(_Stacked(b, n_full), cfg),
        "r2": _rglru_block(_Stacked(b, n_full), cfg),
        "attn": _attn_block(_Stacked(b, n_full), cfg),
    }
    if _n_tail(cfg):
        params["tail"] = _rglru_block(_Stacked(b, _n_tail(cfg)), cfg)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None, dtype=None):
    """Random weights with the reference's scheme, drawn on ``device``
    (the card unless asked otherwise) from a ``torch.Generator`` seeded
    with ``seed``; ``dtype`` defaults to ``cfg.dtype``."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _build(cfg, nn.Builder(gen, dev, dtype or DTYPES[cfg.dtype]))


def param_shapes(cfg: ModelConfig, dtype=None):
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    memory); ``dtype`` defaults to ``cfg.dtype``."""
    return _build(cfg, nn.Builder(dtype=dtype or DTYPES[cfg.dtype],
                                  mode="shape"))


def param_specs(cfg: ModelConfig):
    """Each parameter's partition spec under ``cfg.sharding_profile`` and
    the ambient mesh (:func:`repro_torch.runtime.sharding.use_mesh`; the
    production mesh outside one)."""
    with sharding.profile(cfg.sharding_profile):
        return _build(cfg, nn.Builder(mode="spec"))


# The stacked subtrees (a leading layer axis) and the top-level leaves.
STACKS = ("blocks", "periods", "tail", "encoder", "decoder")
TOP = ("embed", "unembed", "final_norm", "enc_pos", "dec_pos",
       "enc_final_norm")


def gather_plan(cfg: ModelConfig, mesh, rows: tuple = (), *,
                per_layer: bool = True):
    """A tree like the params of :class:`~repro_torch.runtime.tp.Gather`
    on ``mesh``: each leaf all-gathered over the axes other than "model"
    that its spec shards (the FSDP axes), a stacked leaf per layer (its
    plan without the layer axis; with ``per_layer`` False, the whole
    stack at once), its gradient summed over those of the axes in
    ``rows`` (the batch's: their ranks hold other rows).  The SSD block's
    :data:`ssd.WHOLE_LEAVES` are gathered over "model" too, their
    gradients summed there where the block's heads split; where its di
    splits off the heads' boundaries (a smoke config on a wide mesh)
    every SSD leaf is gathered whole and the block computed whole on
    every rank, their gradients the same there and sliced."""
    with sharding.use_mesh(mesh):
        specs = param_specs(cfg)
    heads_split = _is_ssd(cfg) and ssd.heads_split(
        cfg, specs["blocks"]["ssd"]["norm"], mesh.shape.get(tp.AXIS, 1))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = (tuple(node)[1:] if per_layer and path[0] in STACKS
                else tuple(node))
        axes = [a for a in sharding.spec_axes(spec) if a != tp.AXIS]
        summed = list(rows)
        if path[-2:-1] == ("ssd",) and (path[-1] in ssd.WHOLE_LEAVES
                                        or not heads_split):
            axes.append(tp.AXIS)
            if heads_split:
                summed.append(tp.AXIS)
        return tp.layer_plan(mesh, spec, tuple(axes), tuple(summed))

    return walk(specs, ())


def _index(tree, i: int):
    """Layer i of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> list:
    """The per-layer trees of a stacked tree, as views (one ``unbind`` a
    leaf, whose backward stacks the layers' gradients once)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _stack(trees: list):
    """Stack per-layer trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Embedding and output head.
# ---------------------------------------------------------------------------

def _embed_tokens(cfg: ModelConfig, params, tokens):
    """The token embeddings; where the table holds a rank's vocab rows
    (:func:`tp.share`) the rank looks up the tokens in them, zero rows for
    the rest, and the ranks' rows are psummed (one term each: exact)."""
    table = params["embed"]
    rows = tp.share(table.shape[0], cfg.vocab_size)
    if rows is None:
        h = table[tokens]
    else:
        local = tokens.long() - rows[0]
        mine = (local >= 0) & (local < rows[1] - rows[0])
        h = table[local.clamp(0, rows[1] - rows[0] - 1)]
        h = tp.exit(torch.where(mine[..., None], h,
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device)))
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def trunk_input(cfg: ModelConfig, params, batch):
    """The residual stream that enters the first layer (B, S, D): the
    token embeddings, after the batch's ``"patches"`` (phi-3-vision's
    stub, prepended) or plus the learned decoder positions (whisper)."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    if _has_patches(cfg, batch):
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    if _is_encdec(cfg):
        h = h + params["dec_pos"][:h.shape[1]][None]
    return h


def _frames(cfg: ModelConfig, batch):
    """Whisper's ``batch["frames"]``, which its encoder reads."""
    if "frames" not in batch:
        raise ValueError(
            f"{cfg.name}: the encoder-decoder reads batch['frames'], its "
            f"precomputed frame embeddings (B, {cfg.encoder_seq}, "
            f"{cfg.d_model}); the batch holds {sorted(batch)}")
    return batch["frames"]


def _out_table(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def out_rows(cfg: ModelConfig, params) -> tuple | None:
    """(v0, v1) of the vocab rows the output table holds where it is a
    rank's share over "model", else None."""
    return tp.share(_out_table(cfg, params).shape[0], cfg.vocab_size)


def logits_fn(cfg: ModelConfig, params, h, vocab: tuple | None = None):
    """The (soft-capped) logits of h; ``vocab`` = (v0, v1) gives those of
    the output table's rows [v0, v1) alone.  Where the table holds a
    rank's vocab rows those are the logits (``vocab`` None or the same
    rows)."""
    table = _out_table(cfg, params)
    rows = out_rows(cfg, params)
    if rows is not None:
        if vocab is not None and tuple(vocab) != rows:
            raise ValueError(f"logits of vocab rows {vocab} from a table "
                             f"holding {rows}")
    elif vocab is not None:
        table = table[vocab[0]:vocab[1]]
    return nn.softcap(h @ table.T, cfg.logits_softcap)


# ---------------------------------------------------------------------------
# Forward (training trunk) and loss.
# ---------------------------------------------------------------------------

def _apply_rglru_block(cfg, lp, h, mode):
    r_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    h = h + rglru.apply_rglru(cfg, lp["rglru"], r_in, mode=mode)
    f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
    return h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp,
                            cfg.d_ff)


def layer_statics(cfg: ModelConfig):
    """Each layer's attention window and rope theta, the reference's
    ``_layer_statics_py``: a local layer has ``cfg.window`` and, in a
    mixed local and global pattern (gemma3), theta 10000; a global layer
    has window 0 (unbounded) and ``cfg.rope_theta``."""
    mixed = len(set(cfg.attn_pattern)) > 1
    windows, thetas = [], []
    for i in range(cfg.num_layers):
        if cfg.layer_type(i) == "local":
            windows.append(cfg.window)
            thetas.append(10000.0 if mixed else cfg.rope_theta)
        else:
            windows.append(0)
            thetas.append(cfg.rope_theta)
    return windows, thetas


def _ffn(cfg, lp, h):
    """The block's second half: the MoE or the MLP on the normed h."""
    f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
    if cfg.num_experts > 0:
        return h + moe.apply_moe(cfg, lp["moe"], f_in)
    if cfg.d_ff > 0:
        return h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp,
                            cfg.d_ff)
    return h


def _apply_attn_block(cfg, lp, h, positions, window, theta, mode):
    a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    h = h + attention.attention(cfg, lp["attn"], a_in, positions,
                                window=window, rope_theta=theta, mode=mode)
    return _ffn(cfg, lp, h)


def _apply_ssd_block(cfg, lp, h, mode):
    s_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    return h + ssd.apply_ssd(cfg, lp["ssd"], s_in, mode=mode)


def _scan_layers(cfg: ModelConfig, body, h, layers: list, plan=None):
    """``body(h, lp)`` over the per-layer trees ``layers`` in order; under
    remat ("block" or "group") each body runs in ``torch.utils.checkpoint``
    and is recomputed in the backward.  With ``plan`` (a tree like one
    item of ``layers`` of :class:`~repro_torch.runtime.tp.Gather`) the
    body first gathers its layer's blocks, so under remat the backward
    gathers them again and frees them after.  The values do not depend on
    remat; "group"'s coarser residuals, the reference's memory trade for
    Mixtral-8x22B at full size on a mesh, are not ported (no config of
    the port sets it)."""
    if plan is not None:
        inner = body

        def body(h, lp):
            return inner(h, tp.gather_tree(lp, plan))
    for lp in layers:
        if cfg.remat in ("block", "group"):
            h = tp.checkpoint(body, h, lp)
        else:
            h = body(h, lp)
    return h


def _encode(cfg: ModelConfig, params, frames, mode: str = "auto"):
    """Whisper's encoder over the precomputed frame embeddings (B,
    encoder_seq, D): non-causal self-attention, no rope, each layer
    recomputed in the backward under remat."""
    h = frames.to(DTYPES[cfg.dtype]) + params["enc_pos"][None]

    def body(h, lp):
        a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
        h = h + attention.attention(cfg, lp["attn"], a_in, None, window=0,
                                    causal=False, rope_theta=0.0, mode=mode)
        f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
        return h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp,
                            cfg.d_ff)

    h = _scan_layers(cfg, body, h, _unstack(params["encoder"]),
                     tp.plan_of("encoder"))
    return nn.apply_norm(params["enc_final_norm"], h, cfg.norm, cfg.norm_eps)


def _cross_kv(cfg, enc, lp):
    """A decoder layer's cross-attention k and v (B, S_enc, KV', hd) of
    the encoder's output (on a mesh that splits the heads: the rank's kv
    heads, or every kv head where they do not split)."""
    heads = attention._heads(cfg, lp["cross_attn"])
    if heads is not None:
        enc = tp.enter(enc)
    k, v, _ = attention._project_kv(cfg, lp["cross_attn"], enc, heads, True)
    return k, v


def _apply_cross_block(cfg, lp, h, kv, mode, return_kv=False):
    """A whisper decoder layer: causal self-attention (no rope), the
    cross-attention to ``kv``, the MLP; with ``return_kv`` also the
    self-attention's k and v, which the prefill caches."""
    a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, k, v = attention.attention(cfg, lp["self_attn"], a_in, None,
                                    window=0, rope_theta=0.0, mode=mode,
                                    return_kv=True)
    h = h + out
    x_in = nn.apply_norm(lp["norm_x"], h, cfg.norm, cfg.norm_eps)
    h = h + attention.attention(cfg, lp["cross_attn"], x_in, None, window=0,
                                kv_override=kv, mode=mode)
    f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
    h = h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp, cfg.d_ff)
    return (h, k, v) if return_kv else h


def forward(cfg: ModelConfig, params, batch, *, mode: str = "auto"):
    """Final hidden states (B, S, D) of the trunk over batch["tokens"]
    (B, S) (phi-3-vision with ``"patches"``: (B, P + S, D); whisper reads
    ``"frames"``).  ``mode`` goes to the kernel ops."""
    return _forward(cfg, tp.gather_top(params, TOP), batch, mode)


def _forward(cfg: ModelConfig, params, batch, mode: str):
    """:func:`forward` with the top-level leaves gathered."""
    h = trunk_input(cfg, params, batch)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    if _is_encdec(cfg):
        enc = _encode(cfg, params, _frames(cfg, batch), mode)
        # each layer's cross k and v inside its body (the weights differ),
        # so remat recomputes them
        h = _scan_layers(
            cfg, lambda h, lp: _apply_cross_block(
                cfg, lp, h, _cross_kv(cfg, enc, lp), mode),
            h, _unstack(params["decoder"]), tp.plan_of("decoder"))
    elif _is_ssd(cfg):
        h = _scan_layers(
            cfg, lambda h, lp: _apply_ssd_block(cfg, lp, h, mode), h,
            _unstack(params["blocks"]), tp.plan_of("blocks"))
    elif _is_uniform(cfg):
        windows, thetas = layer_statics(cfg)
        h = _scan_layers(
            cfg, lambda h, lps: _apply_attn_block(cfg, lps[0], h, positions,
                                                  lps[1], lps[2], mode),
            h, list(zip(_unstack(params["blocks"]), windows, thetas)),
            (tp.plan_of("blocks"), None, None))
    else:
        def period(h, lps):
            r1, r2, at = lps
            h = _apply_rglru_block(cfg, r1, h, mode)
            h = _apply_rglru_block(cfg, r2, h, mode)
            return _apply_attn_block(cfg, at, h, positions, cfg.window,
                                     cfg.rope_theta, mode)

        periods = params["periods"]
        h = _scan_layers(cfg, period, h, list(zip(
            _unstack(periods["r1"]), _unstack(periods["r2"]),
            _unstack(periods["attn"]))), tuple(
                tp.plan_of("periods", k) for k in ("r1", "r2", "attn")))
        if "tail" in params:
            h = _scan_layers(
                cfg, lambda h, lp: _apply_rglru_block(cfg, lp, h, mode), h,
                _unstack(params["tail"]), tp.plan_of("tail"))
    return nn.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch, *, mode: str = "auto"):
    """Mean next-token cross-entropy (f32 scalar).  batch: "tokens" (B,
    S) and optionally "labels" (default: the next token, 0 at the end)
    and "mask" (default: all but the last position); phi-3-vision's
    "patches" take no loss, whisper's "frames" feed the encoder.  Uses the
    sequence-chunked loss when ``cfg.loss_chunk`` divides S (never
    materializes (B, S, V))."""
    tot, cnt = loss_parts(cfg, params, batch, mode=mode)
    return tot / torch.clamp(cnt, min=1.0)


def loss_parts(cfg: ModelConfig, params, batch, *, mode: str = "auto"):
    """(the masked sum of the token losses, the mask's sum), both f32
    scalars: :func:`loss_fn` is their quotient.  A batch split over ranks
    sums each part over the ranks before dividing (a mean of the ranks'
    means is another function where their masks differ)."""
    params = tp.gather_top(params, TOP)
    h = _forward(cfg, params, batch, mode)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if _has_patches(cfg, batch):
        h = h[:, -S:]                      # loss only over the text tail
    labels = batch.get("labels")
    if labels is None:
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
    table = _out_table(cfg, params)
    vocab = out_rows(cfg, params)
    if vocab is not None:
        h = tp.enter(h)
    if cfg.loss_chunk and S % cfg.loss_chunk == 0:
        return nn.chunked_loss_parts(h, table, labels, cfg.loss_chunk,
                                     cfg.logits_softcap, mask, vocab)
    return nn.cross_entropy_parts(logits_fn(cfg, params, h), labels, mask,
                                  vocab)


# ---------------------------------------------------------------------------
# Decode caches + serve step.
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=None, device=None):
    """The (stacked) cache tree for ``serve_step``."""
    dev = device_mod.resolve(device)
    dtype = dtype or DTYPES[cfg.dtype]

    def stacked(one, n):
        # torch.stack([t] * n), without the stack: on ``meta`` (the cache's
        # shapes alone) the stack imports Python meta kernels, seconds on a
        # process's first call
        return {k: t.new_empty((n,) + tuple(t.shape)).copy_(
            t.expand((n,) + tuple(t.shape))) for k, t in one.items()}

    if _is_ssd(cfg):
        return stacked(ssd.init_ssd_cache(cfg, batch, dtype, dev),
                       cfg.num_layers)
    if _is_encdec(cfg):
        spec = attention.CacheSpec("full", max_seq)
        kvh = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
               cfg.head_dim)
        return {"self": stacked(attention.init_cache(cfg, spec, batch, dtype,
                                                     dev), cfg.num_layers),
                "cross_k": torch.zeros(kvh, dtype=dtype, device=dev),
                "cross_v": torch.zeros(kvh, dtype=dtype, device=dev)}
    if _is_uniform(cfg):
        # one stack per cache kind ("full" for global layers, "ring" for
        # local ones), each in layer order
        per: dict = {}
        for spec in _layer_specs(cfg, max_seq):
            per.setdefault(spec.kind, [spec, 0])[1] += 1
        return {k: stacked(attention.init_cache(cfg, spec, batch, dtype,
                                                dev), n)
                for k, (spec, n) in per.items()}
    spec = attention.CacheSpec("ring", min(cfg.window, max_seq))
    n_full = _n_full(cfg)
    cache = {
        "r1": stacked(rglru.init_rglru_cache(cfg, batch, dtype, dev),
                      n_full),
        "r2": stacked(rglru.init_rglru_cache(cfg, batch, dtype, dev),
                      n_full),
        "attn": stacked(attention.init_cache(cfg, spec, batch, dtype, dev),
                        n_full),
    }
    if _n_tail(cfg):
        cache["tail"] = stacked(rglru.init_rglru_cache(cfg, batch, dtype,
                                                       dev), _n_tail(cfg))
    return cache


def _layer_specs(cfg: ModelConfig, max_seq: int) -> list:
    """Each layer's cache: a "ring" of the window for a local layer, a
    "full" one of ``max_seq`` for a global one."""
    return [attention.cache_spec(cfg, cfg.layer_type(i), max_seq)
            for i in range(cfg.num_layers)]


def serve_step(cfg: ModelConfig, params, cache, tokens, pos: int, *,
               layouts: dict | None = None, vocab: tuple | None = None):
    """One decode step.  tokens: (B, 1) int; pos: the absolute position.
    Returns (logits (B, 1, V), new_cache); the input cache is not
    modified.

    On a process mesh ``cache`` is this rank's block of every leaf and
    ``layouts`` maps each attention cache stack ("full", "ring", "attn",
    "self", "cross_k") whose kv heads or slots are split to its
    :class:`~repro_torch.models.attention.BlockLayout` (a stack not named
    holds whole heads and slots of its rows); tokens are the rank's rows;
    ``vocab`` = (v0, v1) returns the logits of those vocab rows alone."""
    pos = int(pos)
    layouts = layouts or {}
    h = _embed_tokens(cfg, params, tokens)
    if _is_ssd(cfg):
        new = []
        for i in range(cfg.num_layers):
            lp = _index(params["blocks"], i)
            s_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
            out, c = ssd.decode_ssd(cfg, lp["ssd"], _index(cache, i), s_in)
            h = h + out
            new.append(c)
        h = nn.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return logits_fn(cfg, params, h, vocab), _stack(new)
    if _is_uniform(cfg):
        h, new_cache = _decode_uniform(cfg, params, cache, h, pos, layouts)
        h = nn.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return logits_fn(cfg, params, h, vocab), new_cache
    if _is_encdec(cfg):
        h, new_cache = _decode_encdec(cfg, params, cache, h, pos, layouts)
        h = nn.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return logits_fn(cfg, params, h, vocab), new_cache
    layout = layouts.get("attn")
    spec = attention.CacheSpec("ring", _slots(cache["attn"], layout))
    periods = params["periods"]
    new = {"r1": [], "r2": [], "attn": []}
    for i in range(_n_full(cfg)):
        h, c = _decode_rglru_block(cfg, _index(periods["r1"], i),
                                   _index(cache["r1"], i), h)
        new["r1"].append(c)
        h, c = _decode_rglru_block(cfg, _index(periods["r2"], i),
                                   _index(cache["r2"], i), h)
        new["r2"].append(c)
        h, c = _decode_attn_block(cfg, _index(periods["attn"], i),
                                  _index(cache["attn"], i), spec, h, pos,
                                  cfg.window, cfg.rope_theta, layout)
        new["attn"].append(c)
    new_cache = {k: _stack(v) for k, v in new.items()}
    if "tail" in params:
        tail = []
        for i in range(_n_tail(cfg)):
            h, c = _decode_rglru_block(cfg, _index(params["tail"], i),
                                       _index(cache["tail"], i), h)
            tail.append(c)
        new_cache["tail"] = _stack(tail)
    h = nn.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    return logits_fn(cfg, params, h, vocab), new_cache


def _slots(stack, layout) -> int:
    """The global slot count of a cache stack ((L, B, S, KV, hd) k) whose
    block this rank holds."""
    return layout.size if layout is not None and layout.dim == "seq" \
        else int(stack["k"].shape[2])


def _decode_rglru_block(cfg, lp, c, h):
    r_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, nc = rglru.decode_rglru(cfg, lp["rglru"], c, r_in)
    h = h + out
    f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
    return h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp,
                            cfg.d_ff), nc


def _decode_attn_block(cfg, lp, c, spec, h, pos, window, theta,
                       layout=None):
    a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, nc = attention.decode_attention(cfg, lp["attn"], c, spec, a_in,
                                         pos, window=window,
                                         rope_theta=theta, layout=layout)
    return _ffn(cfg, lp, h + out), nc


def _decode_encdec(cfg, params, cache, h, pos, layouts):
    """Decode through whisper's decoder: the learned position of ``pos``,
    then each layer's cached self-attention, its cross-attention over the
    cached encoder k and v, and its MLP."""
    layout = layouts.get("self")
    spec = attention.CacheSpec("full", _slots(cache["self"], layout))
    h = h + params["dec_pos"][pos][None, None]
    new = []
    for i in range(cfg.num_layers):
        lp = _index(params["decoder"], i)
        a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
        out, c = attention.decode_attention(
            cfg, lp["self_attn"], _index(cache["self"], i), spec, a_in, pos,
            window=0, rope_theta=0.0, layout=layout)
        h = h + out
        x_in = nn.apply_norm(lp["norm_x"], h, cfg.norm, cfg.norm_eps)
        h = h + attention.cross_attention_cached(
            cfg, lp["cross_attn"], x_in, cache["cross_k"][i],
            cache["cross_v"][i], layout=layouts.get("cross_k"))
        f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
        h = h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp, cfg.d_ff)
        new.append(c)
    return h, dict(cache, self=_stack(new))


def _decode_uniform(cfg, params, cache, h, pos, layouts):
    """Decode through the uniform stack in layer order; layer i reads and
    writes its slot of its kind's stack (gemma3's local and global layers
    interleave)."""
    windows, thetas = layer_statics(cfg)
    kinds = [spec.kind for spec in _layer_specs(cfg, 1 << 30)]
    specs = {k: attention.CacheSpec(k, _slots(c, layouts.get(k)))
             for k, c in cache.items()}
    new = {k: [] for k in cache}
    for i in range(cfg.num_layers):
        kind = kinds[i]
        h, c = _decode_attn_block(
            cfg, _index(params["blocks"], i),
            _index(cache[kind], len(new[kind])), specs[kind], h, pos,
            windows[i], thetas[i], layouts.get(kind))
        new[kind].append(c)
    return h, {k: _stack(v) for k, v in new.items()}


# ---------------------------------------------------------------------------
# Prefill.
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch, max_seq: int | None = None, *,
            mode: str = "auto"):
    """Run the trunk over a prompt and build the decode caches.

    batch: {"tokens": (B, S) int}, with ``"patches"`` (phi-3-vision,
    prepended: the caches then hold P + S positions) or ``"frames"``
    (whisper's encoder input).  Returns (logits_last (B, V), cache).
    ``mode`` goes to the kernel ops (``"plain"`` forces the plain
    versions on the card, for comparisons).  For Mamba-2, S must be a
    multiple of ``min(cfg.ssm_chunk, S)``, as in the reference.  S must
    be at least the conv width minus one (3 for both recurrent
    families): a shorter prompt raises ``ValueError``."""
    h = trunk_input(cfg, params, batch)
    B, S = h.shape[:2]                  # S includes prepended patches
    if _is_ssd(cfg):
        per = []
        for i in range(cfg.num_layers):
            h, c = _ssd_prefill_block(cfg, _index(params["blocks"], i), h,
                                      mode)
            per.append(c)
        return _logits_last(cfg, params, h), _stack(per)
    max_seq = max_seq or S
    positions = torch.arange(S, device=h.device).expand(B, S)
    if _is_encdec(cfg):
        enc = _encode(cfg, params, _frames(cfg, batch), mode)
        spec = attention.CacheSpec("full", max_seq)
        per = {"self": [], "cross_k": [], "cross_v": []}
        for i in range(cfg.num_layers):
            h, (c, ck, cv) = _cross_prefill_block(
                cfg, _index(params["decoder"], i), h, enc, spec, mode)
            per["self"].append(c)
            per["cross_k"].append(ck)
            per["cross_v"].append(cv)
        return _logits_last(cfg, params, h), {k: _stack(v)
                                              for k, v in per.items()}
    if _is_uniform(cfg):
        windows, thetas = layer_statics(cfg)
        per: dict = {}
        for i, spec in enumerate(_layer_specs(cfg, max_seq)):
            h, c = _attn_prefill_block(
                cfg, _index(params["blocks"], i), h, positions, spec,
                windows[i], thetas[i], mode)
            per.setdefault(spec.kind, []).append(c)
        return _logits_last(cfg, params, h), {k: _stack(v)
                                              for k, v in per.items()}
    spec = attention.CacheSpec("ring", min(cfg.window, max_seq))
    periods = params["periods"]
    per = {"r1": [], "r2": [], "attn": []}
    for i in range(_n_full(cfg)):
        h, c = _rglru_prefill_block(cfg, _index(periods["r1"], i), h,
                                    positions, mode)
        per["r1"].append(c)
        h, c = _rglru_prefill_block(cfg, _index(periods["r2"], i), h,
                                    positions, mode)
        per["r2"].append(c)
        h, c = _attn_prefill_block(cfg, _index(periods["attn"], i), h,
                                   positions, spec, cfg.window,
                                   cfg.rope_theta, mode)
        per["attn"].append(c)
    cache = {k: _stack(v) for k, v in per.items()}
    if "tail" in params:
        tail = []
        for i in range(_n_tail(cfg)):
            h, c = _rglru_prefill_block(cfg, _index(params["tail"], i), h,
                                        positions, mode)
            tail.append(c)
        cache["tail"] = _stack(tail)
    return _logits_last(cfg, params, h), cache


def _logits_last(cfg, params, h):
    """The last position's logits (B, V) of the trunk's output h."""
    h = nn.apply_norm(params["final_norm"], h[:, -1:, :], cfg.norm,
                      cfg.norm_eps)
    return logits_fn(cfg, params, h)[:, 0]


def _attn_prefill_block(cfg, lp, h, positions, spec, window, theta,
                        mode="auto"):
    a_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, k, v = attention.attention(cfg, lp["attn"], a_in, positions,
                                    window=window, rope_theta=theta,
                                    mode=mode, return_kv=True)
    h = _ffn(cfg, lp, h + out)
    cache = attention.prefill_cache(cfg, spec, k, v,
                                    torch.arange(h.shape[1], device=h.device))
    return h, cache


def _cross_prefill_block(cfg, lp, h, enc, spec, mode="auto"):
    """A whisper decoder layer of the prefill: returns h and (its self
    cache, the cross k and v of the encoder's output ``enc``)."""
    kv = _cross_kv(cfg, enc, lp)
    h, k, v = _apply_cross_block(cfg, lp, h, kv, mode, return_kv=True)
    cache = attention.prefill_cache(cfg, spec, k, v,
                                    torch.arange(h.shape[1], device=h.device))
    return h, (cache, *kv)


def _rglru_prefill_block(cfg, lp, h, positions, mode="auto"):
    r_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, st = _rglru_prefill(cfg, lp["rglru"], r_in, mode)
    h = h + out
    f_in = nn.apply_norm(lp["norm2"], h, cfg.norm, cfg.norm_eps)
    return h + nn.apply_mlp(lp["mlp"], f_in, cfg.act, cfg.gated_mlp,
                            cfg.d_ff), st


def _rglru_prefill(cfg, params, x, mode="auto"):
    """``rglru.apply_rglru`` that also returns the decode cache (every
    channel's: a rank's all-gathered where the channels split)."""
    out, hseq, rec = rglru._prefill(cfg, params, x, mode)
    h, conv = hseq[:, -1].float(), _conv_cache(rec,
                                               params["conv_w"].shape[0])
    if rglru._channels(cfg, params) is not None:
        h, conv = tp.gather_dims([(h, 1), (conv, 2)])
    return out, {"h": h, "conv": conv}


def _ssd_prefill_block(cfg, lp, h, mode="auto"):
    s_in = nn.apply_norm(lp["norm1"], h, cfg.norm, cfg.norm_eps)
    out, cache = _ssd_prefill(cfg, lp["ssd"], s_in, mode)
    return h + out, cache


def _ssd_prefill(cfg, params, x, mode="auto"):
    """``ssd.apply_ssd`` without its padding, that also returns the
    decode cache: the last ``ssm_conv - 1`` rows of the pre-conv stream
    and the final ssm state (B, nh, N, hd) in f32."""
    out, xbc, state = ssd._prefill(cfg, params, x, pad=False, mode=mode)
    conv, state = ssd.cache_rows(cfg, _conv_cache(xbc, cfg.ssm_conv), state,
                                 cfg.ssm_conv - 1, ssd._heads(cfg, params))
    return out, {"conv": conv, "state": state}


def _conv_cache(seq, width: int):
    """The decode conv cache: the last ``width - 1`` rows of the pre-conv
    stream ``seq`` (B, S, C).  Decode reads all of them, so a prompt
    shorter than that is refused here, before any decode step (the
    reference keeps the S rows it has and decodes wrong logits)."""
    S = seq.shape[1]
    if S < width - 1:
        raise ValueError(
            f"prefill: the longest prompt has {S} tokens, shorter than the "
            f"conv width minus one ({width - 1}) that decode's conv cache "
            f"needs")
    return seq[:, -(width - 1):, :]
