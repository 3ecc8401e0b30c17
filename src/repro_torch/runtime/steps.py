"""Train, prefill and serve step factories, and the specs of their
inputs.

The counterparts of ``repro.runtime.steps``: ``make_loss_fn``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``, and the
partition specs ``batch_specs``, ``opt_specs`` and ``cache_specs_tree``
(equal to the reference's as tuples).  Steps are eager calls; the AdamW
update is in place, which is what the reference's buffer donation buys.

``make_train_step(mesh=...)`` is sharded training on a
:class:`~repro_torch.runtime.mesh.ProcessMesh`, the same function as the
reference's GSPMD step: each rank holds its block of the parameters and
of both AdamW moments as ``param_specs`` and ``opt_specs`` lay them out,
computes tensor-parallel on "model" (its heads, d_ff columns, channels,
experts and vocab rows; :mod:`repro_torch.runtime.tp`), gathers each
layer's blocks over their FSDP axes inside the layer and reduce-scatters
the layer's gradient back into its block, never holding the whole tree,
and computes the gradient of the global loss on its rows of the batch
(:func:`make_train_step` says how).

``make_prefill_step(mesh=...)`` and ``make_serve_step(mesh=...,
cache_shapes=...)`` are the reference's sharded serving steps on a
``ProcessMesh``.  Every rank passes its blocks of the params and the
whole global inputs; the step computes the rank's rows, tensor-parallel
on "model", with the rank's share of the params (:func:`tp_share`: its
blocks gathered over their FSDP axes once and kept while the blocks are
unchanged; no rank holds the whole tree) and returns the rank's blocks
of the outputs.  The prefill returns the whole last-position logits on
every rank and this rank's block of every cache leaf under
``cache_specs_tree``; the serve step takes and returns cache blocks and
returns its block of the logits.  The cache is never gathered: decode's
attention runs on the block, with its kv heads split over "model", its
slots split over "model" (``kv_seq``) or its rows alone
(:mod:`repro_torch.models.attention` says how).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import LM_DTYPES
from repro_torch.models import attention, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, tp
from repro_torch.runtime.sharding import P


_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frames": ("batch", "seq", "embed"),
    "patches": ("batch", "seq", "embed"),
}


def batch_specs(cfg: ModelConfig, batch_shapes: dict) -> dict:
    """Shape-aware specs of an input batch (values: anything with a
    ``.shape``, e.g. ``meta`` tensors) under the ambient mesh."""
    with sharding.profile(cfg.sharding_profile):
        return {name: sharding.act_spec_shaped(tuple(s.shape),
                                               *_BATCH_AXES[name])
                for name, s in batch_shapes.items()}


def opt_specs(cfg: ModelConfig) -> dict:
    pspec = transformer.param_specs(cfg)
    return {"m": pspec, "v": pspec, "step": P()}


def cache_specs_tree(cfg: ModelConfig, cache_shapes):
    """Specs of a decode cache: batch dim over ('pod', 'data'), kv-head
    dim over 'model' where present (shape-aware fallbacks)."""
    def spec_for(name, leaf):
        nd = len(leaf.shape)
        if name == "pos":
            return P()
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S, KV, D) stacked / (B, S, KV, D) unstacked.  Prefer
            # kv-head sharding; fall back to sequence sharding of the
            # cache when kv heads don't divide the model axis.
            axes = ((None, "batch", None, "kv_heads", None) if nd == 5
                    else ("batch", None, "kv_heads", None))
            spec = sharding.act_spec_shaped(leaf.shape, *axes)
            if spec[3 if nd == 5 else 2] is None:
                axes = ((None, "batch", "kv_seq", None, None) if nd == 5
                        else ("batch", "kv_seq", None, None))
                spec = sharding.act_spec_shaped(leaf.shape, *axes)
            return spec
        # recurrent states: (L, B, ...) — batch-shard only
        axes = [None, "batch"] + [None] * (nd - 2)
        return sharding.act_spec_shaped(leaf.shape, *axes)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec_for(name, node)

    with sharding.profile(cfg.sharding_profile):
        return walk(cache_shapes, "")


def make_loss_fn(cfg: ModelConfig, *, mode: str = "auto"):
    """``loss(params, batch) -> f32 scalar``; ``mode`` goes to the kernel
    ops."""
    def loss(params, batch):
        return transformer.loss_fn(cfg, params, batch, mode=mode)
    return loss


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the grads a tree like
    params, in the params' dtypes (bf16 params give bf16 grads, as in the
    reference); every param leaf is set to require grad."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), adamw.tree_map(lambda _: next(grads), params)


# The kernel each layer kind of ``ModelConfig.attn_pattern`` runs.
_KERNEL_OF = {"global": "flash_attention", "local": "flash_attention",
              "rglru": "rglru_scan", "ssd": "ssd_scan"}


def check_trainable(cfg: ModelConfig, dtype: torch.dtype, device) -> None:
    """Refuse, before a step runs, params that the kernels cannot train:
    on the card every layer's forward and backward is a kernel, and each
    takes f32 or bf16 (``flash_attention`` and its backward for attention
    layers, ``rglru_scan`` for recurrent ones, ``ssd_scan`` for SSD ones);
    the CPU runs the plain versions in any dtype."""
    if torch.device(device).type != "cuda" or dtype in LM_DTYPES:
        return
    kernels = " and ".join(sorted({_KERNEL_OF.get(t, t)
                                   for t in cfg.attn_pattern}))
    names = " or ".join(str(d).removeprefix("torch.") for d in LM_DTYPES)
    raise TypeError(
        f"{cfg.name}: training on the card needs {names} params (got "
        f"{dtype}): the {kernels} kernels take no other dtype")


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    lr_schedule=None, mesh=None, *,
                    batch_shapes: dict | None = None, mode: str = "auto"):
    """Returns ``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``; the update is in place, and ``train_step.last
    ["grad_norm"]`` is the last step's global gradient norm (before
    clipping).  The batch holds what the model reads: whisper's
    ``"frames"`` beside its tokens, phi-3-vision's optional
    ``"patches"``.  With ``opt_cfg.accum_steps`` = k > 1 the batch splits
    into k microbatches along its leading axis and their grads are summed
    in f32 and divided by k, as the reference's microbatch scan does.
    Each step first refuses what :func:`check_trainable` refuses: on the
    card, params in a dtype that no kernel takes (f32 and bf16 train
    there, attention layers included).  ``mode`` goes to the kernel ops.

    With ``mesh`` (a ``ProcessMesh``) every rank calls the step with its
    blocks of the params and of ``m`` and ``v`` (``param_specs`` and
    ``opt_specs`` under the mesh) and the whole global batch, and the
    step (a) takes this rank's rows of each microbatch by
    ``batch_specs`` (``batch_shapes``, anything with a ``.shape``, or
    the first batch's shapes: every batch must have them), so ranks off
    the batch's mesh axes hold the same rows; (b) computes the gradient
    of the global loss, the sum of the masked token losses over the rows
    of every rank over the sum of their mask, tensor-parallel on
    "model", each layer's blocks all-gathered over their FSDP axes in
    the layer (:func:`transformer.gather_plan`) and its gradient reduce-
    scattered back over the batch's axes among them, in f32, into the
    block; (c) sums each leaf's gradient over the batch's other mesh
    axes, in f32, cast once to the dtype the single-process step's
    gradients have (the params' without accumulation, f32 with it); (d)
    clips by the global norm, each leaf's squared block norms summed over
    the axes that shard it; (e) runs AdamW in place on the blocks; (f)
    returns the global loss, the same bits on every rank.  Ranks that
    hold the same block end with the same bits."""
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, lr_schedule, mesh,
                                   batch_shapes, mode)
    loss_fn = make_loss_fn(cfg, mode=mode)
    accum = opt_cfg.accum_steps
    last = {"grad_norm": None}

    def step(params, opt_state, batch):
        leaf = adamw.leaves(params)[0]
        check_trainable(cfg, leaf.dtype, leaf.device)
        lr = (lr_schedule(int(opt_state["step"]))
              if lr_schedule is not None else opt_cfg.lr)
        if accum > 1:
            grads, loss = None, 0.0
            for i in range(accum):
                l, g = value_and_grad(loss_fn, params,
                                      _microbatch(batch, accum, i))
                grads = (adamw.tree_map(lambda x: x.float(), g)
                         if grads is None else
                         adamw.tree_map(torch.add, grads, g))
                loss = loss + l
            grads = adamw.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, last["grad_norm"] = adamw.adamw_step(
            opt_cfg, grads, opt_state, params, lr=lr)
        return loss, params, opt_state

    step.last = last
    return step


def _microbatch(batch: dict, accum: int, i: int) -> dict:
    """Microbatch ``i`` of ``accum``: the global rows [i B / k, (i + 1) B
    / k)."""
    return {k: v.reshape((accum, v.shape[0] // accum)
                         + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def _row_plan(cfg: ModelConfig, mesh, shapes: dict, accum: int) -> tuple:
    """(the specs of one microbatch's tensors, the mesh axes that split
    its rows) under ``mesh``."""
    micro = {}
    for name, shape in shapes.items():
        if shape[0] % accum:
            raise ValueError(f"batch[{name!r}] has {shape[0]} rows, not a "
                             f"multiple of accum_steps = {accum}")
        micro[name] = torch.empty((shape[0] // accum,) + tuple(shape[1:]),
                                  device="meta")
    with sharding.use_mesh(mesh):
        specs = batch_specs(cfg, micro)
    return specs, _row_axes(specs)


def _sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                        lr_schedule, mesh, batch_shapes, mode: str):
    """The sharded step of :func:`make_train_step` on ``mesh``."""
    accum = opt_cfg.accum_steps
    with sharding.use_mesh(mesh):
        shardings = adamw.leaves(sharding.named_shardings(
            mesh, transformer.param_specs(cfg)))
    plan = {}
    if batch_shapes is not None:
        plan["shapes"] = {k: tuple(v.shape) for k, v in batch_shapes.items()}
    last = {"grad_norm": None}

    def plan_for(batch: dict) -> dict:
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        plan.setdefault("shapes", shapes)
        if shapes != plan["shapes"]:
            raise ValueError(f"batch shapes {shapes} differ from the "
                             f"step's {plan['shapes']}")
        if "specs" not in plan:
            plan["specs"], axes = _row_plan(cfg, mesh, shapes, accum)
            plan["axes"] = axes
            gathers = transformer.gather_plan(cfg, mesh, axes)
            plan["tp"] = tp.TensorParallel(mesh, gathers)
            # the batch axes each leaf's gradient is still summed over:
            # those its gather does not reduce-scatter
            plan["rest"] = [tuple(a for a in axes if mesh.shape[a] > 1 and (
                g is None or a not in g.summed))
                for g in adamw.leaves(gathers)]
        return plan

    def step(params, opt_state, batch):
        blocks = adamw.leaves(params)
        check_trainable(cfg, blocks[0].dtype, blocks[0].device)
        p = plan_for(batch)
        specs, axes = p["specs"], p["axes"]
        lr = (lr_schedule(int(opt_state["step"]))
              if lr_schedule is not None else opt_cfg.lr)
        held = [b.detach().requires_grad_(True) for b in blocks]
        it = iter(held)
        tree = adamw.tree_map(lambda _: next(it), params)
        grads, loss = None, 0.0
        with tp.use(p["tp"]):
            for i in range(accum):
                rows = {k: sharding.local_block(
                    v, sharding.NamedSharding(mesh, specs[k]))
                    for k, v in _microbatch(batch, accum, i).items()}
                tot, cnt = transformer.loss_parts(cfg, tree, rows,
                                                  mode=mode)
                # the global batch's parts, summed over the ranks whose
                # rows differ (the others hold the same rows)
                parts = torch.stack([tot.detach(), cnt.detach()])
                if axes:
                    parts = mesh.psum(parts, axes)
                denom = torch.clamp(parts[1], min=1.0)
                g = list(torch.autograd.grad(tot / denom, held))
                if accum > 1:
                    g = [x.float() for x in g]
                grads = (g if grads is None else
                         [a + b for a, b in zip(grads, g)])
                loss = loss + parts[0] / denom
        if accum > 1:
            loss = loss / accum
        del held, tree
        out = []
        for j, rest in enumerate(p["rest"]):
            g, grads[j] = grads[j], None
            if rest:
                g = mesh.psum(g.float(), rest)
            out.append(g.float() / accum if accum > 1
                       else g.to(blocks[j].dtype))
        norm = _global_norm(out, shardings, mesh)
        it = iter(out)
        params, opt_state, last["grad_norm"] = adamw.adamw_step(
            opt_cfg, adamw.tree_map(lambda _: next(it), params), opt_state,
            params, lr=lr, norm=norm)
        return loss, params, opt_state

    step.last = last
    return step


def _global_norm(blocks: list, shardings: list, mesh) -> torch.Tensor:
    """The f32 global norm of a sharded tree from this rank's blocks: each
    leaf's squared block norm summed over the mesh axes that shard that
    leaf (its other ranks hold the same block), one collective for each
    set of axes."""
    sq = [torch.linalg.vector_norm(b, dtype=torch.float32) ** 2
          for b in blocks]
    by_axes: dict = {}
    for j, sh in enumerate(shardings):
        axes = tuple(a for a in mesh.axis_names
                     if a in sharding.spec_axes(sh.spec))
        by_axes.setdefault(axes, []).append(j)
    for axes, idx in by_axes.items():
        if axes:
            summed = mesh.psum(torch.stack([sq[j] for j in idx]), axes)
            for j, v in zip(idx, summed):
                sq[j] = v
    return torch.sqrt(torch.sum(torch.stack(sq)))


class TPShare:
    """This rank's tensor-parallel share of the parameters of ``cfg`` on
    ``mesh``: its blocks (``param_specs`` under the mesh) gathered over
    their FSDP axes, still split over "model" (the SSD block's
    ``in_proj``, ``conv_w`` and ``conv_b`` whole;
    :func:`transformer.gather_plan`).

    Calling it with the tree of blocks returns the tree of shares.  Each
    leaf is gathered once and kept while its block is the same tensor
    object at the same ``_version``: a decode loop gathers on its first
    call only.  An in-place edit of a block bumps its version and brings
    that leaf's gather back on the next call (every rank must edit the
    same blocks, as an SPMD program does: the gather is a collective).
    An inference tensor has no version counter, so an in-place edit of
    one under ``torch.inference_mode`` goes unseen.  A leaf that no FSDP
    axis splits is its block itself.  The steps take theirs from
    :func:`tp_share`."""

    def __init__(self, cfg: ModelConfig, mesh):
        with sharding.use_mesh(mesh):
            self.shardings = adamw.leaves(sharding.named_shardings(
                mesh, transformer.param_specs(cfg)))
        self.plans = adamw.leaves(transformer.gather_plan(
            cfg, mesh, per_layer=False))
        self._kept: list = [None] * len(self.shardings)

    def __call__(self, params):
        blocks = adamw.leaves(params)
        if len(blocks) != len(self.shardings):
            raise ValueError(f"{len(blocks)} param blocks, but the config "
                             f"has {len(self.shardings)} leaves")
        for j, (b, plan) in enumerate(zip(blocks, self.plans)):
            ver = None if b.is_inference() else b._version
            kept = self._kept[j]
            if kept is None or kept[0] is not b or kept[1] != ver:
                self._kept[j] = None      # free the old leaf first
                with torch.no_grad():
                    self._kept[j] = (b, ver, tp.gather(b.detach(), plan))
        it = iter(k[2] for k in self._kept)
        return adamw.tree_map(lambda _: next(it), params)


def tp_share(cfg: ModelConfig, mesh) -> TPShare:
    """The one :class:`TPShare` of ``cfg`` on ``mesh``, kept in
    ``mesh.kept`` and dropped with the mesh: the prefill and serve steps
    of a config on a mesh (and ``serve_queue``'s waves) share it, so a
    rank holds one share.  ``mesh.kept.clear()`` frees it."""
    kept = mesh.kept.setdefault("tp_share", {})
    if cfg not in kept:
        kept[cfg] = TPShare(cfg, mesh)
    return kept[cfg]


def make_prefill_step(cfg: ModelConfig, mesh=None, max_seq: int | None = None,
                      batch_shapes: dict | None = None, *,
                      mode: str = "auto"):
    """``step(params, batch) -> (logits_last (B, V), cache)``; ``mode``
    goes to the prefill's kernel ops.

    With ``mesh`` every rank passes its blocks of the params and the
    whole global batch; the step takes this rank's rows by
    ``batch_specs`` (``batch_shapes``, or the first batch's shapes: every
    batch must have them), runs the prefill on them tensor-parallel with
    the rank's share of the params (:func:`tp_share`) and returns the
    whole ``logits_last`` on every rank (gathered over the batch's mesh
    axes and, where the output table splits its vocab, "model") and this
    rank's block of every cache leaf
    under ``cache_specs_tree`` of the global cache (its shapes:
    ``transformer.init_decode_cache(cfg, B, max_seq)`` on ``meta``, which
    the prefill's cache must have).  ``step.cache_shapes`` is the global
    cache's shapes (``meta`` tensors, after the first call, or after
    ``step.plan(batch)``, which plans the step from the batch's shapes
    alone and gathers nothing)."""
    if mesh is not None:
        return _sharded_prefill_step(cfg, mesh, max_seq, batch_shapes, mode)

    def step(params, batch):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch, max_seq=max_seq,
                                       mode=mode)
    return step


def make_serve_step(cfg: ModelConfig, mesh=None, cache_shapes=None):
    """``step(params, cache, tokens, pos) -> (logits (B, 1, V), cache)``.

    With ``mesh`` (``cache_shapes``, the global cache's shapes, then
    required) every rank passes its blocks of the params, its blocks of
    the cache (``cache_specs_tree``), the whole (B, 1) tokens and
    ``pos``; the step decodes the rank's rows (the tokens' spec, as the
    reference's) tensor-parallel with the rank's share of the params
    (:func:`tp_share`) and returns this rank's block of the logits,
    ``act_spec_shaped((B, 1, V), "batch", None, "vocab")``, computed from
    the rank's vocab rows of the output table, and its new cache
    blocks.  The cache is never gathered.  ``step.logits_sharding``
    is the logits' :class:`~repro_torch.runtime.sharding.NamedSharding`
    (``sharding.gather`` gives the whole logits)."""
    if mesh is not None:
        if cache_shapes is None:
            raise ValueError("make_serve_step(mesh=...) needs cache_shapes, "
                             "the global cache's shapes")
        return _sharded_serve_step(cfg, mesh, cache_shapes)

    def step(params, cache, tokens, pos):
        with torch.inference_mode():
            return transformer.serve_step(cfg, params, cache, tokens, pos)
    return step


def _tree_shapes(tree):
    return adamw.tree_map(lambda t: tuple(t.shape), tree)


def _cache_shardings(cfg: ModelConfig, mesh, cache_shapes):
    with sharding.use_mesh(mesh):
        return sharding.named_shardings(
            mesh, cache_specs_tree(cfg, cache_shapes))


def _row_axes(specs: dict) -> tuple:
    """The mesh axes that split the rows (dim 0) of every tensor of a
    batch's specs."""
    rows = {sharding.dim_axes(spec[0]) for spec in specs.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch's tensors split their rows over "
                         f"different mesh axes: {specs}")
    return rows.pop()


def _check_cache_rows(shards, rows: tuple) -> None:
    """Every cache leaf with rows (dim 1 of the stacked leaves) splits
    them over ``rows``, the axes of the step's rows."""
    for sh in adamw.leaves(shards):
        if len(sh.spec) > 1 and sharding.dim_axes(sh.spec[1]) != rows:
            raise ValueError(f"a cache leaf splits its rows as "
                             f"{sh.spec}, the batch over {rows}")


def _sharded_prefill_step(cfg: ModelConfig, mesh, max_seq, batch_shapes,
                          mode: str):
    """The prefill of :func:`make_prefill_step` on ``mesh``."""
    plan = {}
    if batch_shapes is not None:
        plan["shapes"] = {k: tuple(v.shape) for k, v in batch_shapes.items()}

    def plan_for(batch: dict) -> dict:
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        plan.setdefault("shapes", shapes)
        if shapes != plan["shapes"]:
            raise ValueError(f"batch shapes {shapes} differ from the "
                             f"step's {plan['shapes']}")
        if "specs" in plan:
            return plan
        with sharding.use_mesh(mesh):
            plan["specs"] = batch_specs(cfg, {
                k: torch.empty(v, device="meta") for k, v in shapes.items()})
        rows = _row_axes(plan["specs"])
        B, S = shapes["tokens"]
        if transformer._has_patches(cfg, shapes):
            S += shapes["patches"][1]
        meta = transformer.init_decode_cache(cfg, B, max_seq or S,
                                             device="meta")
        plan["cache"] = _cache_shardings(cfg, mesh, meta)
        _check_cache_rows(plan["cache"], rows)
        plan["cache_shapes"] = _tree_shapes(meta)
        step.cache_shapes = meta
        vocab = _vocab_axes(cfg, mesh)
        plan["logits"] = sharding.NamedSharding(mesh, P(rows or None,
                                                        vocab or None))
        return plan

    def block_of(local, sh, shape):
        """This rank's block of a cache leaf of the global ``shape`` from
        the prefill's leaf of its rows (dim 1 of the stacked leaves),
        which holds each other dimension whole or as this block's share
        already (a rank's kv heads)."""
        sl = list(sharding.block_slices(sh, shape))
        ok = local.dim() == len(shape)
        for d, n in enumerate(local.shape if ok else ()):
            size = sl[d].stop - sl[d].start
            if d == 1 or (n == size and n != shape[d]):
                ok &= n == size
                sl[d] = slice(None)
            else:
                ok &= n == shape[d]
        if not ok:
            raise ValueError(
                f"the prefill's cache leaf {tuple(local.shape)} is not "
                f"this rank's rows of the global {shape}")
        return local[tuple(sl)].clone()

    def step(params, batch):
        p = plan_for(batch)
        tree = tp_share(cfg, mesh)(params)
        rows = {k: sharding.local_block(v, sharding.NamedSharding(
            mesh, p["specs"][k])) for k, v in batch.items()}
        with torch.inference_mode(), tp.use(tp.TensorParallel(mesh)):
            logits, cache = transformer.prefill(cfg, tree, rows,
                                                max_seq=max_seq, mode=mode)
            cache = adamw.tree_map(block_of, cache, p["cache"],
                                   p["cache_shapes"])
            logits = sharding.gather(logits, p["logits"])
        return logits, cache

    step.cache_shapes = None
    step.plan = plan_for
    return step


def _vocab_axes(cfg: ModelConfig, mesh) -> tuple:
    """The mesh axes (of more than one rank) that split the output
    table's vocab rows."""
    with sharding.use_mesh(mesh):
        spec = transformer.param_specs(cfg)[
            "embed" if cfg.tie_embeddings else "unembed"]
    return tuple(a for a in sharding.dim_axes(spec[0]) if mesh.shape[a] > 1)


def _layout(sh, shape) -> attention.BlockLayout | None:
    """The decode layout of a stacked (L, B, S, KV, hd) k leaf's block:
    its kv heads or slots split, or None (rows alone)."""
    for dim, name in ((3, "heads"), (2, "seq")):
        axes = sharding.dim_axes(sh.spec[dim]) if dim < len(sh.spec) else ()
        if axes:
            start, stop = sharding.dim_range(sh, shape, dim)
            return attention.BlockLayout(name, sh.mesh, axes, start, stop,
                                         shape[dim])
    return None


def _sharded_serve_step(cfg: ModelConfig, mesh, cache_shapes):
    """The decode step of :func:`make_serve_step` on ``mesh``."""
    shapes = _tree_shapes(cache_shapes)
    shards = _cache_shardings(cfg, mesh, cache_shapes)
    B = adamw.leaves(shapes)[0][1]       # the reference's choice of leaf
    V = cfg.vocab_size
    with sharding.use_mesh(mesh), sharding.profile(cfg.sharding_profile):
        tspec = sharding.act_spec_shaped((B, 1), "batch", None)
        lspec = sharding.act_spec_shaped((B, 1, V), "batch", None, "vocab")
    _check_cache_rows(shards, sharding.dim_axes(tspec[0]))
    tshard = sharding.NamedSharding(mesh, tspec)
    lshard = sharding.NamedSharding(mesh, lspec)
    vocab = sharding.dim_range(lshard, (B, 1, V), 2)
    layouts = {}     # each attention stack whose heads or slots split
    for key, node in shards.items():
        if isinstance(node, dict) and "k" in node:
            sh, shape = node["k"], shapes[key]["k"]
        elif key == "cross_k":
            sh, shape = node, shapes[key]
        else:
            continue
        layout = _layout(sh, shape)
        if layout is not None:
            layouts[key] = layout

    def step(params, cache, tokens, pos):
        tree = tp_share(cfg, mesh)(params)
        rows = sharding.local_block(tokens, tshard)
        with torch.inference_mode(), tp.use(tp.TensorParallel(mesh)):
            return transformer.serve_step(
                cfg, tree, cache, rows, pos, layouts=layouts,
                vocab=None if vocab == (0, V) else vocab)

    step.logits_sharding = lshard
    step.layouts = layouts
    return step
