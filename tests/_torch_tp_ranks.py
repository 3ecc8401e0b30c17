"""What each rank runs in ``tests/test_torch_tensor_parallel.py``.

The ranks are spawned processes that import this module by name, so it
imports only torch, numpy and the port.  The test process hands them
numpy inputs (``.npz`` files of flat ``{path: array}`` trees) and checks
what they return; the reference runs in a subprocess of its own.
"""
import collections
import dataclasses
import os
import threading

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import attention, moe, nn, rglru, ssd, transformer
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, tp
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.mesh import ProcessMesh

MESH = ((1, 4), ("data", "model"))
LR = 1e-3
SEED = 7
B, S = 4, 16


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix/...`` entries of a flat tree."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, last = key[len(prefix) + 1:].split("/")
        cur = out
        for p in path:
            cur = cur.setdefault(p, {})
        cur[last] = value
    return out


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _tensors(tree, device):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                          tree)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


# -- the modules, one rank's share against the single-process module --------

def _layer(tree):
    """Layer 0 of a stacked tree."""
    return adamw.tree_map(lambda t: t[0], tree)


def _inputs(cfg, gen, rows=B, seq=S):
    return 0.5 * torch.randn(rows, seq, cfg.d_model, generator=gen)


def _grad_elsewhere(loss, inputs) -> tuple:
    """``torch.autograd.grad(loss, inputs)`` run on a new thread."""
    out = {}
    worker = threading.Thread(target=lambda: out.update(
        g=torch.autograd.grad(loss, inputs)))
    worker.start()
    worker.join()
    return out["g"]


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def module_case(mesh, cfg, path: tuple, fn, gen) -> dict:
    """``fn(params, x)`` of the first layer's module at ``path`` of the
    params (random params, x) in one process and as this rank's share
    under the mesh's tensor-parallel context, with the module's gather
    plan (the SSD leaves gathered over "model"): the relative errors of
    the output, of x's gradient and of each param block's gradient, the
    kernel calls' shapes and the shares' shapes."""
    full = _layer(_at(transformer.init_params(cfg, SEED, device="cpu"),
                      path))
    full = adamw.tree_map(lambda t: t.float(), full)
    x = _inputs(cfg, gen)
    weight = torch.randn(x.shape, generator=gen)
    p1 = adamw.tree_map(lambda t: t.clone().requires_grad_(True), full)
    x1 = x.clone().requires_grad_(True)
    y1 = fn(p1, x1)
    g1 = torch.autograd.grad((y1 * weight).sum(), [x1] + adamw.leaves(p1))

    with sharding.use_mesh(mesh):
        specs = adamw.tree_map(lambda s: sharding.P(*tuple(s)[1:]),
                               _at(transformer.param_specs(cfg), path))
    blocks = adamw.tree_map(
        lambda t, s: sharding.local_block(t, sharding.NamedSharding(
            mesh, s)).clone().requires_grad_(True), full, specs)
    x2 = x.clone().requires_grad_(True)
    calls = []
    plan = _at(transformer.gather_plan(cfg, mesh), path)
    with tp.use(tp.TensorParallel(mesh)), recording(calls):
        # recomputed in the backward, as under remat
        y2 = tp.checkpoint(lambda b, xx: fn(tp.gather_tree(b, plan), xx),
                           blocks, x2)
    # the backward on another thread, without this one's state, as the
    # autograd engine runs it for the card
    g2 = _grad_elsewhere((y2 * weight).sum(), [x2] + adamw.leaves(blocks))
    errs = {"out": _rel(y2, y1), "dx": _rel(g2[0], g1[0])}
    for name, a, b, s in zip(sorted(flatten(full)), g2[1:], g1[1:],
                             adamw.leaves(specs)):
        want = sharding.local_block(b, sharding.NamedSharding(mesh, s))
        errs["d" + name] = _rel(a, want)
    return {"errs": errs, "calls": calls,
            "shares": {k: list(v.shape) for k, v in flatten(blocks).items()}}


def loss_case(mesh, cfg, gen, chunk: int) -> dict:
    """The vocab-parallel embedding and loss: token embeddings of the
    rank's share of the table, and the loss parts of h against the
    table's rows (soft-capped), chunked or not, against one process."""
    V, D = cfg.vocab_size, cfg.d_model
    table = 0.3 * torch.randn(V, D, generator=gen)
    tokens = torch.randint(0, V, (B, S), generator=gen)
    labels = torch.randint(0, V, (B, S), generator=gen)
    mask = (torch.rand(B, S, generator=gen) < 0.8).float()
    h = _inputs(cfg, gen)

    def parts(tbl, hh):
        vocab = tp.share(tbl.shape[0], V)
        if vocab is not None:
            hh = tp.enter(hh)
        if chunk:
            return nn.chunked_loss_parts(hh, tbl, labels, chunk,
                                         cfg.logits_softcap, mask, vocab)
        logits = nn.softcap(hh @ tbl.T, cfg.logits_softcap)
        return nn.cross_entropy_parts(logits, labels, mask, vocab)

    def run(tbl, hh):
        emb = transformer._embed_tokens(cfg, {"embed": tbl}, tokens)
        tot, _ = parts(tbl, hh)
        return emb, tot

    t1 = table.clone().requires_grad_(True)
    h1 = h.clone().requires_grad_(True)
    e1, l1 = run(t1, h1)
    we = torch.randn(e1.shape, generator=gen)
    g1 = torch.autograd.grad(l1 + (e1 * we).sum(), [t1, h1])
    sh = sharding.NamedSharding(mesh, sharding.P("model", None))
    t2 = sharding.local_block(table, sh).clone().requires_grad_(True)
    h2 = h.clone().requires_grad_(True)
    with tp.use(tp.TensorParallel(mesh)):
        e2, l2 = run(t2, h2)
    g2 = _grad_elsewhere(l2 + (e2 * we).sum(), [t2, h2])
    return {"errs": {"embed": _rel(e2, e1), "loss": _rel(l2, l1),
                     "dtable": _rel(g2[0], sharding.local_block(g1[0], sh)),
                     "dh": _rel(g2[1], g1[1])},
            "loss_bits": _numpy(l2)}


def _attention(cfg):
    def fn(p, x):
        pos = torch.arange(x.shape[1]).expand(x.shape[0], -1)
        return attention.attention(cfg, p, x, pos, window=cfg.window)
    return fn


def _rglru(cfg):
    return lambda p, x: rglru.apply_rglru(cfg, p, x)


def _mlp(cfg):
    return lambda p, x: nn.apply_mlp(p, x, cfg.act, cfg.gated_mlp, cfg.d_ff)


def _ssd(cfg):
    return lambda p, x: ssd.apply_ssd(cfg, p, x)


def _moe(cfg):
    return lambda p, x: moe.apply_moe(cfg, p, x)


# (name, arch, the module's path in the params, its function)
MODULES = (
    ("attention_yi", "yi_6b", ("blocks", "attn"), _attention),
    ("attention_recurrentgemma", "recurrentgemma_9b", ("periods", "attn",
                                                       "attn"), _attention),
    ("mlp", "yi_6b", ("blocks", "mlp"), _mlp),
    ("rglru", "recurrentgemma_9b", ("periods", "r1", "rglru"), _rglru),
    ("ssd", "mamba2_1_3b", ("blocks", "ssd"), _ssd),
    ("moe", "olmoe_1b_7b", ("blocks", "moe"), _moe),
)


def module_cases(mesh, gen) -> dict:
    out = {}
    for name, arch, path, make in MODULES:
        cfg = configs.get_smoke_config(arch)
        out[name] = module_case(mesh, cfg, path, make(cfg), gen)
    return out


# -- the kernels' shapes and the parameter gathers ------------------------

KERNELS = ("flash_attention", "rglru_scan", "ssd_scan")


class recording:
    """Record each kernel op's first input shape into ``calls`` as
    (name, shape) while the block runs (the ops are wrapped where the
    model modules look them up)."""

    def __init__(self, calls: list):
        self.calls = calls

    def __enter__(self):
        self.kept = {k: getattr(ops, k) for k in KERNELS}
        for name, fn in self.kept.items():
            def wrap(*a, _fn=fn, _name=name, **k):
                self.calls.append((_name, tuple(a[0].shape)))
                return _fn(*a, **k)
            setattr(ops, name, wrap)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.kept.items():
            setattr(ops, name, fn)


class param_gathers:
    """Record every parameter gather (``tp.Gather.forward``) as (the
    gathered mesh axes, the block's shape, the plan's identity)."""

    def __init__(self, log: list):
        self.log = log

    def __enter__(self):
        self.kept = tp.Gather.forward
        log = self.log

        def forward(plan, block, _fn=self.kept):
            log.append((plan.axes, tuple(block.shape), id(plan)))
            return _fn(plan, block)
        tp.Gather.forward = forward
        return self.log

    def __exit__(self, *exc):
        tp.Gather.forward = self.kept


STEP_ARCHS = ("yi_6b", "recurrentgemma_9b", "mamba2_1_3b")


def _batch(cfg, gen, b=B, s=S):
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=gen)
    mask = torch.ones(b, s)
    mask[:, -1] = 0.0
    mask[: b // 2, s // 2:] = 0.0
    return {"tokens": toks, "labels": torch.nn.functional.pad(
        toks[:, 1:], (0, 1)), "mask": mask}


def step_cases(mesh, gen) -> dict:
    """For each of STEP_ARCHS: one sharded train step and a prefill and
    decode step on the mesh, the kernels' input shapes and the param
    gathers of each."""
    out = {}
    for arch in STEP_ARCHS:
        cfg = configs.get_smoke_config(arch)
        params = transformer.init_params(cfg, SEED, device="cpu")
        with sharding.use_mesh(mesh):
            shards = sharding.named_shardings(mesh,
                                              transformer.param_specs(cfg))
        blocks = adamw.tree_map(
            lambda t, sh: sharding.local_block(t, sh).clone(), params,
            shards)
        batch = _batch(cfg, gen)
        res = {}
        step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                         mesh=mesh)
        calls, gathers = [], []
        with recording(calls), param_gathers(gathers):
            loss, _, _ = step(blocks, adamw.adamw_init(blocks), batch)
        res["train"] = {"calls": calls, "gathers": [g[:2] for g in gathers],
                        "loss": _numpy(loss)}
        blocks = adamw.tree_map(
            lambda t, sh: sharding.local_block(t, sh).clone(), params,
            shards)
        calls, gathers = [], []
        with recording(calls), param_gathers(gathers):
            prefill = steps_mod.make_prefill_step(cfg, mesh, S + 4)
            logits, cache = prefill(blocks, {"tokens": batch["tokens"]})
            serve = steps_mod.make_serve_step(cfg, mesh,
                                              prefill.cache_shapes)
            before = collections.Counter(mesh.collectives)
            serve(blocks, cache, torch.argmax(logits, -1)[:, None], S)
            decode = dict(mesh.collectives - before)
        res["serve"] = {"calls": calls, "gathers": [g[:2] for g in gathers],
                        "decode_collectives": {
                            f"{k[0]}|{k[1]}|{k[2]}": v
                            for k, v in decode.items()}}
        mesh.kept.clear()
        out[arch] = res
    return out


# -- against the reference ---------------------------------------------------

def reference_case(mesh, path: str) -> dict:
    """The Yi smoke train step and a prefill and decode step from the
    inputs at ``path`` (the reference's weights ``p/...``, the batch
    ``b/...``): the loss, the whole state after the step, the prefill's
    logits and the decode step's whole logits."""
    cfg = configs.get_smoke_config("yi_6b")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _tensors(unflatten(flat, "p"), "cpu")
    batch = _tensors(unflatten(flat, "b"), "cpu")
    with sharding.use_mesh(mesh):
        pshard = sharding.named_shardings(mesh, transformer.param_specs(cfg))
        oshard = sharding.named_shardings(mesh, steps_mod.opt_specs(cfg))
    blocks = adamw.tree_map(
        lambda t, sh: sharding.local_block(t, sh).clone(), params, pshard)
    step = steps_mod.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                     mesh=mesh)
    opt = adamw.adamw_init(blocks)
    loss, blocks2, opt = step(blocks, opt, batch)
    state = adamw.tree_map(lambda b, sh: sharding.gather(b, sh),
                           {"params": blocks2, "opt": opt},
                           {"params": pshard, "opt": oshard})
    fresh = adamw.tree_map(
        lambda t, sh: sharding.local_block(t, sh).clone(), params, pshard)
    prefill = steps_mod.make_prefill_step(cfg, mesh, S + 4)
    logits, cache = prefill(fresh, {"tokens": batch["tokens"]})
    serve = steps_mod.make_serve_step(cfg, mesh, prefill.cache_shapes)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    blk, _ = serve(fresh, cache, tok, S)
    return {"loss": _numpy(loss),
            "state": {k: _numpy(v) for k, v in flatten(state).items()},
            "prefill_logits": _numpy(logits),
            "decode_logits": _numpy(sharding.gather(
                blk, serve.logits_sharding))}


def tp_rank(device, tmp: str) -> dict:
    """Every case of the test file on the ("data": 1, "model": 4) mesh."""
    mesh = ProcessMesh(*MESH, device=device)
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(11)
    return {"rank": mesh.rank, "modules": module_cases(mesh, gen),
            "loss": {f"chunk{c}": loss_case(mesh, dataclasses.replace(
                configs.get_smoke_config("gemma_7b"), logits_softcap=30.0),
                gen, c) for c in (0, 4)},
            "steps": step_cases(mesh, gen),
            "reference": reference_case(mesh, os.path.join(tmp,
                                                           "yi.npz"))}
