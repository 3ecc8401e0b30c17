"""What each rank runs in ``tests/test_torch_serve_mesh.py``.

The ranks are spawned processes that import this module by name, so it
imports only torch, numpy and the port.  The test process hands them
numpy inputs (``.npz`` files of flat ``{path: array}`` trees: ``p/...``
the weights, ``b/...`` the prefill batch) and checks what they return
against the reference, which runs in a subprocess of its own.
"""
import collections
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, transformer
from repro_torch.optim import adamw
from repro_torch.runtime import sharding, tp
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.mesh import ProcessMesh

MESH = ((2, 2), ("data", "model"))
COLLECTIVES = ("all_gather", "pmax", "psum", "reduce_scatter", "ppermute",
               "objects")
# parameter gathers (``tp.Gather.forward`` calls) this rank has made
PARAM_GATHERS = {"n": 0}


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


def param_blocks(cfg, mesh, params):
    """This rank's blocks of whole ``params`` under ``param_specs``."""
    with sharding.use_mesh(mesh):
        shards = sharding.named_shardings(mesh, transformer.param_specs(cfg))
    return adamw.tree_map(lambda t, sh: sharding.local_block(t, sh).clone(),
                          params, shards)


def _counts(mesh) -> dict:
    return dict(mesh.counts, params=PARAM_GATHERS["n"])


def _delta(mesh, before: dict) -> dict:
    now = _counts(mesh)
    return {k: now[k] - before[k] for k in COLLECTIVES + ("params",)
            if now[k] != before[k]}


def _split(spec) -> bool:
    return "model" in sharding.spec_axes(spec)


def expected_collectives(cfg, mesh, step, cache_shapes) -> dict:
    """The collectives of one decode step with the params' shares kept,
    as the tensor-parallel model makes them: a psum of the embedding
    where the vocab splits; a layer whose heads, d_ff, experts, channels
    or SSD heads split a psum at its end (the SSD block one more, for its
    norm), an all-gather of the new RG-LRU or SSD state; an attention
    stack whose slots split a pmax and a psum a layer, and an all-gather
    of the queries where its heads split too."""
    with sharding.use_mesh(mesh):
        specs = transformer.param_specs(cfg)
    want: dict = {}

    def add(kind, n):
        if n:
            want[kind] = want.get(kind, 0) + n

    add("psum", int(_split(specs["embed"])))

    def blocks(tree, n):
        if "attn" in tree or "self_attn" in tree:
            add("psum", n * int(_split(tree.get("attn", tree.get(
                "self_attn", {}))["wq"])))
        if "cross_attn" in tree:
            add("psum", n * int(_split(tree["cross_attn"]["wq"])))
        for key in ("mlp", "moe"):
            if key in tree:
                add("psum", n * int(_split(tree[key]["w_up"])))
        if "rglru" in tree and _split(tree["rglru"]["w_in_rec"]):
            add("psum", n)
            add("all_gather", n)
        if "ssd" in tree and _split(tree["ssd"]["norm"]):
            add("psum", 2 * n)
            add("all_gather", n)

    layers = {k: int(adamw.leaves(v)[0].shape[0])
              for k, v in transformer.param_shapes(cfg).items()
              if k in transformer.STACKS and k != "encoder"}
    for key, n in layers.items():
        if key == "periods":
            for sub in ("r1", "r2", "attn"):
                blocks(specs[key][sub], n)
        else:
            blocks(specs[key], n)
    heads = specs.get("blocks", specs.get("periods", {}).get(
        "attn", specs.get("decoder")))
    attn = heads.get("attn", heads.get("self_attn")) if heads else None
    for key, layout in step.layouts.items():
        leaf = cache_shapes[key]
        n = int((leaf["k"] if isinstance(leaf, dict) else leaf).shape[0])
        if layout.dim == "seq":
            add("pmax", n)
            add("psum", n)
            add("all_gather", n * int(attn is not None
                                      and _split(attn["wq"])))
    return want


def decode(step, params, cache, tokens, positions, mesh=None) -> tuple:
    """Greedy decode from ``cache``: each step's whole logits, tokens and
    cache blocks, and its collectives (``mesh``'s counts)."""
    logits, toks, caches, counts = [], [], [], []
    for i, pos in enumerate(positions):
        before = _counts(mesh) if mesh is not None else None
        blk, cache = step(params, cache, tokens, pos)
        whole = sharding.gather(blk, step.logits_sharding)
        if mesh is not None:
            counts.append(_delta(mesh, before))
        logits.append(_numpy(whole))
        tokens = torch.argmax(whole, -1)
        toks.append(_numpy(tokens))
        caches.append({k: _numpy(v) for k, v in flatten(cache).items()})
    return logits, toks, caches, counts


def _local_softmax(scores, valid, v, layout):
    """A broken combine: each rank's slots softmaxed alone."""
    s = torch.where(valid, scores, attention.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", p, v.float())


def _no_sum(out):
    """A broken end of the attention layer: this rank's partial sum of
    the row-parallel ``wo`` kept, the psum over "model" left out."""
    return out


MUTATIONS = {"seq": ("_combine_slots", _local_softmax),
             "heads": ("_sum_heads", _no_sum)}


def run_case(device, mesh, path: str, case: dict) -> dict:
    """One case: the sharded prefill and ``case["steps"]`` greedy decode
    steps, a mutated decode where the case names one, an in-place edit
    of one block and a fresh serve step's first call, then
    ``serve_batch(mesh=)``, ``serve_queue(mesh=, slots=2)`` and a
    sampled ``serve_batch(mesh=, greedy=False)``."""
    cfg = configs.get_smoke_config(case["arch"])
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = param_blocks(cfg, mesh, _tensors(unflatten(flat, "p"), device))
    batch = _tensors(unflatten(flat, "b"), device)
    first = _counts(mesh)
    recorded = collections.Counter(mesh.collectives)
    prefill = steps_mod.make_prefill_step(cfg, mesh, case["max_seq"])
    logits, cache = prefill(params, batch)
    out = {"prefill_counts": _delta(mesh, first),
           "prefill_collectives": dict(mesh.collectives - recorded),
           "prefill_logits": _numpy(logits),
           "prefill_cache": {k: _numpy(v) for k, v in flatten(cache).items()}}
    shapes = prefill.cache_shapes
    serve = steps_mod.make_serve_step(cfg, mesh, shapes)
    out["layouts"] = {k: (v.dim, v.axes, v.start, v.stop, v.size)
                      for k, v in serve.layouts.items()}
    out["expected"] = expected_collectives(cfg, mesh, serve, shapes)
    out["logits_split"] = bool(sharding.spec_axes(
        serve.logits_sharding.spec))
    start = batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)
    positions = [start + i for i in range(case["steps"])]
    tok0 = torch.argmax(logits, -1)[:, None]
    (out["logits"], out["tokens"], out["caches"],
     out["counts"]) = decode(serve, params, cache, tok0, positions, mesh)

    if case.get("mutate"):
        name, broken = MUTATIONS[case["mutate"]]
        keep = getattr(attention, name)
        setattr(attention, name, broken)
        try:
            out["mutated"] = decode(serve, params, cache, tok0,
                                    positions)[0]
        finally:
            setattr(attention, name, keep)

    # one block edited in place: its leaf is gathered again, alone; a
    # new serve step shares the mesh's kept shares, and after they are
    # dropped gathers every leaf an FSDP axis splits on its first call
    tokens = torch.from_numpy(out["tokens"][0]).to(device)
    plans = steps_mod.tp_share(cfg, mesh).plans
    leaf = next(b for b, plan in zip(adamw.leaves(params), plans)
                if plan is not None)
    leaf.mul_(1.0)
    before = _counts(mesh)
    serve(params, cache, tokens, positions[0])
    out["edited_counts"] = _delta(mesh, before)
    fresh = steps_mod.make_serve_step(cfg, mesh, shapes)
    runs, recorded = [], []
    for drop in (False, True, False):
        if drop:
            mesh.kept.clear()
        before = _counts(mesh)
        records = collections.Counter(mesh.collectives)
        fresh(params, cache, tokens, positions[0])
        runs.append(_delta(mesh, before))
        recorded.append(dict(mesh.collectives - records))
    out["fresh_counts"] = runs
    # the collectives of a decode step that gathers the params, as the
    # mesh records them
    out["fresh_collectives"] = recorded[1]
    out["split_leaves"] = sum(1 for plan in plans if plan is not None)
    out["gathered_leaves"] = [sorted(plan.axes) for plan in plans
                              if plan is not None]

    if case.get("serve"):
        prompts = [flat[f"r/{i}"] for i in range(len(
            [k for k in flat if k.startswith("r/")]))]
        for name, fn, kw in (
                ("serve_batch", serve_mod.serve_batch, {}),
                ("serve_queue", serve_mod.serve_queue, {"slots": 2}),
                ("sampled", serve_mod.serve_batch,
                 {"greedy": False, "seed": 3})):
            reqs = [serve_mod.Request(rid=i, prompt=p,
                                      max_new=case["max_new"])
                    for i, p in enumerate(prompts)]
            done, _ = fn(cfg, params, reqs, max_seq=case["serve_max_seq"],
                         mesh=mesh, **kw)
            out[name] = [r.out for r in done]
    return out


def _count_gathers(forward):
    def run(plan, block):
        PARAM_GATHERS["n"] += 1
        return forward(plan, block)
    return run


def serve_rank(device, cases: dict, tmp: str) -> dict:
    """Every case of ``cases`` ({name: case}) on the ("data": 2,
    "model": 2) mesh."""
    tp.Gather.forward = _count_gathers(tp.Gather.forward)
    mesh = ProcessMesh(*MESH, device=device)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "cases": {}}
    for name, case in cases.items():
        out["cases"][name] = run_case(device, mesh,
                                      os.path.join(tmp, f"{name}.npz"), case)
    return out
