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
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.mesh import ProcessMesh

MESH = ((2, 2), ("data", "model"))
COLLECTIVES = ("all_gather", "pmax", "psum", "reduce_scatter", "ppermute",
               "objects")


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


def _delta(mesh, before: dict) -> dict:
    return {k: mesh.counts[k] - before[k] for k in COLLECTIVES
            if mesh.counts[k] != before[k]}


def expected_collectives(step, cache_shapes) -> dict:
    """The collectives of one decode step with the params already whole:
    an all-gather of head outputs a layer of a stack whose kv heads
    split, a pmax and a psum a layer of one whose slots split."""
    want = {}
    for key, layout in step.layouts.items():
        leaf = cache_shapes[key]
        layers = int((leaf["k"] if isinstance(leaf, dict) else leaf).shape[0])
        kinds = ("all_gather",) if layout.dim == "heads" else ("pmax", "psum")
        for kind in kinds:
            want[kind] = want.get(kind, 0) + layers
    return want


def decode(step, params, cache, tokens, positions, mesh=None) -> tuple:
    """Greedy decode from ``cache``: each step's whole logits, tokens and
    cache blocks, and its collectives (``mesh``'s counts)."""
    logits, toks, caches, counts = [], [], [], []
    for i, pos in enumerate(positions):
        before = dict(mesh.counts) if mesh is not None else None
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


def _no_gather(out, layout):
    """A broken head gather: this rank's head outputs in place, the
    others' zero."""
    per = out.shape[2] // (layout.stop - layout.start)
    full = out.new_zeros(out.shape[:2] + (layout.size * per,)
                         + out.shape[3:])
    full[:, :, layout.start * per:layout.stop * per] = out
    return full


MUTATIONS = {"seq": ("_combine_slots", _local_softmax),
             "heads": ("_gather_heads", _no_gather)}


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
    first = dict(mesh.counts)
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
    out["expected"] = expected_collectives(serve, shapes)
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
    # new serve step shares the mesh's whole params, and after they are
    # dropped gathers every split leaf on its first call
    tokens = torch.from_numpy(out["tokens"][0]).to(device)
    shardings = steps_mod.whole_params(cfg, mesh).shardings
    leaf = next(b for b, sh in zip(adamw.leaves(params), shardings)
                if sharding.spec_axes(sh.spec))
    leaf.mul_(1.0)
    before = dict(mesh.counts)
    serve(params, cache, tokens, positions[0])
    out["edited_counts"] = _delta(mesh, before)
    fresh = steps_mod.make_serve_step(cfg, mesh, shapes)
    runs, recorded = [], []
    for drop in (False, True, False):
        if drop:
            mesh.kept.clear()
        before = dict(mesh.counts)
        records = collections.Counter(mesh.collectives)
        fresh(params, cache, tokens, positions[0])
        runs.append(_delta(mesh, before))
        recorded.append(dict(mesh.collectives - records))
    out["fresh_counts"] = runs
    # the collectives of a decode step that gathers the params, as the
    # mesh records them
    out["fresh_collectives"] = recorded[1]
    out["split_leaves"] = sum(1 for sh in shardings
                              if sharding.spec_axes(sh.spec))

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


def serve_rank(device, cases: dict, tmp: str) -> dict:
    """Every case of ``cases`` ({name: case}) on the ("data": 2,
    "model": 2) mesh."""
    mesh = ProcessMesh(*MESH, device=device)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "cases": {}}
    for name, case in cases.items():
        out["cases"][name] = run_case(device, mesh,
                                      os.path.join(tmp, f"{name}.npz"), case)
    return out
