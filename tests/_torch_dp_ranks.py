"""What each rank runs in ``tests/test_torch_dp_train.py``.

The ranks are spawned processes that import this module by name, so it
imports only torch, numpy and the port: the reference runs in a
subprocess of the test process, which hands both sides numpy inputs
(``.npz`` files of flat ``{path: array}`` trees, ``p/...`` the params
and ``b/...`` the batches) and checks what they return.
"""
import collections
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.mesh import ProcessMesh

LR = 1e-3
MESH = ((2, 2), ("data", "model"))


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


def shardings(cfg, mesh):
    """(param shardings, opt shardings) on ``mesh``."""
    with sharding.use_mesh(mesh):
        return (sharding.named_shardings(mesh, transformer.param_specs(cfg)),
                sharding.named_shardings(mesh, steps_mod.opt_specs(cfg)))


def blocks_of(tree, shards):
    return adamw.tree_map(lambda t, sh: sharding.local_block(t, sh).clone(),
                          tree, shards)


def gathered(tree, shards) -> dict:
    """The whole arrays of a sharded tree, flat, as numpy (a collective)."""
    full = adamw.tree_map(lambda b, sh: sharding.gather(b, sh), tree, shards)
    return {k: _numpy(v) for k, v in flatten(full).items()}


def run_case(device, mesh, path: str, arch: str, accum: int) -> tuple:
    """Two sharded steps of ``arch``'s smoke config from the inputs at
    ``path`` (weights ``p/...``, two batches ``b0/...``, ``b1/...``):
    (the losses, grad norms, the first step's collectives as the mesh
    records them, this rank's blocks and the whole state, flat; the
    state; its (param, opt) shardings)."""
    cfg = configs.get_smoke_config(arch)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _tensors(unflatten(flat, "p"), device)
    pshard, oshard = shardings(cfg, mesh)
    params = blocks_of(params, pshard)
    opt = adamw.adamw_init(params)
    step = steps_mod.make_train_step(
        cfg, adamw.AdamWConfig(lr=LR, accum_steps=accum), mesh=mesh)
    losses, norms, collectives = [], [], []
    for i in range(2):
        batch = _tensors(unflatten(flat, f"b{i}"), device)
        before = collections.Counter(mesh.collectives)
        loss, params, opt = step(params, opt, batch)
        collectives.append(dict(mesh.collectives - before))
        losses.append(_numpy(loss))
        norms.append(float(step.last["grad_norm"]))
    state = {"params": params, "opt": opt}
    out = {"losses": losses, "norms": norms, "collectives": collectives[0],
           "blocks": {k: _numpy(v) for k, v in flatten(state).items()},
           "whole": gathered(state, {"params": pshard, "opt": oshard})}
    return out, state, (pshard, oshard)


def _wait_for(marker: str, timeout: float = 600.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(marker):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{marker} did not appear in {timeout} s")
        time.sleep(0.2)


def remeshed(cfg, directory: str, shape, device) -> dict:
    """This rank's blocks of ``directory``'s newest checkpoint on a
    ``shape`` ("data", "model") mesh, flat, with their slices."""
    mesh = ProcessMesh(shape, MESH[1], device=device)
    params, opt, manifest = elastic.remesh(cfg, directory, mesh)
    blocks = flatten({"params": params, "opt": opt})
    pshard, oshard = shardings(cfg, mesh)
    shards = flatten({"params": pshard, "opt": oshard})
    return {"step": manifest["step"],
            "slices": {k: sharding.block_slices(shards[k], sharding.full_shape(
                b.shape, shards[k])) for k, b in blocks.items()},
            "blocks": {k: _numpy(v) for k, v in blocks.items()}}


def dp_rank(device, cases, tmp: str, ckpt_case: str, ref_ckpt: tuple,
            train_case: dict) -> dict:
    """Every case of ``cases`` ((name, arch, accum): two sharded steps on
    the ("data": 2, "model": 2) mesh); the state of ``ckpt_case`` saved
    under the mesh to ``tmp/port_ckpt``; once the reference's checkpoint
    (``ref_ckpt``: its arch and directory) is published, it remeshed onto
    ("data": 4, "model": 1); then ``train(mesh=)``: ``train_case``'s
    first steps on (2, 2) with a checkpoint, resumed to the end on
    (4, 1)."""
    mesh = ProcessMesh(*MESH, device=device)
    out = {"rank": mesh.rank, "cases": {}}
    for name, arch, accum in cases:
        res, state, shards = run_case(device, mesh,
                                      os.path.join(tmp, f"{name}.npz"),
                                      arch, accum)
        out["cases"][name] = res
        if name == ckpt_case:
            mgr = ckpt.CheckpointManager(os.path.join(tmp, "port_ckpt"))
            out["saved"] = mgr.save(state, step=2, shardings={
                "params": shards[0], "opt": shards[1]})
            mgr.close()
            if mesh.rank == 0:
                open(os.path.join(tmp, "port_ckpt.done"), "w").close()
    arch, directory = ref_ckpt
    _wait_for(directory + ".done")
    out["remesh"] = remeshed(configs.get_smoke_config(arch), directory,
                             (4, 1), device)
    out["train"] = train_run(device, tmp, train_case)
    return out


def train_run(device, tmp: str, case: dict) -> dict:
    """``train(mesh=)`` for ``case["first"]`` of ``case["steps"]`` steps
    on the (2, 2) mesh with a checkpoint, then resumed to the end on
    ("data": 4, "model": 1); the losses of both launches and the final
    state, whole."""
    cfg = configs.get_smoke_config(case["arch"])
    with np.load(os.path.join(tmp, "train_init.npz")) as z:
        init = unflatten({k: z[k] for k in z.files}, "p")
    kw = dict(seq=case["seq"], global_batch=case["batch"], dp=case["dp"],
              ckpt_dir=os.path.join(tmp, "train_ckpt"), log_every=100)
    mesh = ProcessMesh(*MESH, device=device)
    _, _, first = train_mod.train(cfg, steps=case["first"], mesh=mesh,
                                  init_params=_tensors(init, device), **kw)
    mesh = ProcessMesh((4, 1), MESH[1], device=device)
    params, opt, rest = train_mod.train(cfg, steps=case["steps"], mesh=mesh,
                                        **kw)
    pshard, oshard = shardings(cfg, mesh)
    return {"losses": first + rest,
            "whole": gathered({"params": params, "opt": opt},
                              {"params": pshard, "opt": oshard})}


def remesh_rank(device, arch: str, directory: str, shape) -> dict:
    """The reference's checkpoint remeshed onto ``shape``."""
    return remeshed(configs.get_smoke_config(arch), directory, shape, device)
