"""The port's data-parallel training on a process mesh against the JAX
package's GSPMD step on four forced XLA devices.

``repro_torch.runtime.mesh.launch`` spawns four gloo ranks on the CPU
once for every case below (``tests/_torch_dp_ranks.py``), on the
("data": 2, "model": 2) mesh; meanwhile a subprocess runs the reference
(``--xla_force_host_platform_device_count=4``) on the same mesh, its MoE
with the DyDD schedule rounded exactly (``_torch_exact_schedule``), as
the port rounds.  Both sides read the same numpy weights (the
reference's ``init_params``, carried across) and batches.  Held here:

* two ``make_train_step(mesh=)`` steps of each case against the
  reference's: the smoke configs of gemma3-1b ("dp" profile), yi-6b
  (GQA), mamba2-1.3b, recurrentgemma-9b, whisper-large-v3 (with frames)
  and olmoe-1b-7b at B = 8, yi with ``accum_steps=2``, and gemma3 at
  B = 2 (the batch does not split over the 4-way dp axes, so ranks hold
  whole microbatches).  Each loss within 1e-5 relative, ``m`` and ``v``
  within 1e-4 relative Frobenius, the params within 1e-5 absolute except
  where the reference's first moment was below 1e-7 after either step
  (2 lr a step there), as ``tests/test_torch_train.py`` holds the
  single-device step after its one step: on mamba2's case an element
  whose step-0 gradient was 3.3e-8 in the reference and 3.7e-8 in the
  port (its first moment 3.3e-9 after that step, 2.9e-5 after the next)
  moved 2.8e-5 apart, the port's single-process step as far from the
  reference's single-device one (2.0e-5) and the reference's mesh step
  1.2e-5 from its own single-device step;
* every rank's loss bits the same, and ranks that hold the same block
  of a leaf hold the same bits;
* checkpoints across packages and mesh shapes, bitwise: the port saves
  under the mesh and the reference's ``remesh`` restores it on
  ("data": 4, "model": 1); the reference saves and the port's ``remesh``
  restores it on (4, 1) and, in a second launch of two ranks, on
  ("data": 1, "model": 2); every block equals its slice of the saved
  arrays, on the layout of the reference's specs;
* ``train(mesh=)``: 2 of 4 steps on (2, 2) with a checkpoint, resumed on
  (4, 1), against the reference's ``train()`` without a mesh, the same
  function (the reference's ``train(mesh=)`` fails:
  ``repro/launch/train.py:37`` gives ``make_train_step`` no
  ``batch_shapes``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402

import _torch_dp_ranks as ranks  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
RANKS = 4
SEQ = 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
TINY_M = 1e-7
STEPS_BOUND = 2 * ranks.LR * 2      # 2 lr a step, two steps
# (name, arch, batch, accum_steps)
CASES = (("yi", "yi_6b", 8, 1),
         ("gemma3", "gemma3_1b", 8, 1),
         ("mamba2", "mamba2_1_3b", 8, 1),
         ("recurrentgemma", "recurrentgemma_9b", 8, 1),
         ("whisper", "whisper_large_v3", 8, 1),
         ("olmoe", "olmoe_1b_7b", 8, 1),
         ("yi_accum2", "yi_6b", 8, 2),
         ("gemma3_b2", "gemma3_1b", 2, 1))
PORT_CKPT = "gemma3"      # the port saves this case's state
REF_CKPT = "yi"           # the reference saves this one's (its first case)
TRAIN = {"arch": "mamba2_1_3b", "steps": 4, "first": 2, "seq": SEQ,
         "batch": 8, "dp": 2}
TIMEOUT_S = 120

REF = r"""
import json, os, sys, time
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
sys.path.insert(0, sys.argv[2])
import _torch_exact_schedule as exact
from repro.core import dydd
dydd.schedule_jnp = exact.exact_schedule_jnp
from repro import configs
from repro.checkpoint import manager as ckpt
from repro.launch import mesh as lmesh
from repro.launch import train as jtrain
from repro.optim import adamw
from repro.runtime import elastic, steps
from repro.models import transformer

tmp = sys.argv[1]
cases, ref_ckpt, port_ckpt, train = (json.loads(a) for a in sys.argv[3:7])
mesh = lmesh.make_test_mesh((2, 2), ("data", "model"))
is_spec = lambda x: isinstance(x, PartitionSpec)


def unflatten(flat, prefix):
    out = {}
    for key, value in flat.items():
        if key.startswith(prefix + "/"):
            *path, last = key[len(prefix) + 1:].split("/")
            cur = out
            for p in path:
                cur = cur.setdefault(p, {})
            cur[last] = value
    return out


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def put(tree, specs):
    return jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        tree, specs, is_leaf=is_spec)


out = {}
for name, arch, batch, accum in cases:
    cfg = configs.get_smoke_config(arch)
    with np.load(os.path.join(tmp, name + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten(flat, "p")
    batches = [unflatten(flat, f"b{i}") for i in range(2)]
    with jax.sharding.set_mesh(mesh):
        shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in batches[0].items()}
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(lr=float(sys.argv[7]),
                                   accum_steps=accum),
            mesh=mesh, donate=False, batch_shapes=shapes)
        p = put(params, transformer.param_specs(cfg))
        o = put(adamw.adamw_init(params), steps.opt_specs(cfg))
        bspec = steps.batch_specs(cfg, shapes)
        for i, b in enumerate(batches):
            loss, p, o = step(p, o, put(b, bspec))
            out[f"{name}/loss{i}"] = np.asarray(loss)
            for k, v in flatten(o["m"]).items():
                out[f"{name}/m{i}/{k}"] = v
    for k, v in flatten({"params": p, "opt": o}).items():
        out[f"{name}/state/{k}"] = v
    if name == ref_ckpt:
        path = ckpt.CheckpointManager(os.path.join(tmp, "ref_ckpt")).save(
            {"params": p, "opt": o}, step=2)
        open(os.path.join(tmp, "ref_ckpt.done"), "w").close()

cfg = configs.get_smoke_config(train["arch"])
params, opt, losses = jtrain.train(
    cfg, steps=train["steps"], seq=train["seq"],
    global_batch=train["batch"], dp=train["dp"], ckpt_dir=None,
    log_every=100)
out["train/losses"] = np.asarray(losses)
for k, v in flatten({"params": params, "opt": opt}).items():
    out[f"train/state/{k}"] = v

arch, name = port_ckpt
t0 = time.monotonic()
while not os.path.exists(os.path.join(tmp, "port_ckpt.done")):
    if time.monotonic() - t0 > 600:
        raise TimeoutError("the port's checkpoint did not appear")
    time.sleep(0.2)
mesh41 = lmesh.make_test_mesh((4, 1), ("data", "model"))
params, opt, manifest = elastic.remesh(configs.get_smoke_config(arch),
                                       os.path.join(tmp, "port_ckpt"), mesh41)
order = [d.id for d in mesh41.devices.flat]
index = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(
        {"params": params, "opt": opt})[0]:
    key = "/".join(str(p.key) for p in path)
    for sh in leaf.addressable_shards:
        rank = order.index(sh.device.id)
        out[f"remesh/{key}/{rank}"] = np.asarray(sh.data)
        index[f"{key}/{rank}"] = [[s.start, s.stop] for s in sh.index]
with open(os.path.join(tmp, "remesh_index.json"), "w") as f:
    json.dump({"step": manifest["step"], "index": index}, f)
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, SEQ)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, SEQ)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    # ranks whose rows differ in their mask counts: a mean of the ranks'
    # means would be another function
    mask[: b // 2, SEQ // 2:] = 0.0
    out = {"b/tokens": toks, "b/labels": labels, "b/mask": mask}
    if cfg.frontend == "audio_stub":
        out["b/frames"] = (0.02 * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _inputs(tmp, i: int, name: str, arch: str, b: int) -> None:
    cfg = jconfigs.get_smoke_config(arch)
    params = jtransformer.init_params(cfg, jax.random.PRNGKey(i))
    flat = {"p/" + k: v for k, v in ranks.flatten(
        jax.tree.map(np.asarray, params)).items()}
    for s in range(2):
        flat.update({f"b{s}/" + k[2:]: v
                     for k, v in _batch(cfg, b, 10 * i + s).items()})
    np.savez(os.path.join(tmp, f"{name}.npz"), **flat)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of four CPU ranks for every case of this file (and one
    of two for the (1, 2) remesh), with the reference's four-device run in
    a process of its own meanwhile."""
    tmp = str(tmp_path_factory.mktemp("dp_train"))
    for i, (name, arch, b, _) in enumerate(CASES):
        _inputs(tmp, i, name, arch, b)
    init = jtransformer.init_params(
        jconfigs.get_smoke_config(TRAIN["arch"]), jax.random.PRNGKey(0))
    np.savez(os.path.join(tmp, "train_init.npz"), **{
        "p/" + k: v for k, v in ranks.flatten(
            jax.tree.map(np.asarray, init)).items()})
    arch_of = {name: arch for name, arch, _, _ in CASES}
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, tmp, HERE,
         json.dumps([[n, a, b, k] for n, a, b, k in CASES]),
         json.dumps(REF_CKPT),
         json.dumps([arch_of[PORT_CKPT], PORT_CKPT]), json.dumps(TRAIN),
         repr(ranks.LR)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref_dir = os.path.join(tmp, "ref_ckpt")
    try:
        out = t_mesh.launch(
            ranks.dp_rank, RANKS, backend="gloo", device="cpu",
            args=([(n, a, k) for n, a, _, k in CASES], tmp, PORT_CKPT,
                  (arch_of[REF_CKPT], ref_dir), TRAIN),
            timeout=TIMEOUT_S)
    finally:
        log = ref.communicate(timeout=600)[0]
    assert ref.returncode == 0, log[-3000:]
    two = t_mesh.launch(ranks.remesh_rank, 2, backend="gloo", device="cpu",
                        args=(arch_of[REF_CKPT], ref_dir, (1, 2)),
                        timeout=TIMEOUT_S)
    with np.load(os.path.join(tmp, "ref.npz")) as z:
        ref_out = {k: z[k] for k in z.files}
    with open(os.path.join(tmp, "remesh_index.json")) as f:
        ref_out["remesh_index"] = json.load(f)
    return out, two, ref_out, tmp


def _frob(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_state(whole: dict, ref: dict, prefix: str, bound: float,
                moments=()) -> None:
    """The port's whole state (flat) against the reference's at
    ``prefix``: params within PARAM_ATOL, m and v within GRAD_RTOL, step
    equal.  Where the reference's first moment was below TINY_M after
    the last step or after any step whose moments ``moments`` name
    (prefixes of flat m trees), a gradient within 100 eps of zero went
    through AdamW's g / (|g| + eps) in that step, and the param is held
    to ``bound``, 2 lr a step (``tests/test_torch_train.py``)."""
    keys = sorted(k for k in whole)
    assert keys == sorted(k[len(prefix):] for k in ref
                          if k.startswith(prefix))
    for k in keys:
        a, b = whole[k].astype(np.float64), ref[prefix + k]
        assert a.shape == b.shape, k
        if k.startswith("params/"):
            leaf = k[len("params/"):]
            tiny = np.abs(ref[prefix + "opt/m/" + leaf]) < TINY_M
            for m in moments:
                tiny |= np.abs(ref[m + leaf]) < TINY_M
            d = np.abs(a - b)
            assert d[~tiny].max(initial=0.0) <= PARAM_ATOL, k
            assert d[tiny].max(initial=0.0) <= bound, k
        elif k == "opt/step":
            assert int(a) == int(b)
        else:
            assert _frob(a, b) <= GRAD_RTOL, (k, _frob(a, b))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dp_step_matches_reference_mesh_step(launched, name):
    out, _, ref, _ = launched
    r0 = out[0]["cases"][name]
    for i, loss in enumerate(r0["losses"]):
        want = float(ref[f"{name}/loss{i}"])
        assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), (i, loss,
                                                                  want)
    check_state(r0["whole"], ref, f"{name}/state/", STEPS_BOUND,
                moments=[f"{name}/m0/"])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dp_step_ranks_agree_bitwise(launched, name):
    out, _, _, _ = launched
    res = [o["cases"][name] for o in out]
    for r in res[1:]:
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(r["losses"], res[0]["losses"]))
        assert r["norms"] == res[0]["norms"]
        assert all(np.array_equal(r["whole"][k], res[0]["whole"][k])
                   for k in r["whole"])
    # each rank's blocks are the slices of the whole arrays its specs give
    # (so ranks holding the same block hold the same bits)
    cfg = jconfigs.get_smoke_config(next(c[1] for c in CASES
                                         if c[0] == name))
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(
            (2, 2), ("data", "model"))):
        specs = _specs(cfg)
    for rank, r in enumerate(res):
        for k, blk in r["blocks"].items():
            whole = res[0]["whole"][k]
            sl = _slices(specs[k], whole.shape, (2, 2), rank)
            assert np.array_equal(blk, whole[sl]), (rank, k)


def _specs(cfg) -> dict:
    """Flat {key: spec tuple} of the reference's params and opt specs."""
    from repro.runtime import steps as jsteps
    tree = {"params": jtransformer.param_specs(cfg),
            "opt": jsteps.opt_specs(cfg)}
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return {"/".join(str(p.key) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_spec)[0]}


def _slices(spec, shape, mesh_shape, rank) -> tuple:
    """The reference's block of ``rank`` on a ("data", "model") mesh."""
    coords = dict(zip(("data", "model"),
                      np.unravel_index(rank, mesh_shape)))
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        k, i = 1, 0
        for a in axes:
            k, i = k * sizes[a], i * sizes[a] + int(coords[a])
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def _saved(path: str) -> dict:
    flat, manifest = t_ckpt.restore_pytree(path)
    assert t_ckpt.verify(path) and manifest["step"] == 2
    return flat


def test_port_checkpoint_restored_by_reference_remesh(launched):
    out, _, ref, tmp = launched
    assert all(o["saved"] == out[0]["saved"] for o in out)
    saved = _saved(out[0]["saved"])
    # the whole arrays the ranks held, written once
    assert sorted(saved) == sorted(out[0]["cases"][PORT_CKPT]["whole"])
    for k, v in saved.items():
        assert np.array_equal(v, out[0]["cases"][PORT_CKPT]["whole"][k])
    index = ref["remesh_index"]
    assert index["step"] == 2
    arch = next(c[1] for c in CASES if c[0] == PORT_CKPT)
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(
            (4, 1), ("data", "model"))):
        specs = _specs(jconfigs.get_smoke_config(arch))
    for key, arr in saved.items():
        for rank in range(RANKS):
            got = ref[f"remesh/{key}/{rank}"]
            sl = tuple(slice(a, b) for a, b in index["index"][
                f"{key}/{rank}"])
            assert np.array_equal(got, arr[sl]), (key, rank)
            # the port's layout on (4, 1) is the reference's
            want = _slices(specs[key], arr.shape, (4, 1), rank)
            assert [(s.start or 0, s.stop or n) for s, n in
                    zip(sl, arr.shape)] == [(s.start, s.stop) for s in want]


@pytest.mark.parametrize("shape", [(4, 1), (1, 2)])
def test_reference_checkpoint_remeshed_by_port(launched, shape):
    out, two, _, tmp = launched
    res = [o["remesh"] for o in out] if shape == (4, 1) else two
    saved = _saved(t_ckpt.latest_checkpoint(os.path.join(tmp, "ref_ckpt")))
    arch = next(c[1] for c in CASES if c[0] == REF_CKPT)
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(
            shape, ("data", "model"))):
        specs = _specs(jconfigs.get_smoke_config(arch))
    assert len(res) == shape[0] * shape[1]
    for rank, r in enumerate(res):
        assert r["step"] == 2 and sorted(r["blocks"]) == sorted(saved)
        for key, arr in saved.items():
            sl = _slices(specs[key], arr.shape, shape, rank)
            assert r["slices"][key] == sl, key
            assert np.array_equal(r["blocks"][key], arr[sl]), (key, rank)


def test_train_mesh_resumed_on_new_mesh_matches_reference_train(launched):
    out, _, ref, _ = launched
    got = out[0]["train"]
    assert all(o["train"]["losses"] == got["losses"] for o in out)
    assert len(got["losses"]) == TRAIN["steps"]
    np.testing.assert_allclose(got["losses"], ref["train/losses"],
                               rtol=LOSS_RTOL)
    check_state(got["whole"], ref, "train/state/",
                2 * 3e-4 * TRAIN["steps"])


TRACED_CASE = "yi"     # the case whose collectives the dry run predicts


@pytest.mark.parametrize("rank", range(RANKS))
def test_step_collectives_match_dry_run(launched, rank):
    """The collectives a rank's ``ProcessMesh`` recorded (kind, result
    bytes, group size, calls) in the first sharded step of
    ``TRACED_CASE`` equal what ``launch.dryrun.lower_cell`` records
    tracing the same step on a ``TracedMesh`` of the same shape and
    rank."""
    import dataclasses
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.launch import dryrun as tdryrun
    from repro_torch.runtime.sharding import AbstractMesh

    out = launched[0]
    _, arch, b, accum = next(c for c in CASES if c[0] == TRACED_CASE)
    from repro_torch import configs as tconfigs
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              train_accum=accum)
    traced = tdryrun.lower_cell(
        cfg, ShapeCase(TRACED_CASE, SEQ, b, "train"),
        t_mesh.TracedMesh(AbstractMesh(*ranks.MESH), rank=rank),
        flops=False)
    got = next(o for o in out if o["rank"] == rank)["cases"][TRACED_CASE]
    assert got["collectives"] and traced["collectives"] == got[
        "collectives"]
