"""Tensor-parallel compute on "model" and per-layer parameter gathering,
on the CPU.

``repro_torch.runtime.mesh.launch`` spawns four gloo ranks once for every
launched case (``tests/_torch_tp_ranks.py``) on the ("data": 1,
"model": 4) mesh, where "model" carries the whole split; meanwhile a
subprocess runs the reference on four forced XLA devices on the same
mesh.  Held here:

* each module, one rank's share under the tensor-parallel context
  against the port's single-process module on the same f32 inputs
  (forward, the input's gradient and each parameter block's gradient,
  within 1e-5 relative): attention with Yi's kv heads whole on the four
  ranks (GQA 8:2) and RecurrentGemma's one kv head (MQA), the MLP, the
  RG-LRU block, the SSD block (Mamba-2, its packed leaves gathered over
  "model"), the MoE (OLMoE, two experts a rank) and the vocab-parallel
  embedding and loss (soft-capped, chunked and not).  The single-process
  modules are held to the reference by ``tests/test_torch_train.py``,
  ``test_torch_lm_serve.py``, ``test_torch_moe.py`` and
  ``test_torch_ssd.py``;
* one Yi smoke train step, its prefill and a decode step against the
  reference's GSPMD steps on the same (1, 4) mesh, at the tolerances of
  ``tests/test_torch_dp_train.py`` and ``test_torch_serve_mesh.py``;
* a rank's kernel calls see its share: H / 4 query heads in
  ``flash_attention``, W / 4 channels in ``rglru_scan``, nh / 4 heads in
  ``ssd_scan``, in the train step and in the prefill;
* no parameter leaf is gathered over "model" but the SSD block's packed
  ``in_proj``, ``conv_w`` and ``conv_b``;
* on a traced (2, 2) rank (no launch), a train step under remat gathers
  each FSDP-split layer leaf once a layer in the forward and once in the
  recompute, the top-level leaves once, and holds at most the top-level
  leaves and one layer's gathered leaves at a time, never the tree.
"""
import collections
import dataclasses
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402
from repro_torch.runtime import steps, tp  # noqa: E402
from repro_torch.runtime.sharding import AbstractMesh  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
RANKS = 4
MODULE_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
TINY_M = 1e-7
ATOL = 1e-4
TIMEOUT_S = 120

REF = r"""
import os, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro import configs
from repro.launch import mesh as lmesh
from repro.optim import adamw
from repro.runtime import steps
from repro.models import transformer

tmp, lr = sys.argv[1], float(sys.argv[2])
mesh = lmesh.make_test_mesh((1, 4), ("data", "model"))
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


cfg = configs.get_smoke_config("yi_6b")
with np.load(os.path.join(tmp, "yi.npz")) as z:
    flat = {k: z[k] for k in z.files}
params, batch = unflatten(flat, "p"), unflatten(flat, "b")
out = {}
with jax.sharding.set_mesh(mesh):
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batch.items()}
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=lr), mesh=mesh,
                                 donate=False, batch_shapes=shapes)
    p = put(params, transformer.param_specs(cfg))
    o = put(adamw.adamw_init(params), steps.opt_specs(cfg))
    loss, p2, o2 = step(p, o, put(batch, steps.batch_specs(cfg, shapes)))
    out["loss"] = np.asarray(loss)
    for k, v in flatten({"params": p2, "opt": o2}).items():
        out["state/" + k] = v
    tok = {"tokens": jnp.asarray(batch["tokens"])}
    tshapes = {"tokens": jax.ShapeDtypeStruct(tok["tokens"].shape,
                                              tok["tokens"].dtype)}
    prefill = steps.make_prefill_step(cfg, mesh=mesh,
                                      max_seq=int(sys.argv[3]),
                                      batch_shapes=tshapes)
    logits, cache = prefill(p, put(tok, steps.batch_specs(cfg, tshapes)))
    out["prefill_logits"] = np.asarray(logits)
    cshapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           cache)
    cache = put(cache, steps.cache_specs_tree(cfg, cshapes))
    serve = steps.make_serve_step(cfg, mesh=mesh, cache_shapes=cshapes)
    nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    logits, _ = serve(p, cache, nxt, jnp.int32(tok["tokens"].shape[1]))
    out["decode_logits"] = np.asarray(logits)
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _inputs(tmp) -> None:
    cfg = jconfigs.get_smoke_config("yi_6b")
    params = jtransformer.init_params(cfg, jax.random.PRNGKey(3))
    flat = {"p/" + k: v for k, v in ranks.flatten(
        jax.tree.map(np.asarray, params)).items()}
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, (ranks.B, ranks.S)).astype(
        np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((ranks.B, ranks.S)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    flat.update({"b/tokens": toks, "b/labels": labels, "b/mask": mask})
    np.savez(os.path.join(tmp, "yi.npz"), **flat)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of four CPU ranks for every launched case of this file,
    with the reference's four-device run in a process of its own
    meanwhile."""
    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    _inputs(tmp)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, tmp, repr(ranks.LR),
         str(ranks.S + 4)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = t_mesh.launch(ranks.tp_rank, RANKS, backend="gloo",
                            device="cpu", args=(tmp,), timeout=TIMEOUT_S)
    finally:
        log = ref.communicate(timeout=600)[0]
    assert ref.returncode == 0, log[-3000:]
    with np.load(os.path.join(tmp, "ref.npz")) as z:
        return out, {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", [m[0] for m in ranks.MODULES])
def test_module_share_matches_single_process(launched, name):
    out, _ = launched
    for o in out:
        errs = o["modules"][name]["errs"]
        assert max(errs.values()) <= MODULE_RTOL, (o["rank"], errs)


def _split(arch) -> dict:
    cfg = tconfigs.get_smoke_config(arch)
    return {"heads": cfg.num_heads // RANKS, "kv": cfg.num_kv_heads,
            "lru": (cfg.lru_width or cfg.d_model) // RANKS,
            "ssd": cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim // RANKS}


@pytest.mark.parametrize("name", [m[0] for m in ranks.MODULES])
def test_module_shares_and_kernel_calls(launched, name):
    """The rank holds a quarter of the split dimension and its kernel
    calls see a quarter of the heads or channels."""
    out, _ = launched
    arch = next(m[1] for m in ranks.MODULES if m[0] == name)
    want = _split(arch)
    for o in out:
        r = o["modules"][name]
        calls = collections.Counter(c for c, _ in r["calls"])
        shapes_ = [s for _, s in r["calls"]]
        if name.startswith("attention"):
            assert calls == {"flash_attention": 1}
            assert shapes_[0][0] == ranks.B * want["heads"]
            assert r["shares"]["wq"][1] == want["heads"]
            # kv heads that do not split over four ranks stay whole
            assert r["shares"]["wk"][1] == want["kv"]
        elif name == "rglru":
            assert calls == {"rglru_scan": 1}
            assert shapes_[0][2] == want["lru"]
        elif name == "ssd":
            assert calls == {"ssd_scan": 1}
            assert shapes_[0][0] == ranks.B * want["ssd"]
            # the packed leaves whole, out_proj a quarter of di
            cfg = tconfigs.get_smoke_config(arch)
            di = cfg.ssm_expand * cfg.d_model
            assert r["shares"]["out_proj"][0] == di // RANKS
        elif name == "mlp":
            cfg = tconfigs.get_smoke_config(arch)
            assert not calls
            assert r["shares"]["w_up"][1] == cfg.d_ff // RANKS
        else:
            cfg = tconfigs.get_smoke_config(arch)
            assert not calls
            assert r["shares"]["w_up"][0] == cfg.num_experts // RANKS
            assert r["shares"]["router"] == [cfg.d_model, cfg.num_experts]


@pytest.mark.parametrize("chunk", ["chunk0", "chunk4"])
def test_vocab_parallel_embedding_and_loss(launched, chunk):
    out, _ = launched
    for o in out:
        errs = o["loss"][chunk]["errs"]
        assert max(errs.values()) <= MODULE_RTOL, (o["rank"], errs)
        assert np.array_equal(o["loss"][chunk]["loss_bits"],
                              out[0]["loss"][chunk]["loss_bits"])


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ranks.STEP_ARCHS)
def test_step_kernel_calls_see_the_rank_share(launched, arch, kind):
    out, _ = launched
    want = _split(arch)
    B = ranks.B
    for o in out:
        calls = o["steps"][arch][kind]["calls"]
        assert calls
        for name, shape in calls:
            if name == "flash_attention":
                assert shape[0] == B * want["heads"], shape
            elif name == "rglru_scan":
                assert shape[2] == want["lru"], shape
            else:
                assert shape[0] == B * want["ssd"], shape


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ranks.STEP_ARCHS)
def test_no_parameter_gathered_over_model_but_the_ssd_leaves(
        launched, arch, kind):
    """On ("data": 1, "model": 4) no FSDP axis gathers: the only
    parameter gathers are the SSD block's packed leaves over "model", one
    a leaf and layer in the train step (no remat in the smoke config), one
    a stacked leaf for serving's share."""
    out, _ = launched
    cfg = tconfigs.get_smoke_config(arch)
    for o in out:
        gathers = o["steps"][arch][kind]["gathers"]
        assert all(axes == ("model",) for axes, _ in gathers)
        if arch != "mamba2_1_3b":
            assert not gathers
            continue
        per = cfg.num_layers if kind == "train" else 1
        assert len(gathers) == 3 * per
        # in_proj's block is a quarter of its packed columns
        packed = (2 * cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_ngroups
                  * cfg.ssm_state + cfg.ssm_expand * cfg.d_model
                  // cfg.ssm_headdim)
        assert any(shape[-1] == packed // RANKS for _, shape in gathers)


@pytest.mark.parametrize("arch", ranks.STEP_ARCHS)
def test_ranks_agree_on_the_loss_bits(launched, arch):
    out, _ = launched
    losses = [o["steps"][arch]["train"]["loss"] for o in out]
    assert all(np.array_equal(x, losses[0]) for x in losses)
    decode = [o["steps"][arch]["serve"]["decode_collectives"] for o in out]
    assert all(d == decode[0] for d in decode)


def test_yi_step_matches_reference(launched):
    out, ref = launched
    for o in out:
        r = o["reference"]
        assert abs(float(r["loss"]) - float(ref["loss"])) <= LOSS_RTOL * abs(
            float(ref["loss"]))
        for k, a in r["state"].items():
            b = ref["state/" + k]
            assert a.shape == b.shape, k
            if k.startswith("params/"):
                tiny = np.abs(ref["state/opt/m/" + k[7:]]) < TINY_M
                d = np.abs(a.astype(np.float64) - b)
                assert d[~tiny].max(initial=0.0) <= PARAM_ATOL, k
                assert d[tiny].max(initial=0.0) <= 2 * ranks.LR, k
            elif k == "opt/step":
                assert int(a) == int(b)
            else:
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert rel <= GRAD_RTOL, (k, rel)


def test_yi_prefill_and_decode_match_reference(launched):
    out, ref = launched
    for o in out:
        r = o["reference"]
        for key in ("prefill_logits", "decode_logits"):
            assert r[key].shape == ref[key].shape
            assert np.max(np.abs(r[key].astype(np.float64) - ref[key])
                          ) <= ATOL, key
            assert np.array_equal(r[key], out[0]["reference"][key])


# -- per-layer gathering, traced ----------------------------------------------

def _traced_train(layers: int, remat: str = "block"):
    """Yi's smoke config at ``layers`` layers under ``remat``, one train
    step traced on rank 0 of a (2, 2) mesh: each parameter gather (its
    plan, the block's shape, the gathered bytes) and the most gathered
    bytes alive at once."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"),
                              num_layers=layers, remat=remat)
    mesh = t_mesh.TracedMesh(AbstractMesh((2, 2), ("data", "model")))
    full = transformer.param_shapes(cfg)
    params = dryrun._blocks(full, mesh, transformer.param_specs, cfg)
    opt = {k: dryrun._blocks(full, mesh, transformer.param_specs, cfg,
                             dtype=torch.float32) for k in ("m", "v")}
    opt["step"] = torch.empty((), dtype=torch.int32, device="meta")
    batch = shapes.input_specs(cfg, shapes.ShapeCase("t", 16, 4, "train"))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh,
                                 batch_shapes=batch)
    calls, live = [], {"now": 0, "max": 0}
    forward = tp.Gather.forward

    def gather(plan, block):
        full = forward(plan, block)
        calls.append(((plan.spec, plan.axes, tuple(block.shape)),
                      full.nbytes))
        live["now"] += full.nbytes
        live["max"] = max(live["max"], live["now"])
        weakref.finalize(full, lambda n=full.nbytes: live.__setitem__(
            "now", live["now"] - n))
        return full
    tp.Gather.forward = gather
    try:
        step(params, opt, batch)
    finally:
        tp.Gather.forward = forward
    return cfg, mesh, params, calls, live["max"]


def test_train_step_gathers_layer_by_layer():
    cfg, mesh, params, calls, peak = _traced_train(4)
    plan = transformer.gather_plan(cfg, mesh, ("data",))

    def keys(tree, layer: bool) -> collections.Counter:
        return collections.Counter(
            (g.spec, g.axes, tuple(b.shape[1:] if layer else b.shape))
            for b, g in zip(adamw.leaves(tree[0]), adamw.leaves(tree[1]))
            if g is not None)
    stacked = keys((params["blocks"], plan["blocks"]), True)
    top = keys(({k: params[k] for k in transformer.TOP if k in params},
                {k: plan[k] for k in transformer.TOP if k in plan}), False)
    assert stacked and top and not set(stacked) & set(top)
    count = collections.Counter(k for k, _ in calls)
    # each layer's leaf in the forward and in the remat recompute, each
    # top-level leaf once
    assert count == collections.Counter(
        {k: 2 * cfg.num_layers * n for k, n in stacked.items()}) + top
    nbytes = dict(calls)
    layer = sum(nbytes[k] * n for k, n in stacked.items())
    top_bytes = sum(nbytes[k] * n for k, n in top.items())
    # at most the top-level leaves and one layer's gathered at once
    assert top_bytes + layer >= peak > top_bytes
    assert peak < top_bytes + cfg.num_layers * layer
