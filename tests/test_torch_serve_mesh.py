"""The port's sharded prefill and decode on a process mesh against the JAX
package's sharded steps on four forced XLA devices.

``repro_torch.runtime.mesh.launch`` spawns four gloo ranks on the CPU
once for every case below (``tests/_torch_serve_ranks.py``), on the
("data": 2, "model": 2) mesh; meanwhile a subprocess runs the reference
(``--xla_force_host_platform_device_count=4``) on the same mesh:
``make_prefill_step(mesh=, batch_shapes=)``, the cache placed on
``cache_specs_tree``'s shardings with ``jax.device_put`` (its sharded
serve step refuses the prefill's unplaced cache), then
``make_serve_step(mesh=, cache_shapes=)``, greedy.  Its MoE runs with
the DyDD schedule rounded exactly (``_torch_exact_schedule``), as the
port rounds.  Both sides read the same numpy weights (the reference's
``init_params``, carried across) and seeded prompts.  The smoke configs
(f32) cover the three cache layouts:

* kv heads split on "model": yi-6b (GQA 8:2), olmoe-1b-7b (the MoE),
  phi3-vision-4.2b (8 patches before the prompt, decode positions
  offset);
* slots split on "model" (``kv_seq``): gemma3-1b at B = 2 (the full and
  the ring cache), recurrentgemma-9b (the ring; its RG-LRU states split
  by rows alone), whisper-large-v3 at B = 2 with a prompt of 8 (the self
  and the cross caches; the full cache's second block holds no valid
  slot for the first 4 steps), and gemma3-1b at B = 2 with an odd full
  cache (29 slots: the spec keeps its sequence whole, the ring splits);
* rows alone: gemma3-1b at B = 4 and whisper-large-v3 at B = 4 (the "dp"
  profile, batch over both axes), mamba2-1.3b (SSD states).

Held in each case: the whole prefill logits and every decode step's
gathered logits within ATOL max-abs of the reference's, greedy tokens
equal, every cache block within ATOL of its slice of the reference's
global cache and "pos" bitwise after the prefill and after every step,
every rank the same logits bits and ranks that hold the same block the
same bits, and the collectives of a decode step (``ProcessMesh.counts``:
the tensor-parallel layers' psums and gathers and the logits' gather, no
parameter gather; an in-place edit of one block brings its gather
back).  A mutation check
on the ``kv_seq`` cases (each rank's slots softmaxed alone, no combine)
and on yi (the psum after the row-parallel ``wo`` left out) must read
more than 100 ATOL from the reference.  ``serve_batch(mesh=)`` and ``serve_queue(mesh=,
slots=2)`` give on every rank the reference's unsharded
``serve_batch`` and ``serve_queue`` tokens, but on OLMoE's shortest,
left-padded request: there the reference's unsharded tokens differ from
its own sharded steps' run as ``serve_batch`` runs its loop (checked),
the routing order among the identical pad tokens being decided by
rounding, and the port, which computes as the sharded steps partition,
gives the sharded steps' tokens.  A sampled ``serve_batch(mesh=)`` gives
the same tokens on every rank.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

import _torch_serve_ranks as ranks  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
RANKS = 4
ATOL = 1e-4              # f32 logits and cache leaves (test_torch_lm_serve)
MUTATION_FACTOR = 100
PROMPT_LENS = (16, 12, 16, 10)   # serve_batch's requests; waves of 2 too
MAX_NEW = 8
TIMEOUT_S = 120


def _case(arch, b, s, steps, max_seq, layout, **kw):
    return dict(arch=arch, batch=b, seq=s, steps=steps, max_seq=max_seq,
                layout=layout, max_new=MAX_NEW,
                serve_max_seq=max(PROMPT_LENS) + MAX_NEW, **kw)


# name -> case; ``layout``: each split stack's kind, as the reference's
# cache specs give it; ``mutate``: the kind of layout the mutation breaks;
# ``serve``: run serve_batch and serve_queue on this arch's requests;
# ``sharded_reference``: also run them through the reference's sharded
# steps (``SHARDED_REFERENCE_ROWS``).
CASES = {
    "yi": _case("yi_6b", 4, 16, 8, 24, {"full": "heads"}, mutate="heads",
                serve=True),
    "olmoe": _case("olmoe_1b_7b", 4, 16, 8, 24, {"full": "heads"},
                   serve=True, sharded_reference=True),
    "phi3": _case("phi3_vision_4_2b", 4, 16, 8, 32, {"full": "heads"},
                  serve=True),
    "gemma3_dp": _case("gemma3_1b", 4, 20, 8, 28, {}, serve=True),
    "gemma3_seq": _case("gemma3_1b", 2, 20, 8, 28,
                        {"full": "seq", "ring": "seq"}, mutate="seq"),
    "gemma3_odd": _case("gemma3_1b", 2, 20, 9, 29, {"ring": "seq"}),
    "recurrentgemma": _case("recurrentgemma_9b", 4, 20, 8, 28,
                            {"attn": "seq"}, mutate="seq", serve=True),
    "mamba2": _case("mamba2_1_3b", 4, 16, 8, 24, {}, serve=True),
    "whisper": _case("whisper_large_v3", 4, 16, 8, 24, {}, serve=True),
    "whisper_seq": _case("whisper_large_v3", 2, 8, 8, 24,
                         {"self": "seq", "cross_k": "seq"}, mutate="seq"),
}

# name -> the requests whose greedy tokens the reference's unsharded
# ``serve_batch`` and ``serve_queue`` and its own sharded steps disagree
# on: OLMoE's shortest prompt, left-padded by 6, whose identical pad
# tokens' expert routing is ordered by rounding that differs between the
# two; the port on the mesh is held to the sharded steps' tokens there.
SHARDED_REFERENCE_ROWS = {"olmoe": (3,)}

REF = r"""
import json, os, sys
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
from repro.launch import mesh as lmesh
from repro.launch import serve as jserve
from repro.runtime import steps
from repro.models import transformer

tmp = sys.argv[1]
cases = json.loads(sys.argv[3])
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
    return {prefix: tree}


def put(tree, specs):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        tree, specs, is_leaf=is_spec)


def sharded_serve(cfg, p, prompts, max_seq, max_new):
    # greedy tokens of the prompts through the sharded steps, as
    # serve_batch runs its loop: prompts left-padded with 0 to the
    # longest, zero frames or patches, the prefill, then max_new decode
    # steps, the first token the prefill's
    S = max(len(r) for r in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, r in enumerate(prompts):
        toks[i, S - len(r):] = r
    batch = {"tokens": toks}
    P_off = 0
    if cfg.frontend == "audio_stub":
        batch["frames"] = np.zeros((len(prompts), cfg.encoder_seq,
                                    cfg.d_model), np.dtype(cfg.dtype))
    if cfg.frontend == "vision_stub":
        batch["patches"] = np.zeros((len(prompts), cfg.num_patches,
                                     cfg.d_model), np.dtype(cfg.dtype))
        P_off = cfg.num_patches
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batch.items()}
    prefill = steps.make_prefill_step(cfg, mesh=mesh,
                                      max_seq=max_seq + P_off,
                                      batch_shapes=shapes)
    logits, cache = prefill(p, put(batch, steps.batch_specs(cfg, shapes)))
    cshapes = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), cache)
    cache = put(cache, steps.cache_specs_tree(cfg, cshapes))
    serve = steps.make_serve_step(cfg, mesh=mesh, cache_shapes=cshapes)
    cur = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    got = []
    for step in range(max_new):
        got.append(np.asarray(cur[:, 0]))
        logits, cache = serve(p, cache, cur, jnp.int32(P_off + S + step))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(got, 1).tolist()


out, specs = {}, {}
for name, case in cases.items():
    cfg = configs.get_smoke_config(case["arch"])
    with np.load(os.path.join(tmp, name + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten(flat, "p")
    batch = {k: jnp.asarray(v) for k, v in unflatten(flat, "b").items()}
    with jax.sharding.set_mesh(mesh):
        shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in batch.items()}
        prefill = steps.make_prefill_step(cfg, mesh=mesh,
                                          max_seq=case["max_seq"],
                                          batch_shapes=shapes)
        p = put(params, transformer.param_specs(cfg))
        logits, cache = prefill(p, put(batch, steps.batch_specs(cfg,
                                                                shapes)))
        out[f"{name}/prefill_logits"] = np.asarray(logits)
        for k, v in flatten(cache).items():
            out[f"{name}/cache0/{k}"] = np.asarray(v)
        cshapes = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), cache)
        cspec = steps.cache_specs_tree(cfg, cshapes)
        specs[name] = {k: list(v) for k, v in flatten(
            jax.tree.map(tuple, cspec, is_leaf=is_spec)).items()}
        cache = put(cache, cspec)
        serve = steps.make_serve_step(cfg, mesh=mesh, cache_shapes=cshapes)
        start = case["seq"] + (batch["patches"].shape[1]
                               if "patches" in batch else 0)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        for i in range(case["steps"]):
            logits, cache = serve(p, cache, tok, jnp.int32(start + i))
            out[f"{name}/logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out[f"{name}/tokens{i}"] = np.asarray(tok)
            for k, v in flatten(cache).items():
                out[f"{name}/cache{i + 1}/{k}"] = np.asarray(v)
        if case.get("sharded_reference"):
            prompts = [flat[f"r/{i}"] for i in range(
                len([k for k in flat if k.startswith("r/")]))]
            for kind in ("serve_batch", "serve_queue"):
                waves = ([prompts] if kind == "serve_batch" else
                         [prompts[i:i + 2]
                          for i in range(0, len(prompts), 2)])
                got = []
                for wave in waves:
                    got += sharded_serve(cfg, p, wave,
                                         case["serve_max_seq"],
                                         case["max_new"])
                out[f"{name}/{kind}_sharded"] = np.asarray(got)
    if case.get("serve"):
        prompts = [flat[f"r/{i}"] for i in range(
            len([k for k in flat if k.startswith("r/")]))]
        for kind in ("serve_batch", "serve_queue"):
            reqs = [jserve.Request(rid=i, prompt=pr,
                                   max_new=case["max_new"])
                    for i, pr in enumerate(prompts)]
            if kind == "serve_batch":
                done, _ = jserve.serve_batch(
                    cfg, params, reqs, max_seq=case["serve_max_seq"])
            else:
                done, _ = jserve.serve_queue(
                    cfg, params, reqs, slots=2,
                    max_seq=case["serve_max_seq"])
            out[f"{name}/{kind}"] = np.asarray([r.out for r in done])
with open(os.path.join(tmp, "ref_specs.json"), "w") as f:
    json.dump(specs, f)
np.savez(os.path.join(tmp, "ref.npz"), **out)
"""


def _inputs(tmp, i: int, name: str, case: dict) -> None:
    cfg = jconfigs.get_smoke_config(case["arch"])
    params = jtransformer.init_params(cfg, jax.random.PRNGKey(i))
    flat = {"p/" + k: v for k, v in ranks.flatten(
        jax.tree.map(np.asarray, params)).items()}
    rng = np.random.default_rng(100 + i)
    b, s = case["batch"], case["seq"]
    flat["b/tokens"] = rng.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)
    if cfg.frontend == "audio_stub":
        flat["b/frames"] = (0.02 * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision_stub":
        flat["b/patches"] = (0.02 * rng.normal(
            size=(b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    for j, n in enumerate(PROMPT_LENS):
        flat[f"r/{j}"] = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
    np.savez(os.path.join(tmp, f"{name}.npz"), **flat)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of four CPU ranks for every case of this file, with the
    reference's four-device run in a process of its own meanwhile."""
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    for i, (name, case) in enumerate(CASES.items()):
        _inputs(tmp, i, name, case)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, tmp, HERE, json.dumps(CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = t_mesh.launch(ranks.serve_rank, RANKS, backend="gloo",
                            device="cpu", args=(CASES, tmp),
                            timeout=TIMEOUT_S)
    finally:
        log = ref.communicate(timeout=600)[0]
    assert ref.returncode == 0, log[-3000:]
    with np.load(os.path.join(tmp, "ref.npz")) as z:
        ref_out = {k: z[k] for k in z.files}
    with open(os.path.join(tmp, "ref_specs.json")) as f:
        specs = json.load(f)
    return out, ref_out, specs


def _slices(spec, shape, rank) -> tuple:
    """The reference's block of ``rank`` on the (2, 2) ("data", "model")
    mesh."""
    names = ranks.MESH[1]
    sizes = dict(zip(names, ranks.MESH[0]))
    coords = dict(zip(names, np.unravel_index(rank, ranks.MESH[0])))
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


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_logits_match_reference(launched, name):
    out, ref, _ = launched
    case = CASES[name]
    for o in out:
        r = o["cases"][name]
        assert _max_abs(r["prefill_logits"],
                        ref[f"{name}/prefill_logits"]) <= ATOL
        for i in range(case["steps"]):
            want = ref[f"{name}/logits{i}"]
            assert r["logits"][i].shape == want.shape
            assert _max_abs(r["logits"][i], want) <= ATOL, (o["rank"], i)
            assert np.array_equal(r["tokens"][i], ref[f"{name}/tokens{i}"])


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_match_reference_slices(launched, name):
    out, ref, specs = launched
    steps = CASES[name]["steps"]
    for o in out:
        r = o["cases"][name]
        blocks = [r["prefill_cache"]] + r["caches"]
        assert len(blocks) == steps + 1
        for i, cache in enumerate(blocks):
            assert sorted(cache) == sorted(specs[name])
            for key, blk in cache.items():
                whole = ref[f"{name}/cache{i}/{key}"]
                want = whole[_slices(specs[name][key], whole.shape,
                                     o["rank"])]
                assert blk.shape == want.shape, (key, i)
                if key.endswith("pos"):
                    assert np.array_equal(blk, want), (key, i)
                else:
                    assert _max_abs(blk, want) <= ATOL, (key, i, o["rank"])


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_bitwise(launched, name):
    out, _, specs = launched
    res = [o["cases"][name] for o in out]
    for r in res[1:]:
        assert np.array_equal(r["prefill_logits"], res[0]["prefill_logits"])
        assert all(np.array_equal(a, b) for a, b in zip(r["logits"],
                                                        res[0]["logits"]))
    # ranks whose specs give the same block hold the same bits
    for i in range(CASES[name]["steps"] + 1):
        for key, spec in specs[name].items():
            held = {}
            for rank, r in enumerate(res):
                blk = (r["prefill_cache"] if i == 0
                       else r["caches"][i - 1])[key]
                sl = str(_slices(spec, _whole_shape(spec, blk.shape), rank))
                if sl in held:
                    assert np.array_equal(held[sl], blk), (key, i)
                held[sl] = blk


def _whole_shape(spec, block_shape) -> tuple:
    sizes = dict(zip(ranks.MESH[1], ranks.MESH[0]))
    out = []
    for d, n in enumerate(block_shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        out.append(n * int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


def _stack_key(key: str) -> str:
    """The flat key of a stack's k leaf ("cross_k" is a leaf itself)."""
    return key if key == "cross_k" else key + "/k"


@pytest.mark.parametrize("name", list(CASES))
def test_cache_layouts_are_the_reference_specs(launched, name):
    out, _, specs = launched
    want = CASES[name]["layout"]
    for o in out:
        r = o["cases"][name]
        assert {k: v[0] for k, v in r["layouts"].items()} == want
        for key, (dim, axes, start, stop, size) in r["layouts"].items():
            spec = specs[name][_stack_key(key)]
            d = 3 if dim == "heads" else 2
            part = spec[d]
            assert tuple(axes) == ((part,) if isinstance(part, str)
                                   else tuple(part))
            whole = _whole_shape(spec, r["caches"][0][_stack_key(key)].shape)
            sl = _slices(spec, whole, o["rank"])[d]
            assert (start, stop, size) == (sl.start, sl.stop, whole[d])


def _plus(counts: dict, gathers: int, params: int = 0) -> dict:
    out = dict(counts)
    if gathers:
        out["all_gather"] = out.get("all_gather", 0) + gathers
    if params:
        out["params"] = params
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_decode_makes_no_parameter_gather(launched, name):
    """The prefill gathers each leaf that an FSDP axis splits once, over
    the axes other than "model" (the SSD block's packed leaves over
    "model" too), into the rank's tensor-parallel share; a decode step
    then makes only its layers' tensor-parallel collectives
    (``expected_collectives``) and the caller's logits gather; an
    in-place edit of one block brings that leaf's gather back; a new
    serve step shares the mesh's kept shares (no gather), and once the
    mesh drops them gathers every such leaf on its first call and none on
    its second."""
    out, _, _ = launched
    for o in out:
        r = o["cases"][name]
        want = r["expected"]
        n = r["split_leaves"]
        assert n and r["prefill_counts"]["params"] == n
        ssd = CASES[name]["arch"] == "mamba2_1_3b"
        assert all(axes == ["data"] or (ssd and "model" in axes)
                   for axes in r["gathered_leaves"])
        assert sum("model" in a for a in r["gathered_leaves"]) == (
            3 if ssd else 0)
        assert all(c == _plus(want, int(r["logits_split"]))
                   for c in r["counts"]), (r["counts"], want)
        assert r["edited_counts"] == _plus(want, 1, 1)
        assert r["fresh_counts"] == [want, _plus(want, n, n), want]


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("mutate")])
def test_mutated_decode_reads_far_from_reference(launched, name):
    out, ref, _ = launched
    r = out[0]["cases"][name]
    worst = max(_max_abs(m, ref[f"{name}/logits{i}"])
                for i, m in enumerate(r["mutated"]))
    assert worst > MUTATION_FACTOR * ATOL, worst


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("serve")])
def test_serve_batch_and_queue_match_reference_tokens(launched, name):
    """The reference's own ``serve_batch`` and ``serve_queue`` are the
    yardstick, but for the requests of ``SHARDED_REFERENCE_ROWS``: there
    the reference's unsharded tokens differ from its own sharded steps'
    (checked here), and the port, which computes as the sharded steps
    partition, is held to those."""
    out, ref, _ = launched
    rows = SHARDED_REFERENCE_ROWS.get(name, ())
    for kind in ("serve_batch", "serve_queue"):
        want = ref[f"{name}/{kind}"].tolist()
        assert len(want) == len(PROMPT_LENS)
        if rows:
            sharded = ref[f"{name}/{kind}_sharded"].tolist()
            assert [i for i in range(len(want))
                    if want[i] != sharded[i]] == list(rows), kind
            for i in rows:
                want[i] = sharded[i]
        for o in out:
            assert o["cases"][name][kind] == want, (kind, o["rank"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("serve")])
def test_sampled_tokens_agree_across_ranks(launched, name):
    """Sampling draws from the same seeded generator on every rank, from
    the same whole logits, so every rank samples the same tokens."""
    out, _, _ = launched
    got = [o["cases"][name]["sampled"] for o in out]
    assert all(len(t) == MAX_NEW for t in got[0])
    assert all(g == got[0] for g in got[1:])


@pytest.mark.parametrize("name", ["make_prefill_step", "make_serve_step"])
def test_step_factories_take_the_reference_positional_order(name):
    """A positional call written for the reference's factory passes the
    same arguments to the port's (its own extras are keyword-only)."""
    import inspect
    from repro.runtime import steps as jsteps

    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD]

    ref = [n for n in positional(getattr(jsteps, name)) if n != "donate"]
    assert positional(getattr(tsteps, name)) == ref


def test_sharded_serve_step_needs_the_cache_shapes():
    cfg = tconfigs.get_smoke_config("yi_6b")
    with pytest.raises(ValueError, match="cache_shapes"):
        tsteps.make_serve_step(cfg, object())


# Cases whose collectives are held to the dry run's: kv heads split (an
# all-gather of head outputs a layer) and slots split (a pmax and a psum
# a layer).
TRACED_CASES = ("yi", "recurrentgemma")


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", TRACED_CASES)
def test_collectives_match_dry_run(launched, name, kind, rank):
    """The collectives a rank's ``ProcessMesh`` recorded (kind, result
    bytes, group size, calls) in the prefill, and in a decode step that
    gathers the params (a fresh serve step after ``mesh.kept.clear()``),
    equal what ``launch.dryrun.lower_cell`` records tracing the same step
    on a ``TracedMesh`` of the same shape and rank."""
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.launch import dryrun as tdryrun
    from repro_torch.runtime.sharding import AbstractMesh

    out, _, _ = launched
    case = CASES[name]
    cfg = tconfigs.get_smoke_config(case["arch"])
    seq = case["seq"] if kind == "prefill" else case["max_seq"]
    traced = tdryrun.lower_cell(
        cfg, ShapeCase(name, seq, case["batch"], kind),
        t_mesh.TracedMesh(AbstractMesh(*ranks.MESH), rank=rank),
        flops=False)
    r = next(o for o in out if o["rank"] == rank)["cases"][name]
    got = r["prefill_collectives" if kind == "prefill"
            else "fresh_collectives"]
    assert got and traced["collectives"] == got
