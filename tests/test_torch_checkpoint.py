"""The port's checkpoints against the JAX package's, on the CPU.

* One nested tree saved by both packages gives the same files: leaf
  keys, file names, shapes, dtypes and the manifest hash — the manifests
  are identical — and each package restores the other's checkpoint.
* The ports of ``tests/test_checkpoint.py``: round trip, corruption and
  torn-leaf detection, ``latest_checkpoint``'s fallback, ``.tmp``
  directories skipped, the async manager's retention and stale-staging
  sweep, and the shape check of ``restore_pytree(like=...)``; with
  ``shardings=`` it gives each rank of a mesh its block of every leaf.
* Four threads saving the same step all return and leave one verified
  checkpoint and no ``.tmp`` directory (the reference can raise
  ``OSError`` errno 39 there).
* Engine snapshots cross packages both ways on the interval, shelf and
  k-d tree domains of ``tests/test_chaos.py``: a JAX snapshot resumed by
  the port, and a port snapshot resumed by ``repro.runtime.elastic``,
  continue with host decisions bitwise equal to the uninterrupted run
  (loads, ``repartitioned``, ``migrated``, the final boundaries) and
  analyses within 1e-12.
"""
import json
import os
import subprocess
import threading

import numpy as np
import pytest
from _hypothesis_shim import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assim import engine as j_engine  # noqa: E402
from repro.assim import streams as j_streams  # noqa: E402
from repro.checkpoint import manager as j_ckpt  # noqa: E402
from repro.runtime import elastic as j_elastic  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.obs import meters as t_meters  # noqa: E402
from repro_torch.runtime import chaos as t_chaos  # noqa: E402
from repro_torch.runtime import elastic as t_elastic  # noqa: E402


@pytest.fixture()
def fresh_meters():
    prev = t_meters.get_meters()
    m = t_meters.Meters()
    t_meters.set_meters(m)
    yield m
    t_meters.set_meters(prev)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 8)), "b": rng.normal(size=(8,)),
            "i": rng.integers(0, 5, size=(3, 2)),
            "f": rng.normal(size=(5,)).astype(np.float32)}


def _tree(make, seed=0):
    """A nested tree of dicts, lists and tuples with ``None`` and a
    scalar, its leaves made by ``make`` from numpy arrays."""
    a = _arrays(seed)
    return {"params": {"w": make(a["w"]), "b": make(a["b"])},
            "opt": [make(a["i"]), (make(a["f"]), None)],
            "step": make(np.asarray(7)), "empty": None}


def _torch_tree(seed=0):
    return _tree(torch.as_tensor, seed)


def _leaves(tree):
    return [np.asarray(v) if not isinstance(v, torch.Tensor)
            else v.numpy() for v in t_ckpt._flatten(tree).values()]


# ---------------------------------------------------------------------------
# The on-disk layout is the reference's.
# ---------------------------------------------------------------------------

def test_same_tree_same_files_in_both_packages(tmp_path):
    meta = {"loader": {"seed": 1, "step": 9}}
    pj = j_ckpt.save_pytree(_tree(jnp.asarray), str(tmp_path / "j"), 3,
                            meta)
    pt = t_ckpt.save_pytree(_torch_tree(), str(tmp_path / "t"), 3, meta)
    assert os.path.basename(pj) == os.path.basename(pt) == "step_00000003"
    assert sorted(os.listdir(pj)) == sorted(os.listdir(pt))
    with open(os.path.join(pj, "manifest.json")) as f:
        mj = f.read()
    with open(os.path.join(pt, "manifest.json")) as f:
        mt = f.read()
    assert mj == mt
    manifest = json.loads(mt)
    assert sorted(manifest["leaves"]) == ["opt/0", "opt/1/0", "params/b",
                                          "params/w", "step"]
    assert manifest["leaves"]["opt/1/0"]["dtype"] == "float32"
    for info in manifest["leaves"].values():
        assert np.array_equal(np.load(os.path.join(pj, info["file"])),
                              np.load(os.path.join(pt, info["file"])))
    assert t_ckpt.verify(pj) and j_ckpt.verify(pt)


def test_each_package_restores_the_others_checkpoint(tmp_path):
    pj = j_ckpt.save_pytree(_tree(jnp.asarray), str(tmp_path / "j"), 1)
    pt = t_ckpt.save_pytree(_torch_tree(), str(tmp_path / "t"), 1)
    got_t, _ = t_ckpt.restore_pytree(pj, like=_torch_tree(seed=1))
    assert isinstance(got_t["params"]["w"], torch.Tensor)
    assert got_t["opt"][1][1] is None and got_t["empty"] is None
    got_j, _ = j_ckpt.restore_pytree(pt, like=_tree(jnp.asarray, seed=1))
    for a, b, c in zip(_leaves(_torch_tree()), _leaves(got_t),
                       [np.asarray(v) for v in
                        t_ckpt._flatten(got_j).values()]):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    flat, manifest = t_ckpt.restore_pytree(str(tmp_path / "j"))
    assert manifest["step"] == 1 and set(flat) == set(
        t_ckpt._flatten(_torch_tree()))


# ---------------------------------------------------------------------------
# Ports of tests/test_checkpoint.py.
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    tree = _torch_tree()
    path = t_ckpt.save_pytree(tree, str(tmp_path), step=3,
                              metadata={"loader": {"seed": 1, "step": 9}})
    got, manifest = t_ckpt.restore_pytree(path, like=tree)
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert np.array_equal(a, b)
    assert got["opt"][1][0].dtype == torch.float32
    assert manifest["step"] == 3
    assert manifest["metadata"]["loader"]["step"] == 9


def test_restore_keeps_the_like_leaves_dtype_and_numpy_leaves(tmp_path):
    path = t_ckpt.save_pytree({"a": np.arange(4.0)}, str(tmp_path), 0)
    got, _ = t_ckpt.restore_pytree(
        path, like={"a": torch.zeros(4, dtype=torch.float32)})
    assert got["a"].dtype == torch.float32 and got["a"].device.type == "cpu"
    got, _ = t_ckpt.restore_pytree(path, like={"a": np.zeros(4, np.int64)})
    assert isinstance(got["a"], np.ndarray) and got["a"].dtype == np.int64


def test_verify_detects_corruption(tmp_path):
    path = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    assert t_ckpt.verify(path)
    victim = os.path.join(path, sorted(
        f for f in os.listdir(path) if f.endswith(".npy"))[0])
    np.save(victim, np.load(victim) + 1)
    assert not t_ckpt.verify(path)
    assert not j_ckpt.verify(path)


def test_latest_skips_torn_checkpoint(tmp_path):
    p1 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    p2 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=2)
    os.remove(os.path.join(p2, sorted(
        f for f in os.listdir(p2) if f.endswith(".npy"))[0]))
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == p1
    assert j_ckpt.latest_checkpoint(str(tmp_path)) == p1


def test_tmp_dirs_ignored(tmp_path):
    t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith(
        "step_00000001")


def test_manager_async_and_gc(tmp_path):
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = _torch_tree()
    for s in range(5):
        mgr.save(tree, step=s, blocking=False)
    # The async save holds its own host copy of the tree.
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    kept = sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    got, manifest = mgr.restore_latest(like=_torch_tree())
    assert manifest["step"] == 4
    assert torch.equal(got["params"]["w"], _torch_tree()["params"]["w"])
    mgr.close()
    assert not mgr._worker.is_alive()


def test_restore_shape_mismatch_raises(tmp_path):
    path = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    bad = _torch_tree()
    bad["params"]["w"] = torch.zeros(3, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore_pytree(path, like=bad)
    with pytest.raises(KeyError, match="missing"):
        t_ckpt.restore_pytree(path, like={"nope": torch.zeros(1)})


def _rank_mesh(shape: dict, rank: int):
    """What a restore reads of a process mesh (its shape, coordinates and
    device), for a rank of a mesh that no process group backs."""
    import types
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(
        rank, tuple(shape.values())))))
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                                 coords=coords, device=torch.device("cpu"))


def test_restore_sharded_gives_each_rank_its_block(tmp_path):
    """``restore_pytree(shardings=)`` (and ``restore_latest``) gives each
    rank of a ("data": 2, "model": 2) mesh its block of every sharded
    leaf, bitwise, and the blocks tile the saved arrays; ``meta``
    like-leaves take their dtype and land on the mesh's device; leaves
    without a sharding, or with an empty spec, stay whole."""
    from repro_torch.runtime.sharding import NamedSharding, P
    path = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    whole = _torch_tree()
    like = _tree(lambda a: torch.empty(a.shape, dtype=torch.float32,
                                       device="meta"))
    like["opt"][0] = torch.empty((3, 2), dtype=torch.int64, device="meta")
    blocks = {"w": [], "b": [], "i": []}
    for rank in range(4):
        mesh = _rank_mesh({"data": 2, "model": 2}, rank)
        shard = {"params": {"w": NamedSharding(mesh, P("data", "model")),
                            "b": NamedSharding(mesh, P(("data", "model")))},
                 "opt": [NamedSharding(mesh, P(None, "model")), (None, None)],
                 "step": NamedSharding(mesh, P()), "empty": None}
        got, manifest = t_ckpt.restore_pytree(path, like=like,
                                              shardings=shard)
        latest, _ = t_ckpt.CheckpointManager(str(tmp_path)).restore_latest(
            like=like, shardings=shard)
        d, m = mesh.coords["data"], mesh.coords["model"]
        for tree in (got, latest):
            w = tree["params"]["w"]
            assert w.dtype == torch.float32 and w.device.type == "cpu"
            assert torch.equal(w, whole["params"]["w"][
                2 * d:2 * d + 2, 4 * m:4 * m + 4].float())
            k = 2 * d + m
            assert torch.equal(tree["params"]["b"],
                               whole["params"]["b"][2 * k:2 * k + 2].float())
            assert torch.equal(tree["opt"][0], whole["opt"][0][:, m:m + 1])
            assert torch.equal(tree["opt"][1][0], whole["opt"][1][0])
            assert int(tree["step"]) == 7 and tree["empty"] is None
        assert manifest["step"] == 1
        for key, leaf in (("w", got["params"]["w"]),
                          ("b", got["params"]["b"]), ("i", got["opt"][0])):
            blocks[key].append(leaf)
    tiles = torch.cat([torch.cat(blocks["w"][2 * d:2 * d + 2], dim=1)
                       for d in range(2)])
    assert torch.equal(tiles, whole["params"]["w"].float())
    assert torch.equal(torch.cat(blocks["b"]), whole["params"]["b"].float())
    assert torch.equal(torch.cat(blocks["i"][:2], dim=1), whole["opt"][0])


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 1000))
def test_roundtrip_random_trees(tmp_path_factory, seed):
    tmp = tmp_path_factory.mktemp(f"ck{seed}")
    rng = np.random.default_rng(seed)
    tree = {"a": torch.as_tensor(rng.normal(size=(rng.integers(1, 10),))),
            "nested": {"b": torch.as_tensor(
                rng.integers(0, 5, size=(3, 2)))}}
    path = t_ckpt.save_pytree(tree, str(tmp), step=0)
    got, _ = t_ckpt.restore_pytree(path, like=tree)
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert np.array_equal(a, b)


def test_latest_falls_back_on_truncated_leaf(tmp_path, fresh_meters):
    p1 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    p2 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=2)
    t_chaos.tear_checkpoint(p2, seed=3)
    assert not t_ckpt.verify(p2)
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == p1
    snap = fresh_meters.snapshot()
    assert snap["counters"]["checkpoint.corrupt_skipped"] == 1
    assert any(e["name"] == "checkpoint.corrupt_skipped"
               and e["path"] == p2 for e in snap["events"])


def test_latest_falls_back_on_corrupt_manifest(tmp_path):
    p1 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=1)
    p2 = t_ckpt.save_pytree(_torch_tree(), str(tmp_path), step=2)
    t_chaos.corrupt_manifest(p2, seed=7)
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == p1


def test_gc_removes_stale_tmp_keeps_live(tmp_path, fresh_meters):
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep=2)
    child = subprocess.Popen(["true"])
    child.wait()
    dead = os.path.join(str(tmp_path), f"step_00000005.{child.pid}-1.tmp")
    live = os.path.join(str(tmp_path),
                        f"step_00000006.{os.getppid()}-1.tmp")
    os.makedirs(dead)
    os.makedirs(live)
    mgr.save(_torch_tree(), step=1, blocking=False)
    mgr.wait()
    mgr.close()
    assert not os.path.exists(dead)
    assert os.path.exists(live)
    assert fresh_meters.snapshot()["counters"][
        "checkpoint.stale_tmp_removed"] == 1


# ---------------------------------------------------------------------------
# The save race of the reference is repaired.
# ---------------------------------------------------------------------------

def test_concurrent_saves_of_one_step_all_return(tmp_path):
    """Four threads save the same step, with a short switch interval so
    their publishing steps interleave: every save returns, and one
    verified checkpoint and no staging directory remain."""
    import sys
    errors = []
    barrier = threading.Barrier(4)

    def save(seed):
        barrier.wait(timeout=30)
        try:
            for _ in range(10):
                t_ckpt.save_pytree(_torch_tree(seed), str(tmp_path), 4,
                                   {"writer": seed})
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=save, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert os.listdir(str(tmp_path)) == ["step_00000004"]
    path = os.path.join(str(tmp_path), "step_00000004")
    assert t_ckpt.verify(path)
    _, manifest = t_ckpt.restore_pytree(path)
    assert manifest["metadata"]["writer"] in range(4)


# ---------------------------------------------------------------------------
# Engine snapshots cross packages.
# ---------------------------------------------------------------------------

KINDS = {
    "interval": (dict(n=48, p=3, iters=6), ("drifting_swarm", 60)),
    "shelf": (dict(n=64, ndim=2, nx=8, ny=8, pr=2, pc=2, iters=6),
              ("rotating_swarm", 80)),
    "kdtree": (dict(n=64, domain_kind="kdtree", p=4, nx=8, ny=8, iters=6),
               ("rotating_swarm", 80)),
}
_CYCLES = 8
HOST = ("loads", "loads_before", "repartitioned", "migrated", "rounds",
        "rebalance_suppressed")


def _jax_run(kind, **run_kw):
    cfg_kw, (scen, m) = KINDS[kind]
    eng = j_engine.AssimilationEngine(j_engine.EngineConfig(**cfg_kw))
    xs = []
    eng.on_analysis = lambda c, x: xs.append(np.asarray(x))
    eng.run(j_streams.ResumableStream(scen, m, _CYCLES, seed=11), **run_kw)
    return eng, xs


def _port_run(kind, **run_kw):
    cfg_kw, (scen, m) = KINDS[kind]
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(**cfg_kw),
                                      device="cpu")
    xs = []
    eng.on_analysis = lambda c, x: xs.append(x.numpy())
    eng.run(t_streams.ResumableStream(scen, m, _CYCLES, seed=11), **run_kw)
    return eng, xs


def _assert_continues(resumed, xs_resumed, base, xs_base):
    """Host decisions bitwise, analyses within 1e-12 of ``base``."""
    rj, bj = resumed.journal.records, base.journal.records
    assert [r.cycle for r in rj] == list(range(_CYCLES))
    for r, b in zip(rj, bj):
        for f in HOST:
            assert getattr(r, f) == getattr(b, f), (r.cycle, f)
    for k, v in base.domain.state_dict().items():
        assert np.array_equal(np.asarray(resumed.domain.state_dict()[k]),
                              np.asarray(v)), k
    assert len(xs_resumed) == _CYCLES - 4
    for a, b in zip(xs_resumed, xs_base[4:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_snapshot_resumes_in_the_port(tmp_path, kind):
    base, xs_base = _jax_run(kind)
    ck = str(tmp_path / kind)
    _jax_run(kind, checkpoint_dir=ck, snapshot_every=4)
    eng, stream = t_elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"), device="cpu")
    assert stream.pos == 4 and eng.cfg.gram_mode == "auto"
    xs = []
    eng.on_analysis = lambda c, x: xs.append(x.numpy())
    eng.run(stream)
    _assert_continues(eng, xs, base, xs_base)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_snapshot_resumes_in_jax(tmp_path, kind):
    base, xs_base = _port_run(kind)
    ck = str(tmp_path / kind)
    _port_run(kind, checkpoint_dir=ck, snapshot_every=4)
    eng, stream = j_elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"))
    assert stream.pos == 4
    xs = []
    eng.on_analysis = lambda c, x: xs.append(np.asarray(x))
    eng.run(stream)
    _assert_continues(eng, xs, base, xs_base)


def test_snapshot_config_keeps_the_port_fields_apart(tmp_path):
    cfg = t_engine.EngineConfig(n=32, p=2, iters=4, gram_mode="plain",
                                solver_kernel="plain")
    eng = t_engine.AssimilationEngine(cfg, device="cpu")
    path = eng.save_checkpoint(str(tmp_path), step=0)
    _, manifest = t_ckpt.restore_pytree(path)
    meta = manifest["metadata"]
    assert meta["config"]["solver_kernel"] == "jnp"
    assert "gram_mode" not in meta["config"]
    assert t_engine.config_from_meta(meta) == cfg
    # The reference builds its config from "config" alone.
    assert j_engine.EngineConfig(**meta["config"]).solver_kernel == "jnp"


def test_bf16_leaves_cross_packages(tmp_path):
    """bf16 leaves (the training path's params) are written as the
    reference writes them: the same 2-byte values and the manifest dtype
    ``bfloat16``; the port restores its own and the reference's bitwise.
    (The reference cannot restore either: its ``astype`` from the
    2-byte void that ``np.load`` returns raises; ROADMAP Queue 3.)"""
    vals = np.random.default_rng(9).normal(size=(6, 5)).astype(np.float32)
    t_tree = {"w": torch.from_numpy(vals).bfloat16(),
              "step": torch.tensor(3, dtype=torch.int32)}
    j_tree = {"w": jnp.asarray(vals).astype(jnp.bfloat16),
              "step": jnp.asarray(3, jnp.int32)}
    pt = t_ckpt.save_pytree(t_tree, str(tmp_path / "t"), 1)
    pj = j_ckpt.save_pytree(j_tree, str(tmp_path / "j"), 1)
    mt, mj = (json.load(open(os.path.join(p, "manifest.json")))
              for p in (pt, pj))
    assert mt == mj            # leaves, dtypes ("bfloat16") and hash
    for path in (pt, pj):
        got, _ = t_ckpt.restore_pytree(path, like=t_tree)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], t_tree["w"])
        assert int(got["step"]) == 3
    with pytest.raises(ValueError):
        j_ckpt.restore_pytree(pt, like=j_tree)
