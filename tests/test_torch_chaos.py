"""The port's chaos injection, engine snapshots and elastic resume against
the JAX package's, on the CPU (the cases of ``tests/test_chaos.py`` that
need no device mesh, at its sizes).

* ``ChaosInjector`` draws the same schedule and fires the same
  injections as the reference's for one config; faults fire once unless
  ``fail_every_attempt``; ``retry_transient`` backs off exponentially
  and lets fatal errors through.
* Retried transient pack and solve faults leave the engine's journal
  bitwise equal to an uninjected run (double buffering on and off), as
  in the reference, whose injections are the same; a fault outliving
  the retries is fatal; a forced straggler is flagged without touching
  the numbers.
* Snapshot resume is bitwise for each domain kind and its host
  decisions equal the reference's resumed run; the in-process elastic
  remesh to p = 2 makes the same host decisions as the reference's,
  with a final analysis within 1e-12 of its.
* An unknown snapshot version is rejected; the domain state round-trips.
* SIGKILL mid-stream in a child process, resume in this one: the joined
  journal and the final analysis are bitwise the uninterrupted run's.
* A ``TimeParEngine`` window checkpoint resumes the sequential engine
  with the tail's DyDD decisions and a final analysis within 1e-6 of
  the windowed run (the reference's bound).
"""
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
from _hypothesis_shim import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.assim import engine as j_engine  # noqa: E402
from repro.assim import streams as j_streams  # noqa: E402
from repro.runtime import chaos as j_chaos  # noqa: E402
from repro.runtime import elastic as j_elastic  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.assim import timepar as t_timepar  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.core import domain as domain_mod  # noqa: E402
from repro_torch.core import kdtree as kdtree_mod  # noqa: E402
from repro_torch.obs import meters as t_meters  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.straggler import StragglerConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HOST = ("loads", "loads_before", "repartitioned", "migrated", "rounds",
        "rebalance_suppressed", "imbalance")


@pytest.fixture()
def fresh_meters():
    prev = t_meters.get_meters()
    m = t_meters.Meters()
    t_meters.set_meters(m)
    yield m
    t_meters.set_meters(prev)


def _host(journal):
    return [tuple(getattr(r, f) for f in HOST) for r in journal.records]


# ---------------------------------------------------------------------------
# Injector determinism and retry mechanics.
# ---------------------------------------------------------------------------

def _fire_all(inj, mod):
    for c in range(64):
        for site in ("pack", "solve"):
            try:
                inj.check(site, c)
            except mod.TransientFault:
                pass


def test_injector_schedule_matches_reference(fresh_meters):
    kw = dict(seed=7, max_cycle=64, pack_fault_rate=0.1,
              solve_fault_rate=0.05, kill_cycles=(9,), straggle_cycles=(3,))
    a = chaos.ChaosInjector(chaos.ChaosConfig(**kw))
    b = chaos.ChaosInjector(chaos.ChaosConfig(**kw))
    ref = j_chaos.ChaosInjector(j_chaos.ChaosConfig(**kw))
    assert a.schedule() == b.schedule() == ref.schedule()
    json.dumps(a.schedule())
    for inj, mod in ((a, chaos), (b, chaos), (ref, j_chaos)):
        _fire_all(inj, mod)
    assert a.injections == b.injections == ref.injections
    assert a.injections
    other = chaos.ChaosInjector(
        chaos.ChaosConfig(seed=8, max_cycle=64, pack_fault_rate=0.1,
                          solve_fault_rate=0.05))
    assert other.schedule()["pack_fault_cycles"] != \
        a.schedule()["pack_fault_cycles"]
    assert fresh_meters.snapshot()["counters"]["chaos.injected.pack"] == \
        2 * sum(r["site"] == "pack" for r in a.injections)


def test_fault_fires_once_unless_fail_every_attempt(fresh_meters):
    inj = chaos.ChaosInjector(chaos.ChaosConfig(pack_fault_cycles=(2,)))
    with pytest.raises(chaos.TransientFault):
        inj.check("pack", 2)
    inj.check("pack", 2)          # second attempt passes
    inj.check("pack", 1)          # unscheduled cycle never fires

    hard = chaos.ChaosInjector(
        chaos.ChaosConfig(pack_fault_cycles=(2,), fail_every_attempt=True))
    with pytest.raises(chaos.TransientFault):
        chaos.retry_transient(lambda: hard.check("pack", 2), retries=2,
                              backoff=0.0, site="pack", cycle=2,
                              sleep=lambda s: None)
    assert len(hard.injections) == 3   # initial + both retries


def test_retry_transient_backoff_sequence(fresh_meters):
    delays, calls = [], {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise chaos.TransientFault("flaky")
        return "ok"

    out = chaos.retry_transient(fn, retries=3, backoff=0.05, site="solve",
                                cycle=1, sleep=delays.append)
    assert out == "ok"
    assert delays == [0.05, 0.1]   # exponential
    snap = fresh_meters.snapshot()
    assert snap["counters"]["chaos.retries"] == 2
    assert [e["attempt"] for e in snap["events"]
            if e["name"] == "chaos.retry"] == [1, 2]


def test_retry_transient_does_not_catch_fatal():
    with pytest.raises(ZeroDivisionError):
        chaos.retry_transient(lambda: 1 / 0, retries=5, backoff=0.0,
                              sleep=lambda s: None)


# ---------------------------------------------------------------------------
# Engine-level chaos.
# ---------------------------------------------------------------------------

def _cfg(mod=t_engine, **kw):
    return mod.EngineConfig(n=48, p=3, iters=6, **kw)


def _stream(mod=t_streams, cycles=6, seed=3, m=60):
    return mod.make_stream("drifting_swarm", m, cycles, seed=seed)


def _eng(cfg, **kw):
    return t_engine.AssimilationEngine(cfg, device="cpu", **kw)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_engine_transient_faults_retry_bitwise(fresh_meters, double_buffer):
    base = _eng(_cfg(double_buffer=double_buffer)).run(_stream())
    sched = dict(pack_fault_cycles=(1, 3), solve_fault_cycles=(2,))
    inj = chaos.ChaosInjector(chaos.ChaosConfig(**sched))
    j = _eng(_cfg(double_buffer=double_buffer), chaos=inj).run(_stream())
    assert j.deterministic_json() == base.deterministic_json()
    ref_inj = j_chaos.ChaosInjector(j_chaos.ChaosConfig(**sched))
    ref = j_engine.AssimilationEngine(
        _cfg(j_engine, double_buffer=double_buffer), chaos=ref_inj)
    ref.run(_stream(j_streams))
    assert inj.injections == ref_inj.injections
    assert {(r["site"], r["cycle"]) for r in inj.injections} == \
        {("pack", 1), ("pack", 3), ("solve", 2)}
    assert _host(j) == _host(ref.journal)
    assert fresh_meters.snapshot()["counters"]["chaos.retries"] == 3


def test_engine_fault_outliving_retries_is_fatal(fresh_meters):
    inj = chaos.ChaosInjector(
        chaos.ChaosConfig(solve_fault_cycles=(1,), fail_every_attempt=True))
    eng = _eng(_cfg(solve_retries=1), chaos=inj)
    with pytest.raises(chaos.TransientFault):
        eng.run(_stream())
    assert len(eng.journal.records) == 1


def test_forced_straggler_flags_without_touching_numerics(fresh_meters):
    base = _eng(_cfg()).run(_stream())
    scfg = StragglerConfig(grace_steps=1, consecutive_trigger=1,
                           deadline_factor=10.0)
    inj = chaos.ChaosInjector(
        chaos.ChaosConfig(straggle_cycles=(4,), straggle_device=0,
                          straggle_factor=1e6))
    j = _eng(_cfg(), straggler_config=scfg, chaos=inj).run(_stream())
    assert j.records[4].straggler_flags == [0]
    assert fresh_meters.snapshot()["counters"][
        "engine.straggler.flags"] >= 1
    assert any(r["site"] == "straggle" for r in inj.injections)
    assert j.deterministic_json() == base.deterministic_json()


# ---------------------------------------------------------------------------
# Snapshot / restore on every domain kind.
# ---------------------------------------------------------------------------

KINDS = {
    "interval": (dict(n=48, p=3, iters=6), ("drifting_swarm", 60)),
    "shelf": (dict(n=64, ndim=2, nx=8, ny=8, pr=2, pc=2, iters=6),
              ("rotating_swarm", 80)),
    "kdtree": (dict(n=64, domain_kind="kdtree", p=4, nx=8, ny=8, iters=6),
               ("rotating_swarm", 80)),
}
_CYCLES = 8


def _kind_run(kind, **run_kw):
    cfg_kw, (scen, m) = KINDS[kind]
    eng = _eng(t_engine.EngineConfig(track_reference=True, **cfg_kw))
    j = eng.run(t_streams.ResumableStream(scen, m, _CYCLES, seed=11),
                **run_kw)
    return eng, j


def _ref_resume(kind, ck, **kw):
    """The reference's run of the same kind, checkpointed at 4 and
    resumed there (``kw``: ``p`` for an elastic resume)."""
    cfg_kw, (scen, m) = KINDS[kind]
    j_engine.AssimilationEngine(j_engine.EngineConfig(**cfg_kw)).run(
        j_streams.ResumableStream(scen, m, _CYCLES, seed=11),
        checkpoint_dir=ck, snapshot_every=4)
    eng, stream = j_elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"), **kw)
    eng.run(stream)
    return eng


@pytest.mark.parametrize("kind", list(KINDS))
def test_snapshot_resume_bitwise(tmp_path, kind):
    base_eng, base = _kind_run(kind)
    ck = str(tmp_path / kind)
    _kind_run(kind, checkpoint_dir=ck, snapshot_every=4)
    eng2, stream2 = elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"), device="cpu")
    assert stream2 is not None and stream2.pos == 4
    assert stream2.remaining() == _CYCLES - 4
    j = eng2.run(stream2)
    assert j.deterministic_json() == base.deterministic_json()
    assert torch.equal(eng2.analysis, base_eng.analysis)
    assert j.meta["resume"] == [
        {"at_cycle": 4, "p": eng2.p, "remeshed": False}]
    assert _host(j) == _host(
        _ref_resume(kind, str(tmp_path / "ref")).journal)


@pytest.mark.parametrize("kind", list(KINDS))
def test_elastic_remesh_in_process(tmp_path, kind):
    new_p = 2
    ck = str(tmp_path / kind)
    _kind_run(kind, checkpoint_dir=ck, snapshot_every=4)
    eng2, stream2 = elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"), p=new_p, device="cpu")
    assert eng2.p == new_p and stream2.pos == 4
    j = eng2.run(stream2)
    assert [r.cycle for r in j.records] == list(range(_CYCLES))
    assert all(len(r.loads) == new_p for r in j.records[4:])
    assert all(len(r.loads) > new_p for r in j.records[:4])
    assert j.meta["resume"][-1] == \
        {"at_cycle": 4, "p": new_p, "remeshed": True}
    ref = _ref_resume(kind, str(tmp_path / "ref"), p=new_p)
    assert _host(j) == _host(ref.journal)
    assert j.meta == ref.journal.meta
    np.testing.assert_allclose(eng2.analysis.numpy(),
                               np.asarray(ref.analysis), rtol=0,
                               atol=1e-12)


def test_restore_rejects_unknown_snapshot_version(tmp_path):
    path = t_ckpt.save_pytree({"truth": np.zeros(4)}, str(tmp_path), step=1,
                              metadata={"snapshot_version": 99})
    with pytest.raises(ValueError, match="snapshot version"):
        t_engine.AssimilationEngine.restore(path, device="cpu")


def test_resume_names_the_mesh_item(tmp_path):
    """Resume onto a mesh refuses, before any rank meets another, a mesh
    whose rank count is not the new p (a mesh stands in here; the mesh
    runs are ``tests/test_torch_mesh_resume.py``), at the saved p and at
    a new one; an empty directory has nothing to resume."""
    def mesh(k):
        return types.SimpleNamespace(
            shape={"sub": k}, device=torch.device("cpu"),
            index=lambda axes: 0, describe=lambda: {"shape": {"sub": k}})

    eng = t_engine.AssimilationEngine(
        t_engine.EngineConfig(n=48, p=4, solver="shardmap"), device="cpu",
        mesh=mesh(4))
    tree, meta = eng.snapshot()
    t_ckpt.save_pytree(tree, str(tmp_path / "ck"), 0, meta)
    for p, k in ((None, 3), (2, 4), (2, 3)):
        with pytest.raises(ValueError, match=f"p={p or 4} but the given "
                                             f"mesh has {k} device"):
            elastic.resume_assim_engine(str(tmp_path / "ck"), p=p,
                                        device="cpu", mesh=mesh(k))
    eng, _ = elastic.resume_assim_engine(str(tmp_path / "ck"), p=2,
                                         device="cpu", mesh=mesh(2))
    assert eng.p == 2 and eng.cfg.solver == "shardmap"
    with pytest.raises(FileNotFoundError):
        elastic.resume_assim_engine(str(tmp_path / "none"), device="cpu")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000),
       kind=st.sampled_from(["interval", "shelf", "kdtree"]))
def test_domain_state_roundtrip(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "interval":
        dom, fresh = (domain_mod.Interval1D(n=32, p=4),
                      domain_mod.Interval1D(n=32, p=4))
        obs = np.sort(rng.random(50))
    elif kind == "shelf":
        dom, fresh = (domain_mod.ShelfTiling2D(nx=8, ny=8, pr=2, pc=2),
                      domain_mod.ShelfTiling2D(nx=8, ny=8, pr=2, pc=2))
        obs = rng.random((50, 2))
    else:
        dom, fresh = (kdtree_mod.KDTreeDomain(nx=8, ny=8, p=4),
                      kdtree_mod.KDTreeDomain(nx=8, ny=8, p=4))
        obs = rng.random((50, 2))
    dom.rebalance(obs)
    state = dom.state_dict()
    fresh.load_state({k: np.array(v) for k, v in state.items()})
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v, state[k])
    np.testing.assert_array_equal(fresh.counts(obs), dom.counts(obs))


def test_remesh_helpers_match_reference():
    edges = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    out = elastic.rebalanced_edges(edges, [0, 0, 4, 4], new_p=2)
    np.testing.assert_allclose(out, [0.0, 3.0, 4.0])
    np.testing.assert_allclose(
        elastic.rebalanced_edges(edges, [0, 0, 0, 0], new_p=4),
        np.linspace(0.0, 4.0, 5))
    rng = np.random.default_rng(0)
    for new_p in (2, 3, 5):
        loads = rng.integers(0, 20, size=4)
        assert np.array_equal(
            elastic.rebalanced_edges(edges, loads, new_p),
            j_elastic.rebalanced_edges(edges, loads, new_p))
    for args in ((4, 2, None, None), (2, 2, None, None), (6, 4, None, None),
                 (8, 2, 4, None)):
        assert elastic._shelf_grid(*args) == j_elastic._shelf_grid(*args)
    with pytest.raises(ValueError):
        elastic._shelf_grid(8, pr_old=2, pr=3, pc=3)


# ---------------------------------------------------------------------------
# SIGKILL mid-stream, resume in this process.
# ---------------------------------------------------------------------------

_CHILD = """
from repro_torch.assim.engine import AssimilationEngine, EngineConfig
from repro_torch.assim import streams
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
inj = ChaosInjector(ChaosConfig(kill_cycles=(5,)))
eng = AssimilationEngine(EngineConfig(n=48, p=3, iters=6), device="cpu",
                         chaos=inj)
eng.run(streams.ResumableStream("drifting_swarm", 60, 10, seed=2),
        checkpoint_dir={ck!r}, snapshot_every=2)
print("UNREACHABLE")
"""


def test_kill_and_resume_bitwise_subprocess(tmp_path):
    """SIGKILL the engine after cycle 5 (after the cycle-6 snapshot is
    due at cycle 5's end), resume here from the surviving checkpoint:
    the joined journal and the analysis are the uninterrupted run's."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD.format(ck=ck)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    assert "UNREACHABLE" not in out.stdout
    latest = t_ckpt.latest_checkpoint(ck)
    assert latest is not None and latest.endswith("step_00000006")

    base_eng = _eng(t_engine.EngineConfig(n=48, p=3, iters=6))
    base = base_eng.run(
        t_streams.ResumableStream("drifting_swarm", 60, 10, seed=2))
    eng2, stream2 = elastic.resume_assim_engine(ck, device="cpu")
    assert stream2.pos == 6
    j = eng2.run(stream2)
    assert j.deterministic_json() == base.deterministic_json()
    assert torch.equal(eng2.analysis, base_eng.analysis)


# ---------------------------------------------------------------------------
# Parareal window checkpoints -> sequential resume.
# ---------------------------------------------------------------------------

def test_window_checkpoint_resumes_sequentially(tmp_path):
    name, m, cycles, seed = "drifting_swarm", 120, 8, 0
    cfg = t_engine.EngineConfig(n=48, p=4, iters=30, time_windows=4,
                                pint_tol=1e-10)
    ck = str(tmp_path / "pint")
    tp = t_timepar.TimeParEngine(cfg, device="cpu")
    tp.run(t_streams.ResumableStream(name, m, cycles, seed=seed),
           checkpoint_dir=ck, snapshot_every=1)
    present = sorted(d for d in os.listdir(ck) if d.startswith("step_"))
    assert present == [f"step_{s:08d}" for s in (2, 4, 6, 8)]
    _, manifest = t_ckpt.restore_pytree(os.path.join(ck, "step_00000004"))
    assert manifest["metadata"]["pint"] == {"window": 1, "time_windows": 4}

    eng, stream = elastic.resume_assim_engine(
        os.path.join(ck, "step_00000004"), device="cpu")
    assert stream is not None and stream.pos == 4
    assert len(eng.journal.records) == 4
    eng.run(stream)
    assert len(eng.journal.records) == cycles
    for rr, rw in zip(eng.journal.records[4:], tp.journal.records[4:]):
        assert rr.loads == rw.loads
        assert rr.repartitioned == rw.repartitioned
    diff = float(torch.max(torch.abs(eng.analysis - tp.analysis)))
    assert diff < 1e-6, diff
