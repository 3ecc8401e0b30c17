"""The port's multi-tenant fleet server against the JAX package's, on the
CPU (the cases of ``tests/test_fleet.py`` and of the fleet half of
``tests/test_chaos.py`` that need no device mesh, at their sizes).

* ``quantize_capacity`` equals the reference's; ``cohort_key`` separates
  shapes and solver settings; ``CohortSolver`` pads a cohort of three to
  four and returns each member bitwise equal to its standalone solve.
* ``FleetServer`` gives every stream a journal and per-cycle analyses
  bitwise equal to the same stream run alone by ``AssimilationEngine``
  — two 1D streams; mixed shelf, k-d tree and 1D streams with residual
  recording and more streams than slots — and the reference's
  ``FleetServer`` makes the same host decisions with analyses within
  1e-12.
* ``add_stream`` validation; a prepare that raises retires its stream
  and frees the slot; retried pack and cohort-solve faults leave the
  journals bitwise; a crashed stream is readmitted from its snapshot and
  completes bitwise; a fleet snapshot resumes under the single engine.
* The mesh options' up-front checks (no rank meets another before
  them; the mesh runs are ``tests/test_torch_mesh_fleet.py``).
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.assim import FleetServer as JFleetServer  # noqa: E402
from repro.assim import engine as j_engine  # noqa: E402
from repro.assim import fleet as j_fleet  # noqa: E402
from repro.assim import streams as j_streams  # noqa: E402
from repro_torch.assim import AssimilationEngine, EngineConfig  # noqa: E402
from repro_torch.assim import FleetServer, streams  # noqa: E402
from repro_torch.assim import fleet as fleet_mod  # noqa: E402
from repro_torch.core import cls, dd, ddkf, dydd  # noqa: E402
from repro_torch.obs import meters as t_meters  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

HOST = ("loads", "loads_before", "loads_weighted", "repartitioned",
        "migrated", "rounds", "imbalance", "rebalance_suppressed",
        "comm_bytes_per_cycle")


@pytest.fixture()
def fresh_meters():
    prev = t_meters.get_meters()
    m = t_meters.Meters()
    t_meters.set_meters(m)
    yield m
    t_meters.set_meters(prev)


# ---------------------------------------------------------------------------
# Cohort machinery.
# ---------------------------------------------------------------------------

def test_quantize_capacity_matches_reference():
    for size in range(1, 20):
        for mult in (1, 2, 8):
            assert fleet_mod.quantize_capacity(size, mult) == \
                j_fleet.quantize_capacity(size, mult)
    assert fleet_mod.quantize_capacity(3) == 4
    with pytest.raises(ValueError):
        fleet_mod.quantize_capacity(0)


def _pack_problem(n=48, p=4, m=96, seed=0, obs_seed=0):
    rng = np.random.default_rng(obs_seed)
    obs = np.sort(rng.beta(2, 5, size=m))
    prob = cls.local_problem(np.random.default_rng(seed), n, obs,
                             device="cpu")
    dec = dd.decompose_1d(n, dydd.dydd_1d(obs, p).boundaries)
    return ddkf.pack(prob, dec)


def test_cohort_key_separates_shapes_and_statics():
    pk1 = _pack_problem(seed=0)
    pk2 = _pack_problem(seed=1)          # same shapes, different data
    pk3 = _pack_problem(n=64, seed=0)    # different n (and w)

    def k(pk, iters=40, damping=1.0, rec=False):
        return fleet_mod.cohort_key(pk, iters, damping, rec)

    assert k(pk1) == k(pk2)
    assert k(pk1) != k(pk3)
    assert k(pk1) != k(pk1, iters=60)
    assert k(pk1) != k(pk1, damping=0.7)
    assert k(pk1) != k(pk1, rec=True)


def test_cohort_solver_bitwise_vs_standalone(fresh_meters):
    packs = [_pack_problem(seed=s) for s in range(3)]
    seq = [ddkf.solve_vmapped(pk, iters=40, damping=0.8) for pk in packs]
    solver = fleet_mod.CohortSolver()
    key = fleet_mod.cohort_key(packs[0], 40, 0.8, False)
    res = solver.solve(key, packs)
    assert res.size == 3 and res.capacity == 4       # padded to 2**j
    for a, b in zip(res.xs, seq):
        assert torch.equal(a, b)
    # The capacity stays pinned when the cohort shrinks.
    res = solver.solve(key, packs[:1])
    assert res.capacity == 4 and torch.equal(res.xs[0], seq[0])
    counters = fresh_meters.snapshot()["counters"]
    assert counters["fleet.cohort.members"] == 4
    assert counters["fleet.cohort.padded_slots"] == 4


def test_mesh_options_name_item_13(tmp_path):
    """The fleet's mesh path checks what it is given before any rank
    meets another (a mesh stands in here: nothing reaches a
    collective): the axis exists, the server's engines run where the
    mesh's ranks do, and a cohort divides over the axis."""
    cpu8 = types.SimpleNamespace(shape={"fleet": 8},
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh has no axis 'data'"):
        fleet_mod.CohortSolver(mesh=cpu8, axis="data")
    assert fleet_mod.CohortSolver(mesh=cpu8).mult == 8
    with pytest.raises(ValueError, match="ranks run on cuda but"):
        FleetServer(mesh=types.SimpleNamespace(
            shape={"fleet": 8}, device=torch.device("cuda")), device="cpu")
    assert FleetServer(mesh=cpu8, device="cpu").solver.mult == 8
    pk = _pack_problem()
    with pytest.raises(ValueError, match="cohort size 3 does not divide "
                                         "over the 8-device 'fleet'"):
        ddkf.solve_fleet([pk] * 3, mesh=cpu8)
    with pytest.raises(ValueError, match="cohort size 6 does not divide"):
        ddkf.solve_fleet(ddkf.stack_packed([pk] * 6), mesh=cpu8)
    with pytest.raises(FileNotFoundError):
        elastic.resume_assim_engine(str(tmp_path), device="cpu", mesh=cpu8)


# ---------------------------------------------------------------------------
# FleetServer against standalone engines and the reference's server.
# ---------------------------------------------------------------------------

def _recorder(store):
    def forecast(x):
        store.append(x.clone())
        return x
    return forecast


def _sequential(specs):
    out = {}
    for sid, cfg_kw, (name, m, cycles, seed) in specs:
        rec = []
        eng = AssimilationEngine(EngineConfig(**cfg_kw), device="cpu",
                                 forecast=_recorder(rec))
        eng.run(streams.make_stream(name, m, cycles, seed=seed))
        out[sid] = (rec, eng.analysis, eng.journal)
    return out


def _fleet(specs, **server_kw):
    server = FleetServer(device="cpu", **server_kw)
    recs = {}
    for sid, cfg_kw, (name, m, cycles, seed) in specs:
        recs[sid] = []
        server.add_stream(sid, EngineConfig(**cfg_kw),
                          streams.make_stream(name, m, cycles, seed=seed),
                          forecast=_recorder(recs[sid]))
    return recs, server.serve(), server


def _reference_fleet(specs, **server_kw):
    server = JFleetServer(**server_kw)
    for sid, cfg_kw, (name, m, cycles, seed) in specs:
        server.add_stream(sid, j_engine.EngineConfig(**cfg_kw),
                          j_streams.make_stream(name, m, cycles, seed=seed))
    return server.serve(), server


def _assert_stream_parity(specs, seq, recs, journals, server):
    for sid, _, (_, _, cycles, _) in specs:
        rec_s, final_s, j_s = seq[sid]
        j_f = journals[sid]
        assert len(j_f) == len(j_s) == cycles
        assert len(recs[sid]) == len(rec_s)
        for a, b in zip(recs[sid], rec_s):
            assert torch.equal(a, b), sid
        assert torch.equal(server.engines[sid].analysis, final_s), sid
        assert j_f.deterministic_json() == j_s.deterministic_json(), sid


def _assert_reference_parity(specs, journals, server, j_journals,
                             j_server):
    for sid, _, _ in specs:
        for rt, rj in zip(journals[sid].records, j_journals[sid].records):
            for f in HOST:
                assert getattr(rt, f) == getattr(rj, f), (sid, f)
            np.testing.assert_allclose(rt.residual_history,
                                       rj.residual_history, rtol=0,
                                       atol=1e-12)
        np.testing.assert_allclose(server.engines[sid].analysis.numpy(),
                                   np.asarray(j_server.engines[sid].analysis),
                                   rtol=0, atol=1e-12)


def test_fleet_two_streams_bitwise_1d(fresh_meters):
    specs = [
        ("s0", dict(n=48, p=4, iters=30), ("drifting_swarm", 120, 3, 0)),
        ("s1", dict(n=48, p=4, iters=30), ("bursty_clusters", 120, 3, 1)),
    ]
    seq = _sequential(specs)
    recs, journals, server = _fleet(specs, max_active=2)
    _assert_stream_parity(specs, seq, recs, journals, server)
    assert server.stats["cycles"] == 6
    snap = fresh_meters.snapshot()
    assert snap["counters"]["fleet.cohort.dispatches"] >= 3
    assert "fleet.queue_depth" in snap["gauges"]
    _assert_reference_parity(specs, journals, server,
                             *_reference_fleet(specs, max_active=2))


def test_fleet_mixed_domains_bitwise_with_churn(fresh_meters):
    """2D shelf + kdtree + 1D with residual recording, more streams than
    slots, and two static streams that share a cohort key."""
    specs = [
        ("shelf", dict(ndim=2, nx=12, ny=8, pr=2, pc=2, iters=25),
         ("rotating_swarm", 200, 3, 1)),
        ("kdtree", dict(ndim=2, nx=16, ny=12, domain_kind="kdtree", p=4,
                        iters=25), ("satellite_track", 240, 3, 2)),
        ("hist", dict(n=64, p=4, iters=25, record_residuals=True),
         ("storm_front", 150, 3, 4)),
        ("line", dict(n=48, p=4, iters=25), ("drifting_swarm", 120, 4, 5)),
        ("static_a", dict(n=48, p=4, iters=25, rebalance=False),
         ("drifting_swarm", 120, 3, 6)),
        ("static_b", dict(n=48, p=4, iters=25, rebalance=False),
         ("drifting_swarm", 120, 3, 7)),
    ]
    seq = _sequential(specs)
    recs, journals, server = _fleet(specs, max_active=3, pack_workers=2,
                                    gather_window=0.2)
    _assert_stream_parity(specs, seq, recs, journals, server)
    snap = fresh_meters.snapshot()
    repacks = [e for e in snap["events"]
               if e["name"] == "fleet.dydd.repack"]
    assert repacks, "expected at least one DyDD repack in these streams"
    assert snap["counters"]["fleet.rounds"] == server.stats["rounds"]
    assert max(e["size"] for e in snap["events"]
               if e["name"] == "fleet.cohort") >= 2
    _assert_reference_parity(
        specs, journals, server,
        *_reference_fleet(specs, max_active=3, pack_workers=2))


def test_fleet_add_stream_validation():
    server = FleetServer(device="cpu")
    cfg = EngineConfig(n=32, p=2, iters=10)
    server.add_stream("a", cfg, [])
    with pytest.raises(ValueError, match="duplicate"):
        server.add_stream("a", cfg, [])
    with pytest.raises(ValueError, match="vmapped"):
        server.add_stream("b", EngineConfig(n=32, p=2, solver="shardmap"),
                          [])
    with pytest.raises(ValueError, match="pack_workers"):
        FleetServer(pack_workers=0, device="cpu")
    journals = server.serve()          # empty stream retires immediately
    assert len(journals["a"]) == 0
    assert server.stats["cycles"] == 0


# ---------------------------------------------------------------------------
# Failure paths.
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return EngineConfig(n=48, p=3, iters=6, **kw)


def _stream(cycles=6, seed=3, m=60):
    return streams.make_stream("drifting_swarm", m, cycles, seed=seed)


def test_fleet_prepare_failure_reclaims_slot(fresh_meters):
    server = FleetServer(max_active=1, pack_workers=2, gather_window=0.0,
                         device="cpu")
    # np.asarray("boom", float64) raises inside prepare on the pool.
    server.add_stream("bad", _cfg(), iter(["boom"]))
    server.add_stream("good", _cfg(), _stream(cycles=4, seed=1))
    journals = server.serve()
    assert len(journals["bad"]) == 0
    assert len(journals["good"]) == 4   # got the reclaimed slot
    assert server.scheduler.idle()
    snap = fresh_meters.snapshot()
    assert snap["counters"]["fleet.streams_failed"] == 1
    assert any(e["name"] == "fleet.stream_failed" and e["sid"] == "bad"
               for e in snap["events"])


def test_fleet_transient_pack_fault_retry_bitwise(fresh_meters):
    def run_fleet(with_chaos):
        server = FleetServer(pack_workers=2, gather_window=0.0,
                             retry_backoff=0.001, device="cpu")
        for i in range(2):
            inj = (chaos.ChaosInjector(
                chaos.ChaosConfig(pack_fault_cycles=(1, 3)))
                if with_chaos else None)
            server.add_stream(f"s{i}", _cfg(), _stream(cycles=5, seed=i),
                              chaos=inj)
        return server.serve()

    a, b = run_fleet(False), run_fleet(True)
    for sid in a:
        assert a[sid].deterministic_json() == b[sid].deterministic_json()
    assert fresh_meters.snapshot()["counters"]["chaos.retries"] >= 4


def test_fleet_cohort_solve_retry_bitwise(fresh_meters):
    def run_fleet(inj):
        server = FleetServer(pack_workers=2, gather_window=0.0,
                             retry_backoff=0.001, chaos=inj, device="cpu")
        for i in range(2):
            server.add_stream(f"s{i}", _cfg(), _stream(cycles=5, seed=i))
        return server.serve()

    a = run_fleet(None)
    b = run_fleet(chaos.ChaosInjector(
        chaos.ChaosConfig(solve_fault_cycles=(0, 2))))
    for sid in a:
        assert a[sid].deterministic_json() == b[sid].deterministic_json()
    assert fresh_meters.snapshot()["counters"]["chaos.retries"] >= 2


def test_fleet_snapshot_resume_bitwise(tmp_path, fresh_meters):
    cycles = 7
    base = AssimilationEngine(_cfg(), device="cpu").run(
        streams.ResumableStream("drifting_swarm", 60, cycles, seed=4))
    ck = str(tmp_path / "fleet")
    server = FleetServer(pack_workers=2, gather_window=0.0, device="cpu")
    server.add_stream("s", _cfg(),
                      streams.ResumableStream("drifting_swarm", 60, cycles,
                                              seed=4),
                      checkpoint_dir=ck, snapshot_every=3)
    fleet_j = server.serve()["s"]
    assert fleet_j.deterministic_json() == base.deterministic_json()
    # A fleet-taken snapshot continues bitwise under the single engine.
    eng2, stream2 = elastic.resume_assim_engine(
        os.path.join(ck, "step_00000003"), device="cpu")
    assert stream2.pos == 3
    j = eng2.run(stream2)
    assert j.deterministic_json() == base.deterministic_json()


def test_fleet_readmit_crashed_stream(fresh_meters, tmp_path):
    """A stream whose pack faults exhaust the retry budget is retired as
    failed; readmit() rebuilds it from its latest snapshot through the
    SlotScheduler and the completed journal and analysis are bitwise
    the uninterrupted run's."""
    cfg = EngineConfig(n=48, p=4, iters=25)
    name, m, cycles, seed = "drifting_swarm", 120, 6, 0

    eng_ref = AssimilationEngine(cfg, device="cpu")
    eng_ref.run(streams.make_stream(name, m, cycles, seed=seed))

    ckpt = str(tmp_path / "s0")
    inj = chaos.ChaosInjector(chaos.ChaosConfig(
        pack_fault_cycles=(3,), fail_every_attempt=True))
    server = FleetServer(max_active=2, max_retries=1, retry_backoff=0.0,
                         device="cpu")
    server.add_stream("s0", cfg,
                      streams.ResumableStream(name, m, cycles, seed=seed),
                      checkpoint_dir=ckpt, snapshot_every=1, chaos=inj)
    server.add_stream("side", cfg,
                      streams.make_stream("bursty_clusters", 120, 4,
                                          seed=1))
    journals = server.serve()
    assert len(journals["s0"]) == 3          # crashed before cycle 3
    assert len(journals["side"]) == 4

    with pytest.raises(ValueError, match="checkpoint_dir"):
        server.readmit("side")               # no snapshots configured
    with pytest.raises(KeyError):
        server.readmit("nope")

    server.readmit("s0")                     # fresh engine, no chaos
    with pytest.raises(ValueError, match="active or queued"):
        server.readmit("s0")                 # already back in the queue
    journals = server.serve()
    assert len(journals["s0"]) == cycles
    assert journals["s0"].deterministic_json() == \
        eng_ref.journal.deterministic_json()
    assert torch.equal(server.engines["s0"].analysis, eng_ref.analysis)
    assert server.engines["s0"].device.type == "cpu"

    snap = fresh_meters.snapshot()
    names = [e["name"] for e in snap["events"]]
    assert "fleet.stream_failed" in names
    assert snap["counters"]["fleet.streams_readmitted"] == 1
    re_ev = [e for e in snap["events"]
             if e["name"] == "fleet.stream_readmitted"][0]
    assert re_ev["sid"] == "s0" and re_ev["resume_cycle"] == 3
