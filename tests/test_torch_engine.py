"""The port's streaming engine against the JAX package's, on the CPU.

Both engines run the same config and scenario (n = 64 or a 12 x 8 mesh,
m = 150, p = 4, 4 cycles) on the interval, shelf and k-d tree domains.
Per cycle, the host decisions are identical, the analyses agree within
1e-12 (same arithmetic; summation order differs by package) and so do
the recorded Schwarz residual histories.  Within the port, double
buffering on and off give identical journals, and a run's snapshots
restore bitwise.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.assim import engine as j_engine  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402

CONFIGS = {
    "interval": (dict(n=64, p=4), "drifting_swarm"),
    "shelf": (dict(ndim=2, nx=12, ny=8, pr=2, pc=2, overlap=1,
                   damping=0.7), "rotating_swarm"),
    "kdtree": (dict(ndim=2, domain_kind="kdtree", nx=12, ny=8, p=4,
                    overlap=1, damping=0.7), "satellite_track"),
}
HOST_FIELDS = ("loads", "loads_before", "loads_weighted", "imbalance",
               "imbalance_before", "efficiency", "repartitioned",
               "migrated", "rounds", "rebalance_suppressed",
               "comm_bytes_per_cycle", "halo_fraction",
               "comm_edge_bytes_per_cycle", "comm_mvec_bytes_per_cycle",
               "comm_mvec_axis_bytes_per_cycle", "window")


def _run(module, kind, **kw):
    cfg_kw, scenario = CONFIGS[kind]
    cfg = module.EngineConfig(iters=120, track_reference=True, **cfg_kw,
                              **kw)
    eng = (module.AssimilationEngine(cfg, device="cpu")
           if module is t_engine else module.AssimilationEngine(cfg))
    xs = []
    eng.on_analysis = lambda cycle, x: xs.append(np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x))
    journal = eng.run_scenario(scenario, m=150, cycles=4, seed=3)
    return journal, xs


@pytest.mark.parametrize("kind", ["interval", "shelf", "kdtree"])
def test_engine_matches_reference(kind):
    jj, jx = _run(j_engine, kind, record_residuals=True)
    tj, tx = _run(t_engine, kind, record_residuals=True)
    assert jj.meta == tj.meta
    assert len(jj.records) == len(tj.records) == 4
    assert any(r.repartitioned for r in tj.records)
    for jr, tr in zip(jj.records, tj.records):
        for f in HOST_FIELDS:
            assert getattr(jr, f) == getattr(tr, f), (jr.cycle, f)
        assert tr.error_vs_direct < 1e-10
        assert len(tr.residual_history) == 120
        np.testing.assert_allclose(tr.residual_history,
                                   jr.residual_history, rtol=0, atol=1e-12)
    for a, b in zip(jx, tx):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["interval", "kdtree"])
def test_double_buffer_gives_identical_journals(kind):
    on, x_on = _run(t_engine, kind, double_buffer=True)
    off, x_off = _run(t_engine, kind, double_buffer=False)
    assert on.deterministic_json() == off.deterministic_json()
    for a, b in zip(x_on, x_off):
        assert np.array_equal(a, b)


def test_engine_config_matches_reference_fields():
    j_fields = {f.name for f in dataclasses.fields(j_engine.EngineConfig)}
    t_fields = {f.name for f in dataclasses.fields(t_engine.EngineConfig)}
    assert t_fields - j_fields == {"gram_mode"}
    assert j_fields <= t_fields


class _Mesh:
    """A stand-in for a mesh: the engine's up-front checks read only its
    ``shape`` (the sharded runs are in ``test_torch_shardmap.py``)."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("kw,mesh,match", [
    (dict(solver="shardmap"), None,
     "p=4 but the process group has 0 rank"),
    (dict(solver="shardmap"), _Mesh(sub=1),
     "p=4 but the given mesh has 1 device"),
    (dict(solver="shardmap", ndim=2, n=64, pr=2, pc=2),
     _Mesh(row=2, col=4), "p=4 but the given mesh has 8 device")])
def test_unported_paths_raise(kw, mesh, match):
    """``solver="shardmap"`` runs one rank per subdomain, and refuses up
    front a process group or a mesh with another number of ranks."""
    with pytest.raises(ValueError, match=match):
        t_engine.AssimilationEngine(t_engine.EngineConfig(**kw),
                                    device="cpu", mesh=mesh)


def test_shardmap_mesh_check_matches_reference():
    """A mesh of the wrong size is refused with the reference's words."""
    import jax
    with pytest.raises(ValueError) as ref:
        j_engine.AssimilationEngine(
            j_engine.EngineConfig(solver="shardmap"),
            mesh=jax.make_mesh((1,), ("sub",)))
    with pytest.raises(ValueError) as port:
        t_engine.AssimilationEngine(t_engine.EngineConfig(solver="shardmap"),
                                    device="cpu", mesh=_Mesh(sub=1))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [dict(time_windows=2),
                                dict(time_windows=4, pint_max_iters=0,
                                     pint_coarse_iters=3, pint_fine_iters=5)])
def test_engine_accepts_time_windows_as_the_reference_does(kw):
    """The sequential engine validates the Parareal settings and runs
    its cycles in order whatever they are, as the reference's does
    (``TimeParEngine`` reads them)."""
    cfg_kw = dict(n=32, p=2, iters=20, **kw)
    ref = j_engine.AssimilationEngine(j_engine.EngineConfig(**cfg_kw))
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(**cfg_kw),
                                      device="cpu")
    jj = ref.run_scenario("drifting_swarm", m=60, cycles=2, seed=1)
    tj = eng.run_scenario("drifting_swarm", m=60, cycles=2, seed=1)
    assert [r.loads for r in tj.records] == [r.loads for r in jj.records]
    assert [r.window for r in tj.records] == [-1, -1]
    assert "pint" not in tj.meta


@pytest.mark.parametrize("kw,field", [(dict(time_windows=0), "time_windows"),
                                      (dict(pint_tol=0.0), "pint_tol")])
def test_engine_rejects_bad_parareal_settings(kw, field):
    with pytest.raises(ValueError, match=field):
        j_engine.AssimilationEngine(j_engine.EngineConfig(**kw))
    with pytest.raises(ValueError, match=field):
        t_engine.AssimilationEngine(t_engine.EngineConfig(**kw),
                                    device="cpu")


def test_checkpoints_and_snapshots_still_raise_item_10(tmp_path):
    """Checkpoints, snapshots and restore no longer raise the refusal
    that named ROADMAP.md Queue 1 item 10: a run saves its snapshots, a
    snapshot is in the reference's format, and restore continues the
    stream bitwise."""
    cfg = t_engine.EngineConfig(n=32, p=2, iters=10)
    eng = t_engine.AssimilationEngine(cfg, device="cpu")
    ck = str(tmp_path / "ck")
    eng.run(t_streams.ResumableStream("drifting_swarm", 60, 3, seed=1),
            checkpoint_dir=ck, snapshot_every=1)
    assert sorted(os.listdir(ck)) == [f"step_{s:08d}" for s in (1, 2, 3)]
    tree, meta = eng.snapshot()
    assert set(meta["config"]) == {
        f.name for f in dataclasses.fields(j_engine.EngineConfig)}
    assert meta["config_port"] == {"gram_mode": "auto"}
    assert meta["autotune"] == {"gram": [], "schwarz": []}
    assert np.array_equal(tree["analysis"], eng.analysis.numpy())
    back = t_engine.AssimilationEngine.restore(ck, device="cpu")
    assert torch.equal(back.analysis, eng.analysis)
    assert back.journal.deterministic_json() == \
        eng.journal.deterministic_json()
    assert back.resume_stream().remaining() == 0


def test_host_state_and_reset_clock():
    """``host_state`` copies what ``prepare`` advances, with the cursor of
    a resumable stream; ``reset_clock`` restarts the cycle clock."""
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(n=32, p=2,
                                                            iters=10),
                                      device="cpu")
    assert eng.host_state()["cursor"] is None
    stream = t_streams.ResumableStream("drifting_swarm", 60, 2)
    eng.run(stream)
    hs = eng.host_state()
    assert hs["cursor"]["pos"] == 2 and np.array_equal(hs["truth"],
                                                       eng._truth)
    hs["truth"][:] = 0.0
    assert not np.array_equal(hs["truth"], eng._truth)
    before = eng._t_last
    eng.reset_clock()
    assert eng._t_last >= before
