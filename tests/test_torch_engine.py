"""The port's streaming engine against the JAX package's, on the CPU.

Both engines run the same config and scenario (n = 64 or a 12 x 8 mesh,
m = 150, p = 4, 4 cycles) on the interval, shelf and k-d tree domains.
Per cycle, the host decisions are identical, the analyses agree within
1e-12 (same arithmetic; summation order differs by package) and so do
the recorded Schwarz residual histories.  Within the port, double
buffering on and off give identical journals.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.assim import engine as j_engine  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402

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


@pytest.mark.parametrize("kw,item", [
    (dict(solver="shardmap"), "item 11"), (dict(time_windows=2), "item 10")])
def test_unported_paths_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        t_engine.AssimilationEngine(t_engine.EngineConfig(**kw),
                                    device="cpu")
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        eng.run([], checkpoint_dir="ckpt", snapshot_every=1)
    with pytest.raises(NotImplementedError, match="item 8"):
        eng.snapshot()
