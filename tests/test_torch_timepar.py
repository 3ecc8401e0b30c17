"""The port's Parareal engine and fleet solve against the JAX package's.

* ``window_bounds`` equals the reference's; both engines validate the
  ``time_windows``/``pint_*`` settings alike.
* ``ddkf.pad_packed_width`` pads every field as the reference does (one
  reference packing carried across with ``convert.packed_from_numpy``),
  rebuilds ``owner_slots``, and solves within 1e-13 of the unpadded
  packing (only reduction extents change).
* ``ddkf.stack_packed`` + ``ddkf.solve_fleet`` equal per-problem
  ``solve_vmapped`` calls bitwise, with and without warm starts.
* ``TimeParEngine`` against the reference ``TimeParEngine`` on the
  interval case ``(n=48, p=4, iters=30)``, the shelf case of
  ``tests/test_timepar.py`` and a warm-started interval case: the host
  decisions and window tags equal, the same Parareal iteration count,
  each cycle's analysis within 1e-10 of the reference's (measured:
  1.8e-15; the sequential engines agree to 1e-12) and within 1e-6 of the
  port's own sequential chain (the reference's bound).
* Both degenerate settings are the port's sequential engine, bitwise.
* The ("time", "sub") mesh is checked up front (its runs are in
  ``tests/test_torch_shardmap.py``); ``solve_fleet(mesh=...)`` refuses
  up front a cohort that does not divide over the axis, a warm start and
  a missing axis (its runs are in ``tests/test_torch_mesh_fleet.py``);
  fault injection retries
  bitwise and window checkpoints are saved (their resume is held in
  ``tests/test_torch_chaos.py``).
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assim import engine as j_engine  # noqa: E402
from repro.assim import streams as j_streams  # noqa: E402
from repro.assim import timepar as j_timepar  # noqa: E402
from repro.core import cls as j_cls  # noqa: E402
from repro.core import dd as j_dd  # noqa: E402
from repro.core import ddkf as j_ddkf  # noqa: E402
from repro.core import dydd as j_dydd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.assim import timepar as t_timepar  # noqa: E402
from repro_torch.core import cls as t_cls  # noqa: E402
from repro_torch.core import dd as t_dd  # noqa: E402
from repro_torch.core import ddkf as t_ddkf  # noqa: E402
from repro_torch.core import dydd as t_dydd  # noqa: E402

DATA_FIELDS = ("A_loc", "L_loc", "cols", "mask", "muov", "wdiv", "mult",
               "mult_loc", "scatter_cols", "gather_cols", "r", "b")
HOST_FIELDS = ("loads", "loads_before", "loads_weighted", "imbalance",
               "imbalance_before", "efficiency", "repartitioned",
               "migrated", "rounds", "rebalance_suppressed",
               "comm_bytes_per_cycle", "halo_fraction",
               "comm_edge_bytes_per_cycle", "comm_mvec_bytes_per_cycle",
               "comm_mvec_axis_bytes_per_cycle", "window")


# ---------------------------------------------------------------------------
# Window partition and config validation.
# ---------------------------------------------------------------------------

def test_window_bounds_match_reference():
    for cycles in range(1, 13):
        for windows in range(1, 10):
            assert t_timepar.window_bounds(cycles, windows) == \
                j_timepar.window_bounds(cycles, windows), (cycles, windows)
    assert t_timepar.window_bounds(7, 3) == [0, 2, 4, 7]


@pytest.mark.parametrize("kw,field", [
    (dict(time_windows=0), "time_windows"), (dict(pint_tol=0.0), "pint_tol"),
    (dict(pint_max_iters=-1), "pint_max_iters"),
    (dict(pint_fine_iters=-2), "pint_fine_iters")])
def test_config_validation_matches_reference(kw, field):
    with pytest.raises(ValueError, match=field):
        j_engine.AssimilationEngine(j_engine.EngineConfig(n=32, p=2, **kw))
    for make in (t_engine.AssimilationEngine, t_timepar.TimeParEngine):
        with pytest.raises(ValueError, match=field):
            make(t_engine.EngineConfig(n=32, p=2, **kw), device="cpu")


# ---------------------------------------------------------------------------
# Padding, stacking and the fleet solve.
# ---------------------------------------------------------------------------

def _packing(seed=0, n=64, p=4, overlap=1, obs_n=200):
    """(reference packing, the same packing in the port) of a local
    problem on DyDD boundaries."""
    rng = np.random.default_rng(seed)
    obs = np.sort(rng.beta(2, 5, size=obs_n))
    H0 = j_cls.state_operator(n)
    H1 = j_cls.observation_operator(n, obs)
    x_true = rng.normal(size=n)
    y = np.concatenate([H0, H1]) @ x_true + 1e-3 * rng.normal(
        size=H0.shape[0] + obs_n)
    A = np.concatenate([H0, H1])
    jdec = j_dd.decompose_1d(n, j_dydd.dydd_1d(obs, p).boundaries,
                             overlap=overlap)
    jp = j_ddkf.with_rhs(j_ddkf.pack_operator(
        jnp.asarray(A), jnp.ones(A.shape[0]), jdec, solver_kernel="jnp"),
        jnp.asarray(y))
    tp = convert.packed_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in DATA_FIELDS},
        {"n": jp.n, "p": jp.p, "w": jp.w, "solve_kernel": "jnp"},
        device="cpu")
    return jp, tp


def test_pad_packed_width_matches_reference():
    jp, tp = _packing()
    w_new = tp.w + 5
    jq, tq = j_ddkf.pad_packed_width(jp, w_new), \
        t_ddkf.pad_packed_width(tp, w_new)
    assert (tq.w, tq.n, tq.p, tq.m) == (jq.w, jq.n, jq.p, jq.m) == \
        (w_new, tp.n, tp.p, tp.m)
    for f in DATA_FIELDS:
        want, got = np.asarray(getattr(jq, f)), np.asarray(getattr(tq, f))
        assert got.shape == want.shape and np.array_equal(got, want), f
    # owner_slots is rebuilt for the new width: dump slot p * w_new.
    assert np.array_equal(tq.owner_slots.numpy(),
                          t_ddkf.owner_slots(tq.scatter_cols, tq.n))
    assert int(tq.owner_slots.max()) == tq.p * w_new
    # The padded slots solve to zero; the estimate moves by rounding.
    for kern in ("plain", "fused"):
        a = t_ddkf.solve_vmapped(dataclasses.replace(tp, solve_kernel=kern),
                                 iters=60)
        b = t_ddkf.solve_vmapped(dataclasses.replace(tq, solve_kernel=kern),
                                 iters=60)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-13)
    assert t_ddkf.pad_packed_width(tp, tp.w) is tp
    with pytest.raises(ValueError, match="shrink"):
        t_ddkf.pad_packed_width(tp, tp.w - 1)


def _fleet(overlap):
    """Three same-shape packings of different problems: the second with
    other data, the third from another decomposition padded to the
    common width (its owner_slots may be narrower)."""
    _, a = _packing(seed=0, overlap=overlap)
    _, b = _packing(seed=1, overlap=overlap)
    _, c = _packing(seed=2, overlap=0)
    w = max(pk.w for pk in (a, b, c))
    return [t_ddkf.pad_packed_width(pk, w) for pk in (a, b, c)]


@pytest.mark.parametrize("overlap", [0, 2])
def test_solve_fleet_equals_standalone_solves(overlap):
    packs = _fleet(overlap)
    stacked = t_ddkf.stack_packed(packs)
    assert stacked.A_loc.shape == (3,) + tuple(packs[0].A_loc.shape)
    assert isinstance(stacked.cols, np.ndarray)
    x0 = np.random.default_rng(5).normal(size=(3, packs[0].n))
    for kern in ("plain", "fused"):
        st = dataclasses.replace(stacked, solve_kernel=kern)
        xs = t_ddkf.solve_fleet(st, iters=40, damping=0.8)
        xh, hist = t_ddkf.solve_fleet(st, iters=40, damping=0.8,
                                      residual_history=True)
        xw = t_ddkf.solve_fleet(st, iters=10, x0=torch.as_tensor(x0))
        assert hist.shape == (3, 40)
        for s, pk in enumerate(packs):
            pk = dataclasses.replace(pk, solve_kernel=kern)
            alone = t_ddkf.solve_vmapped(pk, iters=40, damping=0.8)
            assert torch.equal(xs[s], alone) and torch.equal(xh[s], alone)
            _, h = t_ddkf.solve_vmapped(pk, iters=40, damping=0.8,
                                        residual_history=True)
            assert torch.equal(hist[s], h)
            assert torch.equal(xw[s], t_ddkf.solve_vmapped(
                pk, iters=10, x0=x0[s]))


def test_stack_packed_refuses_mixed_shapes():
    _, a = _packing(seed=0)
    _, b = _packing(seed=1, n=48)
    with pytest.raises(ValueError, match="cohorts"):
        t_ddkf.stack_packed([a, b])
    with pytest.raises(ValueError, match="cohorts"):
        t_ddkf.stack_packed([a, dataclasses.replace(a, solve_kernel="fused")])
    with pytest.raises(ValueError, match="at least one"):
        t_ddkf.stack_packed([])
    # The mesh path's up-front checks (a mesh stands in: nothing reaches
    # a collective): the cohort divides over the axis, no warm start.
    mesh = types.SimpleNamespace(shape={"fleet": 2})
    with pytest.raises(ValueError, match="cohort size 3 does not divide "
                                         "over the 2-device 'fleet'"):
        t_ddkf.solve_fleet(t_ddkf.stack_packed([a] * 3), mesh=mesh)
    with pytest.raises(NotImplementedError, match="single-device only"):
        t_ddkf.solve_fleet([a, a], mesh=mesh, x0=torch.zeros(2, a.n))
    with pytest.raises(ValueError, match="mesh has no axis 'fleet'"):
        t_ddkf.solve_fleet([a, a], mesh=types.SimpleNamespace(
            shape={"sub": 2}))


def test_solver_warm_start_from_converged_state():
    """``x0=`` on the solve entry points (``tests/test_timepar.py``'s
    check): restarting from a converged estimate reproduces it, an
    all-zero x0 is bitwise the cold start, and the fleet path threads
    per-problem warm starts."""
    rng = np.random.default_rng(0)
    obs = np.sort(rng.beta(2, 5, size=200))
    prob = t_cls.local_problem(rng, 64, obs, device="cpu")
    dec = t_dd.decompose_1d(64, t_dydd.dydd_1d(obs, 4).boundaries,
                            overlap=1)
    pk = t_ddkf.pack(prob, dec)
    x_full = t_ddkf.solve_vmapped(pk, iters=200)
    x_warm = t_ddkf.solve_vmapped(pk, iters=20, x0=x_full)
    assert float(torch.max(torch.abs(x_warm - x_full))) < 1e-10
    x_cold = t_ddkf.solve_vmapped(pk, iters=40)
    x_zero = t_ddkf.solve_vmapped(pk, iters=40, x0=np.zeros(64))
    assert torch.equal(x_cold, x_zero)
    xs = t_ddkf.solve_fleet(t_ddkf.stack_packed([pk, pk]), iters=20,
                            x0=torch.stack([x_full, x_full]))
    assert float(torch.max(torch.abs(xs - x_full[None]))) < 1e-10


# ---------------------------------------------------------------------------
# The Parareal engine against the reference.
# ---------------------------------------------------------------------------

CASES = {
    "interval": (dict(n=48, p=4, iters=30), ("drifting_swarm", 120, 8, 0)),
    "shelf": (dict(ndim=2, nx=12, ny=8, pr=2, pc=2, iters=25),
              ("rotating_swarm", 200, 8, 1)),
    "interval_warm": (dict(n=48, p=4, iters=300, pint_coarse_iters=30,
                           pint_fine_iters=150),
                      ("drifting_swarm", 120, 8, 0)),
}


def _port_sequential(cfg_kw, spec):
    name, m, cycles, seed = spec
    eng = t_engine.AssimilationEngine(t_engine.EngineConfig(**cfg_kw),
                                      device="cpu")
    chain = []
    eng.on_analysis = lambda cycle, x: chain.append(x.numpy())
    eng.run(t_streams.make_stream(name, m, cycles, seed=seed))
    return eng, chain


@pytest.mark.parametrize("case", list(CASES))
def test_timepar_matches_reference(case):
    cfg_kw, (name, m, cycles, seed) = CASES[case]
    cfg_kw = dict(cfg_kw, time_windows=4, pint_tol=1e-8)
    jt = j_timepar.TimeParEngine(j_engine.EngineConfig(**cfg_kw))
    jj = jt.run(j_streams.make_stream(name, m, cycles, seed=seed))
    tt = t_timepar.TimeParEngine(t_engine.EngineConfig(**cfg_kw),
                                 device="cpu")
    tj = tt.run(t_streams.ResumableStream(name, m, cycles, seed=seed))

    jp, tp = jj.meta["pint"], tj.meta["pint"]
    assert tp["mesh"] is None and jp["mesh"] == {"time": 1, "sub": 1}
    for key in jp:
        if key not in ("mesh", "correction_norms"):
            assert tp[key] == jp[key], key
    assert tp["converged"] and tp["correction_norms"][-1] <= 1e-8
    np.testing.assert_allclose(tp["correction_norms"],
                               jp["correction_norms"], rtol=0, atol=1e-10)
    assert len(tj.records) == len(jj.records) == cycles
    for jr, tr in zip(jj.records, tj.records):
        for f in HOST_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), (tr.cycle, f)
    assert [r.window for r in tj.records] == [
        w for w, n in enumerate(tp["window_sizes"]) for _ in range(n)]
    assert len(tt.analyses) == cycles
    for a, b in zip(jt.analyses, tt.analyses):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-10)
    # The window-boundary host states: the stream cursor rewound to each
    # boundary, the last one equal to the sequential engine's end state.
    seq, chain = _port_sequential(
        {k: v for k, v in cfg_kw.items() if not k.startswith("pint")
         and k != "time_windows"}, (name, m, cycles, seed))
    ends = np.cumsum(tp["window_sizes"])
    assert [tt.window_host[w]["cursor"]["pos"] for w in range(4)] == \
        list(ends)
    assert np.array_equal(tt.window_host[3]["truth"], seq._truth)
    diff = max(float(np.max(np.abs(a - b)))
               for a, b in zip(tt.analyses, chain))
    assert diff < 1e-6, diff


@pytest.mark.parametrize("degenerate_kw", [dict(time_windows=1),
                                           dict(pint_max_iters=0)],
                         ids=["one_window", "zero_iters"])
def test_degenerate_is_bitwise_sequential(degenerate_kw):
    name, m, cycles, seed = "bursty_clusters", 120, 5, 3
    base = dict(n=48, p=4, iters=30)
    ref, chain = _port_sequential(base, (name, m, cycles, seed))
    tp = t_timepar.TimeParEngine(t_engine.EngineConfig(
        **base, **{"time_windows": 4, **degenerate_kw}), device="cpu")
    tp.run(t_streams.make_stream(name, m, cycles, seed=seed))
    assert "pint" not in tp.journal.meta
    assert tp.journal.deterministic_json() == \
        ref.journal.deterministic_json()
    assert torch.equal(tp.analysis, ref.analysis)
    assert all(np.array_equal(a, b) for a, b in zip(tp.analyses, chain))


class _Mesh:
    """A stand-in for a mesh: the engine's up-front checks read only its
    ``shape`` (the runs on a process mesh are in
    ``test_torch_shardmap.py``)."""

    def __init__(self, **shape):
        self.shape = shape


def test_unported_options_name_their_items(tmp_path):
    """The ("time", "sub") mesh is checked up front (both axes, p over
    ``sub``); fault injection and window checkpoints now run: a retried
    pack fault leaves the journal bitwise, and each window boundary
    saves."""
    from repro_torch.runtime import chaos as t_chaos
    cfg = t_engine.EngineConfig(n=32, p=2, iters=10, time_windows=2)
    with pytest.raises(ValueError, match="missing the 'time' axis"):
        t_timepar.TimeParEngine(cfg, device="cpu", mesh=_Mesh(sub=2))
    with pytest.raises(ValueError,
                       match="do not divide over the 4-device 'sub'"):
        t_timepar.TimeParEngine(cfg, device="cpu",
                                mesh=_Mesh(time=2, sub=4))
    base = t_timepar.TimeParEngine(cfg, device="cpu")
    base.run(t_streams.make_stream("drifting_swarm", 50, 2))
    inj = t_chaos.ChaosInjector(t_chaos.ChaosConfig(pack_fault_cycles=(1,)))
    tp = t_timepar.TimeParEngine(cfg, device="cpu", chaos=inj)
    ck = str(tmp_path / "ck")
    tp.run(t_streams.ResumableStream("drifting_swarm", 50, 2),
           checkpoint_dir=ck, snapshot_every=1)
    assert [(r["site"], r["cycle"]) for r in inj.injections] == \
        [("pack", 1)]
    assert tp.journal.deterministic_json() == \
        base.journal.deterministic_json()
    assert sorted(os.listdir(ck)) == ["step_00000001", "step_00000002"]
