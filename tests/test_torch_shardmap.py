"""The port's distributed DD-KF against the JAX package's, on CPU ranks.

``repro_torch.runtime.mesh.launch`` spawns eight ranks that join over
gloo on the CPU, once for every case below; each runs the port's ``solve_shardmap``, the engine's
``solver="shardmap"`` or the Parareal engine's ("time", "sub") mesh on
its share (``tests/_torch_shardmap_ranks.py``).  The inputs are made
here, once, with numpy and the reference, and what the ranks return is
held here to the reference:

* the reference's ``SCRIPT``, ``SCRIPT_2D`` and ``SCRIPT_KDTREE`` checks
  (``tests/test_ddkf_multidevice.py``) at their bounds: within 1e-9 of
  the reference's ``cls.solve``, 1e-13 between the exchange, m-vector
  and step paths, and 1e-13 to the reference's ``solve_vmapped`` on the
  same packing; a rank's block equals the rows of the whole packing bit
  for bit; a neighbour solve makes ``halo.rounds`` exchanges an
  iteration; every rank returns the same bits;
* ``SCRIPT_ENGINE`` (and the k-d tree engine runs): loads and
  repartitions equal to the reference's vmapped journal, the neighbour
  exchange journals fewer bytes than the allreduce one, and every rank's
  deterministic journal and analyses are the same;
* ``SCRIPT_TIMEPAR``: the auto mesh is {"time": 4, "sub": 2}, Parareal
  converges within 1e-6 of the sequential chain, in as many iterations
  as the reference's own mesh run (a subprocess with eight forced XLA
  host devices), whose analyses it matches within 1e-10;
* the checks that refuse a world size other than p, a missing axis and
  p not dividing over ``sub``, and the CLI's ``--solver shardmap`` at
  p = 2.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.assim import engine as j_engine  # noqa: E402
from repro.assim import streams as j_streams  # noqa: E402
from repro.core import cls as j_cls  # noqa: E402
from repro.core import dd as j_dd  # noqa: E402
from repro.core import ddkf as j_ddkf  # noqa: E402
from repro.core import dydd as j_dydd  # noqa: E402
from repro.core import dydd2d as j_dydd2d  # noqa: E402
from repro.core import domain as j_domain  # noqa: E402
from repro.core import kdtree as j_kdtree  # noqa: E402
from repro_torch.assim import engine as t_engine  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402

import _torch_shardmap_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 8
DATA_FIELDS = ("A_loc", "L_loc", "cols", "mask", "muov", "wdiv", "mult",
               "mult_loc", "scatter_cols", "gather_cols", "r", "b")


def _arrays(prob) -> dict:
    return {k: np.asarray(getattr(prob, k))
            for k in ("H0", "y0", "H1", "y1", "R0", "R1")}


def _packed(pk) -> tuple:
    return ({f: np.asarray(getattr(pk, f)) for f in DATA_FIELDS},
            {"n": pk.n, "p": pk.p, "w": pk.w,
             "solve_kernel": pk.solve_kernel})


def _solve_cases() -> list:
    """The problems of SCRIPT (1D chain, overlap 0 and 2), SCRIPT_2D (2 x
    4 shelf, overlap 1) and SCRIPT_KDTREE (8-leaf k-d tree, overlap 1),
    with the reference's packings, direct solves and vmapped solves."""
    cases = []
    rng = np.random.default_rng(0)
    obs = rng.beta(2, 5, size=400)
    prob = j_cls.local_problem(jax.random.PRNGKey(0), 128, obs)
    res = j_dydd.dydd_1d(obs, 8)
    decs = {ov: j_dd.decompose_1d(prob.n, res.boundaries, overlap=ov)
            for ov in (0, 2)}
    cases.append(dict(name="1d", kind="interval", n=prob.n,
                      boundaries=np.asarray(res.boundaries),
                      mesh=(("sub",), (8,)), iters=120, damping=1.0,
                      prob=prob, decs=decs))

    ny, nx = 8, 16
    n = nx * ny
    dom = j_domain.ShelfTiling2D(nx=nx, ny=ny, pr=2, pc=4)
    obs2 = j_dydd2d.make_observations_2d(400, kind="clustered", seed=4)
    dom.rebalance(obs2)
    raster = (np.clip((obs2[:, 1] * ny).astype(int), 0, ny - 1) * nx
              + np.clip((obs2[:, 0] * nx).astype(int), 0, nx - 1)
              + 0.5) / n
    cases.append(dict(name="2d", kind="shelf",
                      prob=j_cls.local_problem(jax.random.PRNGKey(0), n,
                                               np.sort(raster)),
                      mesh=(("row", "col"), (2, 4)), iters=200,
                      damping=0.7, dom=dom,
                      decs={1: dom.decomposition(overlap=1)}))

    kdom = j_kdtree.KDTreeDomain(nx=16, ny=8, p=8)
    obs3 = next(iter(j_streams.make_stream("satellite_track", 400, 1,
                                           seed=3)))
    kdom.rebalance(obs3)
    kdec = kdom.decomposition(overlap=1)
    assert len(kdec.halo_exchange.edges) > 7       # more than a chain
    cases.append(dict(name="kdtree", kind="kdtree",
                      prob=j_cls.local_problem(
                          jax.random.PRNGKey(0), kdom.n,
                          np.sort(kdom.obs_positions(obs3))),
                      mesh=(("sub",), (8,)), iters=200, damping=0.7,
                      dom=kdom, decs={1: kdec}))
    for c in cases:
        c["direct"] = np.asarray(j_cls.solve(c["prob"]))
        ref = {ov: j_ddkf.pack(c["prob"], dec) for ov, dec in
               c["decs"].items()}
        c["ref_short"] = {ov: np.asarray(j_ddkf.solve_vmapped(
            pk, iters=ranks.SHORT, damping=c["damping"]))
            for ov, pk in ref.items()}
        c["ref_packed"] = {ov: _packed(pk) for ov, pk in ref.items()}
        c["overlaps"] = tuple(c["decs"])
        c["problem"] = _arrays(c["prob"])
        if "dom" in c:
            c["describe"] = c["dom"].describe()
            c["state"] = {k: np.asarray(v)
                          for k, v in c["dom"].state_dict().items()}
    return cases


def _for_ranks(case: dict) -> dict:
    keep = ("name", "kind", "n", "boundaries", "mesh", "iters", "damping",
            "overlaps", "problem", "ref_packed", "describe", "state")
    return {k: case[k] for k in keep if k in case}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of eight CPU ranks for every case of this file, with
    the reference's own mesh Parareal in a process of its own
    meanwhile."""
    ref_out = str(tmp_path_factory.mktemp("ref") / "timepar.npz")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", REF_TIMEPAR, ref_out],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        cases = _solve_cases()
        out = t_mesh.launch(ranks.all_cases, RANKS, backend="gloo",
                            device="cpu",
                            args=([_for_ranks(c) for c in cases],
                                  ENGINE_RUNS, TIMEPAR))
    finally:
        log = ref.communicate(timeout=600)[0]
    assert ref.returncode == 0, log[-2000:]
    with np.load(ref_out) as z:
        ref_tp = {"analyses": z["analyses"], "iters": int(z["iters"])}
    return cases, out, ref_tp


@pytest.fixture(scope="module")
def solved(launched):
    return launched[:2]


def _max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("name", ["1d", "2d", "kdtree"])
def test_solve_shardmap_matches_reference(solved, name):
    cases, out = solved
    case = next(c for c in cases if c["name"] == name)
    for ov in case["overlaps"]:
        res = [o[name][ov] for o in out]
        r0 = res[0]
        keys = [k for k, v in r0.items() if isinstance(v, torch.Tensor)]
        # Every rank ends with the same bits.
        for r in res[1:]:
            for k in keys:
                assert torch.equal(r[k], r0[k]), (name, ov, k)
        x = r0["x"].numpy()
        assert x.shape == (case["prob"].n,) and np.isfinite(x).all()
        assert float(np.linalg.norm(x - case["direct"])) < 1e-9
        assert _max(r0["x_ref_pack"], case["ref_short"][ov]) < 1e-13
        for k in ("x_psum", "x_fused"):
            assert _max(r0[k], r0["x_short"]) < 1e-13, k
        assert torch.equal(r0["x_whole"], r0["x_short"])
        assert r0["hist"].shape == (ranks.SHORT,)
        assert all(len(r["times"]) == RANKS for r in res)
        if ov:
            assert _max(r0["x_neighbour"], r0["x"]) < 1e-13
            assert float(np.linalg.norm(
                r0["x_neighbour"].numpy() - case["direct"])) < 1e-9


@pytest.mark.parametrize("name", ["1d", "2d", "kdtree"])
def test_rank_block_equals_the_whole_packing_rows(solved, name):
    cases, out = solved
    case = next(c for c in cases if c["name"] == name)
    for ov in case["overlaps"]:
        assert all(o[name][ov]["block_equal"] for o in out)


@pytest.mark.parametrize("name", ["1d", "2d", "kdtree"])
def test_neighbour_exchange_runs_halo_rounds_an_iteration(solved, name):
    cases, out = solved
    case = next(c for c in cases if c["name"] == name)
    ov = max(case["overlaps"])
    for o in out:
        res = o[name][ov]
        assert res["rounds"] == case["decs"][ov].halo_exchange.rounds
        assert res["ppermutes"] == case["iters"] * res["rounds"]


@pytest.mark.parametrize("key,match", [
    ("p_mismatch", "have 8 devices but the packing has p=4"),
    ("missing_axis", "mesh has no axis 'row'"),
    ("engine_world", "p=4 but the process group has 8 rank"),
    ("timepar_axis", "missing the 'time' axis"),
    ("timepar_sub", "p=2 subdomains do not divide over the 4-device"),
])
def test_distributed_checks_refuse(solved, key, match):
    _, out = solved
    for o in out:
        assert match in o["errors"][key], o["errors"][key]
    assert all("holds subdomains 0..0" in o["errors"]["wrong_block"]
               for o in out[1:])
    assert {o["transport"] for o in out} == {"direct"}


def test_mesh_groups_are_row_major(solved):
    """On a ("time": 2, "sub": 4) mesh rank r sits at (r // 4, r % 4): its
    "time" group is {r % 4, r % 4 + 4}, its "sub" group the four ranks of
    its row, both axes the whole world; ``group`` is that process
    group."""
    _, out = solved
    for r, o in enumerate(out):
        g = o["groups"]
        assert g["time"] == ([r % 4, r % 4 + 4],) * 2 + (r // 4,)
        row = list(range(4 * (r // 4), 4 * (r // 4) + 4))
        assert g["sub"] == (row, row, r % 4)
        assert g[("time", "sub")] == (list(range(8)), list(range(8)), r)


def test_launch_and_mesh_refuse_without_a_group_or_with_nccl_on_one_card():
    with pytest.raises(RuntimeError, match="initialised default process"):
        t_mesh.ProcessMesh((2,), ("sub",), device="cpu")
    with pytest.raises(ValueError, match="runs on the card only"):
        t_mesh.launch(ranks.engine_cases, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        t_mesh.check_launch(8, "nccl", torch.device("cuda"))
    with pytest.raises(ValueError, match="backend must be one of"):
        t_mesh.check_launch(2, "mpi", torch.device("cpu"))
    assert t_mesh.transport_for("gloo", torch.device("cuda")) == "host"


# ---------------------------------------------------------------------------
# The engines.
# ---------------------------------------------------------------------------

ENGINE_RUNS = (
    ("shelf", dict(ndim=2, nx=16, ny=8, pr=2, pc=4, iters=200, damping=0.7,
                   overlap=1, imbalance_threshold=1.5), "rotating_swarm",
     160, 2),
    # SCRIPT_KDTREE's engine runs, at 60 of its 200 iterations: the host
    # decisions do not depend on them (the analyses are held to the
    # port's vmapped engine at the same count).
    ("kdtree", dict(ndim=2, domain_kind="kdtree", p=8, nx=16, ny=8,
                    iters=60, damping=0.7, overlap=1,
                    imbalance_threshold=1.5), "satellite_track", 160, 2),
)
TIMEPAR = {"kw": dict(n=64, p=2, iters=60, time_windows=4, pint_tol=1e-8),
           "scenario": "drifting_swarm", "m": 160, "cycles": 12}

REF_TIMEPAR = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.assim import EngineConfig, streams
from repro.assim.timepar import TimeParEngine

kw = dict(n=64, p=2, iters=60, time_windows=4, pint_tol=1e-8)
tp = TimeParEngine(EngineConfig(**kw))
journal = tp.run(streams.make_stream("drifting_swarm", 160, 12, seed=0))
pint = journal.meta["pint"]
assert pint["mesh"] == {"time": 4, "sub": 2}, pint["mesh"]
np.savez(sys.argv[1], analyses=np.stack(tp.analyses),
         iters=pint["iters"])
"""


@pytest.fixture(scope="module")
def engines(launched):
    return launched[1:]


@pytest.mark.parametrize("name", [r[0] for r in ENGINE_RUNS])
def test_engine_shardmap_journal_matches_vmapped(engines, name):
    out, _ = engines
    _, kw, scenario, m, cycles = next(r for r in ENGINE_RUNS
                                      if r[0] == name)
    ref = j_engine.AssimilationEngine(
        j_engine.EngineConfig(solver="vmapped", **kw)).run_scenario(
        scenario, m=m, cycles=cycles, seed=0)
    port = t_engine.AssimilationEngine(
        t_engine.EngineConfig(solver="vmapped", **kw), device="cpu")
    xs = []
    port.on_analysis = lambda cycle, x: xs.append(x.numpy())
    port.run_scenario(scenario, m=m, cycles=cycles, seed=0)
    runs = {comm: [o[(name, comm)] for o in out]
            for comm in ("allreduce", "neighbour")}
    for comm, per_rank in runs.items():
        r0 = per_rank[0]
        for r in per_rank[1:]:
            assert r["journal"] == r0["journal"]
            assert all(np.array_equal(a, b) for a, b in
                       zip(r["analyses"], r0["analyses"]))
        assert r0["meta"]["mesh"]["transport"] == "direct"
        assert r0["meta"]["mesh"]["backend"] == "gloo"
        for rec, want in zip(r0["records"], ref.records):
            assert rec["loads"] == list(want.loads)
            assert rec["repartitioned"] == want.repartitioned
            assert rec["error_vs_direct"] < (1e-9 if kw["iters"] >= 200
                                             else np.inf)
            assert len(rec["device_solve_times"]) == 8
            assert len(rec["residual_history"]) == (
                kw["iters"] if comm == "allreduce" else 0)
        assert max(_max(a, b) for a, b in zip(r0["analyses"], xs)) < 1e-13
    for a, c in zip(runs["allreduce"][0]["records"],
                    runs["neighbour"][0]["records"]):
        assert c["comm_bytes_per_cycle"] < a["comm_bytes_per_cycle"]


def test_timepar_time_sub_mesh_8_ranks(engines):
    out, ref_tp = engines
    per_rank = [o["timepar"] for o in out]
    r0 = per_rank[0]
    for r in per_rank[1:]:
        assert r["journal"] == r0["journal"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["analyses"], r0["analyses"]))
    pint = r0["pint"]
    assert pint["mesh"] == {"time": 4, "sub": 2}, pint["mesh"]
    assert pint["converged"], pint
    assert pint["iters"] == ref_tp["iters"]
    assert len(r0["analyses"]) == TIMEPAR["cycles"]
    assert _max(np.stack(r0["analyses"]), ref_tp["analyses"]) < 1e-10

    kw = {k: v for k, v in TIMEPAR["kw"].items()
          if k not in ("time_windows", "pint_tol")}
    seq = t_engine.AssimilationEngine(t_engine.EngineConfig(**kw),
                                      device="cpu")
    chain = []
    seq.on_analysis = lambda cycle, x: chain.append(x.numpy())
    seq.run(t_streams.make_stream(TIMEPAR["scenario"], TIMEPAR["m"],
                                  TIMEPAR["cycles"], seed=0))
    assert max(_max(a, b) for a, b in zip(r0["analyses"], chain)) < 1e-6
    for rw, rs in zip(r0["records"], seq.journal.records):
        assert rw["loads"] == list(rs.loads)
        assert rw["repartitioned"] == rs.repartitioned


def test_cli_shardmap_two_ranks():
    """``python -m repro_torch.assim --solver shardmap`` launches p ranks
    with the backend it is given; rank 0 prints the table once."""
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.assim", "--device", "cpu",
           "--solver", "shardmap", "--backend", "gloo", "--n", "48",
           "--p", "2", "--m", "80", "--cycles", "2", "--iters", "60",
           "--scenarios", "drifting_swarm"]
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.count("summary:") == 1, run.stdout
    assert "shardmap over 2 ranks (gloo, direct transport)" in run.stdout
    err = float(run.stdout.split("max error vs one-shot solve ")[1].split()[0])
    assert err < 1e-9



def test_cli_shardmap_needs_a_backend(monkeypatch, capsys):
    from repro_torch.assim import cli
    monkeypatch.setattr(sys, "argv", ["repro_torch.assim", "--device", "cpu",
                                      "--solver", "shardmap"])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code != 0
    assert "--backend" in capsys.readouterr().err
