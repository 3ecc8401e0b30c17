"""The port's fleet and ``compressed_psum`` on a process mesh, against the
JAX package's on eight forced XLA devices.

``repro_torch.runtime.mesh.launch`` spawns eight gloo ranks on the CPU
once for every case below (``tests/_torch_mesh_ranks.py``): each runs
``FleetServer(mesh=..., mesh_axis="fleet")`` over three streams (two on
DyDD, one static) with a transient pack fault, a transient cohort-solve
fault and a snapshot every 2 cycles, then ``compressed_psum`` of its row
of an f32 and a bf16 gradient.  Meanwhile a subprocess runs the
reference's ``FleetServer`` on an 8-device ``("fleet",)`` mesh
(``tests/test_fleet.py``'s ``SCRIPT_FLEET_8DEV`` with the same streams
and faults) and its ``compressed_psum`` under ``shard_map``.  Held here:

* every rank's journals, forecasts and analyses bitwise equal, and each
  stream bitwise its standalone ``AssimilationEngine.run`` in this
  process;
* loads and migrations bitwise the reference's, forecasts and analyses
  within 1e-13, cohort capacities and padded slots equal;
* the retries agreed: one pack retry and one solve retry on every rank;
* a cohort of three same-shape members padded to 8: every rank holds
  every member, each bitwise its standalone solve, and a cohort of 3
  refused by ``solve_fleet`` on the 8-rank axis;
* each step of each stream written by rank 0 alone, every rank's
  snapshot the same;
* ``compressed_psum``'s mean and new error bitwise the reference's, in
  f32 and bf16.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.assim import AssimilationEngine, EngineConfig  # noqa: E402
from repro_torch.assim import streams as t_streams  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 8
CYCLES = 3
# Two streams on DyDD and one static.  Their sizes differ, so each
# cohort holds one stream whatever the rounds: which streams a round
# holds follows thread timing, in the reference as in the port, and
# would move the padded-slot count between any two runs.  The cohort of
# several members is held in its own case (``_cohort_case``).
SPECS = [(f"s{i}", dict(n=48 + 8 * i, p=4, iters=25, rebalance=i < 2),
          ("drifting_swarm", 120, CYCLES, i)) for i in range(3)]
# A gather window far longer than a prepare: every round holds every
# stream in flight, in the reference as on the ranks.
FLEET = {"gather_window": 30.0, "solve_fault_rounds": (1,),
         "pack_fault": ("s1", 1), "snapshot_every": 2}
# The collective timeout of the launch: a round that the ranks do not
# agree on fails the test in a minute, not in the default ten.
TIMEOUT_S = 60

REF = r"""
import sys
import tempfile
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.assim import AssimilationEngine, EngineConfig, FleetServer, streams
from repro.core import _compat
from repro.obs import meters
from repro.optim import compress
from repro.runtime.chaos import ChaosConfig, ChaosInjector

specs, fleet = eval(sys.argv[2]), eval(sys.argv[3])
mesh = _compat.make_device_mesh((8,), ("fleet",))
reg = meters.Meters()
meters.set_meters(reg)
server = FleetServer(mesh=mesh, mesh_axis="fleet",
                     gather_window=fleet["gather_window"],
                     chaos=ChaosInjector(ChaosConfig(
                         solve_fault_cycles=fleet["solve_fault_rounds"])))
recs = {}
with tempfile.TemporaryDirectory() as tmp:
    for sid, kw, (name, m, cycles, seed) in specs:
        recs[sid] = []
        chaos = (ChaosInjector(ChaosConfig(
            pack_fault_cycles=(fleet["pack_fault"][1],)))
            if sid == fleet["pack_fault"][0] else None)
        def forecast(x, store=recs[sid]):
            store.append(np.asarray(x).copy())
            return x
        server.add_stream(sid, EngineConfig(**kw),
                          streams.ResumableStream(name, m, cycles, seed=seed),
                          forecast=forecast, chaos=chaos,
                          checkpoint_dir=f"{tmp}/{sid}",
                          snapshot_every=fleet["snapshot_every"])
    journals = server.serve()
out = {}
for sid, _, _ in specs:
    out[f"{sid}/forecasts"] = np.stack(recs[sid])
    out[f"{sid}/analysis"] = np.asarray(server.engines[sid].analysis)
    out[f"{sid}/loads"] = np.asarray([r.loads for r in journals[sid].records])
    out[f"{sid}/migrated"] = np.asarray(
        [r.migrated for r in journals[sid].records])
    out[f"{sid}/repartitioned"] = np.asarray(
        [r.repartitioned for r in journals[sid].records])
counters = reg.snapshot()["counters"]
for k in ("dispatches", "members", "padded_slots"):
    out[f"cohort/{k}"] = np.asarray(counters[f"fleet.cohort.{k}"])
out["caps"] = np.asarray(sorted(server.solver._caps.values()))

grads = np.load(sys.argv[4])
fn = jax.jit(_compat.shard_map(
    lambda g, e: compress.compressed_psum(g[0], e[0], "fleet"),
    mesh=mesh, in_specs=(P("fleet"), P("fleet")),
    out_specs=(P("fleet"), P("fleet"))))
for dtype in ("float32", "bfloat16"):
    g = jnp.asarray(grads["g"]).astype(getattr(jnp, dtype))
    mean, err = fn(g, jnp.asarray(grads["e"]))
    out[f"compress/{dtype}/mean"] = np.asarray(
        mean.astype(jnp.float32)).reshape(grads["g"].shape)
    out[f"compress/{dtype}/error"] = np.asarray(err).reshape(
        grads["g"].shape)
np.savez(sys.argv[1], **out)
"""


def _grads():
    rng = np.random.default_rng(11)
    g = rng.normal(size=(RANKS, 64, 33)).astype(np.float32)
    g[3] *= 4.0                     # one rank's scale is the max
    e = (1e-2 * rng.normal(size=(RANKS, 64, 33))).astype(np.float32)
    return g, e


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launch of eight CPU ranks for every case of this file, with the
    reference's eight-device run in a process of its own meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh_fleet")
    g, e = _grads()
    np.savez(tmp / "grads.npz", g=g, e=e)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, str(tmp / "ref.npz"), repr(SPECS),
         repr(FLEET), str(tmp / "grads.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = t_mesh.launch(
            ranks.fleet_rank, RANKS, backend="gloo", device="cpu",
            args=(SPECS, dict(FLEET, dir=str(tmp / "ck")),
                  {"float32": (g, e), "bfloat16": (g, e)}),
            timeout=TIMEOUT_S)
    finally:
        log = ref.communicate(timeout=600)[0]
    assert ref.returncode == 0, log[-3000:]
    with np.load(tmp / "ref.npz") as z:
        ref_out = {k: z[k] for k in z.files}
    return out, ref_out, str(tmp / "ck")


def _standalone(sid):
    _, kw, (name, m, cycles, seed) = next(s for s in SPECS if s[0] == sid)
    rec = []

    def forecast(x):
        rec.append(x.numpy().copy())
        return x
    eng = AssimilationEngine(EngineConfig(**kw), device="cpu",
                             forecast=forecast)
    eng.run(t_streams.make_stream(name, m, cycles, seed=seed))
    return eng, rec


@pytest.mark.parametrize("sid", [s[0] for s in SPECS])
def test_mesh_fleet_stream_bitwise_its_standalone_run(launched, sid):
    out, _, _ = launched
    r0 = out[0]["streams"][sid]
    for o in out[1:]:
        r = o["streams"][sid]
        assert r["journal"] == r0["journal"]
        assert np.array_equal(r["analysis"], r0["analysis"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(r["forecasts"], r0["forecasts"]))
    eng, rec = _standalone(sid)
    assert r0["journal"] == eng.journal.deterministic_dict()
    assert np.array_equal(r0["analysis"], eng.analysis.numpy())
    assert len(r0["forecasts"]) == len(rec) == CYCLES - 1
    assert all(np.array_equal(a, b) for a, b in zip(r0["forecasts"], rec))


@pytest.mark.parametrize("sid", [s[0] for s in SPECS])
def test_mesh_fleet_stream_matches_reference_8_devices(launched, sid):
    out, ref, _ = launched
    r0 = out[0]["streams"][sid]
    recs = r0["records"]
    assert [r["loads"] for r in recs] == ref[f"{sid}/loads"].tolist()
    assert [r["migrated"] for r in recs] == ref[f"{sid}/migrated"].tolist()
    assert ([r["repartitioned"] for r in recs]
            == ref[f"{sid}/repartitioned"].tolist())
    assert np.max(np.abs(np.stack(r0["forecasts"])
                         - ref[f"{sid}/forecasts"])) < 1e-13
    assert np.max(np.abs(r0["analysis"] - ref[f"{sid}/analysis"])) < 1e-13


def test_mesh_fleet_cohorts_and_retries_match_reference(launched):
    out, ref, _ = launched
    for o in out:
        c = o["counters"]
        for k in ("dispatches", "members", "padded_slots"):
            assert c[f"fleet.cohort.{k}"] == float(ref[f"cohort/{k}"]), k
        assert o["caps"] == ref["caps"].tolist()
        assert set(o["caps"]) == {RANKS}
        assert all(cap == RANKS for _, cap, _ in o["cohorts"])
        # The transient pack fault and the round-1 solve fault, each
        # retried once, on every rank alike.
        assert o["retries"] == [("pack", "s1"), ("solve", "None")]
        assert c["chaos.retries"] == 2
        assert o["cohorts"] == out[0]["cohorts"]
    assert out[0]["counters"]["fleet.cohort.members"] == len(SPECS) * CYCLES


def test_cohort_solver_spreads_members_over_the_ranks(launched):
    out, _, _ = launched
    c0 = out[0]["cohort"]
    assert (c0["capacity"], c0["size"]) == (RANKS, 3)
    for o in out:
        c = o["cohort"]
        assert c["bitwise"]
        assert all(np.array_equal(a, b) for a, b in zip(c["xs"], c0["xs"]))
        assert "cohort size 3 does not divide over the 8-device" in \
            c["refused"]


def test_mesh_fleet_snapshots_written_once_and_equal(launched):
    out, _, ck = launched
    assert sorted(out[0]["writes"]) == sorted(
        (s[0], 2) for s in SPECS)
    assert all(o["writes"] == [] for o in out[1:])
    for sid, _, _ in SPECS:
        snaps = [o["streams"][sid]["snapshots"] for o in out]
        assert len(snaps[0]) == 1
        for s in snaps[1:]:
            assert s[0].keys() == snaps[0][0].keys()
            assert all(np.array_equal(s[0][k], snaps[0][0][k])
                       for k in s[0])
        path = t_ckpt.latest_checkpoint(os.path.join(ck, sid))
        assert path.endswith("step_00000002") and t_ckpt.verify(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_bitwise_reference_shard_map(launched, dtype):
    out, ref, _ = launched
    g, e = _grads()
    for r, o in enumerate(out):
        mean, err = o["compress"][dtype]
        assert np.array_equal(mean, ref[f"compress/{dtype}/mean"][r])
        assert np.array_equal(err, ref[f"compress/{dtype}/error"][r])
        assert np.array_equal(mean, out[0]["compress"][dtype][0])
    # One process's arithmetic: the int32 sum times the max scale over 8.
    from repro_torch.optim import compress
    qs = [compress.compress_with_feedback(
        torch.from_numpy(g[r]).to(getattr(torch, dtype)),
        torch.from_numpy(e[r])) for r in range(RANKS)]
    total = sum(q.to(torch.int32) for q, _, _ in qs)
    scale = max(s for _, s, _ in qs)
    want = (total.float() * scale / RANKS).to(getattr(torch, dtype))
    assert np.array_equal(out[0]["compress"][dtype][0], want.float().numpy())
