"""Resume onto a process mesh: the port's ``solver="shardmap"`` engine
killed on four gloo CPU ranks and resumed on four and on two, against an
uninterrupted mesh run and the JAX package's elastic resume.

Three launches (``tests/_torch_mesh_ranks.py``), each with a short
collective timeout:

* four ranks run the engine with a snapshot every 2 cycles and are
  SIGKILLed by their injectors at the end of cycle 3: the launch raises
  well inside the collective timeout, naming the signal, and the newest
  verified step is 4;
* four ranks run the same stream uninterrupted (rank 0 alone writes each
  step, every rank's snapshot the same), then resume the killed run's
  step 4: the journal and final analysis are bitwise the uninterrupted
  run's; then ``TimeParEngine`` on their ("time", "sub") mesh with a
  checkpoint every window, each written by rank 0 alone;
* two ranks resume step 4 at p = 2: no cycle is replayed, and the
  decisions (``meta["resume"]``, the loads after the remesh) equal the
  reference's ``resume_assim_engine`` at the same config, run with
  ``solver="vmapped"`` on forced XLA devices in a subprocess (the
  reference's ``solve_shardmap`` fails on this tree; these decisions are
  host numpy that do not depend on the solver).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.runtime import mesh as t_mesh  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RUN = {"cfg": dict(n=48, p=4, iters=25, solver="shardmap",
                   track_reference=True),
       "scenario": "drifting_swarm", "m": 120, "cycles": 6, "seed": 0,
       "snapshot_every": 2, "kill_cycle": 3,
       # Parareal's window checkpoints on the auto ("time": 2, "sub": 2)
       # mesh of the same four ranks.
       "pint": {"cfg": dict(n=48, p=2, iters=25, time_windows=2),
                "cycles": 4}}
NEW_P = 2
# The collective timeout of every launch: a rank that waited for a dead
# one would hold the launch this long.
TIMEOUT_S = 120
HOST = ("cycle", "loads", "loads_before", "repartitioned", "migrated",
        "rounds", "rebalance_suppressed")

REF = r"""
import json, os, sys
import jax
jax.config.update("jax_enable_x64", True)
from repro.assim import AssimilationEngine, EngineConfig, streams
from repro.runtime import elastic

run, new_p, ck = eval(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = dict(run["cfg"], solver="vmapped")
eng = AssimilationEngine(EngineConfig(**cfg))
eng.run(streams.ResumableStream(run["scenario"], run["m"], run["cycles"],
                                seed=run["seed"]),
        checkpoint_dir=ck, snapshot_every=run["snapshot_every"])
step = os.path.join(ck, "step_%08d" % (run["kill_cycle"] + 1))
eng, stream = elastic.resume_assim_engine(step, p=new_p)
pos = stream.pos
journal = eng.run(stream)
print(json.dumps({"pos": pos, "resume": journal.meta["resume"],
                  "records": journal.to_dict()["records"]}))
"""


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The three launches, with the reference's run in a process of its
    own during the first."""
    tmp = tmp_path_factory.mktemp("mesh_resume")
    ck = str(tmp / "killed")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, repr(RUN), str(NEW_P),
         str(tmp / "ref")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        with pytest.raises(Exception) as killed:
            t_mesh.launch(ranks.killed_rank, RUN["cfg"]["p"],
                          backend="gloo", device="cpu", args=(RUN, ck),
                          timeout=TIMEOUT_S)
        kill_wall = time.perf_counter() - t0
        same = t_mesh.launch(ranks.resume_rank, RUN["cfg"]["p"],
                             backend="gloo", device="cpu",
                             args=(RUN, ck, str(tmp)),
                             timeout=TIMEOUT_S)
        step = os.path.join(ck, "step_%08d" % (RUN["kill_cycle"] + 1))
        grown = t_mesh.launch(ranks.elastic_rank, NEW_P, backend="gloo",
                              device="cpu", args=(step, NEW_P),
                              timeout=TIMEOUT_S)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return {"killed": killed.value, "kill_wall": kill_wall, "ck": ck,
            "same": same, "grown": grown,
            "ref": json.loads(out.strip().splitlines()[-1])}


def test_mesh_kill_makes_the_launch_raise_promptly(launched):
    assert "SIGKILL" in str(launched["killed"]), launched["killed"]
    assert launched["kill_wall"] < TIMEOUT_S
    latest = t_ckpt.latest_checkpoint(launched["ck"])
    assert latest is not None and latest.endswith(
        "step_%08d" % (RUN["kill_cycle"] + 1))
    assert t_ckpt.verify(latest)


@pytest.mark.parametrize("run", ["full", "pint"])
def test_mesh_checkpoint_written_by_one_rank(launched, run):
    """Rank 0 alone writes each step of the uninterrupted mesh run and of
    Parareal's window checkpoints on the ("time", "sub") mesh, and every
    rank's snapshot of each is the same before the write."""
    res = [o[run] for o in launched["same"]]
    if run == "full":
        steps = list(range(RUN["snapshot_every"], RUN["cycles"] + 1,
                           RUN["snapshot_every"]))
    else:
        assert all(r["mesh"] == {"time": 2, "sub": 2} for r in res)
        steps = [2, 4]                      # two windows of two cycles
    assert res[0]["writes"] == [(run, s) for s in steps]
    assert all(r["writes"] == [] for r in res[1:])
    for r in res:
        assert len(r["snapshots"]) == len(steps)
        for a, b in zip(r["snapshots"], res[0]["snapshots"]):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_mesh_resume_same_p_bitwise_uninterrupted(launched):
    for o in launched["same"]:
        full, res = o["full"], o["resumed"]
        assert o["pos"] == RUN["kill_cycle"] + 1
        assert o["mesh"]["shape"] == {"sub": RUN["cfg"]["p"]}
        assert res["journal"] == full["journal"]
        assert np.array_equal(res["analysis"], full["analysis"])
        assert res["journal"] == launched["same"][0]["full"]["journal"]
        assert res["meta"]["resume"] == [
            {"at_cycle": RUN["kill_cycle"] + 1, "p": RUN["cfg"]["p"],
             "remeshed": False}]
        assert all(r["error_vs_direct"] < 1e-6 for r in res["records"])


def test_mesh_elastic_resume_matches_reference(launched):
    ref = launched["ref"]
    at = RUN["kill_cycle"] + 1
    g0 = launched["grown"][0]
    for o in launched["grown"]:
        assert o["pos"] == ref["pos"] == at
        assert o["p"] == NEW_P and o["mesh"]["shape"] == {"sub": NEW_P}
        assert o["journal"] == g0["journal"]
        assert np.array_equal(o["analysis"], g0["analysis"])
        recs = o["records"]
        assert [r["cycle"] for r in recs] == list(range(RUN["cycles"]))
        assert all(len(r["loads"]) == NEW_P for r in recs[at:])
        assert all(len(r["loads"]) == RUN["cfg"]["p"] for r in recs[:at])
        assert o["meta"]["resume"] == ref["resume"] == [
            {"at_cycle": at, "p": NEW_P, "remeshed": True}]
        for r, w in zip(recs, ref["records"]):
            assert {k: r[k] for k in HOST} == {k: w[k] for k in HOST}
        assert all(r["error_vs_direct"] < 1e-6 for r in recs[at:])
