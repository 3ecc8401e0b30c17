"""What each rank runs in ``tests/test_torch_mesh_fleet.py`` and
``tests/test_torch_mesh_resume.py``.

The ranks are spawned processes that import this module by name, so it
imports only torch, numpy and the port: the reference runs in the test
process (or a subprocess of it), which hands the ranks numpy inputs and
checks what they return.
"""
import os

import numpy as np
import torch

from repro_torch.assim import AssimilationEngine, EngineConfig, streams
from repro_torch.assim.serving import FleetServer
from repro_torch.checkpoint import manager as ckpt
from repro_torch.obs import meters
from repro_torch.optim import compress
from repro_torch.runtime import elastic
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
from repro_torch.runtime.mesh import ProcessMesh


def _numpy(t):
    return t.detach().cpu().numpy()


def record_writes(log: list):
    """Wrap ``checkpoint.manager.save_pytree`` so this rank logs each step
    it writes (the engine calls it through the module)."""
    save = ckpt.save_pytree

    def logged(tree, directory, step, metadata=None):
        log.append((os.path.basename(directory), int(step)))
        return save(tree, directory, step, metadata)

    ckpt.save_pytree = logged


def record_snapshots(eng, store: list):
    """Keep each snapshot's array tree that ``eng`` takes (what a
    checkpoint of it writes)."""
    snap = eng.snapshot

    def kept(*a, **kw):
        tree, meta = snap(*a, **kw)
        store.append({k: np.asarray(v).copy() for k, v in tree.items()})
        return tree, meta

    eng.snapshot = kept


# ---------------------------------------------------------------------------
# The fleet and compressed_psum on one ("fleet",) mesh.
# ---------------------------------------------------------------------------

def _recorder(store: list):
    def forecast(x):
        store.append(_numpy(x).copy())
        return x
    return forecast


def fleet_rank(device, specs, fleet: dict, grads: dict) -> dict:
    """``FleetServer(mesh=)`` over the streams of ``specs`` with the
    faults of ``fleet``, then ``compressed_psum`` of this rank's row of
    each gradient of ``grads``."""
    ranks = torch.distributed.get_world_size()
    mesh = ProcessMesh((ranks,), ("fleet",), device=device)
    writes = []
    record_writes(writes)
    reg = meters.Meters()
    prev = meters.set_meters(reg)
    try:
        server = FleetServer(
            mesh=mesh, mesh_axis="fleet", device=device,
            gather_window=fleet["gather_window"],
            chaos=ChaosInjector(ChaosConfig(
                solve_fault_cycles=fleet["solve_fault_rounds"])))
        recs, snaps = {}, {}
        for sid, kw, (name, m, cycles, seed) in specs:
            recs[sid], snaps[sid] = [], []
            chaos = (ChaosInjector(ChaosConfig(
                pack_fault_cycles=(fleet["pack_fault"][1],)))
                if sid == fleet["pack_fault"][0] else None)
            eng = AssimilationEngine(EngineConfig(**kw), device=device,
                                     forecast=_recorder(recs[sid]),
                                     chaos=chaos)
            record_snapshots(eng, snaps[sid])
            server.add_stream(
                sid, eng.cfg, streams.ResumableStream(name, m, cycles,
                                                      seed=seed),
                engine=eng,
                checkpoint_dir=os.path.join(fleet["dir"], sid),
                snapshot_every=fleet["snapshot_every"])
        journals = server.serve()
    finally:
        meters.set_meters(prev)
    snap = reg.snapshot()
    out = {"streams": {
        sid: {"forecasts": recs[sid],
              "analysis": _numpy(server.engines[sid].analysis),
              "journal": journals[sid].deterministic_dict(),
              "records": journals[sid].to_dict()["records"],
              "snapshots": snaps[sid]}
        for sid, _, _ in specs},
        "counters": {k: v for k, v in snap["counters"].items()
                     if k.startswith(("fleet.cohort.", "chaos."))},
        "cohorts": [(e["size"], e["capacity"], e["w"])
                    for e in snap["events"] if e["name"] == "fleet.cohort"],
        "retries": sorted((e["site"], str(e.get("sid")))
                          for e in snap["events"]
                          if e["name"] == "chaos.retry"),
        "caps": sorted(server.solver._caps.values()),
        "writes": writes}
    out["cohort"] = _cohort_case(mesh, device)
    out["compress"] = {}
    r = mesh.rank
    for dtype, (g, e) in grads.items():
        grad = torch.from_numpy(g[r]).to(getattr(torch, dtype))
        mean, err = compress.compressed_psum(grad, torch.from_numpy(e[r]),
                                             "fleet", mesh=mesh)
        out["compress"][dtype] = (mean.float().numpy(), err.numpy())
    return out


def _cohort_case(mesh, device) -> dict:
    """One cohort of three same-shape packings (static streams, seeds
    0-2) through ``CohortSolver(mesh=)``: padded to the axis size, each
    rank solves its slice, every rank gets every member; each member
    against its standalone ``solve_vmapped`` on this rank, and the
    refusal of a cohort that does not divide over the axis."""
    from repro_torch.assim.fleet import CohortSolver, cohort_key
    from repro_torch.core import ddkf

    cfg = EngineConfig(n=48, p=4, iters=25, rebalance=False,
                       record_residuals=True)
    packs = []
    for seed in range(3):
        eng = AssimilationEngine(cfg, device=device)
        obs = next(iter(streams.make_stream("drifting_swarm", 120, 1,
                                            seed=seed)))
        packs.append(eng.solve_input(eng.prepare(0, obs))[0])
    key = cohort_key(packs[0], cfg.iters, cfg.damping, True)
    res = CohortSolver(mesh=mesh, axis="fleet").solve(key, packs)
    alone = [ddkf.solve_vmapped(pk, iters=cfg.iters, damping=cfg.damping,
                                residual_history=True) for pk in packs]
    try:
        ddkf.solve_fleet(packs, iters=2, mesh=mesh, axis="fleet")
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    return {"capacity": res.capacity, "size": res.size,
            "xs": [_numpy(x) for x in res.xs],
            "bitwise": all(torch.equal(x, a[0]) and torch.equal(h, a[1])
                           for x, h, a in zip(res.xs, res.hists, alone)),
            "refused": refused}


# ---------------------------------------------------------------------------
# Resume onto a mesh.
# ---------------------------------------------------------------------------

def _stream(run: dict):
    return streams.ResumableStream(run["scenario"], run["m"], run["cycles"],
                                   seed=run["seed"])


def killed_rank(device, run: dict, ck: str) -> None:
    """The ``solver="shardmap"`` engine with a snapshot every
    ``run["snapshot_every"]`` cycles, SIGKILLed by its injector at the end
    of cycle ``run["kill_cycle"]`` on every rank."""
    chaos = ChaosInjector(ChaosConfig(kill_cycles=(run["kill_cycle"],)))
    eng = AssimilationEngine(EngineConfig(**run["cfg"]), device=device,
                             chaos=chaos)
    eng.run(_stream(run), checkpoint_dir=ck,
            snapshot_every=run["snapshot_every"])
    raise AssertionError("the injector did not kill this rank")


def _engine_out(eng, journal) -> dict:
    return {"journal": journal.deterministic_dict(),
            "records": journal.to_dict()["records"],
            "meta": dict(journal.meta),
            "analysis": _numpy(eng.analysis), "p": eng.p}


def resume_rank(device, run: dict, ck: str, tmp: str) -> dict:
    """The uninterrupted ``solver="shardmap"`` run with its snapshots
    (which rank writes each, and every rank's snapshot), the resume of
    the killed run's newest step at the same p, and ``TimeParEngine`` on
    the auto ("time", "sub") mesh with a checkpoint every window."""
    from repro_torch.assim.timepar import TimeParEngine

    writes, snaps = [], []
    record_writes(writes)
    eng = AssimilationEngine(EngineConfig(**run["cfg"]), device=device)
    record_snapshots(eng, snaps)
    full = _engine_out(eng, eng.run(
        _stream(run), checkpoint_dir=os.path.join(tmp, "full"),
        snapshot_every=run["snapshot_every"]))
    full.update(writes=list(writes), snapshots=snaps)
    eng, stream = elastic.resume_assim_engine(ck, device=device)
    out = {"full": full, "pos": stream.pos, "mesh": eng.mesh.describe()}
    out["resumed"] = _engine_out(eng, eng.run(stream))
    del writes[:]
    tp = TimeParEngine(EngineConfig(**run["pint"]["cfg"]), device=device)
    psnaps = []
    record_snapshots(tp.engine, psnaps)
    tp.run(_stream(dict(run, cycles=run["pint"]["cycles"])),
           checkpoint_dir=os.path.join(tmp, "pint"), snapshot_every=1)
    out["pint"] = {"writes": list(writes), "snapshots": psnaps,
                   "mesh": dict(tp.mesh.shape)}
    return out


def elastic_rank(device, step: str, p: int) -> dict:
    """The killed run's step resumed at a new p on this launch's ranks."""
    eng, stream = elastic.resume_assim_engine(step, p=p, device=device)
    out = {"pos": stream.pos, "mesh": eng.mesh.describe()}
    out.update(_engine_out(eng, eng.run(stream)))
    return out
