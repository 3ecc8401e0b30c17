"""What each rank runs in ``tests/test_torch_shardmap.py``.

The ranks are spawned processes that import this module by name, so it
imports only torch, numpy and the port: the reference runs in the test
process, which hands the ranks numpy inputs and checks what they return.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.assim import AssimilationEngine, EngineConfig, streams
from repro_torch.assim.timepar import TimeParEngine
from repro_torch.core import ddkf
from repro_torch.core import dd
from repro_torch.runtime.mesh import ProcessMesh

# Iterations of the solves that hold the paths to each other.
SHORT = 30
# The per-slot device fields a per-rank packing holds one row of.
ROW_FIELDS = ("A_loc", "L_loc", "mask", "muov", "wdiv", "gather_cols")


def _numpy(t):
    return t.detach().cpu().numpy()


def _errors(fn) -> str:
    """The message of the ValueError ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _decomposition(case: dict, overlap: int):
    if case["kind"] == "interval":
        return dd.decompose_1d(case["n"], case["boundaries"],
                               overlap=overlap)
    dom = convert.domain_from_state(case["describe"], case["state"])
    return dom.decomposition(overlap=overlap)


def _block_equal(rank_pk, whole, i: int) -> bool:
    """A rank's packing against row i of the whole packing, bit for bit."""
    ok = rank_pk.first == i and rank_pk.A_loc.shape[0] == 1
    for f in ROW_FIELDS:
        ok &= torch.equal(getattr(rank_pk, f), getattr(whole, f)[i:i + 1])
    for f in ("mult", "r", "b", "owner_slots"):
        ok &= torch.equal(getattr(rank_pk, f), getattr(whole, f))
    for f in ddkf.HOST_FIELDS:
        ok &= np.array_equal(getattr(rank_pk, f), getattr(whole, f))
    return bool(ok)


def solve_cases(device, cases: list) -> dict:
    """The reference's ``SCRIPT``, ``SCRIPT_2D`` and ``SCRIPT_KDTREE``
    solves on this rank, plus the per-rank packing, the exchange count
    and the checks that refuse bad meshes."""
    out = {}
    for case in cases:
        names, shape = case["mesh"]
        mesh = ProcessMesh(shape, names, device=device)
        axis = names if len(names) > 1 else names[0]
        i = mesh.index(axis)
        prob = convert.cls_problem_from_numpy(case["problem"], device)
        A, b, r = prob.stacked()
        it, damp = case["iters"], case["damping"]
        res = {}
        for ov in case["overlaps"]:
            dec = _decomposition(case, ov)

            def pack(kernel, rank=True):
                pk = ddkf.pack_operator(
                    A.cpu().numpy(), r.cpu().numpy(), dec,
                    solver_kernel=kernel, device=device,
                    subdomains=range(i, i + 1) if rank else None)
                return ddkf.with_rhs(pk, b)

            pk = pack("plain")
            ref_pk = convert.packed_from_numpy(*case["ref_packed"][ov],
                                               device=device)
            # The full-length solves meet the direct solve; the paths are
            # held to each other (and to the reference's vmapped solve of
            # the same packing) at SHORT iterations.
            full = dict(axis=axis, iters=it, damping=damp)
            short = dict(axis=axis, iters=SHORT, damping=damp)
            if ov:
                short.update(comm="neighbour", halo=dec.halo_exchange)
            r_ov = {
                "block_equal": _block_equal(pk, pack("plain", rank=False),
                                            i),
                "x": ddkf.solve_shardmap(pk, mesh, **full),
                "x_ref_pack": ddkf.solve_shardmap(ref_pk, mesh,
                                                  **dict(short, comm=(
                                                      "allreduce"),
                                                      halo=None)),
                "x_psum": ddkf.solve_shardmap(pk, mesh, mvec="psum",
                                              **short),
                "x_fused": ddkf.solve_shardmap(pack("fused"), mesh,
                                               **short),
                "x_whole": ddkf.solve_shardmap(pack("plain", rank=False),
                                               mesh, **short),
            }
            r_ov["x_short"], r_ov["hist"], r_ov["times"] = \
                ddkf.solve_shardmap(pk, mesh, residual_history=True,
                                    return_per_device=True, **short)
            if ov:
                halo = dec.halo_exchange
                before = mesh.counts["ppermute"]
                r_ov["x_neighbour"] = ddkf.solve_shardmap(
                    pk, mesh, comm="neighbour", halo=halo, **full)
                r_ov["ppermutes"] = mesh.counts["ppermute"] - before
                r_ov["rounds"] = halo.rounds
            res[ov] = r_ov
        out[case["name"]] = res
    # The checks, on the 8-rank world.
    mesh = ProcessMesh((8,), ("sub",), device=device)
    small = _decomposition(cases[0], 0)
    A, b, r = convert.cls_problem_from_numpy(cases[0]["problem"],
                                             device).stacked()
    pk4 = ddkf.pack_operator(A.cpu().numpy(), r.cpu().numpy(),
                             dd.decompose_1d(cases[0]["n"],
                                             dd.uniform_boundaries(4)),
                             device=device)
    pk8 = ddkf.pack_operator(A.cpu().numpy(), r.cpu().numpy(), small,
                             device=device, subdomains=range(0, 1))
    grid = ProcessMesh((2, 4), ("time", "sub"), device=device)
    out["groups"] = {
        axes: (dist.get_process_group_ranks(grid.group(axes)),
               grid.group_ranks(axes), grid.index(axes))
        for axes in ("time", "sub", ("time", "sub"))}
    out["errors"] = {
        "p_mismatch": _errors(lambda: ddkf.solve_shardmap(pk4, mesh)),
        "missing_axis": _errors(lambda: ddkf.solve_shardmap(
            pk4, mesh, axis="row")),
        "wrong_block": _errors(lambda: ddkf.solve_shardmap(pk8, mesh))
        if mesh.rank else "",
        "engine_world": _errors(lambda: AssimilationEngine(
            EngineConfig(n=32, p=4, solver="shardmap"), device=device)),
        "timepar_axis": _errors(lambda: TimeParEngine(
            EngineConfig(n=32, p=8, time_windows=2), device=device,
            mesh=mesh)),
        "timepar_sub": _errors(lambda: TimeParEngine(
            EngineConfig(n=32, p=2, time_windows=2), device=device,
            mesh=ProcessMesh((2, 4), ("time", "sub"), device=device))),
    }
    out["transport"] = mesh.transport
    return out


def _engine_run(cfg, device, scenario, m, cycles, seed):
    eng = AssimilationEngine(cfg, device=device)
    xs = []
    eng.on_analysis = lambda cycle, x: xs.append(_numpy(x))
    journal = eng.run_scenario(scenario, m=m, cycles=cycles, seed=seed)
    return {"analyses": xs, "journal": journal.deterministic_dict(),
            "records": journal.to_dict()["records"],
            "meta": dict(journal.meta)}


def engine_cases(device, runs: list, timepar: dict) -> dict:
    """The reference's ``SCRIPT_ENGINE`` (and ``SCRIPT_KDTREE``'s engine
    part) with ``solver="shardmap"`` on both exchanges, then its
    ``SCRIPT_TIMEPAR`` on the auto ("time", "sub") mesh."""
    out = {}
    for name, kw, scenario, m, cycles in runs:
        for comm in ("allreduce", "neighbour"):
            cfg = EngineConfig(solver="shardmap", comm=comm,
                               record_residuals=comm == "allreduce",
                               track_reference=True, **kw)
            out[(name, comm)] = _engine_run(cfg, device, scenario, m,
                                            cycles, seed=0)
    cfg = EngineConfig(**timepar["kw"])
    tp = TimeParEngine(cfg, device=device)
    journal = tp.run(streams.make_stream(timepar["scenario"], timepar["m"],
                                         timepar["cycles"], seed=0))
    out["timepar"] = {"analyses": list(tp.analyses),
                      "pint": journal.meta["pint"],
                      "records": journal.to_dict()["records"],
                      "journal": journal.deterministic_dict()}
    return out


def all_cases(device, cases: list, runs: list, timepar: dict) -> dict:
    """:func:`solve_cases`, then :func:`engine_cases`: one launch."""
    out = solve_cases(device, cases)
    out.update(engine_cases(device, runs, timepar))
    return out
