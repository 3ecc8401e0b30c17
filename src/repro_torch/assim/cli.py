"""Streaming DD-KF assimilation with online DyDD — the port's CLI.

Runs registered observation-stream scenarios through
:class:`repro_torch.assim.AssimilationEngine` and prints, per cycle, the
imbalance before/after DyDD, the balance ratio E, repartitions, migrated
observations, cycle time and the error against the one-shot CLS solve —
the table of ``examples/dydd_assimilation.py``.  ``--solver vmapped``
(the default) solves on one device; ``--solver shardmap`` launches one
rank per subdomain (``--backend gloo`` or ``nccl``, no default; NCCL
needs a card per rank) and rank 0 prints the table.  With
``--time-windows W`` (W > 1) the cycles run through the parallel-in-time
Parareal engine (:class:`repro_torch.assim.TimeParEngine`, on a
("time", "sub") mesh over the ranks under ``shardmap``) and its ``pint``
summary is printed.  Runs on the card unless ``--device cpu``:

  python -m repro_torch.assim --n 2048 --p 8 --m 2000 --cycles 6 \\
      --scenarios drifting_swarm
  python -m repro_torch.assim --device cpu --n 96 --m 200 --cycles 4 \\
      --scenarios drifting_swarm
  python -m repro_torch.assim --ndim 2 --nx 64 --ny 32 --pr 2 --pc 4 \\
      --overlap 1 --m 2000 --cycles 3 --scenarios rotating_swarm
  python -m repro_torch.assim --n 2048 --p 8 --m 2000 --cycles 8 \\
      --time-windows 4 --scenarios drifting_swarm
  python -m repro_torch.assim --solver shardmap --backend gloo --n 2048 \\
      --p 8 --m 2000 --cycles 2 --scenarios drifting_swarm
"""
import argparse
import contextlib
import io
import json

import numpy as np
import torch

from repro_torch.assim import (AssimilationEngine, EngineConfig,
                               TimeParEngine, streams)
from repro_torch.core import ddkf
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import mesh as mesh_mod


def make_config(args) -> EngineConfig:
    common = dict(iters=args.iters, rebalance=not args.static,
                  solver=args.solver,
                  imbalance_threshold=args.threshold,
                  hysteresis=args.hysteresis, track_reference=True,
                  overlap=args.overlap, comm=args.comm,
                  halo_weight=args.halo_weight,
                  record_residuals=args.residuals,
                  solver_kernel=args.solver_kernel,
                  gram_mode=args.gram_mode,
                  time_windows=args.time_windows, pint_tol=args.pint_tol,
                  pint_max_iters=args.pint_max_iters,
                  pint_coarse_iters=args.pint_coarse_iters,
                  pint_fine_iters=args.pint_fine_iters)
    if args.ndim == 1:
        return EngineConfig(n=args.n, p=args.p, **common)
    if args.domain == "kdtree":
        return EngineConfig(ndim=2, domain_kind="kdtree",
                            p=args.pr * args.pc, nx=args.nx, ny=args.ny,
                            damping=args.damping, **common)
    return EngineConfig(ndim=2, nx=args.nx, ny=args.ny, pr=args.pr,
                        pc=args.pc, damping=args.damping, **common)


def print_load_table(domain, rec) -> None:
    """Per-cell loads before/after the cycle's rebalance, as pr x pc grids."""
    before = domain.load_table(rec.loads_before)
    after = domain.load_table(rec.loads)
    rows = []
    for rb, ra in zip(np.atleast_2d(before), np.atleast_2d(after)):
        rows.append("  " + " ".join(f"{v:5d}" for v in rb)
                    + "   ->   " + " ".join(f"{v:5d}" for v in ra))
    print(f"  cycle {rec.cycle} cell loads (before -> after rebalance):")
    print("\n".join(rows))


def run_scenario(name: str, args, device=None) -> None:
    cfg = make_config(args)
    windowed = cfg.time_windows > 1
    eng = (TimeParEngine(cfg, device=device) if windowed
           else AssimilationEngine(cfg, device=device))
    domain = eng.engine.domain if windowed else eng.domain
    dom = eng.journal.meta
    if args.ndim == 1:
        shape = f"p={dom['p']}"
    elif dom["kind"] == "kdtree":
        shape = (f"{dom['p']}-leaf k-d tree on a "
                 f"{dom['nx']}x{dom['ny']} mesh")
    else:
        shape = (f"{dom['pr']}x{dom['pc']} cells on a "
                 f"{dom['nx']}x{dom['ny']} mesh")
    if cfg.solver == "shardmap":
        where = (f"shardmap over {torch.distributed.get_world_size()} "
                 f"ranks ({args.backend}, "
                 f"{mesh_mod.transport_for(args.backend, eng.device)} "
                 f"transport) on {eng.device.type}")
    else:
        where = f"vmapped on {eng.device}"
    print(f"\n=== {name} ({'static DD' if args.static else 'DyDD'}, "
          f"{shape}, overlap={cfg.overlap}, {where}, "
          f"m={args.m}, {args.cycles} cycles"
          + (f", {cfg.time_windows} time windows" if windowed else "")
          + ") ===")
    print(f"{'cycle':>5s} {'imb_in':>7s} {'imb_out':>7s} {'E':>6s} "
          f"{'rep':>4s} {'moved':>6s} {'t_cycle':>8s} {'err_DD-DA':>10s}")
    journal = eng.run_scenario(name, m=args.m, cycles=args.cycles,
                               seed=args.seed)
    for r in journal.records:
        print(f"{r.cycle:5d} {r.imbalance_before:7.2f} {r.imbalance:7.2f} "
              f"{r.efficiency:6.3f} {'yes' if r.repartitioned else '-':>4s} "
              f"{r.migrated:6d} {r.cycle_time * 1e3:7.1f}ms "
              f"{r.error_vs_direct:10.2e}")
        if args.ndim == 2 and r.repartitioned:
            print_load_table(domain, r)
    s = journal.summary()
    print(f"summary: {s['repartitions']} repartitions, "
          f"{s['migrated_total']} observations migrated, "
          f"max imbalance {s['imbalance_max']:.3f}, "
          f"max error vs one-shot solve {s['error_max']:.2e}")
    if cfg.overlap > 0:
        print(f"comm ({cfg.comm}): "
              f"{s['comm_bytes_per_cycle_mean'] / 1e3:.1f} kB/cycle "
              f"modelled, halo fraction "
              f"{s['halo_fraction_mean']:.3f}")
    if s.get("phases"):
        split = ", ".join(f"{k} {v['p50'] * 1e3:.1f}ms"
                          for k, v in sorted(s["phases"].items()))
        print(f"phase p50: {split}")
    if windowed:
        print(f"pint: {json.dumps(journal.meta['pint'])}")
    if cfg.record_residuals and s.get("residual_final_mean") is not None:
        print(f"Schwarz residual (final iter, mean over cycles): "
              f"{s['residual_final_mean']:.2e}")


def run_all(args, device=None) -> None:
    """Every chosen scenario, on ``device`` (this rank's under
    ``shardmap``: every rank runs this, rank 0 writes the trace)."""
    names = args.scenarios or streams.available(ndim=args.ndim)
    tracer = obs_trace.Tracer("repro_torch.assim") if args.trace else None
    with obs_trace.tracing(tracer), obs_trace.torch_profile(args.profile):
        for name in names:
            if streams.get(name).ndim != args.ndim:
                raise SystemExit(
                    f"scenario {name!r} is {streams.get(name).ndim}D; "
                    f"pass --ndim {streams.get(name).ndim}")
            run_scenario(name, args, device)
    if tracer is not None and not (torch.distributed.is_initialized()
                                   and torch.distributed.get_rank()):
        tracer.save(args.trace)
        print(f"\nwrote trace {args.trace} "
              f"({len(tracer.events)} events)")


def run_rank(device, args) -> None:
    """One rank of ``--solver shardmap``: only rank 0 prints."""
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if torch.distributed.get_rank() else contextlib.nullcontext())
    with quiet:
        run_all(args, device)


def main(argv=None) -> None:
    """The CLI on ``argv`` (the command line's arguments by default)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                    "the CPU)")
    ap.add_argument("--ndim", type=int, default=1, choices=(1, 2),
                    help="domain dimension: 1 = interval, 2 = shelf tiling "
                    "or k-d tree (see --domain)")
    ap.add_argument("--domain", default="shelf",
                    choices=("shelf", "kdtree"),
                    help="2D domain kind: shelf tiling (pr x pc cells) or "
                    "adaptive k-d tree (pr*pc median-split leaves)")
    ap.add_argument("--n", type=int, default=512, help="1D state dimension")
    ap.add_argument("--p", type=int, default=8, help="1D subdomains")
    ap.add_argument("--nx", type=int, default=24, help="2D mesh width")
    ap.add_argument("--ny", type=int, default=12, help="2D mesh height")
    ap.add_argument("--pr", type=int, default=2, help="2D strip count")
    ap.add_argument("--pc", type=int, default=4, help="2D cells per strip")
    ap.add_argument("--damping", type=float, default=0.7,
                    help="additive-Schwarz damping (2D tilings converge "
                    "with under-relaxation)")
    ap.add_argument("--m", type=int, default=800, help="observations/cycle")
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="max/mean imbalance ratio arming the rebalance")
    ap.add_argument("--hysteresis", type=int, default=1,
                    help="consecutive over-threshold cycles before firing")
    ap.add_argument("--static", action="store_true",
                    help="disable DyDD (static-DD baseline)")
    ap.add_argument("--overlap", type=int, default=0,
                    help="Schwarz halo width (mesh columns/rows absorbed "
                    "from each grid-graph neighbour)")
    ap.add_argument("--comm", default="allreduce",
                    choices=("allreduce", "neighbour"),
                    help="state-exchange path the comm model prices")
    ap.add_argument("--halo-weight", type=float, default=0.0,
                    help="overlap-aware DyDD: work units per halo column "
                    "added to the loads the schedule balances")
    ap.add_argument("--solver", default="vmapped",
                    choices=("vmapped", "shardmap"),
                    help="vmapped: every subdomain on one device; "
                    "shardmap: one rank per subdomain (needs --backend)")
    ap.add_argument("--backend", default=None, choices=mesh_mod.BACKENDS,
                    help="process-group backend of --solver shardmap "
                    "(gloo: CPU ranks, or card ranks through host copies; "
                    "nccl: one card per rank)")
    ap.add_argument("--solver-kernel", default="auto",
                    choices=ddkf.SOLVER_KERNELS,
                    help="local Schwarz step: auto (fused CUDA kernels on "
                    "the card, plain on the CPU), plain, fused")
    ap.add_argument("--gram-mode", default="auto", choices=ddkf.GRAM_MODES,
                    help="normal-matrix build: auto (gram kernel on the "
                    "card) or plain")
    ap.add_argument("--time-windows", type=int, default=1,
                    help="parallel-in-time windows; > 1 runs the Parareal "
                    "engine")
    ap.add_argument("--pint-tol", type=float, default=1e-8,
                    help="Parareal tolerance on the max boundary correction")
    ap.add_argument("--pint-max-iters", type=int, default=8,
                    help="Parareal iteration cap (0 runs the sequential "
                    "engine)")
    ap.add_argument("--pint-coarse-iters", type=int, default=0,
                    help="coarse Schwarz iterations (0: iters // 10)")
    ap.add_argument("--pint-fine-iters", type=int, default=0,
                    help="fine Schwarz iterations, warm-started from the "
                    "coarse trajectory (0: iters from cold)")
    ap.add_argument("--scenarios", nargs="*", default=None,
                    choices=streams.available(),
                    help="subset of the registered scenarios "
                    "(default: all of this --ndim)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome/Perfetto trace_events timeline "
                    "of the runs here (open at ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="wrap the runs in torch.profiler and write a "
                    "Chrome trace into this directory (kernel-level)")
    ap.add_argument("--residuals", action="store_true",
                    help="journal per-iteration Schwarz residual histories")
    args = ap.parse_args(argv)
    if args.solver == "vmapped":
        run_all(args, args.device)
        return
    if args.backend is None:
        ap.error("--solver shardmap needs --backend gloo or nccl (the "
                 "backend is never chosen for you)")
    ranks = args.p if args.ndim == 1 else args.pr * args.pc
    mesh_mod.launch(run_rank, ranks, backend=args.backend,
                    device=args.device, args=(args,))


if __name__ == "__main__":
    main()
