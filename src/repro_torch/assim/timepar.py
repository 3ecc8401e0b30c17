"""Parallel-in-time assimilation: a time-windowed Parareal engine.

The sequential engine is strictly serial in time — cycle t+1's rhs needs
cycle t's analysis — while everything *else* about a cycle (the DyDD
decision, the repartition, the operator packing, the observation data)
depends only on the stream and the boundary state.  This module exploits
that split, following the DD-DA space-time companions of the source
paper (PAPERS.md: arXiv:2312.00007, arXiv:1807.07107):

  1. **Prepare sweep** — run :meth:`AssimilationEngine.prepare` for every
     cycle of the stream up front, sequentially.  This replays the exact
     rng/domain/truth mutation chain of the sequential engine, so the
     packed operators are bitwise identical to the sequential run's
     (each built by the ``gram`` kernel on the card); only the
     backgrounds are unknown.
  2. **Coarse sweep** — a cheap sequential pass (``pint_coarse_iters``
     Schwarz iterations per cycle, default iters//10) chains approximate
     window-boundary states b_w through the stream.
  3. **Fine sweeps across windows** — each Parareal iteration propagates
     every window from its current boundary state with the *full*
     solver, windows in lockstep: the per-cycle packings are
     width-padded (:func:`ddkf.pad_packed_width`) and solved together:
     stacked (:func:`ddkf.stack_packed`) and solved by
     :func:`ddkf.solve_fleet`, one member after another on one device,
     or on a ``("time", "sub")`` process mesh by
     :func:`ddkf.solve_window_stack` (windows over ``time``, subdomains
     over ``sub``; every rank runs this engine).  With
     ``pint_fine_iters > 0`` each fine solve warm-starts from the coarse
     trajectory of the same cycle and runs only that many Schwarz
     iterations.
  4. **Parareal correction** — sequentially update the boundary states
     ``b_{w+1} <- F(b_w) + G(b_w^new) - G(b_w^old)`` and journal the max
     correction norm per iteration; stop when it drops under
     ``pint_tol`` (in at most W iterations by Parareal's finite
     termination).

Every coarse and single-device fine Schwarz iteration runs the
``schwarz_fwd`` and ``schwarz_bwd`` kernels on the card
(``solver_kernel="auto"``); the mesh's fine sweeps run the reference's
batched composition, as its ``solve_window_stack`` does.

Contract: **tolerance, not bitwise** — the windowed analysis chain
matches the sequential engine's within ``pint_tol`` (plus reduction-
order ULPs from the padded solves).  The degenerate settings
``time_windows=1`` or ``pint_max_iters=0`` run the sequential engine
itself: bitwise identity by construction.

Checkpoints: ``run(checkpoint_dir=..., snapshot_every=k)`` saves an
engine snapshot at every k-th window boundary, from the host state
stashed there during the prepare sweep, with a ``"pint"`` window
descriptor in its metadata; the sequential engine resumes from it.

The mesh: when the process group is initialised, every rank runs the
same engine — the prepare sweep, the coarse sweeps and the corrections
(deterministic, so every rank holds the same boundary states) — and the
fine sweeps split over a ``("time", "sub")`` mesh built over the ranks
(:func:`resolve_time_mesh`) or given as ``mesh=``.  Without a process
group the fine sweeps run on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import ddkf as ddkf_mod
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.assim import streams as streams_mod
from repro_torch.assim.engine import (AssimilationEngine, CycleStep,
                                      EngineConfig, _to_numpy)
from repro_torch.assim.metrics import Journal


def window_bounds(cycles: int, windows: int) -> list:
    """Near-even partition of ``cycles`` into ``windows`` contiguous
    windows: W+1 boundary indices (window w is [bounds[w], bounds[w+1])).
    Pure function of the two counts — the window ids journalled per
    cycle are deterministic."""
    W = max(1, min(int(windows), int(cycles)))
    return [cycles * w // W for w in range(W + 1)]


def resolve_time_mesh(time_windows: int, p: int, time_axis: str = "time",
                      sub_axis: str = "sub", device=None):
    """Build a ``("time", "sub")`` process mesh over every rank of the
    process group, or None when there is no process group or the world
    size does not factor (the fine sweeps then run on one device).

    Picks the largest time-axis size kt such that kt divides the world
    size, kt covers at most ``time_windows`` windows, and the remaining
    ks = world / kt divides p (:func:`ddkf.solve_window_stack` needs both
    axes to divide their problem dimension).  Every rank must call it."""
    if not torch.distributed.is_initialized():
        return None
    world = torch.distributed.get_world_size()
    for kt in range(min(int(time_windows), world), 0, -1):
        if world % kt:
            continue
        ks = world // kt
        if p % ks == 0:
            return mesh_mod.ProcessMesh((kt, ks), (time_axis, sub_axis),
                                        device=device)
    return None


class TimeParEngine:
    """Time-windowed Parareal driver around an :class:`AssimilationEngine`.

    Usage::

        cfg = EngineConfig(n=128, p=2, iters=120, time_windows=4)
        eng = TimeParEngine(cfg)                  # on the card
        journal = eng.run(streams.make_stream("drifting_swarm", 400, 16))
        eng.analyses          # per-cycle analysis chain (np arrays)
        journal.meta["pint"]  # iterations, correction norms, convergence

    ``device=None`` means the card and raises when there is none
    (``device="cpu"`` runs on the CPU).  ``mesh`` (optional) must carry
    the ``time_axis`` and ``sub_axis`` axes; by default, when a process
    group is initialised, one is built over its ranks
    (:func:`resolve_time_mesh`).  The inner engine journals every
    cycle exactly as the sequential engine does (same phases, same comm
    accounting, window-tagged records); ``journal.meta["pint"]`` carries
    the Parareal evidence.  With ``time_windows=1`` or
    ``pint_max_iters=0`` the run *is* the sequential engine (bitwise
    identical journal, no pint meta).
    """

    def __init__(self, config: EngineConfig, device=None, *,
                 forecast: Optional[Callable] = None,
                 domain=None, mesh=None, time_axis: str = "time",
                 sub_axis: str = "sub", chaos=None):
        self.cfg = config
        self.time_axis = time_axis
        self.sub_axis = sub_axis
        self._degenerate = (config.time_windows <= 1
                            or config.pint_max_iters == 0)
        # The windowed path dispatches its fine solves itself; the inner
        # engine only prepares, journals and (in degenerate mode) runs.
        eng_cfg = config if self._degenerate else dataclasses.replace(
            config, solver="vmapped")
        self.engine = AssimilationEngine(eng_cfg, device, forecast=forecast,
                                         domain=domain, chaos=chaos)
        if mesh is not None:
            for ax in (time_axis, sub_axis):
                if ax not in mesh.shape:
                    raise ValueError(
                        f"mesh is missing the {ax!r} axis (has "
                        f"{tuple(mesh.shape)})")
            if self.engine.p % int(mesh.shape[sub_axis]):
                raise ValueError(
                    f"p={self.engine.p} subdomains do not divide over "
                    f"the {int(mesh.shape[sub_axis])}-device "
                    f"'{sub_axis}' mesh axis")
        self.mesh = mesh if not self._degenerate else None
        self._auto_mesh = mesh is None
        self.analyses: list = []
        # Host state at each window boundary of the last windowed run.
        self.window_host: dict = {}
        self.engine.on_analysis = \
            lambda cycle, x: self.analyses.append(_to_numpy(x))

    # -- conveniences mirroring the sequential engine ----------------------

    @property
    def journal(self) -> Journal:
        return self.engine.journal

    @property
    def analysis(self):
        return self.engine.analysis

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def run_scenario(self, name: str, m: int, cycles: int,
                     seed: int = 0, **kw) -> Journal:
        spec = streams_mod.get(name)
        if spec.ndim != self.engine.domain.ndim:
            raise ValueError(
                f"scenario {name!r} is {spec.ndim}D but the engine "
                f"domain is {self.engine.domain.ndim}D")
        return self.run(streams_mod.make_stream(name, m, cycles,
                                                seed=seed, **kw))

    # -- driver -------------------------------------------------------------

    def run(self, stream: Iterable[np.ndarray], *,
            checkpoint_dir: str | None = None,
            snapshot_every: int = 0) -> Journal:
        """Consume the stream to exhaustion; returns the journal.

        Degenerate configs (``time_windows=1`` / ``pint_max_iters=0``)
        delegate to :meth:`AssimilationEngine.run` unchanged — including
        its per-cycle snapshot cadence.  The windowed path snapshots on
        window boundaries instead, every ``snapshot_every`` *windows*.
        """
        if self._degenerate:
            return self.engine.run(stream, checkpoint_dir=checkpoint_dir,
                                   snapshot_every=snapshot_every)
        try:
            return self._run_windowed(stream, checkpoint_dir,
                                      snapshot_every)
        finally:
            # The packed operators of every cycle stay on the device for
            # the whole run; let them go with it.
            self._preps = self._padded_ops = None

    def _background(self, x) -> np.ndarray:
        eng = self.engine
        return (np.zeros(eng.n) if x is None
                else _to_numpy(eng.forecast(x)))

    def _with_rhs(self, c: int, bg: np.ndarray) -> ddkf_mod.PackedDD:
        """Cycle c's width-padded operator with the rhs of background
        ``bg``."""
        prep = self._preps[c]
        return ddkf_mod.with_rhs(self._padded_ops[c],
                                 np.concatenate([prep.H0 @ bg, prep.y1]))

    def _coarse_window(self, bounds, w: int, x):
        """Chain the coarse propagator through window w from boundary
        state ``x`` (None = cold zero background).  Returns the end
        state plus the per-cycle coarse trajectory — the warm starts the
        next fine sweep of this window reuses."""
        cfg = self.cfg
        coarse_iters = cfg.pint_coarse_iters or max(1, cfg.iters // 10)
        traj = []
        for c in range(bounds[w], bounds[w + 1]):
            x = ddkf_mod.solve_vmapped(
                self._with_rhs(c, self._background(x)),
                iters=coarse_iters, damping=cfg.damping)
            traj.append(x)
        return traj[-1], traj

    def _solve_stack(self, packs: list, x0s=None) -> torch.Tensor:
        """One fine solve of a same-shape group of active windows.

        ``x0s`` (optional, one (n,) tensor per pack) warm-starts each
        window's solve — set only when ``pint_fine_iters`` trims the
        fine iteration count."""
        cfg = self.cfg
        iters = cfg.pint_fine_iters or cfg.iters
        if self.mesh is not None:
            # Pad the group to a multiple of the time axis with copies of
            # its first window; each rank stacks only its own share.
            pad = (-len(packs)) % int(self.mesh.shape[self.time_axis])
            x0 = (None if x0s is None
                  else torch.stack(list(x0s) + [x0s[0]] * pad))
            xs = ddkf_mod.solve_window_stack(
                packs + [packs[0]] * pad, self.mesh,
                time_axis=self.time_axis, sub_axis=self.sub_axis,
                iters=iters, damping=cfg.damping, x0=x0)
            return xs[:len(packs)]
        x0 = None if x0s is None else torch.stack(x0s)
        return ddkf_mod.solve_fleet(
            ddkf_mod.stack_packed(packs), iters=iters, damping=cfg.damping,
            x0=x0)

    def _fine_sweep(self, bounds, b_in, coarse_traj=None):
        """Propagate every window from its boundary state with the full
        solver, windows advancing in lockstep (window-step j solves one
        cycle of every still-active window in one stacked call).

        When ``pint_fine_iters`` is set, ``coarse_traj`` (per-window
        per-cycle coarse analyses, computed from the *same* boundary
        states ``b_in``) warm-starts every solve.

        Returns (per-window end states, per-cycle analyses/backgrounds/
        solve-time shares)."""
        W = len(bounds) - 1
        lens = [bounds[w + 1] - bounds[w] for w in range(W)]
        x = list(b_in[:W])
        C = len(self._preps)
        warm = self.cfg.pint_fine_iters > 0 and coarse_traj is not None
        analyses = [None] * C
        backgrounds = [None] * C
        solve_times = [0.0] * C
        for j in range(max(lens)):
            active = [w for w in range(W) if lens[w] > j]
            # Same-shape grouping: scenarios can vary the per-cycle row
            # count, so bucket by the stack key (width already padded to
            # the stream-wide max).
            groups: dict = {}
            bgs = {}
            for w in active:
                bgs[w] = self._background(x[w])
                pk = self._with_rhs(bounds[w] + j, bgs[w])
                groups.setdefault((pk.m, pk.w), []).append((w, pk))
            t0 = time.perf_counter()
            for grp in groups.values():
                x0s = ([coarse_traj[w][j] for w, _ in grp] if warm
                       else None)
                xs = self._solve_stack([pk for _, pk in grp], x0s=x0s)
                for (w, _), xw in zip(grp, xs):
                    x[w] = xw
            device_mod.block(x[active[-1]])
            dt = (time.perf_counter() - t0) / max(len(active), 1)
            for w in active:
                c = bounds[w] + j
                analyses[c] = x[w]
                backgrounds[c] = bgs[w]
                solve_times[c] = dt
        return x, analyses, backgrounds, solve_times

    def _run_windowed(self, stream, checkpoint_dir, snapshot_every):
        eng = self.engine
        cfg = self.cfg
        retries = max(cfg.solve_retries, 0)
        eng._stream = stream if hasattr(stream, "cursor") else None
        pos0 = getattr(stream, "pos", 0)
        obs_list = list(stream)
        C = len(obs_list)
        if C == 0:
            return eng.journal
        base = len(eng.journal.records)
        bounds = window_bounds(C, cfg.time_windows)
        W = len(bounds) - 1
        lens = [bounds[w + 1] - bounds[w] for w in range(W)]
        if self._auto_mesh:
            self.mesh = resolve_time_mesh(W, eng.p, self.time_axis,
                                          self.sub_axis, device=eng.device)
        eng.reset_clock()
        m = meters_mod.get_meters()

        # -- 1. prepare sweep (the sequential engine's exact mutation
        # chain), stashing host state at each window boundary ------------
        steps: list = []
        self.window_host = {}
        with trace_mod.span("pint.prepare", cycles=C, windows=W):
            for w in range(W):
                for c in range(bounds[w], bounds[w + 1]):
                    step = CycleStep(cycle=base + c, obs=obs_list[c],
                                     window=w)
                    step.prep = chaos_mod.retry_transient(
                        lambda: eng.prepare(step.cycle, step.obs,
                                            window=step.window),
                        retries=retries, site="pack", cycle=step.cycle)
                    steps.append(step)
                hs = eng.host_state()
                if hs["cursor"] is not None:
                    # The stream is fully drained; rewind the recorded
                    # cursor to this boundary so resume fast-forwards to
                    # exactly here.
                    hs["cursor"]["pos"] = pos0 + bounds[w + 1]
                self.window_host[w] = hs
        self._preps = [s.prep for s in steps]
        w_max = max(p.packed_op.w for p in self._preps)
        # Width-padded operators, built once: both sweeps re-solve each
        # cycle every Parareal iteration, and padding is boundary-state
        # independent.  Only the padded copy is kept: the journal reads
        # nothing of the packing.
        self._padded_ops = []
        for p in self._preps:
            self._padded_ops.append(ddkf_mod.pad_packed_width(
                p.packed_op, w_max))
            p.packed_op = None

        # -- 2. coarse init sweep ----------------------------------------
        b = [None] * (W + 1)
        b[0] = eng.analysis
        G_old = [None] * W
        G_traj = [None] * W
        with trace_mod.span("pint.coarse", windows=W):
            for w in range(W):
                G_old[w], G_traj[w] = self._coarse_window(bounds, w, b[w])
                b[w + 1] = G_old[w]

        # -- 3./4. Parareal iterations -----------------------------------
        correction_norms: list = []
        converged = False
        analyses = backgrounds = solve_times = None
        iters_done = 0
        for k in range(cfg.pint_max_iters):
            with trace_mod.span("pint.fine", iteration=k, windows=W):
                F_end, analyses, backgrounds, solve_times = \
                    self._fine_sweep(bounds, b, G_traj)
            iters_done = k + 1
            m.inc("pint.iterations")
            with trace_mod.span("pint.correct", iteration=k):
                new_b = [b[0]] + [None] * W
                max_corr = 0.0
                for w in range(W):
                    g_new, G_traj[w] = self._coarse_window(bounds, w,
                                                           new_b[w])
                    s = F_end[w] + g_new - G_old[w]
                    G_old[w] = g_new
                    max_corr = max(max_corr, float(torch.max(torch.abs(
                        s - b[w + 1]))))
                    new_b[w + 1] = s
                b = new_b
            correction_norms.append(max_corr)
            m.observe("pint.correction_norm", max_corr)
            if max_corr <= cfg.pint_tol:
                converged = True
                break
        m.event("pint.converged" if converged else "pint.exhausted",
                iters=iters_done, windows=W,
                final_norm=correction_norms[-1])

        eng.journal.meta["pint"] = {
            "time_windows": W,
            "window_sizes": lens,
            "coarse_iters": (cfg.pint_coarse_iters
                             or max(1, cfg.iters // 10)),
            "fine_iters": cfg.pint_fine_iters or cfg.iters,
            "warm_start": bool(cfg.pint_fine_iters),
            "iters": iters_done,
            "max_iters": cfg.pint_max_iters,
            "correction_norms": [float(v) for v in correction_norms],
            "converged": bool(converged),
            "tol": float(cfg.pint_tol),
            "mesh": (None if self.mesh is None else
                     {str(a): int(k) for a, k in self.mesh.shape.items()}),
        }

        # -- 5. ordered completion: journal every cycle with the last
        # fine sweep's analyses; checkpoints on window boundaries --------
        for c, step in enumerate(steps):
            step.analysis = analyses[c]
            step.background = backgrounds[c]
            step.solve_time = solve_times[c]
            eng.finish_step(step)
            w = step.window
            if (c + 1 == bounds[w + 1] and checkpoint_dir is not None
                    and snapshot_every > 0
                    and (w + 1) % snapshot_every == 0):
                # On a mesh every rank completes the same chain: one
                # writes each window's step (AssimilationEngine.
                # save_checkpoint).
                eng.save_checkpoint(
                    checkpoint_dir, step=base + c + 1,
                    host_state=self.window_host[w],
                    extra_meta={"pint": {"window": w,
                                         "time_windows": W}},
                    mesh=self.mesh)
        return eng.journal
