"""Streaming multi-cycle DD-KF assimilation engine with online DyDD.

The engine consumes an observation stream cycle by cycle and, per cycle:

  1. counts the incoming observations against the *current* subdomain
     boundaries of its :class:`~repro_torch.core.domain.Domain` and
     decides — threshold + hysteresis, see :class:`EngineConfig` — whether
     to fire a DyDD repartition;
  2. decomposes the state index set on the (possibly moved) boundaries and
     packs the local operator blocks — host-side slicing, the copy to the
     device and the batched normal-matrix/Cholesky build there
     (``ddkf.pack_operator``, the ``gram`` kernel);
  3. injects the cycle's right-hand side (background carried forward from
     the previous analysis + fresh observation data) and runs the DD-KF
     solve on one device (``ddkf.solve_vmapped``, the fused Schwarz
     kernels);
  4. journals loads, imbalance, migration volume and timings
     (:mod:`repro_torch.assim.metrics`).

Pipelining: with ``double_buffer=True`` steps 1+2 for cycle t+1 run on a
host worker thread while the device solves cycle t.  This is sound
because the rebalance decision and the operator packing depend only on
the observation stream and the boundary state — never on a solve result;
only the rhs (step 3) consumes the carried analysis, and it is injected
on the main thread.  Both threads launch on the default CUDA stream, so
the device runs their work in the order it was queued, and ``prepare``
waits for its own packing before it returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import cls as cls_mod
from repro_torch.core import dd as dd_mod
from repro_torch.core import ddkf as ddkf_mod
from repro_torch.core import domain as domain_mod
from repro_torch.core import dydd as dydd_mod
from repro_torch.core import kdtree as kdtree_mod
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor
from repro_torch.assim import streams as streams_mod
from repro_torch.assim.metrics import CycleMetrics, Journal, imbalance_ratio


@contextlib.contextmanager
def _phase(phases: dict, name: str, **args):
    """Time one engine phase into both telemetry sinks: the journal's
    per-cycle ``phases`` dict (always, via perf_counter) and the active
    tracer's span timeline (a shared no-op when tracing is off)."""
    t0 = time.perf_counter()
    with trace_mod.span(name, **args):
        yield
    phases[name] = phases.get(name, 0.0) + (time.perf_counter() - t0)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1 "
        f"item {item})")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Streaming DD-KF engine configuration (the fields of
    ``repro.assim.engine.EngineConfig``, plus ``gram_mode``).

    Domain selection: ``ndim=1`` (default) runs on an
    :class:`~repro_torch.core.domain.Interval1D` with ``p`` subdomains
    over an ``n``-point mesh; ``ndim=2`` runs on a
    :class:`~repro_torch.core.domain.ShelfTiling2D` of ``pr x pc`` cells
    over an ``nx x ny`` raster mesh (``nx``/``ny`` default to the
    most-square factoring of ``n``); ``domain_kind="kdtree"`` runs on a
    k-d tree of ``p`` leaves.  An explicit ``domain=`` handed to the
    engine overrides all of these.

    Solver: ``solver="vmapped"`` batches subdomains on a leading axis of
    one device (the only solver ported so far).  ``overlap`` (>= 0) is the
    Schwarz halo width, with ``mu`` the overlap regularization of eq.
    25-26.  ``solver_kernel`` picks the local step ("auto": the fused
    CUDA kernels on the card, the plain composition on the CPU) and
    ``gram_mode`` the normal-matrix build ("auto": the gram kernel on the
    card; "plain": the plain version).

    Rebalance trigger policy: a repartition fires at the start of a cycle
    when EITHER (a) some subdomain would receive zero observations, or
    (b) the max/mean load ratio against the incoming boundaries has
    exceeded ``imbalance_threshold`` for ``hysteresis`` consecutive
    cycles.
    """

    n: int = 256                      # state dimension
    p: int = 4                        # subdomains (1D, kdtree leaves)
    ndim: int = 1                     # 1 = Interval1D, 2 = ShelfTiling2D
    domain_kind: Optional[str] = None  # "interval" | "shelf" | "kdtree";
                                      # None derives from ndim
    pr: int = 2                       # 2D: strip count
    pc: int = 2                       # 2D: cells per strip
    nx: Optional[int] = None          # 2D: mesh width (default: factor n)
    ny: Optional[int] = None          # 2D: mesh height
    overlap: int = 0                  # shared columns between neighbours
    mu: float = 1.0                   # overlap regularization
    iters: int = 120                  # DD-KF Schwarz iterations per cycle
    damping: float = 1.0              # additive-Schwarz under-relaxation
    rebalance: bool = True            # online DyDD on/off (off = static DD)
    imbalance_threshold: float = 1.5  # max/mean ratio that arms the trigger
    hysteresis: int = 1               # consecutive over-threshold cycles
    double_buffer: bool = True        # overlap t+1 packing with t's solve
    track_reference: bool = False     # per-cycle ||x - one_shot|| (O(n^3))
    seed: int = 0                     # truth trajectory + data noise
    smooth: float = 0.25              # H0 second-difference weight
    obs_noise: float = 1e-3           # observation data noise
    truth_drift: float = 0.05         # per-cycle truth random-walk scale
    solver: str = "vmapped"           # "vmapped" ("shardmap": not ported)
    comm: str = "allreduce"           # modelled overlap exchange:
                                      # "allreduce" | "neighbour"
    halo_weight: float = 0.0          # overlap-aware DyDD: work units per
                                      # halo column
    record_residuals: bool = False    # journal the per-iteration Schwarz
                                      # update-norm history
    solver_kernel: str = "auto"       # "auto" | "plain" | "fused"
    gram_mode: str = "auto"           # "auto" | "plain"
    solve_retries: int = 2            # retries under fault injection
                                      # (chaos is not ported yet)
    time_windows: int = 1             # parallel-in-time windows (only 1
                                      # is ported)
    pint_tol: float = 1e-8            # Parareal settings, read only by the
    pint_max_iters: int = 8           # parallel-in-time engine (not
    pint_coarse_iters: int = 0        # ported yet)
    pint_fine_iters: int = 0


def _resolve_mesh_shape(cfg: EngineConfig) -> tuple:
    """(nx, ny) of the 2D raster mesh from the config (factor n if only
    one or neither axis is given)."""
    nx, ny = cfg.nx, cfg.ny
    if nx is None and ny is None:
        return domain_mod.factor_mesh(cfg.n)
    if nx is None or ny is None:
        given = nx if nx is not None else ny
        if given < 1 or cfg.n % given:
            raise ValueError(
                f"mesh axis {given} does not divide n={cfg.n}; give "
                f"both nx and ny or a divisor of n")
        return (given, cfg.n // given) if nx is not None \
            else (cfg.n // given, given)
    return nx, ny


def _domain_from_config(cfg: EngineConfig) -> domain_mod.Domain:
    if cfg.ndim not in (1, 2):
        raise ValueError(f"ndim must be 1 or 2 (got {cfg.ndim})")
    kind = cfg.domain_kind
    if kind is None:
        kind = "interval" if cfg.ndim == 1 else "shelf"
    if kind == "interval":
        return domain_mod.Interval1D(n=cfg.n, p=cfg.p)
    if kind == "shelf":
        nx, ny = _resolve_mesh_shape(cfg)
        return domain_mod.ShelfTiling2D(nx=nx, ny=ny, pr=cfg.pr, pc=cfg.pc)
    if kind == "kdtree":
        nx, ny = _resolve_mesh_shape(cfg)
        return kdtree_mod.KDTreeDomain(nx=nx, ny=ny, p=cfg.p)
    raise ValueError(f"domain_kind must be 'interval', 'shelf' or "
                     f"'kdtree' (got {cfg.domain_kind!r})")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class _Prepared:
    """Host-side work for one cycle, computable before cycle t-1 finishes."""

    cycle: int
    obs: np.ndarray
    packed_op: "ddkf_mod.PackedDD"
    H0: np.ndarray
    H1: np.ndarray
    y1: np.ndarray                # observation data (truth-driven)
    loads: np.ndarray             # post-repartition per-subdomain counts
    loads_before: np.ndarray      # counts against the incoming boundaries
    loads_weighted: np.ndarray    # loads + halo-cost offsets
    imbalance_before: float
    repartitioned: bool
    migrated: int
    rounds: int
    pack_time: float
    halo: "dd_mod.HaloExchange | None"
    comm_bytes_per_cycle: float
    halo_fraction: float
    rebalance_suppressed: bool = False
    phases: dict = dataclasses.field(default_factory=dict)
    comm_edge_bytes_per_cycle: dict = dataclasses.field(
        default_factory=dict)
    comm_mvec_bytes_per_cycle: float = 0.0
    comm_mvec_axis_bytes_per_cycle: dict = dataclasses.field(
        default_factory=dict)
    window: int = -1


@dataclasses.dataclass
class CycleStep:
    """One cycle of the engine's per-cycle state machine:
    :meth:`AssimilationEngine.prepare` fills ``prep``,
    :meth:`AssimilationEngine.solve_step` fills the solve outputs,
    :meth:`AssimilationEngine.finish_step` journals it."""

    cycle: int
    obs: np.ndarray
    window: int = -1
    prep: Optional[_Prepared] = None
    analysis: Optional[torch.Tensor] = None
    background: Optional[np.ndarray] = None
    solve_time: float = 0.0
    hist: object = None
    device_times: list = dataclasses.field(default_factory=list)


class AssimilationEngine:
    """Multi-cycle DD-KF with online DyDD rebalancing on a Domain.

    Usage::

        cfg = EngineConfig(n=128, p=4, rebalance=True)
        eng = AssimilationEngine(cfg)                 # on the card
        journal = eng.run(streams.make_stream("drifting_swarm", 400, 6))

        eng = AssimilationEngine(cfg, device="cpu")   # on the CPU

    ``device=None`` means the card and raises when there is none.  The
    analysis of cycle t is carried as the background of cycle t+1
    (persistence forecast by default; pass ``forecast`` to override).
    ``eng.analysis`` holds the latest analysis state (a tensor on the
    engine's device).
    """

    def __init__(self, config: EngineConfig, device=None, *,
                 forecast: Optional[Callable] = None,
                 domain: Optional[domain_mod.Domain] = None,
                 straggler_config: Optional[StragglerConfig] = None,
                 chaos=None):
        self.cfg = config
        self.device = device_mod.resolve(device)
        self.forecast = forecast or (lambda x: x)
        if config.solver == "shardmap":
            raise _not_ported("solver='shardmap'", "11")
        if config.solver != "vmapped":
            raise ValueError(f"unknown solver {config.solver!r}")
        if config.time_windows > 1:
            raise _not_ported("time_windows > 1 (Parareal)", "10")
        if chaos is not None:
            raise _not_ported("chaos injection", "8")
        if config.comm not in ("allreduce", "neighbour"):
            raise ValueError(f"comm must be 'allreduce' or 'neighbour' "
                             f"(got {config.comm!r})")
        if config.solver_kernel not in ddkf_mod.SOLVER_KERNELS:
            raise ValueError(
                f"solver_kernel must be one of {ddkf_mod.SOLVER_KERNELS} "
                f"(got {config.solver_kernel!r})")
        if config.gram_mode not in ddkf_mod.GRAM_MODES:
            raise ValueError(
                f"gram_mode must be one of {ddkf_mod.GRAM_MODES} "
                f"(got {config.gram_mode!r})")
        if config.halo_weight < 0:
            raise ValueError(f"halo_weight is a per-halo-column work cost "
                             f"and must be >= 0 (got {config.halo_weight})")
        if config.overlap < 0:
            raise ValueError(
                f"overlap is a halo width and must be >= 0 "
                f"(got {config.overlap})")
        if config.hysteresis < 1:
            raise ValueError(
                f"hysteresis must be >= 1 (got {config.hysteresis}); "
                f"1 means fire as soon as the threshold is crossed")
        if config.imbalance_threshold < 1.0:
            raise ValueError(
                f"imbalance_threshold is a max/mean ratio and must be "
                f">= 1.0 (got {config.imbalance_threshold})")

        self.domain = domain if domain is not None \
            else _domain_from_config(config)
        self.n = self.domain.n
        self.p = self.domain.p
        self.journal = Journal(meta=self.domain.describe())
        self.analysis: Optional[torch.Tensor] = None
        self._H0 = cls_mod.state_operator(self.n, smooth=config.smooth)
        self._rng = np.random.default_rng(config.seed)
        self._truth = self._rng.normal(size=self.n)
        self._streak = 0  # consecutive over-threshold cycles
        self._last_rebalance_loads: Optional[np.ndarray] = None
        self._suppressed = False  # this cycle's trigger was suppressed
        self._dec_cache: Optional[dd_mod.Decomposition] = None
        self._t_last = time.perf_counter()
        # One straggler monitor per subdomain, as the reference keeps;
        # the single-device solve feeds monitor 0 the whole-solve time.
        self._stragglers = [StragglerMonitor(straggler_config)
                            for _ in range(self.p)]
        # Optional per-cycle analysis hook: ``on_analysis(cycle, x)``.
        self.on_analysis: Optional[Callable] = None

    # -- rebalance trigger policy ------------------------------------------

    def _should_rebalance(self, loads: np.ndarray) -> bool:
        self._suppressed = False
        if not self.cfg.rebalance:
            self._streak = 0
            return False
        fire = False
        if (loads == 0).any():
            # Empty subdomain: the DD step cannot wait out the hysteresis.
            self._streak = 0
            fire = True
        else:
            if imbalance_ratio(loads) > self.cfg.imbalance_threshold:
                self._streak += 1
            else:
                self._streak = 0
            if self._streak >= self.cfg.hysteresis:
                self._streak = 0
                fire = True
        if fire and self._last_rebalance_loads is not None \
                and np.array_equal(loads, self._last_rebalance_loads):
            # The last rebalance already left exactly these loads: re-firing
            # would schedule the same targets again — suppress, and journal
            # the suppression.
            self._suppressed = True
            return False
        return fire

    # -- host-side cycle preparation (runs on the worker thread) -----------

    def _current_dec(self) -> dd_mod.Decomposition:
        """The decomposition of the *current* boundaries, cached across
        cycles and invalidated only by a rebalance."""
        if self._dec_cache is None:
            self._dec_cache = self.domain.decomposition(
                overlap=self.cfg.overlap)
        return self._dec_cache

    def _halo_offsets(self) -> np.ndarray | None:
        if self.cfg.halo_weight <= 0 or self.cfg.overlap <= 0:
            return None
        return self.cfg.halo_weight * self._current_dec().halo_sizes

    def prepare(self, cycle: int, obs: np.ndarray,
                window: int = -1) -> _Prepared:
        """Host-side work for one cycle: DyDD decision, repartition,
        operator packing (ending in the device-side factor build, waited
        for here so ``pack_time`` is honest), observation data.  Depends
        only on the stream and boundary state — never on a solve result —
        so it may run on a worker thread while the device solves an
        earlier cycle.  At most one ``prepare`` per engine may be in
        flight at a time."""
        t0 = time.perf_counter()
        cfg = self.cfg
        obs = np.asarray(obs, dtype=np.float64)
        phases: dict = {}

        with _phase(phases, "count", cycle=cycle):
            loads_in = self.domain.counts(obs)
            imb_before = imbalance_ratio(loads_in)
            fire = self._should_rebalance(loads_in)
        repartitioned, migrated, rounds = False, 0, 0
        if fire:
            with _phase(phases, "dydd", cycle=cycle):
                info = self.domain.rebalance(
                    obs, cost_offsets=self._halo_offsets())
            repartitioned = True
            migrated = info.migrated
            rounds = info.rounds
            self._dec_cache = None   # boundaries moved
        suppressed = self._suppressed
        loads = self.domain.counts(obs)
        if repartitioned:
            self._last_rebalance_loads = np.asarray(loads).copy()

        with _phase(phases, "halo", cycle=cycle):
            dec = self._current_dec()
            loads_weighted = loads + np.rint(
                cfg.halo_weight * dec.halo_sizes).astype(np.int64)
            halo = dec.halo_exchange
        with _phase(phases, "pack", cycle=cycle, p=self.p):
            H1 = cls_mod.observation_operator(
                self.n, self.domain.obs_positions(obs),
                block=self.domain.row_size)
            A = np.concatenate([self._H0, H1], axis=0)
            r = np.ones((A.shape[0],))
            packed_op = ddkf_mod.pack_operator(
                A, r, dec, mu=cfg.mu, gram_mode=cfg.gram_mode,
                solver_kernel=cfg.solver_kernel, device=self.device)
            device_mod.block(packed_op.L_loc)

        with _phase(phases, "data", cycle=cycle):
            # Truth-driven observation data: the truth random-walks each
            # cycle (deterministic under cfg.seed, independent of any
            # solve result — which is what makes this method
            # pipelineable).
            self._truth = ((1.0 - cfg.truth_drift) * self._truth
                           + cfg.truth_drift * self._rng.normal(
                               size=self.n))
            y1 = H1 @ self._truth + cfg.obs_noise * self._rng.normal(
                size=H1.shape[0])

        # Modelled per-cycle communication volume of a sharded solve of
        # this packing (journalled as the reference does).
        axis_names, axis_shape = self.domain.mesh_axes()
        stats = packed_op.comm_stats(halo=halo, comm=cfg.comm,
                                     mesh_shape=axis_shape)
        comm_bytes = stats["bytes_per_iter_total"] * cfg.iters
        edge_bytes = {k: float(v) * cfg.iters
                      for k, v in packed_op.edge_send_bytes(halo).items()}
        mvec_bytes = (stats["mvec_bytes_per_device"] * self.p * cfg.iters)
        mvec_axis_bytes = {
            name: float(v) * self.p * cfg.iters
            for name, v in zip(axis_names,
                               stats["mvec_bytes_per_device_per_axis"])}

        return _Prepared(cycle=cycle, obs=obs, packed_op=packed_op,
                         H0=self._H0, H1=H1, y1=y1, loads=loads,
                         loads_before=loads_in,
                         loads_weighted=loads_weighted,
                         imbalance_before=imb_before,
                         repartitioned=repartitioned, migrated=migrated,
                         rounds=rounds,
                         pack_time=time.perf_counter() - t0,
                         halo=halo,
                         comm_bytes_per_cycle=float(comm_bytes),
                         halo_fraction=dec.halo_fraction,
                         rebalance_suppressed=suppressed,
                         phases=phases,
                         comm_edge_bytes_per_cycle=edge_bytes,
                         comm_mvec_bytes_per_cycle=float(mvec_bytes),
                         comm_mvec_axis_bytes_per_cycle=mvec_axis_bytes,
                         window=window)

    # -- device-side solve (main thread) -----------------------------------

    def solve_input(self, prep: _Prepared):
        """(rhs-injected packing, background) for a prepared cycle — the
        only step that consumes the carried analysis, so it must run
        *after* the previous cycle's :meth:`complete_cycle`."""
        background = (np.zeros(self.n) if self.analysis is None
                      else _to_numpy(self.forecast(self.analysis)))
        y0 = prep.H0 @ background
        packed = ddkf_mod.with_rhs(prep.packed_op,
                                   np.concatenate([y0, prep.y1]))
        return packed, background

    def _solve(self, prep: _Prepared):
        """Returns (analysis, background, residual_hist, device_times);
        ``device_times`` is empty on this single-device path (the caller
        substitutes the whole-solve time)."""
        cfg = self.cfg
        packed, background = self.solve_input(prep)
        hist = None
        with trace_mod.span("solve", cycle=prep.cycle,
                            solver=cfg.solver) as sp:
            out = ddkf_mod.solve_vmapped(
                packed, iters=cfg.iters, damping=cfg.damping,
                residual_history=cfg.record_residuals)
            x = out[0] if cfg.record_residuals else out
            if cfg.record_residuals:
                hist = out[1]
            sp.fence(x)
        return x, background, hist, []

    def _reference_error(self, prep: _Prepared, background: np.ndarray,
                         x: torch.Tensor) -> float:
        """||x_engine - x_one_shot|| for the cycle's CLS problem."""
        prob = cls_mod.from_arrays(prep.H0, prep.H0 @ background, prep.H1,
                                   prep.y1, x.dtype, x.device)
        return float(torch.linalg.norm(x - cls_mod.solve(prob)))

    # -- driver -------------------------------------------------------------

    def run(self, stream: Iterable[np.ndarray], *,
            checkpoint_dir: str | None = None,
            snapshot_every: int = 0) -> Journal:
        """Consume the stream to exhaustion; returns the journal.  Cycle
        numbering continues from the journal."""
        if checkpoint_dir is not None or snapshot_every:
            raise _not_ported("checkpointing", "8")
        it = iter(stream)
        base = len(self.journal.records)
        self._t_last = time.perf_counter()

        def finish(step: CycleStep) -> None:
            self.finish_step(self.solve_step(step))

        if not self.cfg.double_buffer:
            for i, obs in enumerate(it):
                step = CycleStep(cycle=base + i, obs=obs)
                step.prep = self.prepare(step.cycle, step.obs)
                finish(step)
            return self.journal

        # Double-buffered: prepare cycle t+1 on the worker while the main
        # thread solves cycle t.  prepare mutates boundary/truth state, so
        # exactly one prepare is in flight at a time (single worker, next
        # submit only after the previous result is claimed).
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="pack") as pool:
            first = next(it, None)
            if first is None:
                return self.journal
            step = CycleStep(cycle=base, obs=first)
            fut = pool.submit(self.prepare, step.cycle, step.obs)
            cycle = base
            while fut is not None:
                step.prep = fut.result()
                cur = step
                cycle += 1
                fut = None
                nxt = next(it, None)
                if nxt is not None:
                    step = CycleStep(cycle=cycle, obs=nxt)
                    fut = pool.submit(self.prepare, step.cycle, step.obs)
                finish(cur)
        return self.journal

    def run_scenario(self, name: str, m: int, cycles: int,
                     seed: int = 0, **kw) -> Journal:
        """Convenience: run a registered stream scenario end to end."""
        spec = streams_mod.get(name)
        if spec.ndim != self.domain.ndim:
            raise ValueError(
                f"scenario {name!r} is {spec.ndim}D but the engine domain "
                f"is {self.domain.ndim}D")
        return self.run(streams_mod.make_stream(name, m, cycles,
                                                seed=seed, **kw))

    def solve_step(self, step: CycleStep) -> CycleStep:
        """Stage 2 of the cycle state machine: the device solve, wall
        time measured to analysis-ready."""
        t0 = time.perf_counter()
        x, background, hist, device_times = self._solve(step.prep)
        step.analysis = device_mod.block(x)
        step.background = background
        step.hist = hist
        step.device_times = device_times
        step.solve_time = time.perf_counter() - t0
        return step

    def finish_step(self, step: CycleStep) -> CycleStep:
        """Stage 3: journal the solved step and publish its analysis."""
        self.complete_cycle(step.prep, step.analysis, step.background,
                            solve_time=step.solve_time, hist=step.hist,
                            device_times=step.device_times)
        return step

    def complete_cycle(self, prep: _Prepared, x, background,
                       solve_time: float, hist=None,
                       device_times=None) -> None:
        """Journal a solved cycle and carry its analysis forward.  Must be
        called in cycle order — it publishes ``self.analysis`` for the
        next cycle's :meth:`solve_input`."""
        device_times = list(device_times) if device_times else []
        x = device_mod.block(x)
        now = time.perf_counter()
        # Measured wall time since the previous cycle completed — with
        # double buffering this is what the pipelining actually buys.
        cycle_time = now - self._t_last
        t_cycle0 = self._t_last
        self._t_last = now
        self.analysis = x
        if self.on_analysis is not None:
            self.on_analysis(prep.cycle, x)

        trace_mod.emit("cycle", t_cycle0, cycle_time, cycle=prep.cycle)

        if not device_times:
            device_times = [solve_time]
        flags = [i for i, dt in enumerate(device_times)
                 if self._stragglers[i].record(dt)]

        residual_history = ([] if hist is None
                            else [float(v) for v in _to_numpy(hist)])
        phases = dict(prep.phases)
        phases["solve"] = solve_time

        m = meters_mod.get_meters()
        m.inc("engine.cycles")
        if prep.repartitioned:
            m.inc("engine.rebalance.fired")
        if prep.rebalance_suppressed:
            m.inc("engine.rebalance.suppressed")
        if prep.migrated:
            m.inc("engine.migrated", prep.migrated)
        m.observe("engine.imbalance", imbalance_ratio(prep.loads))
        m.observe("engine.halo_fraction", prep.halo_fraction)
        m.inc("solve.comm_bytes_per_cycle", prep.comm_bytes_per_cycle)
        if residual_history:
            m.observe("engine.residual_final", residual_history[-1])
        if flags:
            m.inc("engine.straggler.flags", len(flags))
            m.event("engine.straggler", cycle=prep.cycle, devices=flags,
                    device_times=[float(t) for t in device_times])

        err = (self._reference_error(prep, background, x)
               if self.cfg.track_reference else float("nan"))
        self.journal.append(CycleMetrics(
            cycle=prep.cycle,
            loads=[int(v) for v in prep.loads],
            loads_before=[int(v) for v in prep.loads_before],
            imbalance=imbalance_ratio(prep.loads),
            imbalance_before=prep.imbalance_before,
            efficiency=dydd_mod.balance_ratio(prep.loads),
            repartitioned=prep.repartitioned,
            migrated=prep.migrated,
            rounds=prep.rounds,
            pack_time=prep.pack_time,
            solve_time=solve_time,
            cycle_time=cycle_time,
            error_vs_direct=err,
            comm_bytes_per_cycle=prep.comm_bytes_per_cycle,
            halo_fraction=prep.halo_fraction,
            loads_weighted=[int(v) for v in prep.loads_weighted],
            rebalance_suppressed=prep.rebalance_suppressed,
            phases=phases,
            residual_history=residual_history,
            comm_edge_bytes_per_cycle=prep.comm_edge_bytes_per_cycle,
            comm_mvec_bytes_per_cycle=prep.comm_mvec_bytes_per_cycle,
            comm_mvec_axis_bytes_per_cycle=(
                prep.comm_mvec_axis_bytes_per_cycle),
            device_solve_times=[float(t) for t in device_times],
            straggler_flags=flags,
            window=prep.window))

    # -- checkpoint / resume (not ported yet) -------------------------------

    def snapshot(self, *args, **kwargs):
        raise _not_ported("engine snapshots", "8")

    @classmethod
    def restore(cls, *args, **kwargs):
        raise _not_ported("engine restore", "8")
