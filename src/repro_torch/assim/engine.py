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
     solve: on one device (``ddkf.solve_vmapped``, the fused Schwarz
     kernels), or with ``solver="shardmap"`` one rank per subdomain of a
     :class:`~repro_torch.runtime.mesh.ProcessMesh`
     (``ddkf.solve_shardmap``: every rank runs this engine, packs and
     solves its own subdomain, and keeps the whole journal);
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
import copy
import dataclasses
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.core import cls as cls_mod
from repro_torch.core import dd as dd_mod
from repro_torch.core import ddkf as ddkf_mod
from repro_torch.core import domain as domain_mod
from repro_torch.core import dydd as dydd_mod
from repro_torch.core import kdtree as kdtree_mod
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime import mesh as mesh_mod
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
    one device; ``solver="shardmap"`` runs one rank per subdomain on a
    process mesh shaped like the domain's processor graph — the engine
    builds it when the process group has p ranks, or takes an explicit
    ``mesh=``; a rank-count mismatch is rejected up front.  ``comm``
    picks the sharded solve's overlap exchange (``"allreduce"`` or
    ``"neighbour"``) and the modelled traffic the journal records.
    ``overlap`` (>= 0) is the
    Schwarz halo width, with ``mu`` the overlap regularization of eq.
    25-26.  ``solver_kernel`` picks the local step ("auto": the fused
    CUDA kernels on the card, the plain composition on the CPU) and
    ``gram_mode`` the normal-matrix build ("auto": the gram kernel on the
    card; "plain": the plain version).  The ``time_windows`` and
    ``pint_*`` fields are read by
    :class:`repro_torch.assim.timepar.TimeParEngine`; this engine
    validates them and runs its cycles in sequence whatever they are.

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
    solver: str = "vmapped"           # "vmapped" | "shardmap"
    comm: str = "allreduce"           # overlap exchange (sharded solve,
                                      # comm model): "allreduce" |
                                      # "neighbour"
    halo_weight: float = 0.0          # overlap-aware DyDD: work units per
                                      # halo column
    record_residuals: bool = False    # journal the per-iteration Schwarz
                                      # update-norm history
    solver_kernel: str = "auto"       # "auto" | "plain" | "fused"
    gram_mode: str = "auto"           # "auto" | "plain"
    solve_retries: int = 2            # bounded retry on a TransientFault
                                      # from prepare/solve (exponential
                                      # backoff); exceeding it is fatal
    time_windows: int = 1             # parallel-in-time (Parareal) window
                                      # count for assim.timepar; 1 = the
                                      # sequential cycle loop
    pint_tol: float = 1e-8            # Parareal tolerance on the max
                                      # window-boundary correction
    pint_max_iters: int = 8           # Parareal iteration cap; 0 runs the
                                      # sequential engine
    pint_coarse_iters: int = 0        # coarse Schwarz iterations;
                                      # 0 = max(1, iters // 10)
    pint_fine_iters: int = 0          # fine Schwarz iterations; 0 = iters
                                      # from cold, else warm-started from
                                      # the coarse trajectory


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


# Checkpoint-tree key prefix for the domain's boundary-state arrays.
_DOMAIN_PREFIX = "domain/"

# A snapshot's "config" holds the reference's EngineConfig fields under
# the reference's names, so that either package restores it; the port's
# own fields go under "config_port".  solver_kernel: the reference's
# "jnp" is the port's "plain", and each fused variant its fused step.
_PORT_FIELDS = ("gram_mode",)
_KERNEL_TO_REF = {"auto": "auto", "plain": "jnp", "fused": "fused"}
_KERNEL_FROM_REF = {"auto": "auto", "jnp": "plain", "fused": "fused",
                    "fused_interpret": "fused", "fused_ref": "fused"}


def config_to_meta(cfg: EngineConfig) -> tuple:
    """(``config``, ``config_port``) entries of a snapshot's metadata."""
    d = dataclasses.asdict(cfg)
    ref = {k: v for k, v in d.items() if k not in _PORT_FIELDS}
    ref["solver_kernel"] = _KERNEL_TO_REF[cfg.solver_kernel]
    return ref, {k: d[k] for k in _PORT_FIELDS}


def config_from_meta(meta: dict) -> EngineConfig:
    """The EngineConfig a snapshot's metadata records — written by either
    package (a reference snapshot has no ``config_port``: the port's own
    fields keep their defaults)."""
    kw = dict(meta["config"])
    kw["solver_kernel"] = _KERNEL_FROM_REF[kw["solver_kernel"]]
    kw.update(meta.get("config_port", {}))
    return EngineConfig(**kw)


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


# Snapshot metadata that each rank of a mesh fills from its own clock.
_RANK_LOCAL_META = ("journal", "stragglers")


def snapshot_digest(tree: dict, metadata: dict) -> str:
    """sha256 of what a snapshot holds that every rank of a mesh must
    hold alike: every array of the tree (key, dtype, shape, bytes), the
    metadata but the straggler monitors, and the journal's deterministic
    view (its wall times are each rank's own)."""
    h = hashlib.sha256()
    for key in sorted(tree):
        arr = np.ascontiguousarray(tree[key])
        h.update(f"{key}|{arr.dtype.str}|{arr.shape}|".encode())
        h.update(arr.tobytes())
    rest = {k: v for k, v in metadata.items() if k not in _RANK_LOCAL_META}
    rest["journal"] = Journal.from_dict(
        metadata["journal"]).deterministic_dict()
    h.update(json.dumps(rest, sort_keys=True, default=str).encode())
    return h.hexdigest()


class AssimilationEngine:
    """Multi-cycle DD-KF with online DyDD rebalancing on a Domain.

    Usage::

        cfg = EngineConfig(n=128, p=4, rebalance=True)
        eng = AssimilationEngine(cfg)                 # on the card
        journal = eng.run(streams.make_stream("drifting_swarm", 400, 6))

        eng = AssimilationEngine(cfg, device="cpu")   # on the CPU

    ``device=None`` means the card and raises when there is none.  With
    ``solver="shardmap"`` every rank of the process group builds this
    engine with its own device (``mesh`` / ``mesh_axis`` as the
    reference's: an explicit :class:`~repro_torch.runtime.mesh.
    ProcessMesh` and the axes the subdomains run over).  The
    analysis of cycle t is carried as the background of cycle t+1
    (persistence forecast by default; pass ``forecast`` to override).
    ``eng.analysis`` holds the latest analysis state (a tensor on the
    engine's device).  ``chaos`` (a
    :class:`~repro_torch.runtime.chaos.ChaosInjector`) injects the
    scheduled faults; ``run(checkpoint_dir=..., snapshot_every=k)``
    saves a snapshot every k cycles, and :meth:`restore` rebuilds an
    engine from one (the reference's snapshots too).
    """

    def __init__(self, config: EngineConfig, device=None, *,
                 forecast: Optional[Callable] = None,
                 domain: Optional[domain_mod.Domain] = None,
                 straggler_config: Optional[StragglerConfig] = None,
                 chaos=None, mesh=None, mesh_axis=None):
        self.cfg = config
        self.device = device_mod.resolve(device)
        self.forecast = forecast or (lambda x: x)
        if config.solver not in ("vmapped", "shardmap"):
            raise ValueError(f"unknown solver {config.solver!r}")
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
        if config.time_windows < 1:
            raise ValueError(
                f"time_windows must be >= 1 (got {config.time_windows})")
        if (config.pint_max_iters < 0 or config.pint_coarse_iters < 0
                or config.pint_fine_iters < 0):
            raise ValueError(
                f"pint_max_iters/pint_coarse_iters/pint_fine_iters must "
                f"be >= 0 (got {config.pint_max_iters}/"
                f"{config.pint_coarse_iters}/{config.pint_fine_iters})")
        if config.pint_tol <= 0:
            raise ValueError(
                f"pint_tol must be > 0 (got {config.pint_tol})")

        self.domain = domain if domain is not None \
            else _domain_from_config(config)
        self.n = self.domain.n
        self.p = self.domain.p
        self.mesh, self.mesh_axis = self._resolve_mesh(mesh, mesh_axis)
        # The subdomains this process packs: its own on the sharded path.
        self._subdomains = None
        if self.mesh is not None:
            i = self.mesh.index(self.mesh_axis)
            self._subdomains = range(i, i + 1)
        self.journal = Journal(meta=self.domain.describe())
        if self.mesh is not None:
            self.journal.meta["mesh"] = self.mesh.describe()
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
        self._chaos = chaos
        # The stream being consumed, when it exposes a serializable
        # cursor (streams.ResumableStream) — what snapshot() records so
        # resume can fast-forward the seeded generator.
        self._stream = None
        self._restored_cursor: Optional[dict] = None
        # Optional per-cycle analysis hook: ``on_analysis(cycle, x)``.
        self.on_analysis: Optional[Callable] = None

    # -- mesh resolution for the sharded solver ----------------------------

    def _resolve_mesh(self, mesh, mesh_axis):
        """Validate or build the process mesh for ``solver='shardmap'``.

        The solver needs one rank per subdomain, laid out as the domain's
        processor graph (``domain.mesh_axes()``: a (p,) chain in 1D, a
        (pr, pc) grid in 2D).  A mismatched rank count is rejected here,
        up front, with the fix spelled out."""
        if self.cfg.solver != "shardmap":
            return mesh, mesh_axis
        names, shape = self.domain.mesh_axes()
        if mesh is None:
            world = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 0)
            if world != self.p:
                raise ValueError(
                    f"solver='shardmap' requires a mesh with one device "
                    f"per subdomain: p={self.p} but the process group has "
                    f"{world} rank(s)" + ("" if world else
                                          " (none is initialised)")
                    + f".  Start {self.p} ranks (repro_torch.runtime.mesh."
                    f"launch, or torch.distributed.init_process_group), "
                    f"pass mesh= explicitly, or match the config's p/pr*pc "
                    f"to the ranks")
            mesh = mesh_mod.ProcessMesh(shape, names, device=self.device)
            return mesh, (names if len(names) > 1 else names[0])
        n_mesh = int(np.prod(list(mesh.shape.values())))
        if n_mesh != self.p:
            raise ValueError(
                f"solver='shardmap' requires a mesh with one device per "
                f"subdomain: p={self.p} but the given mesh has {n_mesh} "
                f"device(s) (shape {dict(mesh.shape)}).  Rebuild the mesh "
                f"to match, or change p/pr/pc")
        if mesh_axis is None:
            axes = tuple(mesh.shape.keys())
            mesh_axis = axes if len(axes) > 1 else axes[0]
        return mesh, mesh_axis

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
        # Fault injection sits BEFORE any state mutation: a retried
        # prepare after a TransientFault starts from identical rng/
        # domain/truth state, so the retry is bitwise-equivalent to an
        # uninjected run.
        if self._chaos is not None:
            self._chaos.check("pack", cycle)
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
                solver_kernel=cfg.solver_kernel, device=self.device,
                subdomains=self._subdomains)
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
        """Returns (analysis, background, residual_hist, device_times).

        ``device_times`` is each rank's solve time in subdomain order on
        the sharded path (every rank holds all p, all-gathered), and
        empty on the single-device path (the caller substitutes the
        whole-solve time)."""
        cfg = self.cfg
        # The solve mutates no engine state until complete_cycle, so a
        # fault raised here leaves the cycle cleanly retryable.
        if self._chaos is not None:
            self._chaos.check("solve", prep.cycle)
        packed, background = self.solve_input(prep)
        hist = None
        device_times: list = []
        with trace_mod.span("solve", cycle=prep.cycle,
                            solver=cfg.solver) as sp:
            t0 = time.perf_counter()
            if cfg.solver == "shardmap":
                out = ddkf_mod.solve_shardmap(
                    packed, self.mesh, axis=self.mesh_axis,
                    iters=cfg.iters, damping=cfg.damping, comm=cfg.comm,
                    halo=prep.halo, residual_history=cfg.record_residuals,
                    return_per_device=True)
                device_times = out[-1]
                for i, dt in enumerate(device_times):
                    trace_mod.emit("solve", t0, dt, track=f"device {i}",
                                   cycle=prep.cycle)
            else:
                out = ddkf_mod.solve_vmapped(
                    packed, iters=cfg.iters, damping=cfg.damping,
                    residual_history=cfg.record_residuals)
            x = out[0] if isinstance(out, tuple) else out
            if cfg.record_residuals:
                hist = out[1]
            sp.fence(x)
        return x, background, hist, device_times

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
        """Consume the stream to exhaustion; returns the journal.

        Resume-aware: cycle numbering continues from the journal (a
        restored engine picks up at ``len(journal)``), and when the
        stream exposes a ``cursor`` (:class:`streams.ResumableStream`)
        it is recorded for :meth:`snapshot`.  With ``checkpoint_dir``
        and ``snapshot_every=k``, an atomic engine checkpoint is saved
        every k completed cycles — on those cycles the next cycle's
        prepare (which mutates rng/domain/truth state) is *deferred*
        until the snapshot is taken, so the saved state is exactly the
        cycle boundary and resume is bitwise journal-continuing.
        """
        cfg = self.cfg
        self._stream = stream if hasattr(stream, "cursor") else None
        it = iter(stream)
        base = len(self.journal.records)
        self._t_last = time.perf_counter()

        def snap_due(cycle: int) -> bool:
            return (checkpoint_dir is not None and snapshot_every > 0
                    and (cycle + 1) % snapshot_every == 0)

        def finish(step: CycleStep) -> None:
            self.finish_step(self.solve_step(step))
            if snap_due(step.cycle):
                self.save_checkpoint(checkpoint_dir, step=step.cycle + 1)
            if self._chaos is not None:
                # After the snapshot: a kill at cycle c resumes from a
                # checkpoint no newer than c+1, never a torn mid-cycle.
                self._chaos.maybe_kill("cycle_end", step.cycle)

        if not cfg.double_buffer:
            for i, obs in enumerate(it):
                step = CycleStep(cycle=base + i, obs=obs)
                step.prep = chaos_mod.retry_transient(
                    lambda: self.prepare(step.cycle, step.obs),
                    retries=max(cfg.solve_retries, 0),
                    site="pack", cycle=step.cycle)
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
                step.prep = self._claim_prepare(fut, pool, step.cycle,
                                                step.obs)
                cur = step
                cycle += 1
                fut = None

                def submit_next():
                    nonlocal fut, step
                    nxt = next(it, None)
                    if nxt is not None:
                        step = CycleStep(cycle=cycle, obs=nxt)
                        fut = pool.submit(self.prepare, step.cycle,
                                          step.obs)

                if snap_due(cur.cycle):
                    # Snapshot cycle: do NOT pipeline — the next prepare
                    # would mutate rng/domain/truth before the save, and
                    # the checkpoint would no longer be a cycle boundary.
                    finish(cur)
                    submit_next()
                else:
                    submit_next()
                    finish(cur)
        return self.journal

    def _claim_prepare(self, fut, pool, cycle: int, obs):
        """Claim an in-flight prepare, retrying TransientFaults with
        exponential backoff by resubmitting the same (cycle, obs) — safe
        because injected pack faults fire before any state mutation."""
        retries = max(self.cfg.solve_retries, 0)
        for attempt in range(retries + 1):
            try:
                return fut.result()
            except chaos_mod.TransientFault:
                if attempt >= retries:
                    raise
                m = meters_mod.get_meters()
                m.event("chaos.retry", site="pack", cycle=int(cycle),
                        attempt=attempt + 1)
                m.inc("chaos.retries")
                time.sleep(0.05 * (2.0 ** attempt))
                fut = pool.submit(self.prepare, cycle, obs)

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
        """Stage 2 of the cycle state machine: the device solve (bounded
        TransientFault retries), wall time measured to analysis-ready."""
        t0 = time.perf_counter()
        x, background, hist, device_times = chaos_mod.retry_transient(
            lambda: self._solve(step.prep),
            retries=max(self.cfg.solve_retries, 0),
            site="solve", cycle=step.prep.cycle)
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

    def reset_clock(self) -> None:
        """Restart the per-cycle wall-clock reference (``cycle_time`` of
        the next completed cycle is measured from now) — what ``run``
        does at stream start, exposed for external drivers."""
        self._t_last = time.perf_counter()

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
        if self._chaos is not None:
            # Forced straggler: inflate the scheduled device's *reported*
            # time — the solve already happened, analyses stay bitwise.
            device_times = self._chaos.straggle(prep.cycle, device_times)
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

    # -- checkpoint / resume ------------------------------------------------

    # v2 adds nothing mandatory over v1 — it marks snapshots that may
    # carry the optional "pint" metadata entry (window id + window count
    # of a parallel-in-time window-boundary save) and may be assembled
    # from a stashed host_state().  restore() accepts both versions.
    SNAPSHOT_VERSION = 2
    _SNAPSHOT_VERSIONS = (1, 2)

    def host_state(self) -> dict:
        """Deep copy of the host-side mutable state ``prepare`` advances
        (truth, rng, domain boundary state, trigger state, stream
        cursor) at the current point of the prepare sweep.

        The parallel-in-time engine prepares *every* cycle up front, so
        a window boundary's host state is long gone by the time the
        window's analyses exist — it stashes this at each boundary
        during the sweep and hands it back to :meth:`snapshot` when the
        completion phase reaches the boundary."""
        cursor = self._stream.cursor if self._stream is not None else None
        return {
            "truth": np.asarray(self._truth, np.float64).copy(),
            "rng_state": copy.deepcopy(self._rng.bit_generator.state),
            "domain": {k: np.asarray(v).copy()
                       for k, v in self.domain.state_dict().items()},
            "streak": int(self._streak),
            "last_rebalance_loads": (
                None if self._last_rebalance_loads is None
                else np.asarray(self._last_rebalance_loads).copy()),
            "cursor": copy.deepcopy(cursor),
        }

    def snapshot(self, host_state: dict | None = None,
                 extra_meta: dict | None = None) -> tuple:
        """(tree, metadata) capturing everything resume needs, in the
        reference's snapshot format (either package restores it).

        Must be taken at a cycle boundary with no prepare in flight
        (``run`` defers the pipelined next-prepare around snapshot
        cycles).  The tree holds the array state (truth, carried
        analysis, domain boundary state) as numpy arrays; the metadata
        holds the JSON-side state: config, rng bit-generator state
        (exact — resume re-draws the same truth walk and data noise),
        journal, stream cursor, straggler EWMAs and empty autotune
        caches (the CUDA kernels tune nothing).

        ``host_state`` substitutes a stashed :meth:`host_state` capture
        for the live truth/rng/domain/trigger/cursor state — the
        parallel-in-time engine's window-boundary snapshots.
        ``extra_meta`` merges extra JSON entries into the metadata
        (e.g. the ``"pint"`` window descriptor).
        """
        hs = host_state
        truth = (self._truth if hs is None else hs["truth"])
        domain_sd = (self.domain.state_dict() if hs is None
                     else hs["domain"])
        last_loads = (self._last_rebalance_loads if hs is None
                      else hs["last_rebalance_loads"])
        tree: dict = {"truth": np.asarray(truth, np.float64)}
        if self.analysis is not None:
            tree["analysis"] = _to_numpy(self.analysis)
        if last_loads is not None:
            tree["last_rebalance_loads"] = np.asarray(last_loads)
        for k, v in domain_sd.items():
            tree[_DOMAIN_PREFIX + k] = np.asarray(v)
        cursor = (self._stream.cursor
                  if self._stream is not None else None) \
            if hs is None else hs["cursor"]
        config, config_port = config_to_meta(self.cfg)
        metadata = {
            "snapshot_version": self.SNAPSHOT_VERSION,
            "config": config,
            "config_port": config_port,
            "domain": self.domain.describe(),
            "rng_state": (self._rng.bit_generator.state if hs is None
                          else hs["rng_state"]),
            "streak": int(self._streak if hs is None else hs["streak"]),
            "journal": self.journal.to_dict(),
            "cursor": cursor,
            "stragglers": [s.state_dict() for s in self._stragglers],
            "autotune": {"gram": [], "schwarz": []},
        }
        if extra_meta:
            metadata.update(extra_meta)
        return tree, metadata

    def save_checkpoint(self, directory: str, step: int,
                        host_state: dict | None = None,
                        extra_meta: dict | None = None,
                        mesh=None) -> str:
        """Atomic engine checkpoint via the hash-verified manager
        primitives; ``step`` is the completed-cycle count.  Returns the
        final checkpoint path.

        Under a process mesh — this engine's (``solver="shardmap"``), or
        ``mesh`` for an engine that every rank of a mesh runs alike (a
        fleet's stream, a Parareal window) — every rank calls this at the
        same cycle boundary: the ranks first hold their snapshots equal
        (:func:`snapshot_digest`; a mismatch raises on every rank), then
        the mesh's first rank alone writes the step, and no rank returns
        before it is published (a failed write raises on every rank)."""
        mesh = mesh if mesh is not None else self.mesh
        tree, metadata = self.snapshot(host_state=host_state,
                                       extra_meta=extra_meta)
        t0 = time.perf_counter()
        if mesh is None:
            path = ckpt_mod.save_pytree(tree, directory, step, metadata)
        else:
            digests = mesh.gather_objects(snapshot_digest(tree, metadata))
            if len(set(digests)) != 1:
                raise RuntimeError(
                    f"the ranks' snapshots of step {step} differ (sha256 "
                    f"by rank: {digests}); refusing to write it")
            err = None
            if mesh.index(mesh.axis_names) == 0:
                try:
                    ckpt_mod.save_pytree(tree, directory, step, metadata)
                except Exception as exc:   # agreed below
                    err = exc
            mesh.raise_any(err)
            path = os.path.join(directory, f"step_{step:08d}")
        m = meters_mod.get_meters()
        m.inc("engine.snapshots")
        m.observe("engine.snapshot_time", time.perf_counter() - t0)
        return path

    @classmethod
    def restore(cls, checkpoint: str, device=None, *,
                config: "EngineConfig | None" = None,
                domain: Optional[domain_mod.Domain] = None,
                mesh=None, mesh_axis=None,
                forecast: Optional[Callable] = None,
                straggler_config: Optional[StragglerConfig] = None,
                chaos=None) -> "AssimilationEngine":
        """Rebuild an engine on ``device`` from a checkpoint directory
        (latest verified step) or a specific ``step_XXXX`` path, written
        by this package or by the reference.

        Same-shape resume (``config``/``domain`` omitted) restores the
        exact saved state and is bitwise journal-continuing.  Passing a
        ``config`` and ``domain`` overrides them for an *elastic* resume
        under a different p — the saved domain state is then not loaded
        (the caller, :func:`repro_torch.runtime.elastic.
        remesh_assim_domain`, derives the new tiling) while truth/rng/
        analysis/journal carry over, so the stream still continues
        without replaying cycles.  ``mesh``/``mesh_axis`` are the
        constructor's: a ``solver="shardmap"`` snapshot resumes on a
        process mesh of one rank per subdomain (every rank restores).
        """
        flat, manifest = ckpt_mod.restore_pytree(checkpoint)
        meta = manifest["metadata"]
        ver = meta.get("snapshot_version")
        if ver not in cls._SNAPSHOT_VERSIONS:
            raise ValueError(f"unsupported engine snapshot version {ver}")
        cfg = config if config is not None else config_from_meta(meta)
        eng = cls(cfg, device, forecast=forecast, domain=domain,
                  straggler_config=straggler_config, chaos=chaos,
                  mesh=mesh, mesh_axis=mesh_axis)
        eng._load_snapshot(flat, meta, remeshed=domain is not None)
        return eng

    def _load_snapshot(self, flat: dict, meta: dict,
                       remeshed: bool = False) -> None:
        self._truth = np.asarray(flat["truth"], np.float64)
        if "analysis" in flat:
            self.analysis = torch.as_tensor(flat["analysis"],
                                            device=self.device)
        # Exact generator state, not a reseed: the resumed run draws the
        # same truth steps and data noise the uninterrupted run would.
        self._rng.bit_generator.state = meta["rng_state"]
        journal = Journal.from_dict(meta["journal"])
        resume_log = list(journal.meta.get("resume", []))
        resume_log.append({"at_cycle": len(journal.records),
                           "p": int(self.p), "remeshed": bool(remeshed)})
        if remeshed:
            # New tiling: domain state stays as the caller derived it,
            # trigger/straggler state is stale for the new p — start
            # those fresh.  The journal meta switches to the new
            # descriptor so downstream load_table reshapes correctly.
            journal.meta = self.domain.describe()
        else:
            self.domain.load_state(
                {k.split(_DOMAIN_PREFIX, 1)[1]: v
                 for k, v in flat.items()
                 if k.startswith(_DOMAIN_PREFIX)})
            self._streak = int(meta.get("streak", 0))
            if "last_rebalance_loads" in flat:
                self._last_rebalance_loads = np.asarray(
                    flat["last_rebalance_loads"])
            for mon, st in zip(self._stragglers,
                               meta.get("stragglers", [])):
                mon.load_state(st)
        journal.meta["resume"] = resume_log
        self.journal = journal
        self._dec_cache = None
        self._restored_cursor = meta.get("cursor")
        # The reference's "autotune" entry holds Pallas block sizes;
        # the CUDA kernels have nothing to import.

    def resume_stream(self) -> "streams_mod.ResumableStream | None":
        """The stream continuation from the restored cursor (None when
        the snapshot was taken without a cursor-bearing stream)."""
        cursor = self._restored_cursor
        if cursor is None:
            return None
        return streams_mod.ResumableStream.from_cursor(cursor)
