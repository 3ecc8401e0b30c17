"""Multi-tenant assimilation serving: N streams on one device or a mesh.

:class:`FleetServer` runs many independent :class:`AssimilationEngine`
streams concurrently by batching their per-cycle DD-KF solves into
cohort solves (:mod:`repro_torch.assim.fleet`) while host-side cycle
preparation (ending in each stream's ``gram`` launch on the card) runs
on a thread pool — the single-engine double-buffering generalized to a
fleet:

* **Continuous batching.**  Streams are submitted to the shared
  :class:`~repro_torch.runtime.scheduler.SlotScheduler`; up to
  ``max_active`` are in flight at once, the rest queue FIFO.  A stream
  retires the moment its observation stream is exhausted and its slot
  is re-filled on the next round (cohort capacities are quantized and
  pinned per shape, as in the reference).

* **Fleet rounds.**  Each round collects every stream whose host-side
  ``prepare`` has finished, immediately pipelines that stream's *next*
  ``prepare`` onto the pool, injects the carried background
  (``solve_input``), buckets the resulting packings into shape cohorts
  and solves each cohort as one stacked solve.  Streams whose
  preparation is still running are simply not in this round — nobody
  waits for the slowest tenant.

* **Per-stream DyDD isolation.**  A stream whose rebalance trigger
  fires does its repartition + repack inside ``prepare`` on a pool
  thread, concurrent with other streams' device solves.  Its changed
  subdomain widths move it to a different cohort on its next round;
  the other streams' cohorts are untouched.

Per-stream results are **bitwise identical** to running each engine's
``run`` loop sequentially: the fleet path runs the very same
``solve_vmapped`` on each member's rows of the stack (see
:func:`repro_torch.core.ddkf.solve_fleet`), and all engine state
transitions go through the same ``prepare → solve_input →
complete_cycle`` methods in the same per-stream order.

The port of ``repro.assim.serving``: ``device`` (``None`` means the
card) is handed to every engine the server builds.  With ``mesh`` (a
:class:`~repro_torch.runtime.mesh.ProcessMesh`) every rank runs the
server — every stream's host decisions and engine state — and each
cohort's members spread over the ``mesh_axis`` ranks
(:class:`~repro_torch.assim.fleet.CohortSolver`).  The rounds are
formed from thread timing, which differs between ranks, so the ranks
agree on every decision before they act on it: a stream joins a round
only once its prepare is done on every rank
(:meth:`~repro_torch.runtime.mesh.ProcessMesh.gather_objects`), and a
prepare, a cohort solve or a fault fails or is retried on every rank or
on none (:meth:`~repro_torch.runtime.mesh.ProcessMesh.raise_any`).
Cohorts, admissions and retirements follow from those in the same
order on every rank, so every rank keeps the same journals; a stream's
snapshot is written by one rank.
"""
from __future__ import annotations

import time
from concurrent.futures import (ALL_COMPLETED, FIRST_COMPLETED,
                                ThreadPoolExecutor, wait)
from typing import Callable, Dict, Iterable, Optional

from repro_torch import device as device_mod
from repro_torch.assim import fleet as fleet_mod
from repro_torch.assim.engine import AssimilationEngine, EngineConfig
from repro_torch.assim.metrics import Journal
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.scheduler import SlotScheduler


class _StreamState:
    """One tenant: an engine, its observation iterator, and the in-flight
    ``prepare`` future (at most one per engine, ever)."""

    def __init__(self, sid, engine: AssimilationEngine, stream: Iterable,
                 checkpoint_dir: Optional[str] = None,
                 snapshot_every: int = 0):
        self.sid = sid
        self.engine = engine
        self.it = iter(stream)
        self.slot: Optional[int] = None
        self.fut = None               # in-flight prepare future
        self.pending = None           # (cycle, obs) of the in-flight
                                      # prepare — what a transient-fault
                                      # retry resubmits verbatim
        self.exhausted = False        # iterator has run dry
        self.cycles = 0
        self.checkpoint_dir = checkpoint_dir
        self.snapshot_every = int(snapshot_every)

    def snap_due(self, cycle: int) -> bool:
        return (self.checkpoint_dir is not None
                and self.snapshot_every > 0
                and (cycle + 1) % self.snapshot_every == 0)


class FleetServer:
    """Continuous-batching server for assimilation streams.

    Usage::

        server = FleetServer(max_active=64)        # on the card
        for i in range(256):
            server.add_stream(f"s{i}", EngineConfig(n=48, p=4),
                              streams.make_stream("drifting_swarm", 120, 8,
                                                  seed=i))
        journals = server.serve()          # {sid: Journal}

    ``device=None`` means the card and raises when there is none
    (``device="cpu"`` runs on the CPU); every engine the server builds
    or restores runs there.  ``mesh``/``mesh_axis`` spread cohort
    batches over the ranks of a process mesh axis (e.g. an 8-rank
    ``("fleet",)`` mesh); every rank builds the same server, adds the
    same streams and calls :meth:`serve`, and cohort sizes are padded to
    a multiple of the axis size.  Only ``solver="vmapped"`` engines can
    ride a fleet.
    """

    def __init__(self, mesh=None, mesh_axis: str = "fleet",
                 max_active: Optional[int] = None, pack_workers: int = 4,
                 gather_window: float = 0.02, solver=None,
                 chaos: "chaos_mod.ChaosInjector | None" = None,
                 max_retries: int = 2, retry_backoff: float = 0.05,
                 device=None):
        self.device = device_mod.resolve(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(
                f"the mesh's ranks run on {mesh.device} but the server's "
                f"engines on {self.device}: pass the mesh's device")
        self.mesh = mesh
        if pack_workers < 1:
            raise ValueError(f"pack_workers must be >= 1 "
                             f"(got {pack_workers})")
        if gather_window < 0:
            raise ValueError(f"gather_window must be >= 0 "
                             f"(got {gather_window})")
        self.gather_window = gather_window
        # Server-level fault handling: `chaos` injects transient faults
        # at cohort-solve dispatch (site "solve", keyed by round);
        # TransientFaults from any stream's prepare or any cohort solve
        # are retried up to max_retries with exponential backoff before
        # the affected stream(s) are retired as failed.
        self.chaos = chaos
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.scheduler = SlotScheduler(capacity=max_active,
                                       meters_prefix="fleet.")
        # An explicit solver carries its pinned cohort capacities across
        # server lifetimes.
        self.solver = solver if solver is not None \
            else fleet_mod.CohortSolver(mesh=mesh, axis=mesh_axis)
        self.pack_workers = pack_workers
        self.journals: Dict[object, Journal] = {}
        self.engines: Dict[object, AssimilationEngine] = {}
        self._sids: set = set()
        # Per-sid intake record (checkpoint_dir / snapshot_every /
        # forecast) — survives the _StreamState, which is dropped when a
        # stream retires or fails, so readmit() can rebuild the stream
        # from its latest snapshot after the fact.
        self._stream_meta: Dict[object, dict] = {}
        self.stats: Dict[str, float] = {}

    # -- stream intake -----------------------------------------------------

    def add_stream(self, sid, config: EngineConfig,
                   stream: Iterable, *,
                   forecast: Optional[Callable] = None,
                   domain=None, engine: Optional[AssimilationEngine]
                   = None, checkpoint_dir: Optional[str] = None,
                   snapshot_every: int = 0,
                   chaos: "chaos_mod.ChaosInjector | None" = None
                   ) -> None:
        """Queue one assimilation stream (engine built here, started at
        admission).  ``sid`` keys the returned journal and must be
        unique.

        ``checkpoint_dir``/``snapshot_every`` enable per-stream periodic
        engine snapshots (taken at cycle boundaries — the stream's next
        prepare is deferred around the save, like the single-engine
        run loop).  ``chaos`` attaches a per-stream fault injector to
        the engine (pack faults surface at claim time and are retried).
        Pass a restored ``engine`` (from
        :func:`repro_torch.runtime.elastic.resume_assim_engine`) to
        continue an interrupted stream mid-fleet — cycle numbering picks
        up from its journal.
        """
        if sid in self._sids:
            raise ValueError(f"duplicate stream id {sid!r}")
        if config.solver != "vmapped":
            raise ValueError(
                f"fleet serving requires solver='vmapped' (stream "
                f"{sid!r} asked for {config.solver!r}); the shardmap "
                f"solver dedicates one device per subdomain and cannot "
                f"be batched on a problem axis")
        self._sids.add(sid)
        self._stream_meta[sid] = {"checkpoint_dir": checkpoint_dir,
                                  "snapshot_every": int(snapshot_every),
                                  "forecast": forecast}
        if engine is None:
            engine = AssimilationEngine(config, self.device,
                                        forecast=forecast, domain=domain,
                                        chaos=chaos)
        elif chaos is not None:
            engine._chaos = chaos
        engine._stream = stream if hasattr(stream, "cursor") else None
        self.engines[sid] = engine
        self.scheduler.submit(_StreamState(
            sid, engine, stream, checkpoint_dir=checkpoint_dir,
            snapshot_every=snapshot_every))

    def readmit(self, stream_id, *,
                chaos: "chaos_mod.ChaosInjector | None" = None) -> None:
        """Re-admit a retired or crashed stream from its latest
        per-stream snapshot.

        The stream must have been added with a ``checkpoint_dir`` and
        must currently be out of the scheduler (retired after
        exhaustion or failed — i.e. its journal has been recorded).
        The engine and the observation stream continuation are rebuilt
        with :func:`repro_torch.runtime.elastic.resume_assim_engine` (latest
        hash-verified snapshot wins; no completed cycle is replayed)
        and resubmitted through the :class:`SlotScheduler` like any
        new tenant — it queues FIFO and acquires a slot on the next
        admission round.  ``chaos`` optionally attaches a fresh fault
        injector to the resumed engine (the crashed run's injector is
        *not* carried over).  Emits a ``fleet.stream_readmitted`` obs
        event.
        """
        from repro_torch.runtime import elastic as elastic_mod

        if stream_id not in self._sids:
            raise KeyError(f"unknown stream id {stream_id!r}")
        if stream_id not in self.journals:
            raise ValueError(
                f"stream {stream_id!r} is still active or queued; only "
                f"a retired/failed stream can be readmitted")
        meta = self._stream_meta.get(stream_id, {})
        ckpt_dir = meta.get("checkpoint_dir")
        if ckpt_dir is None:
            raise ValueError(
                f"stream {stream_id!r} was added without a "
                f"checkpoint_dir; nothing to readmit from")
        engine, stream = elastic_mod.resume_assim_engine(
            ckpt_dir, device=self.device, forecast=meta.get("forecast"),
            chaos=chaos)
        if stream is None:
            raise ValueError(
                f"stream {stream_id!r}'s snapshot carries no resumable "
                f"cursor (was it fed a plain iterable?)")
        engine._stream = stream
        self.engines[stream_id] = engine
        # The stale partial journal is superseded by the restored
        # engine's journal (which the next retirement re-records).
        self.journals.pop(stream_id, None)
        m = meters_mod.get_meters()
        m.event("fleet.stream_readmitted", sid=stream_id,
                resume_cycle=len(engine.journal.records))
        m.inc("fleet.streams_readmitted")
        self.scheduler.submit(_StreamState(
            stream_id, engine, stream, checkpoint_dir=ckpt_dir,
            snapshot_every=meta.get("snapshot_every", 0)))

    # -- serving loop ------------------------------------------------------

    def _admit(self, pool: ThreadPoolExecutor) -> None:
        """Fill free slots from the queue; kick off each newcomer's first
        ``prepare``.  Empty streams retire immediately (their journal is
        the empty journal).  Cycle numbering starts at the engine's
        journal length, so a restored engine continues its count."""
        for slot, st in self.scheduler.admit():
            st.slot = slot
            st.engine.reset_clock()
            first = next(st.it, None)
            if first is None:
                st.exhausted = True
                self.journals[st.sid] = st.engine.journal
                self.scheduler.retire(slot)
                continue
            base = len(st.engine.journal.records)
            st.pending = (base, first)
            st.fut = pool.submit(st.engine.prepare, base, first)

    def _submit_next(self, st: _StreamState,
                     pool: ThreadPoolExecutor, cycle: int) -> None:
        """Draw the stream's next observation and pipeline its prepare;
        marks the stream exhausted when the iterator runs dry."""
        nxt = next(st.it, None)
        if nxt is None:
            st.exhausted = True
            return
        st.pending = (cycle, nxt)
        st.fut = pool.submit(st.engine.prepare, cycle, nxt)

    def _fail_stream(self, st: _StreamState, exc: BaseException) -> None:
        """Retire a crashed stream: journal what it completed, reclaim
        its slot (the scheduler re-admits from the queue on the next
        round), and journal the failure as an obs event.  Every stream
        failure path funnels through here — a prepare that raises on the
        pool can no longer leak its slot."""
        m = meters_mod.get_meters()
        m.event("fleet.stream_failed", sid=st.sid,
                cycles_completed=int(st.cycles),
                error=f"{type(exc).__name__}: {exc}")
        m.inc("fleet.streams_failed")
        st.exhausted = True
        st.fut = None
        self.journals[st.sid] = st.engine.journal
        if st.slot is not None:
            self.scheduler.retire(st.slot)
            st.slot = None

    def _raise_any(self, err: Exception | None) -> None:
        """Raise ``err`` — on a mesh, every rank raises where any rank's
        part failed (:meth:`ProcessMesh.raise_any`)."""
        if self.mesh is not None:
            self.mesh.raise_any(err)
        elif err is not None:
            raise err

    def _ready(self, active: list) -> list:
        """The streams of this round: those whose prepare is done — on a
        mesh, done on every rank.  Where no stream is done on every rank
        yet, this rank waits for those done on some rank and the round
        is empty (the caller goes round again)."""
        done = [st.fut is not None and st.fut.done() for st in active]
        if self.mesh is None:
            return [st for st, d in zip(active, done) if d]
        masks = self.mesh.gather_objects(done)
        every = [all(col) for col in zip(*masks)]
        if not any(every):
            wait([st.fut for st, col in zip(active, zip(*masks))
                  if any(col)], return_when=ALL_COMPLETED)
        return [st for st, e in zip(active, every) if e]

    def _claim(self, st: _StreamState, pool: ThreadPoolExecutor):
        """Claim a finished prepare, retrying TransientFaults by
        resubmitting the same (cycle, obs) with exponential backoff —
        injected pack faults fire before any engine state mutation, so
        the retry is bitwise-equivalent.  Non-transient exceptions and
        an exhausted retry budget propagate to the failure path.  On a
        mesh the ranks agree on each attempt's outcome; a rank whose
        prepare succeeded keeps it while another rank retries."""
        m = meters_mod.get_meters()
        fut, prep = st.fut, None
        for attempt in range(self.max_retries + 1):
            err = None
            if prep is None:
                try:
                    prep = fut.result()
                except Exception as exc:   # agreed in _raise_any
                    err = exc
            try:
                self._raise_any(err)
                return prep
            except chaos_mod.TransientFault:
                if attempt >= self.max_retries:
                    raise
            cycle, obs = st.pending
            m.event("chaos.retry", site="pack", sid=st.sid,
                    cycle=int(cycle), attempt=attempt + 1)
            m.inc("chaos.retries")
            time.sleep(self.retry_backoff * (2.0 ** attempt))
            if prep is None:
                fut = pool.submit(st.engine.prepare, cycle, obs)

    def _cohort_solve(self, key, packs, round_no: int):
        """One cohort dispatch behind the server-level fault injector."""
        err = None
        if self.chaos is not None:
            try:
                self.chaos.check("solve", round_no)
            except chaos_mod.TransientFault as exc:   # agreed below
                err = exc
        self._raise_any(err)
        return self.solver.solve(key, packs)

    def serve(self) -> Dict[object, Journal]:
        """Run every queued stream to exhaustion; returns the per-stream
        journals keyed by sid."""
        m = meters_mod.get_meters()
        t_start = time.perf_counter()
        rounds = 0
        with ThreadPoolExecutor(max_workers=self.pack_workers,
                                thread_name_prefix="pack") as pool:
            self._admit(pool)
            while not self.scheduler.idle():
                active = list(self.scheduler.active().values())
                in_flight = [st.fut for st in active if st.fut is not None]
                ready = [st for st in active
                         if st.fut is not None and st.fut.done()]
                if not ready:
                    wait(in_flight, return_when=FIRST_COMPLETED)
                elif len(ready) < len(in_flight) and self.gather_window:
                    # Gather window: give stragglers a short grace to
                    # join this round — fuller rounds mean larger (and
                    # more repeatable) cohorts, hence fewer solves and
                    # fewer distinct pinned capacities.  A stream
                    # mid-DyDD-repack that misses the window simply
                    # rides the next round; nobody blocks on it.
                    wait(in_flight, timeout=self.gather_window)
                ready = self._ready(active)
                if not ready:
                    continue

                # Claim finished preps; pipeline each stream's next
                # prepare onto the pool *before* this round's solve so
                # host packing overlaps device work (the engine's
                # double-buffering, fleet-wide).  On a snapshot-due
                # cycle the next prepare is deferred until after the
                # save (it would mutate the engine state mid-snapshot);
                # a stream whose prepare ultimately failed is retired
                # with its slot reclaimed.
                items = []
                deferred = []
                for st in ready:
                    try:
                        prep = self._claim(st, pool)
                    except Exception as e:
                        self._fail_stream(st, e)
                        continue
                    st.fut = None
                    if st.snap_due(prep.cycle):
                        deferred.append((st, prep))
                    else:
                        self._submit_next(st, pool, prep.cycle + 1)
                    if prep.repartitioned:
                        # DyDD isolation: note the repack; the stream's
                        # new shape re-buckets it below without touching
                        # anyone else's cohort.
                        m.event("fleet.dydd.repack", sid=st.sid,
                                cycle=prep.cycle, migrated=prep.migrated)
                    packed, background = st.engine.solve_input(prep)
                    cfg = st.engine.cfg
                    key = fleet_mod.cohort_key(packed, cfg.iters,
                                               cfg.damping,
                                               cfg.record_residuals)
                    items.append((key, (st, prep, packed, background)))

                with trace_mod.span("fleet.round", round=rounds,
                                    streams=len(items)):
                    for key, members in fleet_mod.group_cohorts(
                            items).items():
                        try:
                            res = chaos_mod.retry_transient(
                                lambda: self._cohort_solve(
                                    key, [pk for (_, _, pk, _)
                                          in members], rounds),
                                retries=self.max_retries,
                                backoff=self.retry_backoff,
                                site="solve", cycle=rounds)
                        except Exception as e:
                            # Cohort lost: retire its members; other
                            # cohorts (and their streams) are untouched.
                            for (st, _, _, _) in members:
                                self._fail_stream(st, e)
                            continue
                        for (st, prep, _, background), x, hist in zip(
                                members, res.xs, res.hists):
                            st.engine.complete_cycle(
                                prep, x, background,
                                solve_time=res.solve_time, hist=hist)
                            st.cycles += 1
                            if (st.engine._chaos is not None
                                    and not st.snap_due(prep.cycle)):
                                st.engine._chaos.maybe_kill(
                                    "cycle_end", prep.cycle)
                rounds += 1
                m.inc("fleet.rounds")

                # Deferred tail of snapshot cycles: the engine is at a
                # clean cycle boundary (solve completed, next prepare
                # not yet submitted) — save, then resume pipelining.
                for st, prep in deferred:
                    if st.exhausted and st.slot is None:
                        continue   # failed during its cohort solve
                    st.engine.save_checkpoint(st.checkpoint_dir,
                                              step=prep.cycle + 1,
                                              mesh=self.mesh)
                    if st.engine._chaos is not None:
                        st.engine._chaos.maybe_kill("cycle_end",
                                                    prep.cycle)
                    self._submit_next(st, pool, prep.cycle + 1)

                for st in ready:
                    if st.exhausted and st.fut is None \
                            and st.slot is not None:
                        self.journals[st.sid] = st.engine.journal
                        self.scheduler.retire(st.slot)
                        st.slot = None
                self._admit(pool)

        wall = time.perf_counter() - t_start
        total_cycles = sum(len(j) for j in self.journals.values())
        self.stats = {"wall_time": wall, "rounds": rounds,
                      "streams": len(self.journals),
                      "cycles": total_cycles,
                      "cycles_per_sec": (total_cycles / wall if wall
                                         else 0.0)}
        m.gauge("fleet.cycles_per_sec", self.stats["cycles_per_sec"])
        return self.journals
