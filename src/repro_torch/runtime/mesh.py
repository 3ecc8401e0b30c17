"""Process meshes over ``torch.distributed`` and the collectives the
distributed DD-KF solve runs on them.

The reference runs its sharded solves as one program over a JAX device
mesh (``shard_map``).  PyTorch's idiom is multi-controller: every rank
runs the same host program and the ranks meet in collectives.  This
module is the port's counterpart of the reference's mesh constructors
(``repro.core._compat.make_device_mesh``,
``repro.launch.mesh.make_test_mesh``):

* :func:`launch` spawns ``nprocs`` ranks (``spawn`` start method: a
  process that has initialised CUDA cannot fork), joins them through a
  ``file://`` store in a temporary directory and returns what each rank's
  function returned, in rank order.  Each rank runs on the card
  (``cuda:{rank % device_count}``) unless the caller asks for the CPU.
* :class:`ProcessMesh` lays the ranks of the default process group out
  row-major over named axes, as a JAX mesh lays out its devices, and
  builds one sub-group per set of axes.
* Its methods are the collectives: :meth:`ProcessMesh.psum`,
  :meth:`~ProcessMesh.pmax`, :meth:`~ProcessMesh.axis_allreduce` (psum
  over the outer axes, then reduce-scatter and all-gather on the
  innermost, the reference's ``axis_allreduce``),
  :meth:`~ProcessMesh.ppermute` (one batch of point-to-point sends per
  round), :meth:`~ProcessMesh.all_gather` and
  :meth:`~ProcessMesh.reduce_scatter` (both along dim 0: the sharded
  training step's parameter gathers and gradient reductions build on
  them, :mod:`repro_torch.runtime.sharding`).  Every rank of a group
  ends with the same bits.
* Host decisions that every rank must take alike (which streams join a
  round, whether a step failed) meet in
  :meth:`~ProcessMesh.gather_objects` and
  :meth:`~ProcessMesh.raise_any`.
* Every collective call is counted by method (``counts``) and recorded
  by kind, result bytes and group size (``collectives``,
  :func:`record_collective`).  :class:`TracedMesh` is one rank of a mesh
  that no one launches: its collectives return ``meta`` tensors and only
  count and record, so a step traced on it (the dry run,
  :mod:`repro_torch.launch.dryrun`) reports what that rank would move.

Transport: with ``backend="nccl"`` tensors on the card go to the
collective directly, and two ranks may not share a card (NCCL refuses
it).  With ``backend="gloo"``, CPU tensors go directly and tensors on the
card are copied through pinned host buffers (``transport == "host"``).
The backend is the caller's choice; nothing here switches it.
"""
from __future__ import annotations

import collections
import datetime
import itertools
import os
import pickle
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod

BACKENDS = ("gloo", "nccl")
# How long a rank waits in a collective for the others before it fails
# (``launch(timeout=...)`` sets another).
TIMEOUT = datetime.timedelta(minutes=10)


def _tensor_collective(fn, *args, **kw):
    """Call ``reduce_scatter_tensor`` or ``all_gather_into_tensor``: the
    one-tensor forms every supported torch has (some releases warn that
    a ``*_single`` name replaces them; the list forms are far slower on
    gloo)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def transport_for(backend: str, device: torch.device) -> str:
    """``"direct"`` where the backend takes the device's tensors, ``"host"``
    where gloo takes card tensors through pinned host copies."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} "
                         f"(got {backend!r})")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' runs on the card only; ask for "
                             "backend='gloo' to run ranks on the CPU")
        return "direct"
    return "host" if device.type == "cuda" else "direct"


def check_launch(nprocs: int, backend: str, device: torch.device) -> None:
    """Raise before any rank starts where the ranks cannot run: NCCL with
    two ranks on one card."""
    transport_for(backend, device)
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1 (got {nprocs})")
    if backend == "nccl" and nprocs > torch.cuda.device_count():
        raise ValueError(
            f"backend='nccl' needs a card per rank: {nprocs} ranks but "
            f"{torch.cuda.device_count()} card(s) — NCCL refuses two ranks "
            f"on one GPU.  Ask for backend='gloo' (collectives through "
            f"pinned host copies) or at most {torch.cuda.device_count()} "
            f"ranks")


def _rank_entry(rank: int, nprocs: int, backend: str, device: str,
                tmp: str, timeout: datetime.timedelta) -> None:
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # The ranks share the host's cores.
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=nprocs, timeout=timeout)
    try:
        out = fn(dev, *args)
        part = os.path.join(tmp, f"rank{rank}.part")
        torch.save(out, part)
        os.replace(part, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, *, backend: str, device=None,
           args: tuple = (), timeout: float | None = None) -> list:
    """Run ``fn(device, *args)`` on ``nprocs`` new ranks of one process
    group; returns the ranks' return values in rank order.

    ``fn`` must be importable by name (the ranks are spawned, not
    forked).  ``device=None`` puts rank r on ``cuda:{r % device_count}``
    and raises without a card; ``device="cpu"`` runs the ranks on the CPU.
    Each rank runs one intra-op thread.  ``backend`` is ``"gloo"`` or
    ``"nccl"`` and has no default.  ``timeout`` is how many seconds a
    rank waits in a collective for the others before it fails (default
    :data:`TIMEOUT`).  A rank that raises or dies fails the launch: the
    others are stopped and the error names the rank and its exception
    or signal.  What a rank returns travels back through ``torch.save``,
    tensors and all."""
    dev = device_mod.resolve(device)
    check_launch(nprocs, backend, dev)
    wait = (TIMEOUT if timeout is None
            else datetime.timedelta(seconds=float(timeout)))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The call travels in a file: through the spawn pipe, each start
        # would wait for the previous child to read it.
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        torch.multiprocessing.spawn(
            _rank_entry, args=(nprocs, backend, dev.type, tmp, wait),
            nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(nprocs)]


# The reference's HLO names of the collectives (``hlo_analysis`` reads
# them); ``gather_objects`` moves host objects and is counted apart, as
# ``counts["objects"]``.
KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "ppermute": "collective-permute"}


def record_collective(log: collections.Counter, name: str, nbytes: int,
                      group: int) -> None:
    """Count one collective call of method ``name`` (a key of
    :data:`KINDS`) in ``log``, keyed by (kind, the bytes of its result on
    this rank, its group size): what
    :func:`repro_torch.launch.hlo_analysis.collective_bytes` reads."""
    log[(KINDS[name], int(nbytes), int(group))] += 1


def group_ranks_of(sizes, names, coords: dict, axes) -> list:
    """The global ranks of the group over ``axes`` that holds the rank at
    ``coords`` of a row-major grid of ``sizes`` over ``names``, in the
    row-major order of the mesh."""
    index = [range(s) if n in axes else (coords[n],)
             for n, s in zip(names, sizes)]
    return [int(np.ravel_multi_index(c, sizes))
            for c in itertools.product(*index)]


class _Mesh:
    """What :class:`ProcessMesh` and :class:`TracedMesh` share: the grid
    and its groups, the counts and records of collective calls, and the
    collectives built on the primitives ``_wire``, ``_unwire``,
    ``_psum``, ``_reduce_scatter`` and ``_all_gather``."""

    def _setup(self, sizes: tuple, names: tuple, rank: int) -> None:
        self.shape = dict(zip(names, sizes))
        self.axis_names = names
        self.rank = rank
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            rank, sizes))))
        self.counts = {"psum": 0, "pmax": 0, "reduce_scatter": 0,
                       "all_gather": 0, "ppermute": 0, "objects": 0}
        # (kind, result bytes, group size) -> calls (record_collective)
        self.collectives: collections.Counter = collections.Counter()
        # state that steps on this mesh share, dropped with the mesh
        # (runtime.steps.tp_share keeps each rank's params share here)
        self.kept: dict = {}
        # (axes) -> (group, its ranks in row-major order over the axes)
        self._groups: dict = {}

    def _count(self, name: str, nbytes: int, group: int) -> None:
        self.counts[name] += 1
        record_collective(self.collectives, name, nbytes, group)

    def describe(self) -> dict:
        """JSON-ready mesh shape, backend and transport."""
        return {"shape": dict(self.shape), "backend": self.backend,
                "transport": self.transport}

    # -- groups ------------------------------------------------------------

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} (has "
                                 f"{self.axis_names})")
        return tuple(a for a in self.axis_names if a in axes)

    def _group(self, axes) -> tuple:
        return self._groups[self._axes(axes)]

    def group(self, axes):
        """This rank's process group over ``axes`` (built with
        ``dist.new_group``; the default group when ``axes`` are all the
        mesh's)."""
        return self._group(axes)[0]

    def group_ranks(self, axes) -> list:
        """The global ranks of this rank's group over ``axes``, in the
        row-major order of the mesh (group index i = ranks[i])."""
        return list(self._group(axes)[1])

    def index(self, axes) -> int:
        """This rank's row-major index within its group over ``axes``."""
        return self.group_ranks(axes).index(self.rank)

    # -- collectives -------------------------------------------------------

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``t`` over the group of ``axes``; the same bits on every
        rank of the group."""
        return self._unwire(self._psum(self._wire(t, copy=True), axes), t)

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The group's tensors ``t`` concatenated along dim 0 in the row-
        major order of ``axes``."""
        return self._unwire(self._all_gather(self._wire(t), axes), t)

    def reduce_scatter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Chunk i (along dim 0) of the sum of ``t`` over the group of
        ``axes``, on the group's rank i (row-major order); the length
        must split over the group."""
        return self._unwire(self._reduce_scatter(self._wire(t), axes), t)

    def axis_allreduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """All-reduce a vector over every axis of ``axes``: a psum over the
        outer axes, then reduce-scatter plus all-gather over the innermost
        (the reference's ``axis_allreduce``).  The length must split over
        the innermost axis."""
        axes = self._axes(axes)
        buf = self._wire(t, copy=True)
        if len(axes) > 1:
            buf = self._psum(buf, axes[:-1])
        buf = self._all_gather(self._reduce_scatter(buf, axes[-1]),
                               axes[-1])
        return self._unwire(buf, t)

    def _scatter_len(self, buf: torch.Tensor, axis, k: int) -> int:
        if buf.shape[0] % k:
            raise ValueError(f"reduce_scatter: length {buf.shape[0]} does "
                             f"not split over the {k} ranks of {axis!r}")
        return buf.shape[0] // k

    def _ppermute_arcs(self, perm, axes) -> tuple:
        """(this rank's group's ranks, the group index it sends to, the
        one it receives from), each a list of at most one."""
        ranks = self.group_ranks(axes)
        me = ranks.index(self.rank)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute: rank index {me} is on more than "
                             f"one arc of {perm}")
        return ranks, dst, src

    # -- host decisions ----------------------------------------------------

    def raise_any(self, exc: BaseException | None, axes=None) -> None:
        """Every rank of the group raises, or none does.  Each rank
        passes the exception its own part of a step raised (or None);
        where any rank failed, every rank raises: a failing rank its own
        exception, the others the first failing rank's.  So the ranks
        take the same retry or failure path, and none waits in a
        collective that the others skip."""
        axes = self.axis_names if axes is None else axes
        try:
            sent = pickle.loads(pickle.dumps(exc))
        except Exception:     # an exception that does not travel
            sent = RuntimeError(f"{type(exc).__name__}: {exc}")
        got = self.gather_objects(sent, axes)
        if exc is not None:
            raise exc
        for i, first in enumerate(got):
            if first is not None:
                raise first from RuntimeError(
                    f"rank {self.group_ranks(axes)[i]} failed its part of "
                    f"this step")


class ProcessMesh(_Mesh):
    """The ranks of the default process group on a named row-major grid.

    ``shape`` is a dict from axis name to size, as a JAX mesh's, and its
    sizes multiply to the world size; rank ``r`` sits at
    ``np.unravel_index(r, sizes)`` (:attr:`coords`), so subdomain
    ``r * pc + c`` of a ``pr x pc`` tiling runs on rank ``r * pc + c``.
    Every rank builds the same sub-groups in the same order at
    construction (a rank that skipped a ``new_group`` would hang the
    others).  ``device`` is where this rank's tensors live (default: the
    card this rank uses; raises without one); :attr:`transport`
    says how they reach the collectives.  :attr:`counts` counts the
    collective calls this rank has made, by method, and
    :attr:`collectives` records each call's kind, result bytes and group
    size (:func:`record_collective`); :attr:`kept` holds state that
    steps on the mesh share."""

    def __init__(self, shape, axis_names, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh needs an initialised default process group: "
                "start the ranks with repro_torch.runtime.mesh.launch or "
                "torch.distributed.init_process_group")
        sizes = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {sizes} and axis names {names} "
                             f"must pair up one to one")
        world = dist.get_world_size()
        if int(np.prod(sizes)) != world:
            raise ValueError(
                f"mesh shape {dict(zip(names, sizes))} holds "
                f"{int(np.prod(sizes))} ranks but the process group has "
                f"{world}")
        self._setup(sizes, names, dist.get_rank())
        dev = device_mod.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.backend = str(dist.get_backend())
        self.transport = transport_for(self.backend, self.device)
        self._pinned: dict = {}
        grid = np.arange(world).reshape(sizes)
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), k):
                rest = [i for i in range(len(names)) if i not in axes]
                moved = np.moveaxis(grid, rest, list(range(len(rest))))
                for fixed in itertools.product(
                        *(range(sizes[i]) for i in rest)):
                    ranks = [int(r) for r in moved[fixed].reshape(-1)]
                    group = (dist.group.WORLD if len(ranks) == world
                             else dist.new_group(ranks))
                    if self.rank in ranks:
                        self._groups[tuple(names[i] for i in axes)] = (
                            group, ranks)

    # -- transport ---------------------------------------------------------
    # Host transport copies each tensor to a pinned buffer and back.  The
    # copy to the host is waited for on a blocking event, so a rank that
    # waits sleeps instead of spinning on a core that its collectives'
    # threads need.  The copy back is not: a cached buffer is written
    # again by gloo only after a later copy to the host on the same stream
    # was waited for, which orders the two (a received buffer, which no
    # copy to the host precedes, is waited for).

    def _on_host(self, t: torch.Tensor) -> bool:
        return self.transport == "host" and t.is_cuda

    def _buffer(self, key: str, shape, dtype) -> torch.Tensor:
        """A cached pinned host buffer of this shape and dtype (each
        collective copies its result off it before the next call)."""
        k = (key, tuple(shape), dtype)
        buf = self._pinned.get(k)
        if buf is None:
            # a normal tensor even when first made while serving (under
            # inference mode), so that a train step's collective of the
            # same shape may write it
            with torch.inference_mode(False):
                buf = torch.empty(tuple(shape), dtype=dtype,
                                  pin_memory=True)
            self._pinned[k] = buf
        return buf

    @staticmethod
    def _wait() -> None:
        ev = torch.cuda.Event(blocking=True)
        ev.record()
        ev.synchronize()

    def _wire(self, t: torch.Tensor, key: str = "in",
              copy: bool = False) -> torch.Tensor:
        """The tensor a collective reads: a pinned host copy (host
        transport), a copy on the card (NCCL given a CPU tensor), or ``t``
        itself (a copy with ``copy``, for collectives that write their
        input)."""
        t = t.contiguous()
        if self._on_host(t):
            buf = self._buffer(key, t.shape, t.dtype)
            buf.copy_(t, non_blocking=True)
            self._wait()
            return buf
        if self.backend == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t.clone() if copy else t

    def _empty(self, shape, like: torch.Tensor, key: str) -> torch.Tensor:
        """An output buffer for a collective on tensors like ``like``."""
        if self._on_host(like):
            return self._buffer(key, shape, like.dtype)
        dev = self.device if self.backend == "nccl" else like.device
        return torch.empty(tuple(shape), dtype=like.dtype, device=dev)

    def _unwire(self, buf: torch.Tensor, like: torch.Tensor,
                wait: bool = False) -> torch.Tensor:
        """A collective's result where ``like`` lives (copied off a pinned
        buffer, which a later call reuses; ``wait``: that copy waited
        for)."""
        if buf.device == like.device:
            return buf.clone() if buf.is_pinned() else buf
        out = torch.empty(buf.shape, dtype=buf.dtype, device=like.device)
        out.copy_(buf, non_blocking=buf.is_pinned())
        if out.is_cuda and wait:
            self._wait()
        return out

    # -- collectives -------------------------------------------------------
    # The _psum, _reduce_scatter and _all_gather steps work on tensors
    # already on the wire, so a chain of them crosses to the host once.

    def _psum(self, buf: torch.Tensor, axes) -> torch.Tensor:
        group, ranks = self._group(axes)
        self._count("psum", buf.nbytes, len(ranks))
        if len(ranks) > 1:
            dist.all_reduce(buf, group=group)
        return buf

    def _reduce_scatter(self, buf: torch.Tensor, axis) -> torch.Tensor:
        """Chunk i (along dim 0) of the group's sum, on group rank i."""
        group, ranks = self._group(axis)
        k = len(ranks)
        n = self._scatter_len(buf, axis, k)
        out = self._empty((n,) + tuple(buf.shape[1:]), buf, "rs")
        self._count("reduce_scatter", out.nbytes, k)
        if k == 1:
            return out.copy_(buf)
        _tensor_collective(dist.reduce_scatter_tensor, out, buf, group=group)
        return out

    def _all_gather(self, buf: torch.Tensor, axes) -> torch.Tensor:
        group, ranks = self._group(axes)
        k = len(ranks)
        out = self._empty((k * buf.shape[0],) + tuple(buf.shape[1:]), buf,
                          "ag")
        self._count("all_gather", out.nbytes, k)
        if k == 1:
            return out.copy_(buf)
        _tensor_collective(dist.all_gather_into_tensor, out, buf,
                           group=group)
        return out

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise maximum of ``t`` over the group of ``axes``."""
        group, ranks = self._group(axes)
        buf = self._wire(t, copy=True)
        self._count("pmax", buf.nbytes, len(ranks))
        if len(ranks) > 1:
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        return self._unwire(buf, t)

    def ppermute(self, buf: torch.Tensor, perm, axes) -> torch.Tensor:
        """One directed exchange round: for each ``(src, dst)`` of
        ``perm`` (group indices over ``axes``; each index at most once as
        a source and once as a destination), ``src``'s ``buf`` arrives at
        ``dst``.  Returns what this rank received, zeros where no arc ends
        here; a rank on no arc posts nothing."""
        ranks, dst, src = self._ppermute_arcs(perm, axes)
        self._count("ppermute", buf.nbytes, len(ranks))
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, self._wire(buf),
                                  ranks[dst[0]]))
        got = None
        if src:
            got = self._empty(buf.shape, buf, "pp")
            ops.append(dist.P2POp(dist.irecv, got, ranks[src[0]]))
        for req in (dist.batch_isend_irecv(ops) if ops else ()):
            req.wait()
        if got is None:
            return torch.zeros_like(buf)
        return self._unwire(got, buf, wait=True)

    # -- host decisions ----------------------------------------------------

    def gather_objects(self, obj, axes=None) -> list:
        """Every rank's picklable ``obj`` over the group of ``axes`` (all
        of the mesh's by default), in the group's row-major order, on
        every rank of it: what the ranks decide on together."""
        axes = self.axis_names if axes is None else axes
        group, ranks = self._group(axes)
        self.counts["objects"] += 1
        if len(ranks) == 1:
            return [obj]
        out = [None] * len(ranks)
        dist.all_gather_object(out, obj, group=group)
        return out


class TracedMesh(_Mesh):
    """One rank of a mesh that no one launches, for a dry run.

    ``mesh`` is anything with a ``shape`` dict and ``axis_names`` (an
    :class:`~repro_torch.runtime.sharding.AbstractMesh`, as
    ``launch.mesh.make_production_mesh`` gives, or a ``ProcessMesh``);
    this is its rank ``rank``.  It needs no process group and has the
    attributes that the steps read (``shape``, ``axis_names``,
    ``coords``, ``rank``, ``device`` = ``meta``, ``kept``, ``counts``,
    ``transport``, ``group_ranks``, ``index``).  Its collectives take
    ``meta`` tensors, return new ``meta`` tensors of their results'
    shapes and dtypes, and only count and record the call
    (:attr:`collectives`, as a ``ProcessMesh`` records it), so a step
    traced on it reports the collectives that this rank of a launched
    mesh would make.  :meth:`gather_objects` returns ``[obj]`` times the
    group's size and :meth:`raise_any` raises this rank's own
    exception."""

    backend = "none"
    transport = "traced"

    def __init__(self, mesh, rank: int = 0):
        names = tuple(str(a) for a in mesh.axis_names)
        sizes = tuple(int(mesh.shape[a]) for a in names)
        if not 0 <= rank < int(np.prod(sizes)):
            raise ValueError(f"rank {rank} is not on the mesh "
                             f"{dict(zip(names, sizes))}")
        self._setup(sizes, names, int(rank))
        self.device = torch.device("meta")

    def _group(self, axes) -> tuple:
        axes = self._axes(axes)
        if axes not in self._groups:
            self._groups[axes] = (None, group_ranks_of(
                tuple(self.shape.values()), self.axis_names, self.coords,
                axes))
        return self._groups[axes]

    def _new(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=like.dtype, device="meta")

    def _wire(self, t: torch.Tensor, key: str = "in",
              copy: bool = False) -> torch.Tensor:
        return t

    def _unwire(self, buf: torch.Tensor, like: torch.Tensor,
                wait: bool = False) -> torch.Tensor:
        return buf

    def _psum(self, buf: torch.Tensor, axes) -> torch.Tensor:
        self._count("psum", buf.nbytes, len(self._group(axes)[1]))
        return self._new(buf.shape, buf)

    def _reduce_scatter(self, buf: torch.Tensor, axis) -> torch.Tensor:
        k = len(self._group(axis)[1])
        out = self._new((self._scatter_len(buf, axis, k),)
                        + tuple(buf.shape[1:]), buf)
        self._count("reduce_scatter", out.nbytes, k)
        return out

    def _all_gather(self, buf: torch.Tensor, axes) -> torch.Tensor:
        k = len(self._group(axes)[1])
        out = self._new((k * buf.shape[0],) + tuple(buf.shape[1:]), buf)
        self._count("all_gather", out.nbytes, k)
        return out

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The shape of the elementwise maximum over the group."""
        self._count("pmax", t.nbytes, len(self._group(axes)[1]))
        return self._new(t.shape, t)

    def ppermute(self, buf: torch.Tensor, perm, axes) -> torch.Tensor:
        """The shape of what this rank receives in one exchange round."""
        ranks, _, _ = self._ppermute_arcs(perm, axes)
        self._count("ppermute", buf.nbytes, len(ranks))
        return self._new(buf.shape, buf)

    def gather_objects(self, obj, axes=None) -> list:
        """``[obj]`` times the group's size: every rank decides as this
        one."""
        axes = self.axis_names if axes is None else axes
        self.counts["objects"] += 1
        return [obj] * len(self._group(axes)[1])
