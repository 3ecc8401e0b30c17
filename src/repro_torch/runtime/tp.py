"""Tensor-parallel compute on the "model" axis and per-layer parameter
gathering on the FSDP axes of a process mesh.

The reference partitions its "tp" architectures by GSPMD: heads, kv
heads, d_ff, vocab, ``lru`` and ``ssm_inner`` on "model", the ``embed``
dims on "data" (FSDP).  The port states the same partition by hand.  A
sharded step (:mod:`repro_torch.runtime.steps`) installs a
:class:`TensorParallel` context for its mesh (:func:`use`); the model
code reads it (:func:`current`) and, where a parameter it holds is the
rank's share of a dimension split over "model" (:func:`share`), computes
only that share:

* :func:`enter` marks the start of a tensor-parallel region: the
  identity forward, a psum over "model" backward (each rank's gradient
  of the region's replicated input is a partial sum);
* :func:`exit` ends one: a psum over "model" forward (the rank's partial
  output, a row-parallel product), the identity backward;
* :func:`allreduce` is a psum both ways (a sum that feeds rank-local
  values, as the squares of the SSD block's gated norm);
* :class:`Gather` brings a layer's blocks to the rank's tensor-parallel
  share: an all-gather over the leaf's FSDP axes forward and the
  gradient reduce-scattered back into the block (summed over the axes
  whose ranks hold other rows, sliced over the others).

Every sum gives the same bits on every rank of its group (the mesh's
collectives do), so ranks along "model" carry the same residual stream
and the same gradients of the leaves they share.  Outside :func:`use`,
or on a mesh whose "model" axis has one rank, :func:`share` is None and
all of these are the identity: the single-process path runs as it did.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.utils.checkpoint

from repro_torch.runtime import sharding

AXIS = "model"

_LOCAL = threading.local()


@dataclasses.dataclass
class TensorParallel:
    """The ambient tensor-parallel state of a sharded step on ``mesh``:
    the "model" axis (``axes``, empty where it is absent or of size one),
    its ``size`` and this rank's ``index`` on it, and ``plan``, a tree of
    :class:`Gather` like the params' (None where the params arrive
    already gathered over their FSDP axes, as in serving)."""

    mesh: object
    plan: object = None

    def __post_init__(self):
        size = int(self.mesh.shape.get(AXIS, 1))
        self.axes = (AXIS,) if size > 1 else ()
        self.size = size if self.axes else 1
        self.index = int(self.mesh.coords[AXIS]) if self.axes else 0


@contextlib.contextmanager
def use(ctx: TensorParallel | None):
    """Make ``ctx`` the ambient tensor-parallel state of the block."""
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


def current() -> TensorParallel | None:
    ctx = getattr(_LOCAL, "ctx", None)
    return ctx if ctx is not None and ctx.axes else None


def share(local: int, full: int) -> tuple | None:
    """(start, stop) of this rank's share of a dimension of ``full``
    split over "model" when the parameter holds ``local`` < ``full`` of
    it, else None (the dimension is whole on every rank)."""
    ctx = current()
    if ctx is None or local == full:
        return None
    if local * ctx.size != full:
        raise ValueError(f"a share of {local} of {full} does not split "
                         f"over the {ctx.size} ranks of {AXIS!r}")
    return ctx.index * local, (ctx.index + 1) * local


def checkpoint(fn, *args):
    """``torch.utils.checkpoint.checkpoint(fn, *args)`` (non-reentrant)
    whose recomputation runs under the tensor-parallel state of the
    call: the backward, and so the recomputation, runs on the autograd
    engine's thread for the card, which does not see this thread's
    state."""
    ctx = getattr(_LOCAL, "ctx", None)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), use(ctx)))


def _psum(t: torch.Tensor, ctx: TensorParallel, dtype=None) -> torch.Tensor:
    """The psum over "model" of ``ctx``, summed in ``dtype`` (default
    ``t``'s)."""
    if dtype is None or dtype == t.dtype:
        return ctx.mesh.psum(t, ctx.axes)
    return ctx.mesh.psum(t.to(dtype), ctx.axes).to(t.dtype)


# The Functions keep the state of their forward for their backward, which
# the autograd engine runs on its own thread for the card.

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tpc, dtype):
        ctx.tpc, ctx.dtype = tpc, dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.tpc, ctx.dtype), None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tpc):
        return _psum(x.contiguous(), tpc)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tpc):
        ctx.tpc = tpc
        return _psum(x.contiguous(), tpc)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.tpc), None


def enter(x: torch.Tensor, *, grad_dtype=None) -> torch.Tensor:
    """The start of a tensor-parallel region: ``x`` itself, whose
    gradient is psummed over "model" (in ``grad_dtype``: a replicated
    parameter's gradient is summed in f32 and cast once)."""
    ctx = current()
    if ctx is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, ctx, grad_dtype)


def exit(x: torch.Tensor) -> torch.Tensor:   # noqa: A001 (the region's end)
    """The end of a tensor-parallel region: the psum of the ranks'
    partial ``x`` over "model"; the gradient passes through."""
    ctx = current()
    if ctx is None:
        return x
    if not torch.is_grad_enabled():
        return _psum(x, ctx)
    return _Exit.apply(x, ctx)


def allreduce(x: torch.Tensor) -> torch.Tensor:
    """A psum over "model" whose gradient is psummed too."""
    ctx = current()
    if ctx is None:
        return x
    if not torch.is_grad_enabled():
        return _psum(x, ctx)
    return _AllReduce.apply(x, ctx)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over "model", no gradient."""
    ctx = current()
    if ctx is None:
        return x.detach()
    return ctx.mesh.pmax(x.detach(), ctx.axes)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` over "model" concatenated along ``dim`` (no
    gradient: the caches and decode's queries)."""
    return gather_dims([(x, dim)])[0]


def gather_dims(pairs) -> list:
    """Each ``(tensor, dim)`` of ``pairs`` all-gathered over "model" and
    concatenated along its ``dim``, in one collective whatever the
    dtypes: the tensors travel as the bytes of each index of their
    ``dim``."""
    ctx = current()
    if ctx is None:
        return [t for t, _ in pairs]
    rows, cols = None, []
    for t, d in pairs:
        moved = t.detach().movedim(d, 0).contiguous()
        if rows is None:
            rows = moved.shape[0]
        elif moved.shape[0] != rows:
            raise ValueError("gather_dims: the tensors' dims differ in "
                             "length")
        flat = moved.view(rows, -1)
        # a dimension of one may keep any stride; bytes need the row's
        flat = flat.as_strided(flat.shape, (flat.shape[1], 1))
        cols.append(flat.view(torch.uint8))
    raw = torch.cat(cols, dim=1)
    got = ctx.mesh.all_gather(raw, ctx.axes)
    out, at = [], 0
    for (t, d), c in zip(pairs, cols):
        part = got[:, at:at + c.shape[1]].contiguous().view(t.dtype)
        at += c.shape[1]
        shape = (got.shape[0],) + tuple(t.movedim(d, 0).shape[1:])
        out.append(part.reshape(shape).movedim(0, d))
    return out


# ---------------------------------------------------------------------------
# Per-layer gathering.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gather:
    """How one leaf (a layer's, without the stack's layer axis) reaches
    its tensor-parallel share from this rank's block: all-gathered over
    the mesh ``axes`` as ``spec`` (the leaf's spec restricted to those
    axes) lays them out, its gradient summed over ``summed`` (the
    gathered axes whose ranks contribute different parts) and sliced
    over the rest."""

    mesh: object
    spec: tuple
    axes: tuple
    summed: tuple

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        return sharding.gather(block, sharding.NamedSharding(
            self.mesh, self.spec))

    def backward(self, full: torch.Tensor, dtype) -> torch.Tensor:
        """This rank's block of the gradient ``full`` of the gathered
        leaf, summed in f32 over ``summed`` and cast to ``dtype``."""
        sh = sharding.NamedSharding(self.mesh, self.spec)
        if not self.summed:
            return sharding.local_block(full, sh).to(dtype, copy=True)
        slices = [sharding.block_slices(sh, full.shape, r)
                  for r in self.mesh.group_ranks(self.summed)]
        chunks = torch.empty((len(slices),) + tuple(full[slices[0]].shape),
                             dtype=torch.float32, device=full.device)
        for chunk, sl in zip(chunks, slices):
            chunk.copy_(full[sl])
        return self.mesh.reduce_scatter(chunks, self.summed)[0].to(dtype)


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, plan):
        ctx.plan, ctx.dtype = plan, block.dtype
        return plan.forward(block)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g.contiguous(), ctx.dtype), None


def gather(block: torch.Tensor, plan: Gather | None) -> torch.Tensor:
    """``block`` brought to its tensor-parallel share by ``plan`` (itself
    where there is no plan or nothing to gather)."""
    if plan is None:
        return block
    if torch.is_grad_enabled() and block.requires_grad:
        return _GatherFn.apply(block, plan)
    return plan.forward(block)


def gather_tree(tree, plan):
    """Each leaf of ``tree`` (nested dicts, tuples and lists of tensors;
    other leaves pass through) gathered by the same leaf of ``plan``, a
    tree like it or None."""
    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, plan.get(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_tree(v, p) for v, p in zip(tree, plan))
    if isinstance(tree, torch.Tensor):
        return gather(tree, plan)
    return tree


def plan_of(*keys):
    """The ambient plan's subtree at ``keys`` (None without one)."""
    ctx = getattr(_LOCAL, "ctx", None)
    node = None if ctx is None else ctx.plan
    for k in keys:
        if node is None:
            return None
        node = node.get(k) if isinstance(node, dict) else None
    return node


def gather_top(params, keys):
    """``params`` with its leaves at ``keys`` (top-level, not stacked)
    gathered by the ambient plan."""
    plan = plan_of()
    if plan is None:
        return params
    out = dict(params)
    for k in keys:
        if k in params:
            out[k] = gather_tree(params[k], plan.get(k))
    return out


def layer_plan(mesh, spec, axes: tuple, summed: tuple) -> Gather | None:
    """The :class:`Gather` of a leaf of ``spec`` (without a layer axis)
    over those of ``axes`` (of more than one rank) that shard it, or None
    where none does.  A dimension split over several axes may gather only
    its minor ones."""
    gathered = tuple(a for a in mesh.axis_names
                     if a in axes and a in sharding.spec_axes(spec)
                     and int(mesh.shape[a]) > 1)
    if not gathered:
        return None
    parts = []
    for part in spec:
        dim = sharding.dim_axes(part)
        keep = tuple(a for a in dim if a in gathered)
        if keep != dim[len(dim) - len(keep):]:
            raise ValueError(f"spec {spec}: cannot gather {keep} of a "
                             f"dimension split over {dim}")
        parts.append(keep[0] if len(keep) == 1 else (keep or None))
    return Gather(mesh, sharding.P(*parts), gathered,
                  tuple(a for a in gathered if a in summed))
