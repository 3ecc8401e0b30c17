"""Logical-axis sharding rules, the ambient mesh and blocks of tensors.

The counterpart of ``repro.runtime.sharding``.  Parameters and
activations are annotated with *logical* axis names; the rules map them
onto whatever physical mesh axes exist (pod/data/model):

  * weights' d_model-like dims  -> 'data'  (ZeRO-3/FSDP, per-pod)
  * heads / d_ff / vocab dims   -> 'model' (tensor parallel)
  * activation batch            -> ('pod', 'data')  (pure DP across pods)
  * expert dim                  -> replicated

The rule tables, the profiles and the shape-aware resolution
(:func:`param_spec`, :func:`act_spec`, :func:`act_spec_shaped`) are the
reference's, so a spec computed here equals the reference's
``PartitionSpec`` as a tuple.  The reference reads the mesh that
``jax.sharding.set_mesh`` installs; here :func:`use_mesh` installs one:
a :class:`~repro_torch.runtime.mesh.ProcessMesh` (the ranks that hold
the blocks) or an :class:`AbstractMesh` (axis sizes only, for specs at
production sizes that no one launches).  Outside any mesh the specs are
the production mesh's (``_DEFAULT_SIZES``), as in the reference.

The reference's activation sharding constraints have no counterpart: the
port states the partition by hand (:mod:`repro_torch.runtime.tp`).  A
sharded step computes tensor-parallel on "model" from each rank's share
of the heads, kv heads, d_ff, vocab, ``lru`` and ``ssm_inner``
dimensions, gathering the blocks over their FSDP axes ("data", "pod")
layer by layer in training and once in serving; decode's attention core
runs on a rank's kv heads or cache slots
(:mod:`repro_torch.models.attention`): :func:`dim_range` is where a
rank's block of a dimension starts and ends, so the rank whose range
holds slot ``pos % L`` of a sequence-split cache is the one that writes
it.  :func:`local_block` is the block a rank holds; :func:`gather` the
whole tensor from the blocks (checkpoints, the FSDP gathers);
:class:`NamedSharding` pairs a mesh with a spec.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the first
    major).  A tuple, so it equals the reference's ``PartitionSpec`` as a
    tuple; its entries beyond the spec's length are ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# logical axis -> physical mesh axis (or tuple).  None = replicated.
# Profile "tp": FSDP on 'data' + tensor parallel on 'model' (big archs).
PARAM_RULES_TP = {
    "embed": "data",        # FSDP dim
    "embed_table": "data",  # embedding d_model dim (FSDP in tp profile)
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": None,
    "moe_expert": "model",   # EP: whole experts on the model axis
    "lru": "model",
    "ssm_inner": "model",
    None: None,
}

ACT_RULES_TP = {
    "kv_seq": "model",   # decode-cache sequence sharding (long context)
    "loss_batch": ("pod", "data"),  # loss chunks: leave 'model' for vocab
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": None,
    "moe_expert": "model",
    "lru": "model",
    "ssm_inner": "model",
    None: None,
}

# Profile "dp": pure data parallelism over every mesh axis + FSDP on
# 'data' (small-d_model or indivisible-head archs: gemma3-1b, whisper).
PARAM_RULES_DP = {k: ("data" if k == "embed" else None)
                  for k in PARAM_RULES_TP}
# PERF-B3: the embedding table stays replicated in the dp profile.
PARAM_RULES_DP["embed_table"] = None
ACT_RULES_DP = {k: None for k in ACT_RULES_TP}
ACT_RULES_DP["batch"] = ("pod", "data", "model")
# KV-cache sequence sharding stays on 'model' in every profile.
ACT_RULES_DP["kv_seq"] = "model"
# Logits stay vocab-sharded on 'model' in the dp profile too (PERF-B2).
ACT_RULES_DP["vocab"] = "model"
ACT_RULES_DP["loss_batch"] = ("pod", "data", "model")

_DEFAULT_SIZES = {"pod": 2, "data": 16, "model": 16}

_LOCAL = threading.local()


@contextlib.contextmanager
def profile(name: str):
    """Activate a sharding profile ('tp' | 'dp') for the enclosed code."""
    prev = getattr(_LOCAL, "profile", "tp")
    _LOCAL.profile = name
    try:
        yield
    finally:
        _LOCAL.profile = prev


def current_profile() -> str:
    return getattr(_LOCAL, "profile", "tp")


def _param_rules():
    return PARAM_RULES_DP if current_profile() == "dp" else PARAM_RULES_TP


def _act_rules():
    return ACT_RULES_DP if current_profile() == "dp" else ACT_RULES_TP


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes without ranks: ``AbstractMesh((16, 16), ("data",
    "model"))``, for the specs of a mesh no one launches."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``ProcessMesh`` or an :class:`AbstractMesh`) the
    ambient mesh of the enclosed code, the counterpart of
    ``jax.sharding.set_mesh``."""
    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        yield mesh
    finally:
        _LOCAL.mesh = prev


def current_mesh():
    """The ambient mesh, or None outside :func:`use_mesh`."""
    return getattr(_LOCAL, "mesh", None)


def _mesh_axis_sizes():
    mesh = current_mesh()
    return None if mesh is None else dict(mesh.shape)


def _resolve(axes, rules, sizes, shape=None) -> P:
    """Map logical axes to a spec, dropping mesh axes that are absent,
    whose size does not divide the tensor dimension (replicate fallback:
    e.g. kv_heads=1 under model=16 stays replicated), or that a previous
    dim already claimed (a mesh axis may appear only once)."""
    parts = []
    used: set = set()
    for i, a in enumerate(axes):
        phys = rules.get(a, None)
        dim = None if shape is None else shape[i]
        if phys is None:
            parts.append(None)
            continue
        cand = phys if isinstance(phys, tuple) else (phys,)
        cand = [x for x in cand if x in sizes and x not in used]
        if dim is not None:
            # keep the largest prefix whose product divides the dim
            kept = []
            prod = 1
            for x in cand:
                if dim % (prod * sizes[x]) == 0:
                    kept.append(x)
                    prod *= sizes[x]
            cand = kept
        used.update(cand)
        if not cand:
            parts.append(None)
        elif len(cand) == 1:
            parts.append(cand[0])
        else:
            parts.append(tuple(cand))
    return P(*parts)


def param_spec(shape, *axes) -> P:
    """Spec of a parameter under the ambient (or production) mesh,
    shape-aware (divisibility fallback)."""
    sizes = _mesh_axis_sizes() or dict(_DEFAULT_SIZES)
    return _resolve(axes, _param_rules(), sizes, shape)


def act_spec(*axes) -> P:
    sizes = _mesh_axis_sizes() or dict(_DEFAULT_SIZES)
    return _resolve(axes, _act_rules(), sizes)


def act_spec_shaped(shape, *axes) -> P:
    """Shape-aware activation spec (inputs whose dims may not divide the
    mesh, e.g. global_batch=1)."""
    sizes = _mesh_axis_sizes() or dict(_DEFAULT_SIZES)
    return _resolve(axes, _act_rules(), sizes, shape)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec laid over a mesh's axes."""
    mesh: object
    spec: P


def dim_axes(part) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_axes(spec) -> tuple:
    """Every mesh axis that shards some dimension of ``spec``."""
    return tuple(a for part in spec for a in dim_axes(part))


def _slices(spec, shape, sizes: dict, coords: dict) -> tuple:
    """The block of a tensor of ``shape`` held at mesh ``coords``."""
    out = []
    for d, n in enumerate(shape):
        axes = dim_axes(spec[d]) if d < len(spec) else ()
        k, i = 1, 0
        for a in axes:
            k, i = k * sizes[a], i * sizes[a] + coords[a]
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {axes} ({k} ways)")
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def block_slices(sharding: NamedSharding, shape, rank=None) -> tuple:
    """The slices of a full tensor of ``shape`` that mesh rank ``rank``
    (default: this rank) holds under ``sharding``."""
    mesh = sharding.mesh
    coords = (mesh.coords if rank is None else dict(zip(
        mesh.axis_names, (int(c) for c in np.unravel_index(
            rank, tuple(mesh.shape.values()))))))
    return _slices(sharding.spec, tuple(shape), mesh.shape, coords)


def dim_range(sharding: NamedSharding, shape, dim: int,
              rank=None) -> tuple:
    """(start, stop) of dimension ``dim`` of a full tensor of ``shape``
    in the block that mesh rank ``rank`` (default: this rank) holds."""
    sl = block_slices(sharding, shape, rank)[dim]
    return sl.start, sl.stop


def named_shardings(mesh, spec_tree):
    """A tree of :class:`NamedSharding` on ``mesh`` like ``spec_tree``
    (nested dicts of specs)."""
    if isinstance(spec_tree, dict):
        return {k: named_shardings(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def full_shape(block_shape, sharding: NamedSharding) -> tuple:
    """The shape of the tensor whose blocks have ``block_shape``."""
    sizes, spec = sharding.mesh.shape, sharding.spec
    return tuple(
        n * int(np.prod([sizes[a] for a in dim_axes(spec[d])]))
        if d < len(spec) else n for d, n in enumerate(block_shape))


def local_block(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``full`` (a view)."""
    return full[block_slices(sharding, full.shape)]


def gather(block: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor on every rank, all-gathered from each rank's
    ``block`` over the spec's axes (one collective; ``block`` itself
    where the spec shards nothing).  The group's blocks arrive in the
    row-major order of the mesh's axes; one permutation puts each in its
    place (a copy, or none where the order is already the tensor's)."""
    mesh, spec = sharding.mesh, sharding.spec
    axes = spec_axes(spec)
    if not axes:
        return block
    shape = full_shape(block.shape, sharding)
    # as bytes, so any dtype travels
    raw = block.contiguous()[None].view(torch.uint8)
    parts = mesh.all_gather(raw, axes).view(block.dtype)
    order = [a for a in mesh.axis_names if a in axes]
    parts = parts.reshape([mesh.shape[a] for a in order]
                          + list(block.shape))
    # dimension d of the whole tensor: its mesh axes (major first), then
    # the block's dimension d
    perm = []
    for d in range(block.dim()):
        perm += [order.index(a) for a in
                 (dim_axes(spec[d]) if d < len(spec) else ())]
        perm.append(len(order) + d)
    return parts.permute(perm).reshape(tuple(shape))
