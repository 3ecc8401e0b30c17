"""Carry state from the JAX package's objects into the port's.

The port imports nothing of ``repro``, so these take plain numpy arrays
and dicts — what ``np.asarray`` of a JAX array, a dataclass's fields or
a domain's ``describe()``/``state_dict()`` give — and build the port's
counterparts on a device.  The parity tests use them to feed one packing,
problem or domain state to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import cls as cls_mod
from repro_torch.core import ddkf as ddkf_mod
from repro_torch.core import domain as domain_mod
from repro_torch.core import kdtree as kdtree_mod

# The reference's iteration-kernel names and their port counterparts:
# "jnp" is the plain composition; every fused variant is the fused step.
_SOLVE_KERNEL = {"jnp": "plain", "fused": "fused",
                 "fused_interpret": "fused", "fused_ref": "fused"}


def packed_from_numpy(fields: dict, meta: dict,
                      device=None) -> ddkf_mod.PackedDD:
    """A ``repro.core.ddkf.PackedDD`` as the port's ``PackedDD``.

    ``fields`` maps each data field of the reference packing to a numpy
    array (``A_loc``, ``L_loc``, ``cols``, ``mask``, ``muov``, ``wdiv``,
    ``mult``, ``mult_loc``, ``scatter_cols``, ``gather_cols``, ``r``,
    ``b``); ``meta`` holds ``n``, ``p``, ``w`` and ``solve_kernel``
    (``solve_block`` has no counterpart and is ignored).  The assembly
    map ``owner_slots`` is derived from ``scatter_cols``; the fields the
    solve never reads stay host arrays (:data:`ddkf.HOST_FIELDS`)."""
    device = device_mod.resolve(device)
    t = {k: np.array(v) if k in ddkf_mod.HOST_FIELDS
         else torch.as_tensor(np.array(v), device=device)
         for k, v in fields.items()}
    n = int(meta["n"])
    return ddkf_mod.PackedDD(
        **t,
        owner_slots=torch.as_tensor(
            ddkf_mod.owner_slots(np.asarray(fields["scatter_cols"]), n),
            device=device),
        n=n, p=int(meta["p"]), w=int(meta["w"]),
        solve_kernel=_SOLVE_KERNEL[meta.get("solve_kernel", "jnp")])


def domain_from_state(describe: dict, state: dict):
    """A domain of the kind and size ``describe`` names (a reference
    domain's ``describe()``), with the boundary state ``state`` (its
    ``state_dict()``) loaded."""
    kind = describe["kind"]
    if kind == "interval1d":
        dom = domain_mod.Interval1D(n=describe["n"], p=describe["p"])
    elif kind == "shelf2d":
        dom = domain_mod.ShelfTiling2D(nx=describe["nx"], ny=describe["ny"],
                                       pr=describe["pr"], pc=describe["pc"])
    elif kind == "kdtree":
        dom = kdtree_mod.KDTreeDomain(nx=describe["nx"], ny=describe["ny"],
                                      p=describe["p"])
    else:
        raise ValueError(f"unknown domain kind {kind!r}")
    dom.load_state({k: np.asarray(v) for k, v in state.items()})
    return dom


def cls_problem_from_numpy(fields: dict, device=None,
                           dtype=device_mod.DTYPE) -> cls_mod.CLSProblem:
    """A ``repro.core.cls.CLSProblem`` (its six fields as numpy arrays)
    as the port's ``CLSProblem``."""
    device = device_mod.resolve(device)
    return cls_mod.CLSProblem(**{
        k: torch.as_tensor(np.asarray(fields[k]), dtype=dtype, device=device)
        for k in ("H0", "y0", "H1", "y1", "R0", "R1")})
