"""Fleet-batched DD-KF solves: cohorts of same-shape cycle solves.

The multi-tenant serving layer (:mod:`repro_torch.assim.serving`) runs
many independent assimilation streams on one device.  This module owns
the batching half of that story: given the rhs-injected
:class:`~repro_torch.core.ddkf.PackedDD` of one cycle from each of
several streams, group them into *cohorts* of identical shape/solver
configuration, pad each cohort to a quantized capacity, stack it on a
leading problem axis (:func:`~repro_torch.core.ddkf.stack_packed`) and
solve it with one :func:`~repro_torch.core.ddkf.solve_fleet` call that
advances every member a full cycle.

Shape bucketing.  Two cycle solves may share a stack only if every
static property matches: problem sizes ``(n, p, w, m)``, dtype, the
resolved local solver kernel, and the Schwarz loop's knobs (``iters``,
``damping``, ``record_residuals``).  :func:`cohort_key` hashes exactly
this set.  Under DyDD the per-subdomain width ``w`` of a stream changes
whenever its boundaries move, so cohort membership is recomputed every
fleet round from the cycle's actual packing.

Capacity quantization.  Each cohort's batch is rounded up to
``k * 2**j`` (``k`` = the fleet mesh axis's rank count, 1 off-mesh) and
pinned per key, as the reference does to bound its compiles; here the
padding slots are copies of member 0 that are solved and discarded
(each one runs the Schwarz kernels ``iters`` times).  Each member is
solved by the same :func:`~repro_torch.core.ddkf.solve_vmapped` a
standalone engine runs — on a contiguous view of its rows of the stack
on one device, on its own packing on a mesh — so fleet results equal
sequential per-engine solves bitwise.

On a process mesh (``CohortSolver(mesh=..., axis=...)``) every rank
solves the same cohorts: the rank at index r of ``axis`` solves its
contiguous slice of each padded cohort and the ranks all-gather the
analyses (:func:`~repro_torch.core.ddkf.solve_fleet`), so no rank stacks
the members of another.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import ddkf as ddkf_mod
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod


def cohort_key(packed: "ddkf_mod.PackedDD", iters: int, damping: float,
               record_residuals: bool) -> tuple:
    """Hashable bucket id: everything that must match for two cycle
    solves to share one stacked solve (shapes + solver config).  The
    last three entries are ``(iters, damping, record_residuals)``."""
    return (packed.n, packed.p, packed.w, packed.m,
            str(packed.A_loc.dtype), packed.solve_kernel, int(iters),
            float(damping), bool(record_residuals))


def quantize_capacity(size: int, mult: int = 1) -> int:
    """Smallest ``mult * 2**j >= size`` — the padded batch of a cohort,
    so live-count churn between rounds re-uses capacities."""
    if size < 1:
        raise ValueError(f"cohort size must be >= 1 (got {size})")
    cap = max(int(mult), 1)
    while cap < size:
        cap *= 2
    return cap


@dataclasses.dataclass
class CohortResult:
    """One batched solve's outputs, unstacked per member."""

    xs: List[torch.Tensor]               # per-member analysis states
    hists: List[Optional[torch.Tensor]]  # per-member residual histories
    solve_time: float                    # wall time of the whole solve
    capacity: int                        # padded batch size
    size: int                            # live members in the solve


class CohortSolver:
    """Solves cohorts of rhs-injected packings with
    :func:`~repro_torch.core.ddkf.solve_fleet` on their device.

    ``mesh``/``axis`` (a :class:`~repro_torch.runtime.mesh.ProcessMesh`
    and one of its axes) spread each cohort's members over the ranks of
    that axis; every rank must call :meth:`solve` with the same cohorts
    in the same order.  Stateless apart from the pinned capacities and
    telemetry."""

    def __init__(self, mesh=None, axis: str = "fleet"):
        if mesh is not None and axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r} (has "
                             f"{tuple(mesh.shape)})")
        self.mesh = mesh
        self.axis = axis
        self.mult = int(mesh.shape[axis]) if mesh is not None else 1
        # Per-key pinned capacity (monotone), as the reference keeps: the
        # padded batch of a shape never shrinks between rounds.
        self._caps: Dict[tuple, int] = {}

    def solve(self, key: tuple,
              packs: Sequence["ddkf_mod.PackedDD"]) -> CohortResult:
        """Run one cohort (all members sharing ``key``) to completion."""
        iters, damping, record_residuals = key[-3:]
        size = len(packs)
        cap = max(quantize_capacity(size, self.mult),
                  self._caps.get(key, 1))
        self._caps[key] = cap
        m = meters_mod.get_meters()
        with trace_mod.span("fleet.cohort", size=size, capacity=cap,
                            n=key[0], p=key[1], w=key[2]) as sp:
            t0 = time.perf_counter()
            if cap == 1:
                # Singleton: skip the stack and solve the packing itself,
                # exactly as the sequential engine does.
                out = ddkf_mod.solve_vmapped(
                    packs[0], iters=iters, damping=damping,
                    residual_history=record_residuals)
                x = out[0][None] if record_residuals else out[None]
                hist = out[1][None] if record_residuals else None
            else:
                padded = list(packs) + [packs[0]] * (cap - size)
                # On a mesh each rank solves its own slice of the list.
                out = ddkf_mod.solve_fleet(
                    padded if self.mesh is not None
                    else ddkf_mod.stack_packed(padded), iters=iters,
                    damping=damping, residual_history=record_residuals,
                    mesh=self.mesh, axis=self.axis)
                x = out[0] if record_residuals else out
                hist = out[1] if record_residuals else None
            sp.fence(x)
            solve_time = time.perf_counter() - t0
        m.inc("fleet.cohort.dispatches")
        m.inc("fleet.cohort.members", size)
        m.inc("fleet.cohort.padded_slots", cap - size)
        m.observe("fleet.cohort.solve_time", solve_time)
        m.event("fleet.cohort", size=size, capacity=cap, n=key[0],
                p=key[1], w=key[2])
        xs = [x[i] for i in range(size)]
        hists = ([hist[i] for i in range(size)] if record_residuals
                 else [None] * size)
        return CohortResult(xs=xs, hists=hists, solve_time=solve_time,
                            capacity=cap, size=size)


def group_cohorts(items: Sequence[Tuple[tuple, object]]
                  ) -> Dict[tuple, List[object]]:
    """Bucket ``(key, member)`` pairs by key, preserving arrival order
    within each cohort (the order members are unstacked back out in)."""
    groups: Dict[tuple, List[object]] = {}
    for key, member in items:
        groups.setdefault(key, []).append(member)
    return groups
