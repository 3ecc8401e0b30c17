"""Roofline terms of a traced step, the counterpart of
``repro.launch.hlo_analysis``.

compute term    = flops / (chips * PEAK_FLOPS)
memory term     = hbm_bytes / (chips * HBM_BW)
collective term = per-device collective bytes / LINK_BW

The reference reads XLA's ``cost_analysis`` and parses the partitioned
HLO for its collectives.  The port runs eagerly, so it has no HLO: the
dry run (:mod:`repro_torch.launch.dryrun`) traces one rank's step on
``meta`` tensors and counts what that rank does (its flops and bytes,
scaled by the chips to global figures as the reference scales XLA's
per-device ones) and the collectives it calls, which a mesh records as
(kind, result bytes, group size)
(:func:`repro_torch.runtime.mesh.record_collective`).
:func:`collective_bytes` turns those records into wire bytes by the
reference's formulas: all-reduce 2 b (g - 1) / g (a ring is a
reduce-scatter and an all-gather at full payload), reduce-scatter
b (g - 1) (the input, g b, transits (g - 1) / g of it), all-gather
b (g - 1) / g, and all-to-all and collective-permute b, with b the
result's bytes on one rank and g the group's size.

Hardware constants: one NVIDIA H100 SXM5, from its data sheet (dense
rates, no sparsity).  ``LINK_BW`` is one link constant as in the
reference, a model of the deployment, not a reading: NVLink 4's 900 GB/s
a card counts both directions, 450 GB/s one way.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
LINK_BW = 450e9              # NVLink 4, bytes/s one direction per card


@dataclasses.dataclass
class CollectiveStats:
    per_device_bytes: float
    counts: dict
    bytes_by_kind: dict


def collective_bytes(records) -> CollectiveStats:
    """Per-device wire bytes of recorded collective calls: ``records``
    maps (kind, result bytes on one rank, group size) to calls, as a
    mesh's ``collectives`` does."""
    counts: dict = {}
    by_kind: dict = {}
    total = 0.0
    for (op, b, g), n in records.items():
        if op == "all-reduce":
            wire = 2.0 * b * (g - 1) / max(g, 1)
        elif op == "reduce-scatter":
            wire = b * (g - 1)           # input = b*g, transits (g-1)/g of it
        elif op == "all-gather":
            wire = b * (g - 1) / max(g, 1)
        else:                            # all-to-all, collective-permute
            wire = b
        counts[op] = counts.get(op, 0) + n
        by_kind[op] = by_kind.get(op, 0.0) + n * wire
        total += n * wire
    return CollectiveStats(per_device_bytes=total, counts=counts,
                           bytes_by_kind=by_kind)


@dataclasses.dataclass
class Roofline:
    flops: float                  # global flops (one rank's times chips)
    hbm_bytes: float              # global bytes accessed
    coll_bytes_per_device: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float            # 6*N*D (or 6*N_active*D)
    counts: dict

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline realized if the dominant term
        were fully overlapped: ideal_compute_time / bound_time."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "chips": self.chips, "compute_s": self.compute_s,
            "memory_s": self.memory_s, "collective_s": self.collective_s,
            "model_flops": self.model_flops, "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac, "counts": self.counts,
        }


def analyze(flops: float, hbm_bytes: float, collectives, chips: int,
            model_flops: float) -> Roofline:
    """The roofline of a step from one rank's traced ``flops`` and
    ``hbm_bytes`` (scaled here by ``chips`` to global figures, as the
    reference scales XLA's per-device ``cost_analysis``) and its recorded
    ``collectives`` (:func:`collective_bytes`)."""
    flops = float(flops) * chips
    hbm = float(hbm_bytes) * chips
    coll = collective_bytes(collectives)
    return Roofline(
        flops=flops, hbm_bytes=hbm,
        coll_bytes_per_device=coll.per_device_bytes, chips=chips,
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=hbm / (chips * HBM_BW),
        collective_s=coll.per_device_bytes / LINK_BW,
        model_flops=model_flops, counts=coll.counts)


def model_flops_train(cfg, seq: int, global_batch: int) -> float:
    """6*N*D with N = active params (MoE: routed experts only)."""
    n_active = cfg.param_count(active_only=True)
    return 6.0 * n_active * seq * global_batch


def model_flops_decode(cfg, cache_len: int, global_batch: int) -> float:
    """One token: 2*N_active matmul FLOPs + attention reads over the cache."""
    n_active = cfg.param_count(active_only=True)
    flops = 2.0 * n_active * global_batch
    # attention over the cache (per global/local layer)
    for i in range(cfg.num_layers):
        t = cfg.layer_type(i)
        if t in ("global", "local"):
            span = cache_len if t == "global" else min(cfg.window, cache_len)
            flops += (4.0 * global_batch * cfg.num_heads * cfg.head_dim
                      * span)
    return flops
