"""Mesh construction, the counterpart of ``repro.launch.mesh``.

:func:`make_test_mesh` lays the launched ranks out on named axes (a
:class:`~repro_torch.runtime.mesh.ProcessMesh`; its sizes multiply to the
world size).  :func:`make_production_mesh` is the reference's 16 x 16
pod or 2 x 16 x 16 pair of pods as an
:class:`~repro_torch.runtime.sharding.AbstractMesh`: axis sizes for the
partition specs, no ranks, since no one launches 256 processes.
"""
from __future__ import annotations

from repro_torch.runtime.mesh import ProcessMesh
from repro_torch.runtime.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).
    Axes: 'data' (DP + FSDP), 'model' (TP/EP); 'pod' is pure DP across
    pods."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(shape, axes, *, device=None) -> ProcessMesh:
    """The launched ranks on a mesh of ``shape`` over ``axes`` (row-major,
    as :class:`ProcessMesh`); ``device`` is this rank's (default: its
    card)."""
    return ProcessMesh(tuple(shape), tuple(axes), device=device)
