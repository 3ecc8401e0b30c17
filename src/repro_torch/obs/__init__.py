"""Observability: span tracing + metrics for the assimilation stack.

A leaf subsystem, as in ``repro.obs``: :mod:`repro_torch.obs.trace` (span
tracer with device-sync fences and Chrome/Perfetto export) and
:mod:`repro_torch.obs.meters` (process-wide counters/gauges/series/events).
"""
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER, NullTracer, Tracer, get_tracer, set_tracer, span,
    torch_profile, tracing)
from repro_torch.obs.meters import (  # noqa: F401
    Meters, comm_matrix, get_meters, set_meters)
