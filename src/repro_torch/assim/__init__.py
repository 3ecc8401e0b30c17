"""Streaming multi-cycle DD-KF assimilation with online DyDD rebalancing
(the single-device engines of ``repro.assim``: the sequential engine,
the parallel-in-time Parareal engine and the multi-tenant fleet
server)."""
from repro_torch.assim.engine import (  # noqa: F401
    AssimilationEngine, CycleStep, EngineConfig)
from repro_torch.assim.metrics import (  # noqa: F401
    CycleMetrics, Journal, imbalance_ratio)
from repro_torch.assim import streams  # noqa: F401
from repro_torch.assim.serving import FleetServer  # noqa: F401
from repro_torch.assim.timepar import TimeParEngine  # noqa: F401
