"""Streaming multi-cycle DD-KF assimilation with online DyDD rebalancing
(the single-device engine of ``repro.assim``)."""
from repro_torch.assim.engine import (  # noqa: F401
    AssimilationEngine, CycleStep, EngineConfig)
from repro_torch.assim.metrics import (  # noqa: F401
    CycleMetrics, Journal, imbalance_ratio)
from repro_torch.assim import streams  # noqa: F401
