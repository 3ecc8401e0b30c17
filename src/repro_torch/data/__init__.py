"""Synthetic observation networks and the DyDD-balanced token loader."""
from repro_torch.data.observations import make_observations  # noqa: F401
