"""Synthetic observation networks."""
from repro_torch.data.observations import make_observations  # noqa: F401
