"""Optimizer, LR schedule and gradient compression: the counterparts of
``repro.optim`` (``adamw``, ``schedule``, ``compress``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step  # noqa
from repro_torch.optim.schedule import make_schedule  # noqa: F401
from repro_torch.optim import compress  # noqa: F401
