"""Fault-tolerant checkpointing: atomic writes, async, the reference's
on-disk layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_checkpoint, restore_pytree, save_pytree,
    verify)
