"""Prefill and serve step factories.

The counterparts of ``repro.runtime.steps.make_prefill_step`` and
``make_serve_step``: eager calls under ``torch.inference_mode()``.  The
reference's jit, mesh shardings and buffer donation have no counterpart
on one device.  The train step waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_seq: int | None = None, *,
                      mode: str = "auto"):
    """``step(params, batch) -> (logits_last (B, V), cache)``; ``mode``
    goes to the prefill's kernel ops."""
    def step(params, batch):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch, max_seq=max_seq,
                                       mode=mode)
    return step


def make_serve_step(cfg: ModelConfig):
    """``step(params, cache, tokens, pos) -> (logits (B, 1, V), cache)``."""
    def step(params, cache, tokens, pos):
        with torch.inference_mode():
            return transformer.serve_step(cfg, params, cache, tokens, pos)
    return step
