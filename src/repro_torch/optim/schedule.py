"""Learning-rate schedules (linear warmup + cosine/linear/constant decay).

The counterpart of ``repro.optim.schedule``, in float32 as the
reference's traced schedule computes it.
"""
from __future__ import annotations

import math

import numpy as np


def make_schedule(kind: str, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    """Returns step -> lr (a Python float, computed in float32)."""
    f32 = np.float32

    def fn(step):
        step = f32(int(step))
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        frac = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        if kind == "cosine":
            decay = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac)
                                    * f32(0.5) * (f32(1) + np.cos(
                                        f32(math.pi) * frac)))
        elif kind == "linear":
            decay = f32(peak_lr) * (f32(1.0) - f32(1 - final_frac) * frac)
        else:
            decay = f32(peak_lr)
        return float(warm if step < warmup_steps else decay)

    return fn
