"""int8 error-feedback gradient compression.

The counterpart of ``repro.optim.compress``: per-tensor symmetric int8
quantization with an error-feedback buffer, so the quantization residual
is added back into the next step's gradient.  ``compressed_psum``, the
data-parallel all-reduce built on it, needs several processes and waits
for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor):
    """x (f32/bf16) -> (int8 values, f32 scale)."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Returns (q, scale, new_error).  new_error = (g + e) - dequant(q)."""
    g = grad.float() + error
    q, scale = quantize(g)
    return q, scale, g - dequantize(q, scale)


def compressed_psum(grad, error, axis_name: str):
    """The int8 all-reduce of the reference's data-parallel step."""
    raise NotImplementedError(
        "compressed_psum is a multi-process all-reduce; the port has no "
        "data-parallel mesh yet (ROADMAP Queue 1 item 13)")


def init_error_buffers(grads_like):
    """f32 zeros shaped like every leaf of a nested dict of tensors."""
    if isinstance(grads_like, dict):
        return {k: init_error_buffers(v) for k, v in grads_like.items()}
    return torch.zeros(grads_like.shape, dtype=torch.float32,
                       device=grads_like.device)
