"""int8 error-feedback gradient compression.

The counterpart of ``repro.optim.compress``: per-tensor symmetric int8
quantization with an error-feedback buffer, so the quantization residual
is added back into the next step's gradient.  ``compressed_psum`` is
the data-parallel all-reduce built on it, over an axis of a
:class:`~repro_torch.runtime.mesh.ProcessMesh` (the reference's runs
inside ``shard_map``): the wire carries the int8 values (widened to
int32 for the sum) and one scale.
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


def compressed_psum(grad: torch.Tensor, error: torch.Tensor,
                    axis_name: str, mesh=None):
    """All-reduce a gradient in int8 with error feedback over the
    ``axis_name`` axis of ``mesh``.

    Every rank of the axis calls this with its own gradient and error
    buffer: each quantizes locally, the ranks psum the int8 values as
    int32 and take the max of their scales, and each dequantizes the sum
    with that scale over the axis size.  Returns ``(mean_grad,
    new_error)``: the mean in ``grad``'s dtype, the same bits on every
    rank, and this rank's own (g + e) - dequant(q)."""
    if mesh is None:
        raise ValueError(
            "compressed_psum needs mesh=: the ProcessMesh whose "
            f"{axis_name!r} axis the gradient is reduced over")
    g = grad.float() + error
    q, scale = quantize(g)
    # (g + e) - q * scale rounded once to f32, as the reference's step
    # computes it under jit (XLA fuses the product into the difference);
    # q has at most 7 bits and the scale 24, so the f64 difference is
    # exact.  compress_with_feedback rounds twice, as the reference does
    # outside jit.
    new_error = (g.double() - q.double() * scale.double()).float()
    n = len(mesh.group_ranks(axis_name))
    summed = mesh.psum(q.to(torch.int32), axis_name)
    scale_max = mesh.pmax(scale, axis_name)
    return (summed.float() * scale_max / n).to(grad.dtype), new_error


def init_error_buffers(grads_like):
    """f32 zeros shaped like every leaf of a nested dict of tensors."""
    if isinstance(grads_like, dict):
        return {k: init_error_buffers(v) for k, v in grads_like.items()}
    return torch.zeros(grads_like.shape, dtype=torch.float32,
                       device=grads_like.device)
