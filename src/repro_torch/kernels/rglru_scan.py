"""RG-LRU linear recurrence on the card.

Wrapper of the CUDA kernel ``csrc/rglru_scan.cu`` (the Hopper counterpart
of the TPU kernel ``repro.kernels.rglru_scan``): h_t = a_t h_{t-1} + b_t
over the sequence axis of (B, S, W) inputs, f32 or bf16 in, the state in
f32, the output in the input type.  It takes CUDA tensors only;
:func:`repro_torch.kernels.ops.rglru_scan` routes CPU tensors to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (see ops.reset_counts)

_FN = {torch.float32: "repro_rglru_scan_f32",
       torch.bfloat16: "repro_rglru_scan_bf16"}
MAX_B = 65535   # the grid's y extent


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h: (B, S, W) with h_t = a_t h_{t-1} + b_t."""
    global launches
    dtype = _build.check_inputs("rglru_scan", {"a": a, "b": b},
                                dtypes=_build.LM_DTYPES)
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"rglru_scan: a must be (B, S, W) with B, S, W >= 1"
                         f" (got {tuple(a.shape)})")
    B, S, W = a.shape
    if B > MAX_B:
        raise ValueError(f"rglru_scan: B must be at most {MAX_B} (got {B})")
    _build.check_shape("rglru_scan", "b", b, (B, S, W))
    h = torch.empty_like(a)
    lib = _build.load()
    err = getattr(lib, _FN[dtype])(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    launches += 1
    return h
