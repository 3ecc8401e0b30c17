"""RG-LRU linear recurrence on the card, forward and backward.

Wrappers of the CUDA kernels in ``csrc/rglru_scan.cu`` (the forward is the
Hopper counterpart of the TPU kernel ``repro.kernels.rglru_scan``; the
backward has no TPU counterpart): h_t = a_t h_{t-1} + b_t over the
sequence axis of (B, S, W) inputs, f32 or bf16 in, the state in f32, the
output in the input type; and its gradients from h and dh by the reverse
scan.  The wrappers take CUDA tensors only.  :class:`RglruScan` is the
autograd Function that :func:`repro_torch.kernels.ops.rglru_scan` calls:
the kernels for CUDA tensors, the plain versions of ``kernels/ref.py``
for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

launches = 0       # forward launches since the last reset (ops.reset_counts)
bwd_launches = 0   # backward launches since the last reset

_FN = {torch.float32: "repro_rglru_scan_f32",
       torch.bfloat16: "repro_rglru_scan_bf16"}
_BWD_FN = {torch.float32: "repro_rglru_scan_bwd_f32",
           torch.bfloat16: "repro_rglru_scan_bwd_bf16"}
MAX_B = 65535   # the grid's y extent


def _check(name: str, tensors: dict):
    dtype = _build.check_inputs(name, tensors, dtypes=_build.LM_DTYPES)
    a = next(iter(tensors.values()))
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"{name}: a must be (B, S, W) with B, S, W >= 1"
                         f" (got {tuple(a.shape)})")
    if a.shape[0] > MAX_B:
        raise ValueError(f"{name}: B must be at most {MAX_B} (got "
                         f"{a.shape[0]})")
    for key, t in tensors.items():
        _build.check_shape(name, key, t, a.shape)
    return dtype


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h: (B, S, W) with h_t = a_t h_{t-1} + b_t."""
    global launches
    dtype = _check("rglru_scan", {"a": a, "b": b})
    B, S, W = a.shape
    h = torch.empty_like(a)
    lib = _build.load()
    err = getattr(lib, _FN[dtype])(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> tuple:
    """The gradients (da, db) of :func:`rglru_scan` from its output h and
    dh, all (B, S, W) in one dtype."""
    global bwd_launches
    dtype = _check("rglru_scan_bwd", {"a": a, "h": h, "dh": dh})
    B, S, W = a.shape
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    lib = _build.load()
    err = getattr(lib, _BWD_FN[dtype])(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db


class RglruScan(torch.autograd.Function):
    """h = rglru_scan(a, b) with the reverse scan as its backward; saves a
    and h."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b) if a.is_cuda else ref.rglru_scan_plain(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        dh = dh.contiguous()
        if a.is_cuda:
            return rglru_scan_bwd(a, h, dh)
        return ref.rglru_scan_bwd_plain(a, h, dh)
