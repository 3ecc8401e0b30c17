"""Batched weighted Gram matrix on the card — the DD-KF setup hot spot.

Wrapper of the CUDA kernel ``csrc/gram.cu`` (the Hopper counterpart of
the TPU kernel ``repro.kernels.gram.gram``): N_i = A_i^T diag(r_i) A_i
for every subdomain i, accumulated in the input type (f64 or f32): f64
on the f64 tensor cores, f32 in exact FMA.  It takes CUDA tensors, and
``meta`` tensors, for which it allocates N on ``meta``, adds the call's
work (:mod:`repro_torch.kernels.cost`) to the active recorder and
launches nothing; :func:`repro_torch.kernels.ops.gram` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, cost

launches = 0   # kernel launches since the last reset (see ops.reset_counts)
# The fleet server's packing threads launch gram concurrently; the count's
# read-modify-write must not lose one of them.
_COUNT_LOCK = threading.Lock()

_FN = {torch.float64: "repro_gram_f64", torch.float32: "repro_gram_f32"}


def gram(A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A: (p, m, w), r: (p, m) -> N: (p, w, w) with N = A^T diag(r) A."""
    global launches
    dtype = _build.check_inputs("gram", {"A": A, "r": r})
    if A.dim() != 3 or min(A.shape) < 1:
        raise ValueError(f"gram: A must be (p, m, w) with p, m, w >= 1 "
                         f"(got {tuple(A.shape)})")
    p, m, w = A.shape
    _build.check_shape("gram", "r", r, (p, m))
    if dtype == torch.float64:
        _build.check_aligned("gram", {"A": A, "r": r})
    N = torch.empty((p, w, w), dtype=dtype, device=A.device)
    if A.is_meta:
        cost.record("gram", cost.gram(A.shape, dtype))
        return N
    lib = _build.load()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = getattr(lib, _FN[dtype])(A.data_ptr(), r.data_ptr(), N.data_ptr(),
                                   p, m, w, stream)
    _build.check(err, "gram")
    with _COUNT_LOCK:
        launches += 1
    return N
