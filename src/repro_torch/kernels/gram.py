"""Batched weighted Gram matrix on the card — the DD-KF setup hot spot.

Wrapper of the CUDA kernel ``csrc/gram.cu`` (the Hopper counterpart of
the TPU kernel ``repro.kernels.gram.gram``): N_i = A_i^T diag(r_i) A_i
for every subdomain i, accumulated in the input type (f64 or f32).  It
takes CUDA tensors only; :func:`repro_torch.kernels.ops.gram` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (see ops.reset_counts)

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
    N = torch.empty((p, w, w), dtype=dtype, device=A.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = getattr(lib, _FN[dtype])(A.data_ptr(), r.data_ptr(), N.data_ptr(),
                                   p, m, w, stream)
    _build.check(err, "gram")
    launches += 1
    return N
