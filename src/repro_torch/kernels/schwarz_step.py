"""Fused additive-Schwarz iteration step on the card — the DD-KF hot loop.

Wrappers of the CUDA kernels in ``csrc/schwarz_step.cu`` (the Hopper
counterparts of the TPU kernels ``repro.kernels.schwarz_step``):

* :func:`schwarz_fwd` — ONE pass over A_i gives y_i = A_i (x_i * wdiv_i)
  and u_i = A_i x_i.  The cross-subdomain sum Ax = sum_i y_i stays
  outside the kernel.
* :func:`schwarz_bwd` — ONE pass over A_i gives
  rhs_i = (A_i^T (r * (b - Ax + u_i)) + muov_i * x_i) * mask_i with the
  residual formed on chip and never stored; the m-reduction is split in
  a fixed number of parts summed in a fixed order (no float atomics).

Both take CUDA tensors only; :mod:`repro_torch.kernels.ops` routes CPU
tensors to the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

fwd_launches = 0   # kernel launches since the last reset
bwd_launches = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _pw(A: torch.Tensor, name: str) -> tuple:
    if A.dim() != 3 or min(A.shape) < 1:
        raise ValueError(f"{name}: A must be (p, m, w) with p, m, w >= 1 "
                         f"(got {tuple(A.shape)})")
    return tuple(A.shape)


def schwarz_fwd(A, x, wdiv):
    """A: (p, m, w), x/wdiv: (p, w) -> (y, u), both (p, m)."""
    global fwd_launches
    dtype = _build.check_inputs("schwarz_fwd", {"A": A, "x": x,
                                                "wdiv": wdiv})
    p, m, w = _pw(A, "schwarz_fwd")
    for k, t in (("x", x), ("wdiv", wdiv)):
        _build.check_shape("schwarz_fwd", k, t, (p, w))
    y = torch.empty((p, m), dtype=dtype, device=A.device)
    u = torch.empty((p, m), dtype=dtype, device=A.device)
    lib = _build.load()
    fn = getattr(lib, f"repro_schwarz_fwd_{_SUFFIX[dtype]}")
    err = fn(A.data_ptr(), x.data_ptr(), wdiv.data_ptr(), y.data_ptr(),
             u.data_ptr(), p, m, w,
             torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "schwarz_fwd")
    fwd_launches += 1
    return y, u


def schwarz_bwd(A, r, b, Ax, u, x, muov, mask):
    """A: (p, m, w), r/b/Ax: (m,), u: (p, m), x/muov/mask: (p, w) ->
    rhs: (p, w)."""
    global bwd_launches
    dtype = _build.check_inputs(
        "schwarz_bwd", {"A": A, "r": r, "b": b, "Ax": Ax, "u": u, "x": x,
                        "muov": muov, "mask": mask})
    p, m, w = _pw(A, "schwarz_bwd")
    for k, t in (("r", r), ("b", b), ("Ax", Ax)):
        _build.check_shape("schwarz_bwd", k, t, (m,))
    _build.check_shape("schwarz_bwd", "u", u, (p, m))
    for k, t in (("x", x), ("muov", muov), ("mask", mask)):
        _build.check_shape("schwarz_bwd", k, t, (p, w))
    lib = _build.load()
    part = torch.empty((p, lib.repro_schwarz_bwd_splits(), w), dtype=dtype,
                       device=A.device)
    out = torch.empty((p, w), dtype=dtype, device=A.device)
    fn = getattr(lib, f"repro_schwarz_bwd_{_SUFFIX[dtype]}")
    err = fn(A.data_ptr(), r.data_ptr(), b.data_ptr(), Ax.data_ptr(),
             u.data_ptr(), x.data_ptr(), muov.data_ptr(), mask.data_ptr(),
             part.data_ptr(), out.data_ptr(), p, m, w,
             torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "schwarz_bwd")
    bwd_launches += 1
    return out
