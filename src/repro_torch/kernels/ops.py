"""Dispatch between the CUDA kernels and their plain PyTorch versions.

``mode="auto"`` sends CUDA tensors to the hand-written kernel (which
launches or raises — there is no fallback) and CPU tensors to the plain
version.  ``mode="plain"`` forces the plain version on any device; it
exists to compare the two.  The choice is made from the tensor's device
alone, so the same call runs the kernel on the card and the plain
version in the CPU tests.
"""
from __future__ import annotations

from repro_torch.kernels import gram as _gram
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import schwarz_step as _sch

MODES = ("auto", "plain")


def _use_kernel(t, mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (got {mode!r})")
    return mode == "auto" and t.is_cuda


def gram(A, r, *, mode: str = "auto"):
    """Batched weighted Gram N = A^T diag(r) A (paper eq. 27).
    A: (p, m, w), r: (p, m) -> (p, w, w)."""
    if _use_kernel(A, mode):
        return _gram.gram(A, r)
    return _ref.gram_plain(A, r)


def schwarz_fwd(A, x, wdiv, *, mode: str = "auto"):
    """(y, u) = (A @ (x * wdiv), A @ x) in one pass over A."""
    if _use_kernel(A, mode):
        return _sch.schwarz_fwd(A, x, wdiv)
    return _ref.schwarz_fwd_plain(A, x, wdiv)


def schwarz_bwd(A, r, b, Ax, u, x, muov, mask, *, mode: str = "auto"):
    """rhs = (A^T @ (r * (b - Ax + u)) + muov * x) * mask in one pass."""
    if _use_kernel(A, mode):
        return _sch.schwarz_bwd(A, r, b, Ax, u, x, muov, mask)
    return _ref.schwarz_bwd_plain(A, r, b, Ax, u, x, muov, mask)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_counts`."""
    return {"gram": _gram.launches, "schwarz_fwd": _sch.fwd_launches,
            "schwarz_bwd": _sch.bwd_launches}


def reset_counts() -> None:
    _gram.launches = 0
    _sch.fwd_launches = 0
    _sch.bwd_launches = 0
