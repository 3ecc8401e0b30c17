"""Dispatch between the CUDA kernels and their plain PyTorch versions.

``mode="auto"`` sends CUDA tensors to the hand-written kernel (which
launches or raises — there is no fallback) and CPU tensors to the plain
version.  ``mode="plain"`` forces the plain version on any device; it
exists to compare the two.  The choice is made from the tensor's device
alone, so the same call runs the kernel on the card and the plain
version in the CPU tests.  ``meta`` tensors take the kernel's wrapper
too, on its meta route: it allocates on ``meta`` what a launch
allocates (outputs, saved workspaces; in the backward the gradients),
adds the call's flops and bytes (:mod:`repro_torch.kernels.cost`) to the
active :class:`~repro_torch.kernels.cost.Recorder`, computes nothing and
counts no launch.  The dry run (:mod:`repro_torch.launch.dryrun`) traces
steps so.

The three LM kernels are differentiable.  In ``"auto"`` mode they run as
autograd Functions (``FlashAttention``, ``RglruScan``, ``SsdScan``) whose
backward is a CUDA kernel too, on the card (its meta route on ``meta``),
and the plain backward of ``kernels/ref.py`` on the CPU; ``"plain"``
runs the plain forward, which autograd differentiates.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import schwarz_step as _sch
from repro_torch.kernels import ssd_scan as _ssd

MODES = ("auto", "plain")


def _auto(mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (got {mode!r})")
    return mode == "auto"


def _use_kernel(t, mode: str) -> bool:
    return _auto(mode) and (t.is_cuda or t.is_meta)


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, mode: str = "auto"):
    """Causal / sliding-window softmax attention, or cross-attention.
    q: (BH, S, D), k, v: (BH_kv, S_kv, D) with BH_kv dividing BH, row
    ``bh // (BH // BH_kv)`` serving query row ``bh`` -> (BH, S, D);
    ``window <= 0`` is unbounded.  S_kv may differ from S only when
    ``causal`` is false and ``window`` is 0 (``ValueError`` otherwise):
    whisper's decoder reading the encoder's frames.  ``softcap`` > 0
    caps the scaled scores as softcap tanh(s / softcap) before the mask
    and the softmax (Gemma 2's ``attn_logit_softcapping``)."""
    if _auto(mode):
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap)
    return _ref.attention_plain(q, k, v, causal=causal, window=window,
                                softcap=softcap)


def rglru_scan(a, b, *, mode: str = "auto"):
    """h_t = a_t h_{t-1} + b_t over the sequence.  a, b: (B, S, W)."""
    if _auto(mode):
        return _rg.RglruScan.apply(a, b)
    return _ref.rglru_scan_plain(a, b)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, state: bool = False,
             mode: str = "auto"):
    """Mamba-2 SSD chunked scan, head-folded: x (BH, S, P), dt (BH, S),
    A (BH,), B/C (BH / rep, S, N) with row ``bh // rep`` serving head
    ``bh`` -> y (BH, S, P), and with ``state`` also the final state
    (BH, N, P) in f32.  ``min(chunk, S)`` must divide S."""
    if _auto(mode):
        y, final = _ssd.SsdScan.apply(x, dt, A, B, C, chunk)
        return (y, final) if state else y
    return _ref.ssd_scan_plain(x, dt, A, B, C, chunk=chunk, state=state)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_counts`."""
    return {"gram": _gram.launches, "schwarz_fwd": _sch.fwd_launches,
            "schwarz_bwd": _sch.bwd_launches,
            "flash_attention": _fa.launches, "rglru_scan": _rg.launches,
            "ssd_scan": _ssd.launches,
            "flash_attention_bwd": _fa.bwd_launches,
            "rglru_scan_bwd": _rg.bwd_launches,
            "ssd_scan_bwd": _ssd.bwd_launches}


def reset_counts() -> None:
    _gram.launches = 0
    _sch.fwd_launches = 0
    _sch.bwd_launches = 0
    _fa.launches = 0
    _rg.launches = 0
    _ssd.launches = 0
    _fa.bwd_launches = 0
    _rg.bwd_launches = 0
    _ssd.bwd_launches = 0
