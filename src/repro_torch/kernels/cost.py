"""The work of each kernel: the flops it must do and the bytes it must
move, from shapes, dtypes and options alone.

One definition serves three readers: ``chip_smoke.py`` (each kernel's
``bound_ms``, the least time the card could take for the call), the
kernels' ``meta`` routes (which add a call's work to the active
:class:`Recorder` and compute nothing), and the dry run
(:mod:`repro_torch.launch.dryrun`), which adds the recorded work to what
``torch.utils.flop_counter`` counts for the plain PyTorch ops.

Bytes count each input read once and each output written once; flops
count what the function needs on these shapes (an attention's visible
score entries only).  A :class:`Work`'s bound is the larger of its bytes
over :data:`PEAK_BYTES` and its flops over the peak of the type it runs
at.

The peaks are the NVIDIA H100 SXM5 data sheet's dense rates (no
sparsity), at the full 700 W power limit: FP64 on the tensor cores 67
TFLOP/s, FP32 outside the tensor cores 67 TFLOP/s, TF32 on the tensor
cores 495 TFLOP/s, BF16 on the tensor cores 989 TFLOP/s, and HBM3 3.35
TB/s.  They are a model of the card, not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's flops, bytes and the flop rate (flop/s) its flops are
    bounded by."""
    flops: int
    nbytes: int
    peak: float

    def bound(self) -> tuple:
        """(bound_ms, bound_by): the larger of the flops over ``peak`` and
        the bytes over :data:`PEAK_BYTES`, in ms, and which of the two
        (``"operations"`` or ``"bytes"``)."""
        t_ops = self.flops / self.peak * 1e3
        t_bytes = self.nbytes / PEAK_BYTES * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


# -- the DA kernels ----------------------------------------------------------

def gram(A_shape, dtype: torch.dtype) -> Work:
    """N = A^T diag(r) A, A (p, m, w): the symmetric half's multiply-adds
    (2 flops each), A and r read, N written."""
    p, m, w = A_shape
    flops = p * m * w * (w + 1)
    elems = p * m * w + p * m + p * w * w
    return Work(flops, elems * _itemsize(dtype), PEAK_FLOPS[dtype])


def schwarz_fwd(A_shape, dtype: torch.dtype) -> Work:
    """(y, u) = (A (x wdiv), A x): two products over A; A, x and wdiv
    read, y and u written."""
    p, m, w = A_shape
    flops = 4 * p * m * w
    elems = p * m * w + 2 * p * w + 2 * p * m
    return Work(flops, elems * _itemsize(dtype), PEAK_FLOPS[dtype])


def schwarz_bwd(A_shape, dtype: torch.dtype) -> Work:
    """rhs = (A^T (r (b - Ax + u)) + muov x) mask: one product over A and
    the elementwise terms; A, r, b, Ax, u, x, muov and mask read, rhs
    written."""
    p, m, w = A_shape
    flops = 2 * p * m * w + 4 * p * m + 3 * p * w
    elems = p * m * w + 3 * m + p * m + 3 * p * w + p * w
    return Work(flops, elems * _itemsize(dtype), PEAK_FLOPS[dtype])


# -- attention ---------------------------------------------------------------

def visible_scores(s: int, causal: bool, window: int,
                   s_kv: int | None = None) -> int:
    """Score entries a (BH = 1) attention of S query rows leaves unmasked
    (S_kv keys, S by default; S_kv differs only in a cross-attention,
    where every key is visible)."""
    if s_kv is not None and s_kv != s:
        return s * s_kv
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window <= 0 else np.maximum(q - window + 1,
                                                              0)
    hi = q + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def flash_attention(q_shape, k_shape, dtype: torch.dtype, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> Work:
    """q (BH, S, D), k and v (BH_kv, S_kv, D): 4 D flops a visible score
    entry (q k^T and p v); q read and o written at BH rows, k and v read
    once at their own BH_kv rows.  The flops are the tensor cores' (or
    the f32 FMAs'): a ``softcap`` call's tanh of each score runs on the
    special-function units beside its exp and is not counted, so the
    bound is the uncapped call's."""
    bh, s, d = q_shape
    flops = 4 * d * bh * visible_scores(s, causal, window, k_shape[1])
    nbytes = (2 * _numel(q_shape) + 2 * _numel(k_shape)) * _itemsize(dtype)
    return Work(flops, nbytes, PEAK_FLOPS[dtype])


def flash_attention_bwd(q_shape, k_shape, dtype: torch.dtype, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> Work:
    """The backward of :func:`flash_attention`: 2 D flops a visible pair
    for each of S (recomputed from the saved lse), dP, dV, dQ and dK; q,
    o, dO read and dQ written at BH rows, k, v read and dK, dV written at
    BH_kv rows, the f32 lse read.  As in :func:`flash_attention`, a
    ``softcap`` call's tanh and its factor 1 - tanh^2 on dS are not
    counted."""
    bh, s, d = q_shape
    flops = 10 * d * bh * visible_scores(s, causal, window, k_shape[1])
    nbytes = ((4 * _numel(q_shape) + 4 * _numel(k_shape)) * _itemsize(dtype)
              + 4 * bh * s)
    return Work(flops, nbytes, PEAK_FLOPS[dtype])


# -- the scans ---------------------------------------------------------------

def rglru_scan(shape, dtype: torch.dtype) -> Work:
    """h_t = a_t h_{t-1} + b_t over (B, S, W): 2 flops an element; a, b
    read, h written."""
    n = _numel(shape)
    return Work(2 * n, 3 * n * _itemsize(dtype), PEAK_FLOPS[dtype])


def rglru_scan_bwd(shape, dtype: torch.dtype) -> Work:
    """(da, db) from a, h and dh: 3 flops an element; 5 accesses an
    element (a, h, dh read, da, db written), the flops at the TF32 peak
    as the other backward bounds."""
    n = _numel(shape)
    return Work(3 * n, 5 * n * _itemsize(dtype), PEAK_TF32)


def ssd_scan(x_shape, B_shape, chunk: int) -> Work:
    """The Mamba-2 SSD scan, f32, x (BH, S, P), B and C (G, S, N): flops
    at the least the function needs, counting the causal triangle's
    chunk (chunk + 1) / 2 pairs: C B^T once per (group, chunk), 2 N a
    pair, as the heads of a group share it; per (head, chunk), (C B^T .*
    L) x, 2 P a pair, and the inter-chunk term and the state update, 2 N
    P a row each, at the TF32 peak.  Bytes: x, dt, A, B, C read once, y
    and the final state written once."""
    bh, s, p = x_shape
    groups, _, n = B_shape
    chunk = min(chunk, s)
    pairs = chunk * (chunk + 1) // 2
    flops = (s // chunk) * (groups * 2 * pairs * n
                            + bh * (2 * pairs * p + 4 * chunk * n * p))
    nbytes = 4 * (2 * bh * s * p + bh * s + bh + 2 * groups * s * n
                  + bh * n * p)
    return Work(flops, nbytes, PEAK_TF32)


def ssd_scan_bwd(x_shape, B_shape, chunk: int) -> Work:
    """The backward of :func:`ssd_scan`'s y: per (head, chunk), dy x^T
    and M^T dy (2 P a pair), dG B and dG^T C (2 N a pair), and 4 chunk N
    P multiply-adds for the state terms, at the TF32 peak; bytes: the
    inputs, dy, the forward's saved C B^T, states and f64 cum read, the
    gradients written."""
    bh, s, p = x_shape
    groups, _, n = B_shape
    chunk = min(chunk, s)
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    flops = 2 * nc * bh * (2 * pairs * (p + n) + 4 * chunk * n * p)
    nbytes = (4 * (3 * bh * s * p + 2 * bh * s + 2 * bh + 4 * groups * s * n
                   + groups * nc * chunk * chunk + bh * nc * n * p)
              + 8 * bh * s)
    return Work(flops, nbytes, PEAK_TF32)


# -- the recorder ------------------------------------------------------------

class Recorder:
    """The kernel calls a traced run made on ``meta`` tensors: each
    call's name and :class:`Work`, in order (``calls``)."""

    def __init__(self):
        self.calls: list = []

    def add(self, name: str, work: Work) -> None:
        self.calls.append((name, work))

    @property
    def flops(self) -> int:
        return sum(w.flops for _, w in self.calls)

    @property
    def nbytes(self) -> int:
        return sum(w.nbytes for _, w in self.calls)

    def by_name(self) -> dict:
        """{name: (calls, flops, bytes)}."""
        out: dict = {}
        for name, w in self.calls:
            n, f, b = out.get(name, (0, 0, 0))
            out[name] = (n + 1, f + w.flops, b + w.nbytes)
        return out


_LOCAL = threading.local()


@contextlib.contextmanager
def recording(recorder: Recorder):
    """Make ``recorder`` the one that the enclosed code's ``meta`` kernel
    calls add their work to (this thread's)."""
    prev = getattr(_LOCAL, "recorder", None)
    _LOCAL.recorder = recorder
    try:
        yield recorder
    finally:
        _LOCAL.recorder = prev


def record(name: str, work: Work) -> None:
    """Add a ``meta`` call's work to the active recorder, if any."""
    rec = getattr(_LOCAL, "recorder", None)
    if rec is not None:
        rec.add(name, work)
